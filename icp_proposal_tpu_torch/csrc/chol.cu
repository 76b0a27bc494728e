// K1 and K2 of the port: the per-chain r×r GP-posterior factor and solves.
//
// K1 icp_chol_solve replaces _chol_kernel / _chol_call in
// icp_proposal_tpu/ops/chol_pallas.py (reached through chol_solve).  Per
// chain: lower L with M = L Lᵀ (zeros above the diagonal), x = M⁻¹·rhs and
// log det M = Σⱼ log dⱼ; a pivot dⱼ ≤ 0 gives NaN from that column on, as
// chol_pallas.py:103 does, and the MH step rejects the NaN.
//   What bounds it here: latency and block-wide synchronisation, not bytes.
//   A 101×101 factor reads and writes ~80 KB per chain but needs r dependent
//   pivot steps, each a __syncthreads pair across the block.
//   Design: one thread block per chain, the whole matrix in shared memory
//   (row stride r|1, odd, so a column walk touches 32 different banks;
//   41.6 KB at r = 101), right-looking factorisation over the lower
//   triangle with one warp per trailing row, then forward and back
//   substitution by warp 0 while the other warps stream L out.  Thousands
//   of chains give the card enough independent blocks to hide the latency.
//
// K2 icp_tri_solve_lt replaces _tri_lt_kernel / _tri_lt_call in the same
// file (reached through tri_solve_lt): solve Lᵀx = z, dividing by
// max(Lⱼⱼ, 1e-30) as chol_pallas.py:342 does.
//   What bounds it: the r-step dependency chain, each step a dependent read
//   of one row of L (latency, ~40 KB read per chain).
//   Design: one warp per chain, back substitution down the columns of L:
//   step j reads row j of L with coalesced lane loads and updates a running
//   residual that the warp keeps in shared memory; no block-wide barrier.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCholThreads = 256;
constexpr int kTriWarps = 4;

__global__ void chol_solve_kernel(const float* __restrict__ m,
                                  const float* __restrict__ rhs,
                                  float* __restrict__ l, float* __restrict__ x,
                                  float* __restrict__ logdet, int r) {
  extern __shared__ float smem[];
  const int ld = r | 1;
  float* a = smem;          // [r][ld] the matrix, factored in place
  float* vec = a + r * ld;  // [r] rhs → y → x
  float* ild = vec + r;     // [r] 1/√dⱼ
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t mat = (size_t)blockIdx.x * r * r;
  const size_t row = (size_t)blockIdx.x * r;

  for (int t = tid; t < r * r; t += blockDim.x) a[(t / r) * ld + t % r] = m[mat + t];
  for (int t = tid; t < r; t += blockDim.x) vec[t] = rhs[row + t];
  __syncthreads();

  float acc = 0.0f;  // Σ log dⱼ, kept by thread 0 in pivot order
  for (int j = 0; j < r; ++j) {
    float d = a[j * ld + j];
    if (!(d > 0.0f)) d = __int_as_float(0x7fc00000);  // non-SPD pivot → NaN
    const float s = sqrtf(d);
    const float inv = 1.0f / s;
    for (int i = j + 1 + tid; i < r; i += blockDim.x) a[i * ld + j] *= inv;
    if (tid == 0) {
      acc += logf(d);
      ild[j] = inv;
    }
    __syncthreads();
    if (tid == 0) a[j * ld + j] = s;  // no thread reads the diagonal below
    // trailing lower triangle: A[i][k] -= L[i][j]·L[k][j] for j < k ≤ i
    for (int i = j + 1 + warp; i < r; i += nwarps) {
      const float lij = a[i * ld + j];
      for (int k = j + 1 + lane; k <= i; k += 32) a[i * ld + k] -= lij * a[k * ld + j];
    }
    __syncthreads();
  }

  if (warp == 0) {
    // L y = rhs: yⱼ = resⱼ/√dⱼ, then resᵢ -= Lᵢⱼ yⱼ below the diagonal
    for (int j = 0; j < r; ++j) {
      const float yj = vec[j] * ild[j];
      __syncwarp();
      for (int i = j + 1 + lane; i < r; i += 32) vec[i] -= a[i * ld + j] * yj;
      if (lane == 0) vec[j] = yj;
      __syncwarp();
    }
    // Lᵀ x = y: xⱼ = resⱼ/√dⱼ, then resᵢ -= Lⱼᵢ xⱼ above it (row j of L)
    for (int j = r - 1; j >= 0; --j) {
      const float xj = vec[j] * ild[j];
      __syncwarp();
      for (int i = lane; i < j; i += 32) vec[i] -= a[j * ld + i] * xj;
      if (lane == 0) vec[j] = xj;
      __syncwarp();
    }
  } else {
    // the other warps write L (zeros above the diagonal) meanwhile
    for (int t = tid - 32; t < r * r; t += blockDim.x - 32) {
      const int i = t / r, k = t % r;
      l[mat + t] = k <= i ? a[i * ld + k] : 0.0f;
    }
  }
  __syncthreads();
  for (int t = tid; t < r; t += blockDim.x) x[row + t] = vec[t];
  if (tid == 0) logdet[blockIdx.x] = acc;
}

__global__ void tri_solve_lt_kernel(const float* __restrict__ l,
                                    const float* __restrict__ z,
                                    float* __restrict__ x, int batch, int r) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  float* res = smem + warp * r;
  const float* lb = l + (size_t)b * r * r;
  for (int t = lane; t < r; t += 32) res[t] = z[(size_t)b * r + t];
  __syncwarp();
  for (int j = r - 1; j >= 0; --j) {
    const float* lrow = lb + (size_t)j * r;
    float d = lrow[j];
    d = isnan(d) ? d : fmaxf(d, 1e-30f);
    const float xj = res[j] / d;
    __syncwarp();
    for (int i = lane; i < j; i += 32) res[i] -= lrow[i] * xj;
    if (lane == 0) res[j] = xj;
    __syncwarp();
  }
  for (int t = lane; t < r; t += 32) x[(size_t)b * r + t] = res[t];
}

// the matrix at row stride r|1, plus the two vectors
int chol_smem_bytes(int r) { return (int)(((size_t)r * (r | 1) + 2 * (size_t)r) * sizeof(float)); }

}  // namespace

extern "C" {

int icp_chol_solve(const float* m, const float* rhs, float* l, float* x, float* logdet,
                   int batch, int r, void* stream) {
  if (batch == 0) return cudaSuccess;
  const int bytes = chol_smem_bytes(r);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  chol_solve_kernel<<<batch, kCholThreads, bytes, (cudaStream_t)stream>>>(
      m, rhs, l, x, logdet, r);
  return cudaGetLastError();
}

int icp_tri_solve_lt(const float* l, const float* z, float* x, int batch, int r,
                     void* stream) {
  if (batch == 0) return cudaSuccess;
  const int blocks = (batch + kTriWarps - 1) / kTriWarps;
  const size_t bytes = (size_t)kTriWarps * r * sizeof(float);
  tri_solve_lt_kernel<<<blocks, kTriWarps * 32, bytes, (cudaStream_t)stream>>>(
      l, z, x, batch, r);
  return cudaGetLastError();
}

const char* icp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
