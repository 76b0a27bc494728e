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
// K6 icp_chol_solve_blocked replaces _chol_blocked_kernel /
// _chol_blocked_call in the same file, which the reference takes where
// _pick_bl(ceil8(r)) is None (every rank ≥ 105; the rank-200 face model).
// Same contract as K1.
//   What bounds it: as K1, the r dependent pivot steps.  K1 at r = 200 needs
//   161 KB of shared memory per block, so one chain per SM is in flight.
//   Design: one block per chain, left-looking over column panels of
//   kPanel = 32 columns, so a block holds one [r, 32] panel plus the
//   [32, k0] row block of L the panel's update reads (54 KB at r = 200,
//   four chains per SM).  Per panel: load M's columns, subtract
//   L[rows, :k0]·L[panel cols, :k0]ᵀ with L read back from device memory
//   (written by this block's earlier panels), factor the panel's columns
//   right-looking, run the forward substitution over them, write them out.
//   The back substitution walks rows of L in device memory, as K2 does.
//   The ragged last panel is narrower: no padding, which gives what the
//   reference's identity padding gives (padded pivots add log 1 = 0).
//
// K7 icp_tri_solve_lt_blocked replaces _tri_lt_blocked_kernel /
// _tri_lt_blocked_call in the same file (taken by the same rule): Lᵀx = z,
// dividing by max(Lⱼⱼ, 1e-30).
//   What bounds it: the r-step dependency chain, as K2.
//   Design: one warp per chain walks the column panels of L from the last
//   to the first: it stages the panel's rows ≥ k0 in shared memory with
//   coalesced row loads, then solves each column j as a dot product of
//   column j below the diagonal with the solved x, reduced by shuffles.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCholThreads = 256;
constexpr int kTriWarps = 4;
constexpr int kPanel = 32;  // K6/K7 panel width
constexpr int kPanelStride = kPanel + 1;  // odd: column walks hit 32 banks
constexpr int kTriBlockedWarps = 2;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan32() { return __int_as_float(0x7fc00000); }

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

// L is read back after this block wrote it, so it is not __restrict__ const:
// the loads must not take the read-only (non-coherent) path.
__global__ void chol_solve_blocked_kernel(const float* __restrict__ m,
                                          const float* __restrict__ rhs, float* l,
                                          float* __restrict__ x,
                                          float* __restrict__ logdet, int r) {
  extern __shared__ float smem[];
  const int rs = r | 1;
  float* panel = smem;                     // [r - k0][kPanelStride] rows k0.. of the panel
  float* rblk = panel + r * kPanelStride;  // [kPanel][rs] L[k0 + c][0..k0)
  float* vec = rblk + kPanel * rs;         // [r] rhs → y → x
  float* ild = vec + r;                    // [r] 1/√dⱼ
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nt = blockDim.x;
  const size_t mat = (size_t)blockIdx.x * r * r;
  const size_t row = (size_t)blockIdx.x * r;
  const float* mb = m + mat;
  float* lb = l + mat;

  for (int t = tid; t < r; t += nt) vec[t] = rhs[row + t];
  float acc = 0.0f;  // Σ log dⱼ, kept by thread 0 in pivot order
  for (int k0 = 0; k0 < r; k0 += kPanel) {
    const int w = min(kPanel, r - k0);
    const int h = r - k0;
    for (int t = tid; t < h * w; t += nt) {
      const int i = t / w, c = t % w;
      panel[i * kPanelStride + c] = mb[(size_t)(k0 + i) * r + k0 + c];
    }
    for (int t = tid; t < w * k0; t += nt) {
      const int c = t / k0, s = t % k0;
      rblk[c * rs + s] = lb[(size_t)(k0 + c) * r + s];
    }
    __syncthreads();
    // left-looking update of the panel's lower part: P[i][c] -= L[k0+i, :k0]·L[k0+c, :k0]
    if (k0 > 0) {
      for (int t = tid; t < h * w; t += nt) {
        const int i = t / w, c = t % w;
        if (i < c) continue;
        const float* li = lb + (size_t)(k0 + i) * r;
        const float* rc = rblk + c * rs;
        float sum = 0.0f;
        for (int s = 0; s < k0; ++s) sum += li[s] * rc[s];
        panel[i * kPanelStride + c] -= sum;
      }
      __syncthreads();
    }
    // factor the panel's columns, right-looking inside the panel
    for (int j = 0; j < w; ++j) {
      float d = panel[j * kPanelStride + j];
      if (!(d > 0.0f)) d = nan32();  // non-SPD pivot → NaN
      const float s = sqrtf(d);
      const float inv = 1.0f / s;
      for (int i = j + 1 + tid; i < h; i += nt) panel[i * kPanelStride + j] *= inv;
      if (tid == 0) {
        acc += logf(d);
        ild[k0 + j] = inv;
      }
      __syncthreads();
      if (tid == 0) panel[j * kPanelStride + j] = s;  // no thread reads it below
      const int wc = w - j - 1;
      for (int t = tid; t < (h - j - 1) * wc; t += nt) {
        const int i = j + 1 + t / wc, c = j + 1 + t % wc;
        if (i >= c)
          panel[i * kPanelStride + c] -= panel[i * kPanelStride + j] * panel[c * kPanelStride + j];
      }
      __syncthreads();
    }
    if (warp == 0) {
      // forward substitution over the panel's pivots: yⱼ = resⱼ/√dⱼ, then
      // resᵢ -= Lᵢⱼ yⱼ below the diagonal
      for (int j = 0; j < w; ++j) {
        const float yj = vec[k0 + j] * ild[k0 + j];
        __syncwarp();
        for (int i = j + 1 + lane; i < h; i += 32) vec[k0 + i] -= panel[i * kPanelStride + j] * yj;
        if (lane == 0) vec[k0 + j] = yj;
        __syncwarp();
      }
    }
    // the panel's columns of L, zeros above the diagonal
    for (int t = tid; t < r * w; t += nt) {
      const int i = t / w, c = t % w;
      lb[(size_t)i * r + k0 + c] = i >= k0 + c ? panel[(i - k0) * kPanelStride + c] : 0.0f;
    }
    __syncthreads();
  }
  if (warp == 0) {
    // Lᵀ x = y: xⱼ = resⱼ/√dⱼ, then resᵢ -= Lⱼᵢ xⱼ above it (row j of L)
    for (int j = r - 1; j >= 0; --j) {
      const float xj = vec[j] * ild[j];
      __syncwarp();
      const float* lrow = lb + (size_t)j * r;
      for (int i = lane; i < j; i += 32) vec[i] -= lrow[i] * xj;
      if (lane == 0) vec[j] = xj;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int t = tid; t < r; t += nt) x[row + t] = vec[t];
  if (tid == 0) logdet[blockIdx.x] = acc;
}

__global__ void tri_solve_lt_blocked_kernel(const float* __restrict__ l,
                                            const float* __restrict__ z,
                                            float* __restrict__ x, int batch, int r) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;  // whole warps leave; no block barrier follows
  float* panel = smem + (size_t)warp * r * (kPanelStride + 1);  // [r - k0][kPanelStride]
  float* xs = panel + r * kPanelStride;  // [r] x, zero until solved
  const float* lb = l + (size_t)b * r * r;
  const float* zb = z + (size_t)b * r;
  for (int t = lane; t < r; t += 32) xs[t] = 0.0f;
  for (int k0 = ((r - 1) / kPanel) * kPanel; k0 >= 0; k0 -= kPanel) {
    const int w = min(kPanel, r - k0);
    const int h = r - k0;
    __syncwarp();
    for (int t = lane; t < h * w; t += 32) {
      const int i = t / w, c = t % w;
      panel[i * kPanelStride + c] = lb[(size_t)(k0 + i) * r + k0 + c];
    }
    __syncwarp();
    for (int j = w - 1; j >= 0; --j) {
      float s = 0.0f;
      for (int i = j + 1 + lane; i < h; i += 32) s += panel[i * kPanelStride + j] * xs[k0 + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      float d = panel[j * kPanelStride + j];
      d = isnan(d) ? d : fmaxf(d, 1e-30f);
      const float xj = (zb[k0 + j] - s) / d;
      if (lane == 0) xs[k0 + j] = xj;
      __syncwarp();
    }
  }
  __syncwarp();
  for (int t = lane; t < r; t += 32) x[(size_t)b * r + t] = xs[t];
}

// the matrix at row stride r|1, plus the two vectors
int chol_smem_bytes(int r) { return (int)(((size_t)r * (r | 1) + 2 * (size_t)r) * sizeof(float)); }

// the panel, the row block of L, the two vectors
int chol_blocked_smem_bytes(int r) {
  return (int)(((size_t)r * kPanelStride + (size_t)kPanel * (r | 1) + 2 * (size_t)r) *
               sizeof(float));
}

// per warp: the panel and x
int tri_blocked_smem_bytes(int r) {
  return (int)((size_t)kTriBlockedWarps * r * (kPanelStride + 1) * sizeof(float));
}

cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

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

int icp_chol_solve_blocked(const float* m, const float* rhs, float* l, float* x,
                           float* logdet, int batch, int r, void* stream) {
  if (batch == 0) return cudaSuccess;
  const int bytes = chol_blocked_smem_bytes(r);
  cudaError_t e = allow_smem((const void*)chol_solve_blocked_kernel, bytes);
  if (e != cudaSuccess) return e;
  chol_solve_blocked_kernel<<<batch, kCholThreads, bytes, (cudaStream_t)stream>>>(
      m, rhs, l, x, logdet, r);
  return cudaGetLastError();
}

int icp_tri_solve_lt_blocked(const float* l, const float* z, float* x, int batch, int r,
                             void* stream) {
  if (batch == 0) return cudaSuccess;
  const int bytes = tri_blocked_smem_bytes(r);
  cudaError_t e = allow_smem((const void*)tri_solve_lt_blocked_kernel, bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (batch + kTriBlockedWarps - 1) / kTriBlockedWarps;
  tri_solve_lt_blocked_kernel<<<blocks, kTriBlockedWarps * 32, bytes,
                                (cudaStream_t)stream>>>(l, z, x, batch, r);
  return cudaGetLastError();
}

const char* icp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
