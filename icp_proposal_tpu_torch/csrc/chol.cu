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
// dividing by max(Lⱼⱼ, 1e-30) (NaN stays NaN, as chol_pallas.py:317 does).
//   What bounds it: the r dependent steps xⱼ = resⱼ / Lⱼⱼ, each needing the
//   one before it; at 2,048 chains also the bytes of the lower triangle
//   (164 MB at r = 200, 0.05 ms at 3.35 TB/s).  The earlier design (column
//   panels staged in 54 KB of shared memory per two chains, each xⱼ a dot
//   product finished by five dependent shuffles) put a five-shuffle tree and
//   a synchronous panel load on that chain and held about one block per SM.
//   Design: the axpy ("column") form, one warp per chain and no shared
//   memory.  Lane l keeps the residual entries i ≡ l (mod 32) in registers
//   (⌈r/32⌉ of them: 7 at r = 200, at most KMAX).  At step j, from r − 1
//   down, the owner lane divides, one __shfl_sync broadcasts xⱼ and every
//   lane subtracts Lⱼᵢ·xⱼ from its entries i < j, with row j of L read as
//   coalesced lane loads of its entries i ≤ j only (the lower triangle, read
//   once).  Rows do not depend on x, so each row is loaded kRowsAhead steps
//   before its step into a ring of registers: the critical path per step is
//   one division, one shuffle and one multiply-subtract, not a device-memory
//   load and five shuffles.  The ring's slot of row j is j mod kRowsAhead, a
//   compile-time index: the steps run in groups of kRowsAhead that start at
//   j ≡ kRowsAhead − 1, and the loop over the 32-row blocks is unrolled so
//   the residual entry of the step is a compile-time index too.  The sums
//   run in another order than the twin's (as in K2): values agree to the
//   tolerance, not bitwise.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCholThreads = 256;
constexpr int kTriWarps = 4;
constexpr int kPanel = 32;  // K6 panel width
constexpr int kPanelStride = kPanel + 1;  // odd: column walks hit 32 banks
constexpr int kTriRowWarps = 2;  // K7: chains (warps) per block
constexpr int kRowsAhead = 4;    // K7: rows of L loaded ahead of their step; divides 32
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

// K7: row j of L, entries i = lane + 32k ≤ j for k ≤ kmax, into row[k]
// (zero elsewhere and for rows outside [0, r))
template <int KMAX>
__device__ __forceinline__ void load_lt_row(float (&row)[KMAX], const float* lb, int r,
                                            int j, int lane, int kmax) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int i = lane + 32 * k;
    if (k <= kmax) row[k] = (j >= 0 && j < r && i <= j) ? lb[(size_t)j * r + i] : 0.0f;
  }
}

// K7: one warp per chain, r ≤ 32·KMAX
template <int KMAX>
__global__ void __launch_bounds__(kTriRowWarps * 32)
    tri_solve_lt_rows_kernel(const float* __restrict__ l, const float* __restrict__ z,
                             float* __restrict__ x, int batch, int r) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kTriRowWarps + (threadIdx.x >> 5);
  if (b >= batch) return;  // whole warps leave; nothing synchronises the block
  const float* lb = l + (size_t)b * r * r;
  float res[KMAX];  // res[k]: entry lane + 32k, z minus the solved terms, then x
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int i = lane + 32 * k;
    res[k] = i < r ? z[(size_t)b * r + i] : 0.0f;
  }
  // ring[j % kRowsAhead] holds row j; the first group starts at jtop ≥ r − 1,
  // jtop ≡ kRowsAhead − 1, in the same 32-row block as r − 1
  const int jtop = (r - 1) | (kRowsAhead - 1);
  float ring[kRowsAhead][KMAX];
#pragma unroll
  for (int t = 0; t < kRowsAhead; ++t)
    load_lt_row<KMAX>(ring[kRowsAhead - 1 - t], lb, r, jtop - t, lane, KMAX - 1);
#pragma unroll
  for (int s = KMAX - 1; s >= 0; --s) {
    if (32 * s > jtop) continue;  // a block above the matrix (uniform)
    for (int jj = min(31, jtop - 32 * s); jj >= 0; jj -= kRowsAhead) {
#pragma unroll
      for (int t = 0; t < kRowsAhead; ++t) {
        const int slot = kRowsAhead - 1 - t;  // == j % kRowsAhead
        const int owner = jj - t;
        const int j = 32 * s + owner;
        if (j < r) {
          // on the owner lane ring[slot][s] is Lⱼⱼ and res[s] is resⱼ
          const float dj = ring[slot][s];
          const float d = isnan(dj) ? dj : fmaxf(dj, 1e-30f);
          const float xj = __shfl_sync(kFull, res[s] / d, owner);
#pragma unroll
          for (int k = 0; k < s; ++k) res[k] -= ring[slot][k] * xj;
          if (lane < owner) {
            res[s] -= ring[slot][s] * xj;
          } else if (lane == owner) {
            res[s] = xj;
          }
        }
        load_lt_row<KMAX>(ring[slot], lb, r, j - kRowsAhead, lane, s);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int i = lane + 32 * k;
    if (i < r) x[(size_t)b * r + i] = res[k];
  }
}

// the matrix at row stride r|1, plus the two vectors
int chol_smem_bytes(int r) { return (int)(((size_t)r * (r | 1) + 2 * (size_t)r) * sizeof(float)); }

// the panel, the row block of L, the two vectors
int chol_blocked_smem_bytes(int r) {
  return (int)(((size_t)r * kPanelStride + (size_t)kPanel * (r | 1) + 2 * (size_t)r) *
               sizeof(float));
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
  const int blocks = (batch + kTriRowWarps - 1) / kTriRowWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (r <= 128) {
    tri_solve_lt_rows_kernel<4><<<blocks, kTriRowWarps * 32, 0, st>>>(l, z, x, batch, r);
  } else if (r <= 256) {
    tri_solve_lt_rows_kernel<8><<<blocks, kTriRowWarps * 32, 0, st>>>(l, z, x, batch, r);
  } else if (r <= 512) {
    tri_solve_lt_rows_kernel<16><<<blocks, kTriRowWarps * 32, 0, st>>>(l, z, x, batch, r);
  } else {
    return cudaErrorInvalidValue;  // the wrapper refuses r > 512 first
  }
  return cudaGetLastError();
}

const char* icp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
