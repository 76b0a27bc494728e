// The ICP target direction's posterior system, assembled in one kernel.
//
// icp_target_assembly replaces no Pallas kernel: the JAX package leaves this
// assembly to XLA (icp_proposal_tpu/models/gpmm.py,
// posterior_factors_anisotropic: Q gathered at the observation ids into an
// [m, 3, r] array, the precision applied, then qᵀ·pq and pqᵀ·ỹ).  Per chain
// b, over the m observations i with ids idᵢ, unit normals nᵢ (the candidate
// mesh's at idᵢ), weights wᵢ (0 on a model-boundary id when the component is
// boundary-aware, else 1), a = 1/σₙ² and c = 1/σₜ²:
//
//   M   = I + Σᵢ wᵢ · Q_{idᵢ}ᵀ (c·I + (a−c)·nᵢnᵢᵀ) Q_{idᵢ}      (lower triangle)
//   rhs =     Σᵢ wᵢ · Q_{idᵢ}ᵀ (c·I + (a−c)·nᵢnᵢᵀ) ỹᵢ,   ỹᵢ = (tᵢ − ref_{idᵢ}) − μ_{idᵢ}
//
// with tᵢ the pose-inverted target point.  Only M's lower triangle is
// written: the factor (csrc/chol.cu) reads nothing else.
//
// What bounds it: FP32 operations.  A chain is a gathered SYRK, [r × 3m] ·
// [3m × r]: B·3m·r(r+1)/2 multiply-adds, 11.9 ms at r = 401, m = 802,
// B = 2,048 and 0.38 ms at r = 101, m = 202, B = 4,096 at 67 TFLOP/s,
// against 0.22 and 0.03 ms for its bytes (the basis once, the inputs, M's
// lower triangle and rhs out) at 3.35 TB/s.  TF32 and any tensor-core split
// are out: the results must be float32's.  The torch path built two
// [B, m, 3, r] tensors (7.9 GB each at r = 401) only to contract them.
//
// Design: register-blocked FFMA over M's lower triangle, the operands
// staged from the L2-resident basis and never written to device memory.
//   * The right-hand side is row r of an (r + 1) × r product: the row
//     operand is [Q | ỹ], the column operand w·PQ.  Rows and columns are cut
//     into micro tiles of 8; a thread owns one 8 × 8 micro tile and keeps it
//     in registers over the whole depth, summed in observation order: no
//     split of the depth, no atomics, the same bits on every launch.
//   * Rows are cut into bands of kEdge = 16 micro rows (128), columns the
//     same.  A block owns one tile of a chain: an off-diagonal tile (band I's
//     rows, band J's columns, J < I, 256 micro tiles, a warp 4 × 8 of them)
//     or a diagonal one (band I's rows and columns, the micro tiles on or
//     below the diagonal).  A thin last band (at most kMergeMax micro rows:
//     the rows 384–401 at r = 401) has no blocks of its own: its rows join
//     every diagonal block, whose columns they span, so those blocks run 6
//     warps where they would run 5, and no block runs 1 or 2 (at r = 401 a
//     chain takes 6 blocks, 8, 8, 8, 6, 6 and 6 warps).  Threads take the
//     micro tiles in row-major order; the block has as many threads as its
//     chain's fullest tile.  Band edge, merge and threads follow from r; the
//     observations a stage (8, or 4 where shared memory would otherwise cost
//     blocks an SM) from the occupancy at r and m (plan).
//   * A stage is kObs observations, 3·kObs rows of depth.  Their rows of
//     the padded basis ([V, 3, rp], rp = 4⌈r/4⌉) at the block's rows and
//     columns go by 16-byte cp.async, gathered by id (a diagonal block
//     copies its rows alone: its columns are a prefix of them), with each
//     observation's reference point, weight, mean, normal (gathered by id)
//     and target point, into a ring of three stages.  One block barrier a
//     stage: past it every thread issues stage s + 2, turns stage s + 1's
//     column operand into w·(c·Q + (a−c)·n(nᵀQ)) and writes its ỹ into row
//     r's slot of the row operand, then runs stage s, 64 FFMA a row of depth
//     from four 16-byte shared loads.  A micro tile's 8 floats are read as
//     two float4 swapped when (i >> 2) & 1 is set, so 8 neighbouring micro
//     tiles cover all 32 banks; the registers' swap is undone when the tile
//     is written.
// The sums run in another order than the plain twin's: values agree to
// float32's tolerance, not bitwise.
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMicro = 8;        // a thread's outputs: 8 rows × 8 columns
constexpr int kEdge = 16;        // micro rows of a band, micro columns of a tile
constexpr int kMergeMax = 6;     // a last band this thin joins the diagonal blocks
constexpr int kNarrow = 13;      // micro rows a block's staged rows hold at least (r ≤ 103)
constexpr int kAhead = 24;       // rows of depth staged ahead of the stage in use
constexpr int kMeta = 16;        // floats a staged observation: ref, w, mean, 0, n, t, 2 unused
constexpr int kMaxThreads = kEdge * kEdge;
constexpr int kMinBlocks = 2;    // blocks an SM at 256 threads: ≤ 128 registers
constexpr int kMaxSmem = 227 * 1024;

struct AsmParams {
  const float* q;        // [V, 3, rp] the scaled basis, rows padded with zeros
  const float* vtab;     // [V, 8]: ref (3), w, mean (3), 0
  const int* ids;        // [B, m]
  const float* tpts;     // [B, m, 3] pose-inverted target points
  const float* normals;  // [B, V, 3] the candidate's vertex normals
  float* mat;            // [B, r, r] M, lower triangle
  float* rhs;            // [B, r]
  int m, r, rp, v;
  int nr, nc;            // micro rows (r + 1 rows: rhs is row r) and columns
  int bands, merge, tiles;  // bands of kEdge micro rows (the last may be thinner)
  float c, amc;          // 1/σₜ², 1/σₙ² − 1/σₜ²
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The block tiles of a chain: rows band I = 0 … tm − 1 holds tiles J = 0 … I
// (J = I the diagonal one), row-major; tm leaves out a merged last band.
struct Tile {
  int rows, cols;  // micro rows and columns
  int r0, ra;      // the first ra micro rows from r0, the rest from the last band's start
  int c0;          // an off-diagonal tile's first micro column
  bool diag;
};

__host__ __device__ __forceinline__ Tile tile_of(int t, int nr, int nc, int bands, int merge) {
  int I = 0;
  while (t > I) {
    t -= I + 1;
    ++I;
  }
  Tile tl;
  tl.diag = t == I;
  tl.r0 = kEdge * I;
  tl.ra = nr - tl.r0 < kEdge ? nr - tl.r0 : kEdge;
  const int last0 = kEdge * (bands - 1);
  const bool joined = merge && tl.diag;
  tl.rows = tl.ra + (joined ? nr - last0 : 0);
  tl.c0 = kEdge * t;
  if (tl.diag) {
    tl.cols = nc - tl.r0 < kEdge ? nc - tl.r0 : kEdge;
    if (joined && I == bands - 2) tl.cols += nc - last0;  // the last band's own diagonal
  } else {
    tl.cols = kEdge;
  }
  return tl;
}

// micro tiles a thread can take in tile tl: on or below the diagonal
__host__ __device__ __forceinline__ int tile_count(const Tile& tl) {
  if (!tl.diag) return tl.rows * tl.cols;
  int n = 0;
  for (int i = 0; i < tl.rows; ++i) n += i + 1 < tl.cols ? i + 1 : tl.cols;
  return n;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int w = 1;
  while (w < n) w <<= 1;
  return w;
}

// stages in the cp.async ring: the one in use, the one being converted and
// kAhead rows of depth in flight
__host__ __device__ constexpr int stages_of(int obs) { return 2 + kAhead / (3 * obs); }

template <int kObs, int kLd>
__host__ __device__ __forceinline__ size_t assembly_smem_bytes(int m) {
  constexpr int kStages = stages_of(kObs);
  const int mpad = (m + kObs - 1) / kObs * kObs;
  return (size_t)kStages * (2 * 3 * kObs * kLd + kObs * kMeta) * sizeof(float) +
         (size_t)mpad * sizeof(int);
}

template <int kObs, int kLd>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    target_assembly_kernel(AsmParams p) {
  extern __shared__ float4 smem4[];
  constexpr int kRows = 3 * kObs;                         // rows of depth a stage
  constexpr int kStages = stages_of(kObs);
  constexpr int kStage = 2 * kRows * kLd + kObs * kMeta;  // floats a stage
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][row op, column op, meta]
  const int nslab = (p.m + kObs - 1) / kObs;
  int* id_s = reinterpret_cast<int*>(ring + kStages * kStage);  // [nslab · kObs]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.x / p.tiles;
  const Tile tl = tile_of(blockIdx.x - b * p.tiles, p.nr, p.nc, p.bands, p.merge);
  const int last0 = kEdge * (p.bands - 1);
  auto row_of = [&](int li) { return li < tl.ra ? tl.r0 + li : last0 + li - tl.ra; };
  auto col_of = [&](int lj) { return tl.diag ? row_of(lj) : tl.c0 + lj; };

  // this thread's micro tile (i, j) of the tile: a full off-diagonal tile
  // in warps of 4 × 8, otherwise the tiles on or below the diagonal in
  // row-major order
  int i = -1, j = 0;
  if (!tl.diag && tl.rows == kEdge) {
    const int w = tid >> 5, l = tid & 31;
    i = (w >> 1) * 4 + (l >> 3);
    j = (w & 1) * 8 + (l & 7);
  } else {
    for (int ii = 0, rest = tid; ii < tl.rows; ++ii) {
      const int n = tl.diag ? min(ii + 1, tl.cols) : tl.cols;
      if (rest < n) {
        i = ii;
        j = rest;
        break;
      }
      rest -= n;
    }
  }
  const bool active = i >= 0;

  for (int o = tid; o < nslab * kObs; o += nthr)
    id_s[o] = o < p.m ? p.ids[(size_t)b * p.m + o] : 0;
  __syncthreads();

  // the copies a thread issues: a staged row is 2·rows (2·cols) 16-byte
  // chunks; lanes take chunk tid % wr of rows tid / wr, tid / wr + nthr / wr, …
  const int wr = pow2_at_least(2 * tl.rows), wc = pow2_at_least(2 * tl.cols);
  const int cr = tid & (wr - 1), cc = tid & (wc - 1);
  const int gr = kMicro * row_of(cr >> 1) + 4 * (cr & 1);  // the basis column of my row chunk
  const int gc = kMicro * col_of(cc >> 1) + 4 * (cc & 1);
  const bool row_chunk = cr < 2 * tl.rows && tid < nthr / wr * wr;
  const bool col_chunk = !tl.diag && cc < 2 * tl.cols && tid < nthr / wc * wc;
  const float* bs = p.normals + (size_t)b * p.v * 3;
  const float* ts = p.tpts + (size_t)b * p.m * 3;

  auto fetch = [&](int s) {
    if (s < nslab) {
      float* st = ring + (s % kStages) * kStage;
      const int obs0 = s * kObs;
      if (row_chunk)
        for (int k = tid / wr; k < kRows; k += nthr / wr) {
          const int o = obs0 + k / 3;
          const bool valid = o < p.m && gr < p.rp;
          cp_async16(st + k * kLd + 4 * cr,
                     p.q + ((size_t)id_s[o] * 3 + k % 3) * p.rp + (valid ? gr : 0), valid);
        }
      if (col_chunk)
        for (int k = tid / wc; k < kRows; k += nthr / wc) {
          const int o = obs0 + k / 3;
          const bool valid = o < p.m && gc < p.rp;
          cp_async16(st + (kRows + k) * kLd + 4 * cc,
                     p.q + ((size_t)id_s[o] * 3 + k % 3) * p.rp + (valid ? gc : 0), valid);
        }
      float* meta = st + 2 * kRows * kLd;
      for (int e = tid; e < kObs * 8; e += nthr) {
        const int o = obs0 + (e >> 3), f = e & 7;
        const bool valid = o < p.m;
        const int id = id_s[o];
        float* dst = meta + (e >> 3) * kMeta;
        if (f < 2)  // ref and w, mean and 0
          cp_async16(dst + 4 * f, p.vtab + (size_t)id * 8 + 4 * f, valid);
        else if (f < 5)  // the normal
          cp_async4(dst + 8 + f - 2, bs + (size_t)id * 3 + f - 2, valid);
        else  // the target point
          cp_async4(dst + 11 + f - 5, ts + (size_t)(valid ? o : 0) * 3 + f - 5, valid);
      }
    }
    cp_async_commit();  // an empty group past the last stage keeps the count
  };

  // stage s's column operand: Q → w·P·Q (a diagonal tile reads Q from its
  // rows); row r's slot of the row operand: ỹ
  const int rq = [&] {  // the right-hand side's float column in the row operand, or -1
    const int mr = p.r / kMicro;
    int li = -1;
    if (mr >= tl.r0 && mr < tl.r0 + tl.ra) li = mr - tl.r0;
    else if (tl.rows > tl.ra && mr >= last0) li = tl.ra + mr - last0;
    return li < 0 ? -1 : kMicro * li + (p.r & (kMicro - 1));
  }();
  auto convert = [&](int s) {
    float* st = ring + (s % kStages) * kStage;
    float* cb = st + kRows * kLd;
    const float* qs = tl.diag ? st : cb;
    const float* meta = st + 2 * kRows * kLd;
    for (int e = tid; e < kObs * wc; e += nthr) {
      const int o = e / wc, c4 = e & (wc - 1);
      if (c4 >= 2 * tl.cols) continue;
      const float* mo = meta + o * kMeta;
      const float nx = mo[8], ny = mo[9], nz = mo[10], w = mo[3];
      const float* src = qs + 3 * o * kLd + 4 * c4;
      const float4 q0 = ld4(src), q1 = ld4(src + kLd), q2 = ld4(src + 2 * kLd);
      const float k0 = p.amc * nx, k1 = p.amc * ny, k2 = p.amc * nz;
      const float g[4] = {nx * q0.x + ny * q1.x + nz * q2.x, nx * q0.y + ny * q1.y + nz * q2.y,
                          nx * q0.z + ny * q1.z + nz * q2.z, nx * q0.w + ny * q1.w + nz * q2.w};
      float* dst = cb + 3 * o * kLd + 4 * c4;
      st4(dst, make_float4((p.c * q0.x + k0 * g[0]) * w, (p.c * q0.y + k0 * g[1]) * w,
                           (p.c * q0.z + k0 * g[2]) * w, (p.c * q0.w + k0 * g[3]) * w));
      st4(dst + kLd, make_float4((p.c * q1.x + k1 * g[0]) * w, (p.c * q1.y + k1 * g[1]) * w,
                                 (p.c * q1.z + k1 * g[2]) * w, (p.c * q1.w + k1 * g[3]) * w));
      st4(dst + 2 * kLd,
          make_float4((p.c * q2.x + k2 * g[0]) * w, (p.c * q2.y + k2 * g[1]) * w,
                      (p.c * q2.z + k2 * g[2]) * w, (p.c * q2.w + k2 * g[3]) * w));
      if (c4 == rq >> 2) {  // a diagonal tile's rows feed its columns: after this read
        float* yr = st + 3 * o * kLd + rq;
        yr[0] = (mo[11] - mo[0]) - mo[4];
        yr[kLd] = (mo[12] - mo[1]) - mo[5];
        yr[2 * kLd] = (mo[13] - mo[2]) - mo[6];
      }
    }
    if (rq >= 0 && rq >> 2 >= 2 * tl.cols)  // row r lies past the columns' chunks
      for (int o = tid; o < kObs; o += nthr) {
        const float* mo = meta + o * kMeta;
        float* yr = st + 3 * o * kLd + rq;
        yr[0] = (mo[11] - mo[0]) - mo[4];
        yr[kLd] = (mo[12] - mo[1]) - mo[5];
        yr[2 * kLd] = (mo[13] - mo[2]) - mo[6];
      }
  };

  float acc[kMicro][kMicro];
#pragma unroll
  for (int x = 0; x < kMicro; ++x)
#pragma unroll
    for (int y = 0; y < kMicro; ++y) acc[x][y] = 0.f;
  const int hi = (i >> 2) & 1, hj = (j >> 2) & 1;  // the float4 swap of the micro tile
  const int a_off = active ? kMicro * i + 4 * hi : 0, a_alt = active ? kMicro * i + 4 - 4 * hi : 0;
  const int b_off = kMicro * j + 4 * hj, b_alt = kMicro * j + 4 - 4 * hj;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  cp_async_wait<kStages - 2>();
  __syncthreads();
  convert(0);
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<kStages - 3>();
    // stage s is converted and stage s + 1 has landed, for every thread;
    // every thread is done with stage s − 1's slot, which stage s + kStages − 1 takes
    __syncthreads();
    fetch(s + kStages - 1);
    if (s + 1 < nslab) convert(s + 1);
    if (active) {
      const float* rb = ring + (s % kStages) * kStage;
      const float* cb = rb + kRows * kLd;
      const float* pa = rb + a_off;
      const float* pa2 = rb + a_alt;
      const float* pb = cb + b_off;
      const float* pb2 = cb + b_alt;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float4 x0 = ld4(pa + k * kLd), x1 = ld4(pa2 + k * kLd);
        const float4 y0 = ld4(pb + k * kLd), y1 = ld4(pb2 + k * kLd);
        const float av[kMicro] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float bv[kMicro] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
        // a column at a time, its rows walked back and forth, so each FFMA
        // shares an operand with the one before: 5 % less time at r = 401
        // than row by row
#pragma unroll
        for (int y = 0; y < kMicro; ++y)
#pragma unroll
          for (int xx = 0; xx < kMicro; ++xx) {
            const int x = y & 1 ? kMicro - 1 - xx : xx;
            acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
          }
      }
    }
  }
  cp_async_wait<0>();

  if (!active) return;
  float* mb = p.mat + (size_t)b * p.r * p.r;
  const int gi = kMicro * row_of(i), gj = kMicro * col_of(j);
#pragma unroll
  for (int x = 0; x < kMicro; ++x) {
    const int row = gi + (x ^ (4 * hi));
#pragma unroll
    for (int y = 0; y < kMicro; ++y) {
      const int col = gj + (y ^ (4 * hj));
      if (col > row || col >= p.r) continue;
      if (row < p.r)
        mb[(size_t)row * p.r + col] = acc[x][y] + (row == col ? 1.f : 0.f);
      else if (row == p.r)
        p.rhs[(size_t)b * p.r + col] = acc[x][y];
    }
  }
}

// The launch at rank r, m observations: bands, merge, tiles a chain,
// threads a block (the fullest tile's micro tiles, in whole warps), the
// staged rows' width, observations a stage and dynamic shared memory.
struct AsmPlan {
  int nr, nc, bands, merge, tiles, threads, ld, obs;
  size_t smem;
};

AsmPlan geometry(int r) {
  AsmPlan pl{};
  pl.nr = (r + kMicro) / kMicro;  // ⌈(r + 1) / 8⌉
  pl.nc = (r + kMicro - 1) / kMicro;
  pl.bands = (pl.nr + kEdge - 1) / kEdge;
  const int thin = pl.nr - kEdge * (pl.bands - 1);
  pl.merge = pl.bands > 1 && thin <= kMergeMax;
  const int tm = pl.bands - pl.merge;
  pl.tiles = tm * (tm + 1) / 2;
  int most = 0, widest = 0;
  for (int t = 0; t < pl.tiles; ++t) {
    const Tile tl = tile_of(t, pl.nr, pl.nc, pl.bands, pl.merge);
    const int n = tile_count(tl);
    most = n > most ? n : most;
    widest = tl.rows > widest ? tl.rows : widest;
  }
  pl.threads = (most + 31) / 32 * 32;
  pl.ld = kMicro * (widest > kEdge ? kEdge + kMergeMax : widest > kNarrow ? kEdge : kNarrow);
  return pl;
}

cudaError_t allow_smem(const void* kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// blocks an SM of the instance <kObs, kLd> at `threads` threads, with the
// shared memory m observations take (`with_smem`) or none
template <int kObs, int kLd>
cudaError_t occupancy(int threads, int m, bool with_smem, int* blocks) {
  static std::atomic<unsigned> done{0};
  const void* kernel = (const void*)target_assembly_kernel<kObs, kLd>;
  *blocks = 0;
  const size_t smem = with_smem ? assembly_smem_bytes<kObs, kLd>(m) : 0;
  if (smem > (size_t)kMaxSmem) return cudaSuccess;
  cudaError_t e = allow_smem(kernel, done);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

template <int kLd>
cudaError_t plan_obs(AsmPlan& pl, int m, int* blocks) {
  int free_smem = 0, with8 = 0, with4 = 0;
  cudaError_t e = occupancy<8, kLd>(pl.threads, m, false, &free_smem);
  if (e == cudaSuccess) e = occupancy<8, kLd>(pl.threads, m, true, &with8);
  if (e == cudaSuccess) e = occupancy<4, kLd>(pl.threads, m, true, &with4);
  if (e != cudaSuccess) return e;
  if (with8 < 1 && with4 < 1) return cudaErrorInvalidValue;  // m too large for a block
  pl.obs = with8 >= free_smem || with8 >= with4 ? 8 : 4;
  *blocks = pl.obs == 8 ? with8 : with4;
  pl.smem = pl.obs == 8 ? assembly_smem_bytes<8, kLd>(m) : assembly_smem_bytes<4, kLd>(m);
  return cudaSuccess;
}

// 8 observations a stage unless their ring costs the block's occupancy,
// then 4; an error where even 4 do not fit
cudaError_t plan(int r, int m, AsmPlan* out, int* blocks) {
  if (r < 1 || m < 1) return cudaErrorInvalidValue;
  AsmPlan pl = geometry(r);
  cudaError_t e = pl.ld == kMicro * kNarrow ? plan_obs<kMicro * kNarrow>(pl, m, blocks)
                  : pl.ld == kMicro * kEdge  ? plan_obs<kMicro * kEdge>(pl, m, blocks)
                                             : plan_obs<kMicro * (kEdge + kMergeMax)>(pl, m, blocks);
  if (e != cudaSuccess) return e;
  *out = pl;
  return cudaSuccess;
}

template <int kObs, int kLd>
void launch_instance(const AsmPlan& pl, int batch, const AsmParams& p, cudaStream_t st) {
  target_assembly_kernel<kObs, kLd>
      <<<(unsigned)((size_t)batch * pl.tiles), pl.threads, pl.smem, st>>>(p);
}

}  // namespace

extern "C" {

// M's lower triangle [B, r, r] (I + the weighted Gram of the precision-
// scaled rows) and rhs [B, r]; ids must lie in [0, v)
int icp_target_assembly(const float* q, const float* vtab, const int* ids, const float* tpts,
                        const float* normals, float* mat, float* rhs, int batch, int m, int r,
                        int rp, int v, float c, float amc, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (rp != (r + 3) / 4 * 4) return cudaErrorInvalidValue;  // the wrapper refuses it first
  AsmPlan pl;
  int blocks = 0;
  cudaError_t e = plan(r, m, &pl, &blocks);
  if (e != cudaSuccess) return e;
  const AsmParams p{q, vtab, ids, tpts, normals, mat, rhs, m, r, rp, v,
                    pl.nr, pl.nc, pl.bands, pl.merge, pl.tiles, c, amc};
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int kLd0 = kMicro * kNarrow, kLd1 = kMicro * kEdge, kLd2 = kMicro * (kEdge + kMergeMax);
  if (pl.ld == kLd0)
    pl.obs == 8 ? launch_instance<8, kLd0>(pl, batch, p, st)
                : launch_instance<4, kLd0>(pl, batch, p, st);
  else if (pl.ld == kLd1)
    pl.obs == 8 ? launch_instance<8, kLd1>(pl, batch, p, st)
                : launch_instance<4, kLd1>(pl, batch, p, st);
  else
    pl.obs == 8 ? launch_instance<8, kLd2>(pl, batch, p, st)
                : launch_instance<4, kLd2>(pl, batch, p, st);
  return cudaGetLastError();
}

// the launch at rank r with m observations: out[0..5] = bands, tiles a
// chain, threads a block, observations a stage, dynamic shared bytes,
// blocks an SM
int icp_target_assembly_config(int r, int m, int* out) {
  AsmPlan pl;
  int blocks = 0;
  cudaError_t e = plan(r, m, &pl, &blocks);
  if (e != cudaSuccess) return e;
  out[0] = pl.bands;
  out[1] = pl.tiles;
  out[2] = pl.threads;
  out[3] = pl.obs;
  out[4] = (int)pl.smem;
  out[5] = blocks;
  return cudaSuccess;
}

}  // extern "C"
