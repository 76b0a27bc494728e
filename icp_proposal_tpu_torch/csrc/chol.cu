// K1, K2, K6 and K7 of the port: the per-chain r×r GP-posterior factor and solves.
//
// K1 icp_chol_solve replaces _chol_kernel / _chol_call in
// icp_proposal_tpu/ops/chol_pallas.py (reached through chol_solve), the
// reference's kernel for r ≤ 104.  K6 icp_chol_solve_blocked replaces
// _chol_blocked_kernel / _chol_blocked_call in the same file, which the
// reference takes where _pick_bl(ceil8(r)) is None (every rank ≥ 105; the
// rank-200 face model).  One contract: per chain, lower L with M = L Lᵀ
// (zeros above the diagonal), x = M⁻¹·rhs and log det M = Σⱼ log dⱼ; a pivot
// dⱼ ≤ 0 gives NaN from that column on, as chol_pallas.py:103 does, and the
// MH step rejects the NaN.  Only M's lower triangle is read.
//   What bounds them here: latency, not bytes.  A factor is r dependent pivot
//   steps (2.7 MFLOP at r = 200); at 2,048 chains the bytes (the lower
//   triangle of M in, L out) take 0.15 ms at 3.35 TB/s.  The earlier kernels
//   spent two block barriers on every pivot (400 at r = 200), and K6 read L
//   back from device memory for its left-looking update and solved in one
//   warp from device memory.
//   Design: one template, chol_solve_tiled_kernel<kWarps>, one block per
//   chain; K1 launches it with 4 warps, K6 with 8.  r is padded to
//   rp = 16⌈r/16⌉ with identity rows and columns, as the reference's blocked
//   kernel pads (chol_pallas.py:164-166): padded pivots factor to 1 and add
//   log 1 = 0.  The lower triangle lives in shared memory as packed 16×16
//   tiles, tile (I, J), I ≥ J, at (I(I+1)/2 + J)·256 floats (93 KB at
//   r = 200, two chains per SM; 215 KB at kMaxRank = 320).  Inside a tile a
//   row is 16 floats whose four 16-byte chunks are permuted by (i >> 1) & 3
//   (swz), so a chunk read by 8 rows and a column walk spread over the banks.
//   Right-looking by panels K = 0…nt−1 with two block barriers a panel:
//     (a) every warp with work in the panel loads tile (K, K) into registers
//         (lane: row lane & 15, columns 8·(lane >> 4)…+7) and factors it with
//         shuffles, 16 pivot steps and no block barrier; 1/√dⱼ is rsqrtf, and
//         log dⱼ is taken after the tile, off the pivot chain;
//     (b) each of those warps writes its Lᵀ_KK (1/√dⱼ on the diagonal) to
//         its own 1 KB scratch and solves X·L_KKᵀ = A_IK for two tiles below
//         at a time, a lane a row, reading Lᵀ_KK as broadcasts;
//     barrier;
//     (c) trailing update A_IJ −= L_IK·L_JKᵀ, K < J ≤ I, a tile per warp at a
//         time: each warp takes a contiguous run of the tiles in row-major
//         order and keeps its row's L_IK in registers, and a lane
//         accumulates 8 outputs (rows i, i + 8; columns c, c + 4, c + 8,
//         c + 12) over k = 0…15 from 16-byte shared loads with explicit
//         fmaf; warp 0 writes (K, K) back;
//     barrier.
//   Then warp 0 runs L y = rhs and Lᵀ x = y from the shared tiles in K7's
//   register axpy form (lane l keeps the residual entries i ≡ l mod 32; a
//   step is one product by 1/√dⱼ, one shuffle, one fmaf a lane, with the
//   next step's column or row of L loaded a step ahead), while the other
//   warps stream L out, coalesced, with zeros above the diagonal and the
//   padding dropped, and warp 1 then sums log det in pivot order.  Lanes
//   of a warp differ by selects, not branches, in the pivot steps and the
//   substitutions: per-lane branches there cost more than the arithmetic.
//   Sums run in another order than the twin's: values agree to the
//   tolerance, not bitwise.
//
// K2 replaces _tri_lt_kernel / _tri_lt_call in the same file (reached
// through tri_solve_lt, r ≤ 104), and K7 replaces _tri_lt_blocked_kernel /
// _tri_lt_blocked_call (taken by the same rule, r ≥ 105): Lᵀx = z, dividing
// by max(Lⱼⱼ, 1e-30) (NaN stays NaN, as chol_pallas.py:317 and :342 do).
// Both launch one kernel, tri_solve_lt_rows_kernel<KMAX>, through one entry
// point, icp_tri_solve_lt_rows; the Python wrappers keep their own launch
// counts.
//   What bounds it: the r dependent steps xⱼ = resⱼ / Lⱼⱼ, each needing the
//   one before it; at 2,048 chains also the bytes of the lower triangle
//   (164 MB at r = 200, 0.05 ms at 3.35 TB/s; 42 MB at r = 101).  No
//   device-memory load may sit on that chain of steps.
//   Design: the axpy ("column") form, one warp per chain and no shared
//   memory.  Lane l keeps the residual entries i ≡ l (mod 32) in registers
//   (⌈r/32⌉ of them: 4 at r = 101, 7 at r = 200, at most KMAX = 4, 8 or 16
//   for r ≤ 128, 256, 512).  At step j, from r − 1 down, the owner lane
//   divides, one __shfl_sync broadcasts xⱼ and every lane subtracts Lⱼᵢ·xⱼ
//   from its entries i < j, with row j of L read as coalesced lane loads of
//   its entries i ≤ j only (the lower triangle, read once).  Rows do not
//   depend on x, so each row is loaded kRowsAhead steps before its step
//   into a ring of registers: the critical path per step is one division,
//   one shuffle and one multiply-subtract, not a device-memory load.  The
//   ring's slot of row j is j mod kRowsAhead, a compile-time index: the
//   steps run in groups of kRowsAhead that start at j ≡ kRowsAhead − 1, and
//   the loop over the 32-row blocks is unrolled so the residual entry of
//   the step is a compile-time index too.  The sums run in another order
//   than the twin's: values agree to the tolerance, not bitwise.
//
// K6 and K7 past the tiled and row kernels' ranks (r > 320 and r > 512;
// the reference serves every rank, its blocked kernels to 1,224 and XLA's
// cholesky and solve_triangular above).  Same contracts as above.
//   What bounds them: M and L no longer fit a block, so they stay in device
//   memory.  The streamed factor's own bound is its r³/3 FP32 flops (0.66 ms
//   at r = 401 on 2,048 chains, 2.20 ms at r = 600); left-looking, it reads
//   the finished columns L[i, :j0] again for every panel of b columns,
//   r³/(6b) floats a chain, which at 2,048 chains spill far past the 50 MB
//   L2.  With b = 64 its schedule moves 6.5 GB at r = 401 and 17.5 GB at
//   r = 600 (1.94 and 5.23 ms at 3.35 TB/s if nothing hit L2: M in, L and
//   y out, the workspace written and read again for each tile's rows and
//   the panel's, and the back substitution's read of L).  Measured (H100
//   80GB HBM3, 700 W): 5.5 ms at r = 401, 12.5 ms at r = 600, 0.12 and 0.18
//   of the flop bound.  Taking each phase out in turn gave back ≈ 1.9 ms
//   (the update), 1.3 (the 64×64 factor, a chain of dependent steps, where
//   the registers spill), 0.7 (the back substitution), 0.55 (the rows below
//   solved against the block) at r = 401: a chain's phases are
//   latency-bound, and four chains an SM do not hide them.  The solve reads
//   L's lower triangle once: the bytes bound it.
//   Design of K6 streamed, chol_solve_streamed_kernel: one block of
//   kStreamWarps = 4 warps per chain and kStreamCtas = 4 chains an SM (128
//   registers, 43.5 KB of shared memory), left-looking by panels of
//   kPanel = 64 columns, as the reference's blocked kernel streams panels
//   through VMEM.  The right-hand side is the matrix's row r, so the
//   panels' own update and solve compute y = L⁻¹·rhs (kept in x until the
//   back substitution).  Each finished panel's rows also go to a workspace
//   in rows of 64 floats, so the update reads them 16 bytes at a time
//   whatever r is.  A panel's rows j0…r go through in row tiles of 64 (the
//   tail in 32 or 16: fewer than 16 rows wasted, 32 where 33–48 remain):
//     (1) each thread holds 8 rows × 4 columns of the tile (rows ty + 8u,
//         columns tx + 16j), started from M's lower triangle;
//     (2) the update over the finished columns, kSlice = 16 at a time: the
//         tile's and the panel's rows of them move by cp.async into a ring
//         of kStages = 3 stages while the last is multiplied, one block
//         barrier a stage; a float4 of the tile row is a broadcast and four
//         of the panel's rows hit distinct banks (rows of kSliceLd = 20
//         floats): 128 FFMA per 12 shared loads.  A 32- or 16-row tile
//         splits the depth between 2 or 4 groups of threads, whose sums
//         join group 0's through shared memory in group order;
//     (3) the first tile: its 64×64 diagonal block into the packed 16×16
//         tiles of K1 (identity past the matrix), factored by every warp
//         with K1's steps (a)–(c); log dⱼ summed in pivot order;
//     (4) the rows below: X·L_ddᵀ = A a column at a time, the column's
//         entries broadcast by shuffles within the half warp that holds the
//         rows, the scale by 1/√d last;
//     (5) the tile goes out through shared memory, whole panel rows at a
//         time, to L (zeros above the diagonal) or y, and to the workspace.
//   Then Lᵀx = y from device memory in the blocked dot form (below).
//   Design of K7 streamed, tri_solve_lt_streamed_kernel: one block of 4
//   warps per chain, the vector of r floats in shared memory (64 KB at the
//   limit kStreamMaxRank) and the blocked dot form, which K6 streamed ends
//   with: for the 32 columns c0…c0+31 from the last block up, each lane sums
//   L[j, c0 + lane]·xⱼ over its warp's share of the rows j below the block
//   (a row's 32 entries are one coalesced load; no step waits on another),
//   warp 0 adds the warps' sums in order and solves the block's triangle by
//   shuffles, its 32 rows loaded before the first step.  So only the r
//   triangle steps are serial, and none of them waits on device memory.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kTile = 16;                  // K1/K6: tile edge
constexpr int kTileElems = kTile * kTile;  // floats in a tile
constexpr int kMaxRank = 320;              // K1/K6: 210 packed tiles fill a block's 227 KB
constexpr int kMaxRes = kMaxRank / 32;     // K1/K6 substitution: residual entries a lane
constexpr int kK1Warps = 4;                // K1: warps per chain (more chains per SM)
constexpr int kK6Warps = 8;                // K6: warps per chain
constexpr int kTriRowWarps = 2;  // K2/K7: chains (warps) per block
constexpr int kRowsAhead = 4;    // K2/K7: rows of L loaded ahead of their step; divides 32
constexpr int kRowsMaxRank = 512;  // K2/K7 row kernel: 16 residual entries a lane
constexpr int kPanel = 64;         // K6 streamed: columns a panel
constexpr int kStreamWarps = 4;    // K6 streamed: warps per chain
constexpr int kStreamThreads = kStreamWarps * 32;
constexpr int kStreamCtas = 4;     // K6 streamed: chains an SM (launch bounds: ≤ 128 registers)
constexpr int kSlice = 16;         // K6 streamed: finished columns a stage of the update
constexpr int kStages = 3;         // K6 streamed: stages in the cp.async ring
constexpr int kSliceLd = 20;       // K6 streamed: floats a staged row (16 + 4: no bank conflicts)
constexpr int kTileRows = 64;      // K6 streamed: rows of the largest row tile
constexpr int kTriStreamWarps = 4;   // K7 streamed: warps per chain
constexpr int kStreamMaxRank = 16384;  // K6/K7 streamed: r floats of vector in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan32() { return __int_as_float(0x7fc00000); }

// K1/K6: offset of element (i, c) inside a tile, and of tile (I, J), I ≥ J
__device__ __forceinline__ int swz(int i, int c) {
  return i * kTile + ((((c >> 2) ^ (i >> 1)) & 3) << 2) + (c & 3);
}
__device__ __forceinline__ int tile_off(int I, int J) {
  return (I * (I + 1) / 2 + J) * kTileElems;
}
// chunk q (columns 4q…4q+3) of row i of a tile
__device__ __forceinline__ float4 ld_chunk(const float* t, int i, int q) {
  return *reinterpret_cast<const float4*>(t + i * kTile + (((q ^ (i >> 1)) & 3) << 2));
}
__device__ __forceinline__ void st_chunk(float* t, int i, int q, float4 v) {
  *reinterpret_cast<float4*>(t + i * kTile + (((q ^ (i >> 1)) & 3) << 2)) = v;
}

// K1/K6 (a): factor the diagonal tile held across the warp as
// a[t] = A[fi][8·fh + t] (fi = lane & 15, fh = lane >> 4) in place: L on and
// below the diagonal, entries above left as they were.  Lanes differ only
// in selects, never in branches.  Each lane keeps pivot fi's dⱼ and 1/√dⱼ
// (dl, il), so log dⱼ and the stores of 1/√dⱼ stay off the pivot chain.
__device__ __forceinline__ void factor_diag(float (&a)[8], int fi, int fh, float& dl,
                                            float& il) {
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int jh = j >> 3, jt = j & 7;
    float d = __shfl_sync(kFull, a[jt], j + 16 * jh);  // A[j][j]
    if (!(d > 0.0f)) d = nan32();                      // non-SPD pivot → NaN
    const float inv = rsqrtf(d);
    const float s = d * inv;
    dl = fi == j ? d : dl;
    il = fi == j ? inv : il;
    const bool mine = fh == jh;
    a[jt] = mine && fi > j ? a[jt] * inv : (mine && fi == j ? s : a[jt]);
    if (j == kTile - 1) break;  // no trailing entries after the last pivot
    const float lij = __shfl_sync(kFull, a[jt], fi + 16 * jh);  // L[fi][j]
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (j >= 8 && t <= j - 8) continue;  // columns ≤ j in both halves
      const float lkj = __shfl_sync(kFull, a[jt], 8 * fh + t + 16 * jh);  // L[8fh + t][j]
      const int k = 8 * fh + t;
      const float upd = fmaf(-lij, lkj, a[t]);
      a[t] = k > j && k <= fi ? upd : a[t];
    }
  }
}

// K1/K6 (b): row fi of tile (I, K) ← row fi of A_IK · L_KK⁻ᵀ, with scr = L_KKᵀ
// (row c holds column c of L_KK below the diagonal, 1/L_cc on it)
__device__ __forceinline__ void solve_row(float* t, int fi, const float* scr) {
  float x[kTile];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = ld_chunk(t, fi, q);
    x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    float lc[kTile];
#pragma unroll
    for (int q = c >> 2; q < 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(scr + c * kTile)[q];
      lc[4 * q] = v.x, lc[4 * q + 1] = v.y, lc[4 * q + 2] = v.z, lc[4 * q + 3] = v.w;
    }
    x[c] *= lc[c];
#pragma unroll
    for (int cp = c + 1; cp < kTile; ++cp) x[cp] = fmaf(-x[c], lc[cp], x[cp]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    st_chunk(t, fi, q, make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
}

// K1/K6 (c): A_IJ −= L_IK·L_JKᵀ over one tile; lane: rows ri = lane >> 2 and
// ri + 8, columns cq + 4u (cq = lane & 3, u = 0…3), read with the operands
// and written once.  li holds rows ri and ri + 8 of L_IK, chunk by chunk.
__device__ __forceinline__ void update_tile(float* aij, const float4 (&li)[2][4],
                                            const float* ljk, int lane) {
  const int ri = lane >> 2, cq = lane & 3;
  float acc[2][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    acc[0][u] = aij[swz(ri, cq + 4 * u)];
    acc[1][u] = aij[swz(ri + 8, cq + 4 * u)];
  }
#pragma unroll
  for (int kq = 0; kq < 4; ++kq) {
    const float4 l0 = li[0][kq], l1 = li[1][kq];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 lj = ld_chunk(ljk, cq + 4 * u, kq);
      acc[0][u] = fmaf(-l0.x, lj.x, acc[0][u]);
      acc[0][u] = fmaf(-l0.y, lj.y, acc[0][u]);
      acc[0][u] = fmaf(-l0.z, lj.z, acc[0][u]);
      acc[0][u] = fmaf(-l0.w, lj.w, acc[0][u]);
      acc[1][u] = fmaf(-l1.x, lj.x, acc[1][u]);
      acc[1][u] = fmaf(-l1.y, lj.y, acc[1][u]);
      acc[1][u] = fmaf(-l1.z, lj.z, acc[1][u]);
      acc[1][u] = fmaf(-l1.w, lj.w, acc[1][u]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    aij[swz(ri, cq + 4 * u)] = acc[0][u];
    aij[swz(ri + 8, cq + 4 * u)] = acc[1][u];
  }
}

// K1/K6 (a)–(c) over the packed lower tiles of an nt·16-square matrix with
// kWarps warps: L in place (entries above the diagonal of a diagonal tile
// left as they were), 1/√dⱼ into ild and log dⱼ into logd; scr0: one
// scratch tile per warp with work in a panel.  Ends on a block barrier.
template <int kWarps>
__device__ __forceinline__ void factor_tiles(float* tiles, float* scr0, float* ild,
                                             float* logd, int nt, int warp, int lane) {
  const int fi = lane & 15, fh = lane >> 4;
  float* scr = scr0 + warp * kTileElems;  // this warp's L_KKᵀ
  for (int K = 0; K < nt; ++K) {
    const int below = nt - 1 - K;
    float a[8];
    if (warp == 0 || 2 * warp < below) {
      // (a) the diagonal tile, factored in registers
      const float* dk = tiles + tile_off(K, K);
      const float4 c0 = ld_chunk(dk, fi, 2 * fh), c1 = ld_chunk(dk, fi, 2 * fh + 1);
      a[0] = c0.x, a[1] = c0.y, a[2] = c0.z, a[3] = c0.w;
      a[4] = c1.x, a[5] = c1.y, a[6] = c1.z, a[7] = c1.w;
      float dl = 0.0f, il = 0.0f;  // this lane's pivot fi: dⱼ and 1/√dⱼ
      factor_diag(a, fi, fh, dl, il);
      if (warp == 0 && fh == 0) {
        ild[K * kTile + fi] = il;
        logd[K * kTile + fi] = logf(dl);
      }
      // (b) Lᵀ_KK into this warp's scratch, then the tiles below, two at a time
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int c = 8 * fh + t;
        if (fi >= c) scr[c * kTile + fi] = fi > c ? a[t] : il;
      }
      __syncwarp();
      for (int q = warp; 2 * q < below; q += kWarps) {
        const int I = K + 1 + 2 * q + fh;
        if (I < nt) solve_row(tiles + tile_off(I, K), fi, scr);
      }
    }
    __syncthreads();
    // (c) the trailing update; warp 0 writes the factored diagonal tile back
    if (warp == 0) {
      float* dk = tiles + tile_off(K, K);
      st_chunk(dk, fi, 2 * fh, make_float4(a[0], a[1], a[2], a[3]));
      st_chunk(dk, fi, 2 * fh + 1, make_float4(a[4], a[5], a[6], a[7]));
    }
    // Each warp takes a contiguous run of the trailing tiles in row-major
    // order (row I holds J = K+1…I) and keeps its row's L_IK in registers.
    const int m_rows = nt - 1 - K;
    const int n_upd = m_rows * (m_rows + 1) / 2;
    const int u_end = (warp + 1) * n_upd / kWarps;
    int u = warp * n_upd / kWarps;
    int I = K + 1, J = u;
    while (J >= I - K) J -= I++ - K;
    J += K + 1;
    float4 li[2][4];
    for (bool fresh = true; u < u_end; ++u, fresh = false) {
      if (fresh || J == K + 1) {
        const float* lik = tiles + tile_off(I, K);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          li[0][kq] = ld_chunk(lik, lane >> 2, kq);
          li[1][kq] = ld_chunk(lik, (lane >> 2) + 8, kq);
        }
      }
      update_tile(tiles + tile_off(I, J), li, tiles + tile_off(J, K), lane);
      if (++J > I) J = K + 1, ++I;
    }
    __syncthreads();
  }
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    chol_solve_tiled_kernel(const float* __restrict__ m, const float* __restrict__ rhs,
                            float* __restrict__ l, float* __restrict__ x,
                            float* __restrict__ logdet, int r) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nt = (r + kTile - 1) / kTile;
  const int rp = nt * kTile;
  const int n_tiles = nt * (nt + 1) / 2;
  float* tiles = reinterpret_cast<float*>(smem4);      // [n_tiles][256] packed lower tiles
  float* ild = tiles + (n_tiles + kWarps) * kTileElems;  // [rp] 1/√dⱼ
  float* logd = ild + rp;                                // [rp] log dⱼ
  const float* mb = m + (size_t)blockIdx.x * r * r;

  // M's lower triangle into the packed tiles, two rows a warp at a time with
  // all their loads issued before the first store; identity in the padding,
  // zeros above the diagonal
  for (int i0 = 2 * warp; i0 < rp; i0 += 2 * kWarps) {
    float v[2][kMaxRes];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h;
#pragma unroll
      for (int q = 0; q < kMaxRes; ++q) {
        const int c = lane + 32 * q;
        v[h][q] = i == c ? 1.0f : 0.0f;
        if (i < r && c <= i) v[h][q] = mb[(size_t)i * r + c];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + h;  // rp is even, so i < rp
#pragma unroll
      for (int q = 0; q < kMaxRes; ++q) {
        const int c = lane + 32 * q;
        if (c < ((i >> 4) + 1) * kTile)
          tiles[tile_off(i >> 4, c >> 4) + swz(i & 15, c & 15)] = v[h][q];
      }
    }
  }
  __syncthreads();

  factor_tiles<kWarps>(tiles, tiles + n_tiles * kTileElems, ild, logd, nt, warp, lane);

  const size_t row = (size_t)blockIdx.x * r;
  if (warp == 0) {
    float res[kMaxRes];  // res[k]: entry lane + 32k, rhs → y → x
#pragma unroll
    for (int k = 0; k < kMaxRes; ++k) {
      const int i = lane + 32 * k;
      res[k] = i < r ? rhs[row + i] : 0.0f;
    }
    // L y = rhs: yⱼ = resⱼ/√dⱼ, then resᵢ −= Lᵢⱼ·yⱼ below the diagonal.
    // Lᵢⱼ for i = lane + 32k sits at rowoff[k] + coff(j): (i >> 1) & 3, the
    // row's swizzle, is (lane >> 1) & 3 for every k
    // (rows past the padding point at row 0: their loads are discarded)
    int rowoff[kMaxRes];
#pragma unroll
    for (int k = 0; k < kMaxRes; ++k) {
      const int i = lane + 32 * k;
      rowoff[k] = i < rp ? tile_off(i >> 4, 0) + (i & 15) * kTile : 0;
    }
    const int lsw = (lane >> 1) & 3;
    // column j of L and 1/√dⱼ, loaded one step ahead of step j (zeros where
    // the step does not update).  Every lane loads; a select, not a branch,
    // drops what the step does not use (the column past the last, j = rp,
    // reads the scratch behind the tiles)
    float lcol[kMaxRes];
    float dj = ild[0];
#pragma unroll
    for (int k = 0; k < kMaxRes; ++k) {
      const int i = lane + 32 * k;
      const float v = tiles[rowoff[k] + (lsw << 2)];
      lcol[k] = i > 0 && i < r ? v : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kMaxRes; ++s) {
      if (32 * s >= r) break;
      const int jend = min(32, r - 32 * s);
#pragma unroll 4
      for (int jj = 0; jj < jend; ++jj) {
        const int j = 32 * s + jj;
        const float yj = __shfl_sync(kFull, res[s] * dj, jj);
#pragma unroll
        for (int k = s; k < kMaxRes; ++k) res[k] = fmaf(-lcol[k], yj, res[k]);
        if (lane == jj) res[s] = yj;
        const int jn = j + 1;  // the next step's column
        const int coff = (jn >> 4) * kTileElems + ((((jn >> 2) & 3) ^ lsw) << 2) + (jn & 3);
        dj = ild[min(jn, r - 1)];
#pragma unroll
        for (int k = s; k < kMaxRes; ++k) {
          const int i = lane + 32 * k;
          const float v = tiles[rowoff[k] + coff];
          lcol[k] = i > jn && i < r ? v : 0.0f;
        }
      }
    }
    // Lᵀ x = y: xⱼ = resⱼ/√dⱼ, then resᵢ −= Lⱼᵢ·xⱼ above it (row j of L).
    // Lⱼᵢ for i = lane + 32k sits at roff(j) + 512k: column i lies in tile
    // column (lane >> 4) + 2k at in-row offset swizzled by (j >> 1) & 3
    // row j of L and 1/√dⱼ, loaded one step ahead of step j; every lane
    // loads (past the row's end the address stays inside the tiles and the
    // scratch behind them) and a select drops what the step does not use
    auto lrow_of = [&](int j) {
      return tiles + tile_off(j >> 4, 0) + (j & 15) * kTile + (lane >> 4) * kTileElems +
             ((((lane >> 2) & 3) ^ ((j >> 1) & 3)) << 2) + (lane & 3);
    };
    float lrow[kMaxRes];
    {
      const float* p = lrow_of(r - 1);
#pragma unroll
      for (int k = 0; k < kMaxRes; ++k) {
        if (32 * k >= r) break;  // (uniform) no block of rows past the matrix
        const float v = p[2 * k * kTileElems];
        lrow[k] = lane + 32 * k < r - 1 ? v : 0.0f;
      }
    }
    dj = ild[r - 1];
#pragma unroll
    for (int s = kMaxRes - 1; s >= 0; --s) {
      if (32 * s >= r) continue;
#pragma unroll 4
      for (int jj = min(31, r - 1 - 32 * s); jj >= 0; --jj) {
        const int j = 32 * s + jj;
        const float xj = __shfl_sync(kFull, res[s] * dj, jj);
#pragma unroll
        for (int k = 0; k <= s; ++k) res[k] = fmaf(-lrow[k], xj, res[k]);
        if (lane == jj) res[s] = xj;
        const int jn = max(j - 1, 0);  // the next step's row
        const float* p = lrow_of(jn);
        dj = ild[jn];
#pragma unroll
        for (int k = 0; k <= s; ++k) {
          const float v = p[2 * k * kTileElems];
          lrow[k] = lane + 32 * k < jn ? v : 0.0f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxRes; ++k) {
      const int i = lane + 32 * k;
      if (i < r) x[row + i] = res[k];
    }
  } else {
    // the other warps write L meanwhile: zeros above the diagonal, no padding
    float* lb = l + (size_t)blockIdx.x * r * r;
    for (int i = warp - 1; i < r; i += kWarps - 1) {
      for (int c = lane; c < r; c += 32)
        lb[(size_t)i * r + c] =
            c <= i ? tiles[tile_off(i >> 4, c >> 4) + swz(i & 15, c & 15)] : 0.0f;
    }
    // and warp 1 sums log det in pivot order
    if (warp == 1 && lane == 0) {
      float logsum = 0.0f;
      for (int j = 0; j < r; ++j) logsum += logd[j];
      logdet[blockIdx.x] = logsum;
    }
  }
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

// K6/K7 streamed: Lᵀv = (v on entry) in place for v [r] in shared memory,
// L [r, r] lower in device memory, all kWarps warps of the block taking
// part.  kGuard divides by max(Lⱼⱼ, 1e-30) with NaN kept (K7's contract);
// K6 divides by Lⱼⱼ.  part: kWarps·32 floats of scratch.
template <int kWarps, bool kGuard>
__device__ __forceinline__ void solve_lt_streamed(const float* lb, float* vec, float* part,
                                                  int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 32 * ((r - 1) / 32); c0 >= 0; c0 -= 32) {
    const int ws = min(32, r - c0);  // columns in this block
    const int col = c0 + lane;
    // Σ_{j ≥ c0+32} L[j][col]·xⱼ over this warp's rows j
    float acc = 0.0f;
    if (lane < ws) {
#pragma unroll 4
      for (int j = c0 + 32 + warp; j < r; j += kWarps)
        acc = fmaf(__ldcg(lb + (size_t)j * r + col), vec[j], acc);
    }
    if (kWarps > 1) {
      part[warp * 32 + lane] = acc;
      __syncthreads();
    }
    if (warp == 0) {
      for (int w = 1; w < kWarps; ++w) acc += part[w * 32 + lane];
      float res = lane < ws ? vec[col] - acc : 0.0f;
      float lrow[32];  // lrow[jj] = L[c0 + jj][col], on and below the diagonal
#pragma unroll
      for (int jj = 0; jj < 32; ++jj)
        lrow[jj] = jj < ws && lane <= jj ? __ldcg(lb + (size_t)(c0 + jj) * r + col) : 0.0f;
#pragma unroll
      for (int jj = 31; jj >= 0; --jj) {
        if (jj >= ws) continue;  // (uniform) past the matrix
        float d = lrow[jj];      // Lⱼⱼ on the owner lane jj
        if (kGuard) d = isnan(d) ? d : fmaxf(d, 1e-30f);
        const float xj = __shfl_sync(kFull, res / d, jj);
        res = lane < jj ? fmaf(-lrow[jj], xj, res) : (lane == jj ? xj : res);
      }
      if (lane < ws) vec[col] = res;
    }
    __syncthreads();
  }
}

// K6 streamed: 16-byte asynchronous copy global → shared; valid false
// fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K6 streamed: the workspace keeps each finished panel q's rows 64q…r
// (row r: y) as rows of 64 floats, 16-byte aligned whatever r is; panel q
// starts at row ws_row(q, r) of the chain's part
__host__ __device__ __forceinline__ size_t ws_row(int q, int r) {
  return (size_t)q * (r + 1) - (size_t)kPanel * q * (q - 1) / 2;
}

// K6 streamed: the rows of the row tile that starts at row p0 of a panel of
// n rows (the right-hand side's included): 64 while more than 48 remain,
// then 32 while more than 16 remain, then 16; the first tile takes 64 from
// 33 rows on, so that it holds all of the diagonal block's w ≤ 64 rows.
// A panel wastes fewer than 16 rows, 32 where it has 33 to 48.
__device__ __forceinline__ int tile_rows(int n, int p0) {
  const int rem = n - p0;
  return rem > (p0 == 0 ? kTileRows / 2 : 3 * kTileRows / 4) ? kTileRows
         : rem > kTileRows / 4                             ? kTileRows / 2
                                                           : kTileRows / 4;
}

// K6 streamed (2): one stage of the update, acc −= A·Bᵀ over this group's
// float4 chunks of the stage's kSlice columns.  as: the tile's rows, bs: the
// panel's 64 rows, [row][kSliceLd] each.  A thread holds rows
// ty + (kH/8)·u (u < 8) and columns tx + 16j (j < 4); the A row is a
// broadcast and the 16 B rows of a quarter warp hit 8 distinct bank
// quads, so no read conflicts; 128 FMAs per 12 shared loads.  kDiag (the
// diagonal tile) skips the 16-column blocks wholly above its rows.
template <int kH, bool kDiag>
__device__ __forceinline__ void update_stage(float (&acc)[8][4], const float* as,
                                             const float* bs, int g, int ty, int tx) {
  constexpr int kChunks = kSlice / 4 / (kTileRows / kH), kRowStep = kH / 8;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int kq = g * kChunks + q;
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kSliceLd + 4 * kq);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 a =
          *reinterpret_cast<const float4*>(as + (ty + kRowStep * u) * kSliceLd + 4 * kq);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kDiag && 16 * j >= kRowStep * (u + 1)) continue;
        acc[u][j] = fmaf(-a.x, b[j].x, acc[u][j]);
        acc[u][j] = fmaf(-a.y, b[j].y, acc[u][j]);
        acc[u][j] = fmaf(-a.z, b[j].z, acc[u][j]);
        acc[u][j] = fmaf(-a.w, b[j].w, acc[u][j]);
      }
    }
  }
}

// K6 streamed: shared memory of a block, in floats
constexpr int kStageFloats = (kTileRows + kPanel) * kSliceLd;  // one stage: A then B
constexpr int kRingFloats = kStages * kStageFloats;
constexpr int kDiagTiles = 10;  // packed lower 16×16 tiles of the 64×64 diagonal block
constexpr int kStreamFixedFloats =
    kRingFloats + (kDiagTiles + 2) * kTileElems + 2 * kPanel;  // ring, block, 2 scratch, ild, logd
// the ring also holds a tile with the groups' sums (kH·kPanel floats a
// group), and the parked sums
static_assert(kRingFloats >= kTileRows * kPanel && kRingFloats >= 32 * kStreamThreads,
              "the ring must hold what stream_tile puts there");

// K6 streamed: one row tile of kH rows, panel rows p0…p0+kH−1 (matrix rows
// j0 + p0…; row r is the right-hand side) and the panel's columns
// j0…j0+w−1.  (1) the thread's outputs start from M's lower triangle (the
// right-hand side in row r), less the update over the finished columns
// 0…j0−1 from the workspace, kSlice at a time through a ring of kStages
// stages filled by cp.async, one block barrier a stage; kTileRows/kH
// groups of 2·kH threads take the chunks of each stage in turn, and (2)
// groups 1, 2, 3 add their sums to group 0's in that order; (3) the first
// tile: its diagonal block into dblk (identity past w), factored by every
// warp as K1 factors its tiles; (4) the rows below the block: X·L_ddᵀ = A a
// column c at a time, aᵢc broadcast by shuffles in the half warp that holds
// row i, every later column less aᵢc·L[col][c]/√d_c, then each column
// scaled by its 1/√d; (5) out through shared memory, whole rows at a time,
// to L (the diagonal block's rows from dblk, zeros above its diagonal) or
// to y, and to the workspace.
template <int kH>
__device__ __forceinline__ void stream_tile(const float* mb, const float* rb, float* lb,
                                            float* xb, float* wsb, float* ring, float* dblk,
                                            float* ild, float* logd, float& logsum, int r,
                                            int j0, int w, int p0) {
  constexpr int kGroups = kTileRows / kH, kGroupThreads = kStreamThreads / kGroups;
  constexpr int kRowStep = kH / 8;
  constexpr int kCopies = (kH + kPanel) * (kSlice / 4);  // 16-byte copies a stage
  const int tid = threadIdx.x;
  const int g = tid / kGroupThreads, tg = tid % kGroupThreads;
  const int ty = tg >> 4, tx = tg & 15;
  const int i0 = j0 + p0;      // the tile's first matrix row
  const int nk = j0 / kSlice;  // stages of finished columns
  const bool diag = p0 == 0;
  float* tile = ring;               // [kH][kPanel] the tile's L on its way out
  float* red = ring + kH * kPanel;  // [kGroups − 1][kH][kPanel] the groups' sums
  __syncthreads();  // the last tile is done with the ring

  auto fetch = [&](int s) {  // stage s into ring slot s % kStages
    if (s < nk) {
      float* as = ring + (s % kStages) * kStageFloats;
      const int q = s * kSlice / kPanel;  // the finished panel the stage's columns lie in
      const float* src0 = wsb + (ws_row(q, r) - (size_t)kPanel * q) * kPanel + s * kSlice % kPanel;
#pragma unroll
      for (int e0 = 0; e0 < kCopies; e0 += kStreamThreads) {
        const int e = e0 + tid;
        if (kCopies % kStreamThreads != 0 && e >= kCopies) break;
        const int row = e / (kSlice / 4), k = 4 * (e % (kSlice / 4));  // A rows, then B's
        const int i = row < kH ? i0 + row : j0 + row - kH;
        const bool valid = row < kH ? i <= r : row - kH < w;
        cp_async16(as + row * kSliceLd + k, src0 + (size_t)i * kPanel + k, valid);
      }
    }
    cp_async_commit();
  };

  // (1) group 0 starts from M's lower triangle (the right-hand side in row
  // r), the other groups from 0; the loads are all in flight with the
  // ring's first stages
  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int i = i0 + ty + kRowStep * u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float v = 0.0f;
      if (g == 0 && c < w) {
        if (i < r) {
          if (j0 + c <= i) v = mb[(size_t)i * r + j0 + c];
        } else if (i == r) {
          v = rb[j0 + c];
        }
      }
      acc[u][j] = v;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s is in; every thread is done with stage s − 1's slot
    fetch(s + kStages - 1);
    const float* as = ring + (s % kStages) * kStageFloats;
    const float* bs = as + kH * kSliceLd;
    if (diag)
      update_stage<kH, true>(acc, as, bs, g, ty, tx);
    else
      update_stage<kH, false>(acc, as, bs, g, ty, tx);
  }
  // (2) the groups' sums, added to group 0's in group order
  if (kGroups > 1 && nk > 0) {
    __syncthreads();  // every thread is done with the ring
    if (g > 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[((g - 1) * kH + ty + kRowStep * u) * kPanel + tx + 16 * j] = acc[u][j];
    }
    __syncthreads();
    if (g == 0) {
      for (int gg = 1; gg < kGroups; ++gg)
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[u][j] += red[((gg - 1) * kH + ty + kRowStep * u) * kPanel + tx + 16 * j];
    }
  }
  if (diag) {
    // (3) the diagonal block's rows p < w into dblk, lower tiles only
    if (g == 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int p = ty + kRowStep * u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p < w && j <= (p >> 4)) dblk[tile_off(p >> 4, j) + swz(p & 15, tx)] = acc[u][j];
      }
    }
    __syncthreads();  // and every thread is done with the ring
    // the sums wait in the ring while every warp factors the block, so they
    // hold no registers there
    if (g == 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) ring[(4 * u + j) * kStreamThreads + tid] = acc[u][j];
    }
    factor_tiles<kStreamWarps>(dblk, dblk + kDiagTiles * kTileElems, ild, logd, kPanel / kTile,
                               tid >> 5, tid & 31);
    if (g == 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[u][j] = ring[(4 * u + j) * kStreamThreads + tid];
    }
    if (tid == 0)
      for (int j = 0; j < w; ++j) logsum += logd[j];
  }
  if (g == 0 && p0 + kH > w) {
    // (4) X·L_ddᵀ = A for every row of a tile with rows below the block
    // (the block's own rows are replaced in (5)): column c's unscaled aᵢc
    // goes to the half warp by shuffles, and every later column takes
    // −aᵢc·(L[col][c]/√d_c); the scale 1/√d_c last
#pragma unroll
    for (int jc = 0; jc < 4; ++jc) {
      if (16 * jc >= w) break;
      const int ce = min(16, w - 16 * jc);
      for (int cc = 0; cc < ce; ++cc) {
        const float il = ild[16 * jc + cc];
        float xs[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) xs[u] = __shfl_sync(kFull, acc[u][jc], cc, 16);
        if (tx > cc) {
          const float lv = dblk[tile_off(jc, jc) + swz(tx, cc)] * il;
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[u][jc] = fmaf(-xs[u], lv, acc[u][jc]);
        }
#pragma unroll
        for (int j = jc + 1; j < 4; ++j) {
          const float lv = dblk[tile_off(j, jc) + swz(tx, cc)] * il;
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[u][j] = fmaf(-xs[u], lv, acc[u][j]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the ring (the groups' or the parked sums)
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float il = ild[tx + 16 * j];
#pragma unroll
      for (int u = 0; u < 8; ++u) tile[(ty + kRowStep * u) * kPanel + tx + 16 * j] = acc[u][j] * il;
    }
  }
  __syncthreads();
  // (5) out, whole rows of the panel at a time: to L or y, and to the workspace
  float* wsp = wsb + (ws_row(j0 / kPanel, r) - j0) * kPanel;  // this panel's rows, by matrix row
#pragma unroll 4
  for (int e = tid; e < kH * kPanel; e += kStreamThreads) {
    const int p = p0 + e / kPanel, c = e % kPanel, i = j0 + p;
    if (i > r || c >= w) continue;
    float v = tile[e];
    if (p < w) v = c <= p ? dblk[tile_off(p >> 4, c >> 4) + swz(p & 15, c & 15)] : 0.0f;
    (i < r ? lb + (size_t)i * r : xb)[j0 + c] = v;
    wsp[(size_t)i * kPanel + c] = v;
  }
}

__global__ void __launch_bounds__(kStreamThreads, kStreamCtas)
    chol_solve_streamed_kernel(const float* __restrict__ m, const float* __restrict__ rhs,
                               float* l, float* x, float* __restrict__ logdet, float* ws,
                               int r) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);     // [kStages][A, B][rows][kSliceLd]
  float* dblk = ring + kRingFloats;                  // [10 + 2][256] the block, 2 scratch tiles
  float* ild = dblk + (kDiagTiles + 2) * kTileElems;  // [kPanel] 1/√dⱼ
  float* logd = ild + kPanel;                        // [kPanel] log dⱼ
  const int tid = threadIdx.x;
  const float* mb = m + (size_t)blockIdx.x * r * r;
  const float* rb = rhs + (size_t)blockIdx.x * r;
  float* lb = l + (size_t)blockIdx.x * r * r;
  float* xb = x + (size_t)blockIdx.x * r;  // y = L⁻¹·rhs, the matrix's row r
  const int n_panels = (r + kPanel - 1) / kPanel;
  float* wsb = ws + blockIdx.x * ws_row(n_panels, r) * kPanel;
  float logsum = 0.0f;  // thread 0: Σ log dⱼ in pivot order

  for (int j0 = 0; j0 < r; j0 += kPanel) {
    const int w = min(kPanel, r - j0);  // columns in this panel
    __syncthreads();  // the last panel is done with dblk, and its L is out
    // the diagonal block starts as the identity
    for (int e = tid; e < kDiagTiles * kTileElems; e += kStreamThreads) {
      const int t = e / kTileElems, i = (e >> 4) & 15, c = e & 15;
      const int I = t >= 6 ? 3 : t >= 3 ? 2 : t >= 1 ? 1 : 0;
      dblk[t * kTileElems + swz(i, c)] = t == I * (I + 1) / 2 + I && i == c ? 1.0f : 0.0f;
    }
    // zeros above the diagonal right of the block, a run of r − j0 − 64
    // columns a row (the block's own come with its rows)
    const int run = r - j0 - kPanel;
    for (int e = tid; e < w * run; e += kStreamThreads)
      lb[(size_t)(j0 + e / run) * r + j0 + kPanel + e % run] = 0.0f;
    const int n = r + 1 - j0;  // the panel's rows, the right-hand side's included
    for (int p0 = 0; p0 < n;) {
      const int h = tile_rows(n, p0);
      if (h == kTileRows)
        stream_tile<kTileRows>(mb, rb, lb, xb, wsb, ring, dblk, ild, logd, logsum, r, j0, w, p0);
      else if (h == kTileRows / 2)
        stream_tile<kTileRows / 2>(mb, rb, lb, xb, wsb, ring, dblk, ild, logd, logsum, r, j0, w,
                                   p0);
      else
        stream_tile<kTileRows / 4>(mb, rb, lb, xb, wsb, ring, dblk, ild, logd, logsum, r, j0, w,
                                   p0);
      p0 += h;
    }
  }
  // Lᵀx = y, the vector and the warps' partial sums over the ring
  __syncthreads();
  float* part = ring;
  float* vec = ring + kStreamWarps * 32;
  for (int i = tid; i < r; i += kStreamThreads) vec[i] = __ldcg(xb + i);
  __syncthreads();
  solve_lt_streamed<kStreamWarps, false>(lb, vec, part, r);
  for (int i = tid; i < r; i += kStreamThreads) xb[i] = vec[i];
  if (tid == 0) logdet[blockIdx.x] = logsum;
}

// K7 streamed: a block per chain, r > kRowsMaxRank
__global__ void __launch_bounds__(kTriStreamWarps * 32)
    tri_solve_lt_streamed_kernel(const float* __restrict__ l, const float* __restrict__ z,
                                 float* __restrict__ x, int r) {
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);  // [kTriStreamWarps][32]
  float* vec = part + kTriStreamWarps * 32;       // [r] z, then x
  const size_t row = (size_t)blockIdx.x * r;
  for (int i = threadIdx.x; i < r; i += kTriStreamWarps * 32) vec[i] = z[row + i];
  __syncthreads();
  solve_lt_streamed<kTriStreamWarps, true>(l + row * r, vec, part, r);
  for (int i = threadIdx.x; i < r; i += kTriStreamWarps * 32) x[row + i] = vec[i];
}

// K6/K7 streamed: dynamic shared memory a block takes at rank r (K6: the
// ring, the diagonal block and its scratch, or the vector with the warps'
// partial sums over them, whichever is larger)
int chol_streamed_smem_bytes(int r) {
  const size_t vec = (size_t)kStreamThreads + r;
  const size_t fixed = kStreamFixedFloats;
  return (int)((vec > fixed ? vec : fixed) * sizeof(float));
}
int tri_streamed_smem_bytes(int r) {
  return (int)((kTriStreamWarps * 32 + (size_t)r) * sizeof(float));
}

// raise `kernel`'s dynamic shared-memory ceiling to `bytes`, once per device
// (bit d of `done`), not on every launch
cudaError_t allow_smem(const void* kernel, int bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// K1/K6: the packed lower tiles, one scratch tile a warp, 1/√dⱼ and log dⱼ
int tiled_smem_bytes(int r, int warps) {
  const int nt = (r + kTile - 1) / kTile;
  return (int)((((size_t)nt * (nt + 1) / 2 + warps) * kTileElems + 2 * (size_t)nt * kTile) *
               sizeof(float));
}

// K1/K6: the kernel's dynamic shared-memory ceiling, what r = kMaxRank needs
template <int kWarps>
cudaError_t allow_tiled_smem() {
  static std::atomic<unsigned> done{0};
  return allow_smem((const void*)chol_solve_tiled_kernel<kWarps>,
                    tiled_smem_bytes(kMaxRank, kWarps), done);
}

template <int kWarps>
int launch_chol_tiled(const float* m, const float* rhs, float* l, float* x, float* logdet,
                      int batch, int r, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (r > kMaxRank) return cudaErrorInvalidValue;  // the wrapper refuses r > kMaxRank first
  const int bytes = tiled_smem_bytes(r, kWarps);
  cudaError_t e = allow_tiled_smem<kWarps>();
  if (e != cudaSuccess) return e;
  chol_solve_tiled_kernel<kWarps><<<batch, kWarps * 32, bytes, (cudaStream_t)stream>>>(
      m, rhs, l, x, logdet, r);
  return cudaGetLastError();
}

// K6 streamed: the kernel's dynamic shared-memory ceiling, what
// r = kStreamMaxRank needs
cudaError_t allow_streamed_smem() {
  static std::atomic<unsigned> done{0};
  return allow_smem((const void*)chol_solve_streamed_kernel,
                    chol_streamed_smem_bytes(kStreamMaxRank), done);
}

}  // namespace

extern "C" {

int icp_chol_solve(const float* m, const float* rhs, float* l, float* x, float* logdet,
                   int batch, int r, void* stream) {
  return launch_chol_tiled<kK1Warps>(m, rhs, l, x, logdet, batch, r, stream);
}

int icp_chol_solve_blocked(const float* m, const float* rhs, float* l, float* x,
                           float* logdet, int batch, int r, void* stream) {
  return launch_chol_tiled<kK6Warps>(m, rhs, l, x, logdet, batch, r, stream);
}

// dynamic shared memory a block of the K1/K6 kernel with `warps` warps
// takes at rank r, as its launch sizes it; -1 past kMaxRank
int icp_chol_tiled_smem_bytes(int r, int warps) {
  return r > kMaxRank ? -1 : tiled_smem_bytes(r, warps);
}

// blocks of the K1/K6 kernel with `warps` warps one SM holds at rank r (the
// occupancy calculator: registers, shared memory, threads); -1 on an error
int icp_chol_tiled_ctas_per_sm(int r, int warps) {
  if ((warps != kK1Warps && warps != kK6Warps) || r > kMaxRank) return -1;
  const bool k1 = warps == kK1Warps;
  const void* kernel = k1 ? (const void*)chol_solve_tiled_kernel<kK1Warps>
                          : (const void*)chol_solve_tiled_kernel<kK6Warps>;
  int n = 0;
  if ((k1 ? allow_tiled_smem<kK1Warps>() : allow_tiled_smem<kK6Warps>()) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, warps * 32,
                                                    tiled_smem_bytes(r, warps)) != cudaSuccess)
    return -1;
  return n;
}

// K6 streamed: any 1 ≤ r ≤ kStreamMaxRank (the wrapper takes it for r > kMaxRank);
// ws: icp_chol_streamed_ws_floats(r) floats a chain
int icp_chol_solve_streamed(const float* m, const float* rhs, float* l, float* x,
                            float* logdet, float* ws, int batch, int r, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (r > kStreamMaxRank) return cudaErrorInvalidValue;  // the wrapper refuses it first
  cudaError_t e = allow_streamed_smem();
  if (e != cudaSuccess) return e;
  chol_solve_streamed_kernel<<<batch, kStreamThreads, chol_streamed_smem_bytes(r),
                               (cudaStream_t)stream>>>(m, rhs, l, x, logdet, ws, r);
  return cudaGetLastError();
}

// K6 streamed: the workspace a chain takes at rank r, in floats; -1 past
// kStreamMaxRank
int icp_chol_streamed_ws_floats(int r) {
  return r > kStreamMaxRank ? -1 : (int)(ws_row((r + kPanel - 1) / kPanel, r) * kPanel);
}

// dynamic shared memory a block of the streamed K6 takes at rank r, as its
// launch sizes it; -1 past kStreamMaxRank
int icp_chol_streamed_smem_bytes(int r) {
  return r > kStreamMaxRank ? -1 : chol_streamed_smem_bytes(r);
}

// blocks (chains) of the streamed K6 one SM holds at rank r (the occupancy
// calculator: registers, shared memory, threads); -1 on an error
int icp_chol_streamed_ctas_per_sm(int r) {
  if (r < 1 || r > kStreamMaxRank) return -1;
  int n = 0;
  if (allow_streamed_smem() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, (const void*)chol_solve_streamed_kernel, kStreamThreads,
          chol_streamed_smem_bytes(r)) != cudaSuccess)
    return -1;
  return n;
}

// K7 streamed: any 1 ≤ r ≤ kStreamMaxRank (the wrapper takes it for r > kRowsMaxRank)
int icp_tri_solve_lt_streamed(const float* l, const float* z, float* x, int batch, int r,
                              void* stream) {
  if (batch == 0) return cudaSuccess;
  if (r > kStreamMaxRank) return cudaErrorInvalidValue;  // the wrapper refuses it first
  static std::atomic<unsigned> done{0};
  cudaError_t e = allow_smem((const void*)tri_solve_lt_streamed_kernel,
                             tri_streamed_smem_bytes(kStreamMaxRank), done);
  if (e != cudaSuccess) return e;
  tri_solve_lt_streamed_kernel<<<batch, kTriStreamWarps * 32, tri_streamed_smem_bytes(r),
                                 (cudaStream_t)stream>>>(l, z, x, r);
  return cudaGetLastError();
}

// K2/K7: the row-streaming solve with the fewest residual entries a lane
// that r needs (KMAX = 4 covers the monolithic ranks r ≤ 104)
int icp_tri_solve_lt_rows(const float* l, const float* z, float* x, int batch, int r,
                          void* stream) {
  if (batch == 0) return cudaSuccess;
  const int blocks = (batch + kTriRowWarps - 1) / kTriRowWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (r <= 128) {
    tri_solve_lt_rows_kernel<4><<<blocks, kTriRowWarps * 32, 0, st>>>(l, z, x, batch, r);
  } else if (r <= 256) {
    tri_solve_lt_rows_kernel<8><<<blocks, kTriRowWarps * 32, 0, st>>>(l, z, x, batch, r);
  } else if (r <= kRowsMaxRank) {
    tri_solve_lt_rows_kernel<16><<<blocks, kTriRowWarps * 32, 0, st>>>(l, z, x, batch, r);
  } else {
    return cudaErrorInvalidValue;  // the wrappers take K7 streamed for r > 512
  }
  return cudaGetLastError();
}

const char* icp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
