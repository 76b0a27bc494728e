// K3, K4, K5 and K8 of the port: the nearest vertex, the shortlist refine,
// the dense closest-point query and the dot-form coarse nearest vertex.
// Compiled with -fmad=false: the tie rules compare float32 squared distances
// for equality, so every product and sum rounds on its own, in the order the
// reference writes them, exactly as the plain PyTorch twins in
// ops/closest_point_cuda.py do.
//
// K3 icp_nearest_vertices replaces _make_nv_kernel / _nv_call in
// icp_proposal_tpu/ops/closest_point_pallas.py (reached through
// nearest_vertices_pallas): ids = argminᵥ ‖q − v‖², d² = dx·dx + dy·dy + dz·dz,
// ties to the lowest id.  The vertex set is shared (batch stride 0, the
// shortlist's coarse stage) or one per chain (stride V·3, the ICP target
// direction against each chain's candidate mesh).
//   What bounds it: FP32 issue rate, ~9 operations per (query, vertex) pair
//   (2,048 × 404 × 1,622 pairs per coarse call); bytes are tiny.
//   Design: one thread per query, the vertex set staged through shared
//   memory in chunks of 2,048 (all threads read the same vertex, a
//   broadcast) and scanned in ascending id order with a strict <, which
//   gives the lowest id on ties.  The ragged edge is masked, not padded.
//
// K4 icp_refine_shortlist replaces _make_refine_kernel / _refine_call in the
// same file (reached through refine_shortlist_pallas): the exact Ericson
// point→triangle cascade (_tile_dist2, closest_point_pallas.py:58-119, same
// operation order, _safe_div included) over the K candidate faces of each
// query's coarse vertex; the winner is the least d², then the smallest face
// id, then the lowest candidate slot.
//   What bounds it: the candidate gather.  The TPU path pregathers the
//   [B, P, 9K] candidate corners (surface_index.py:202-203), 1.9 GB written
//   and read back per step at 2,048 chains; the static tables here are
//   3.7 MB and stay in L2.
//   Design: the kernel takes the coarse ids and the static cand [V, K] and
//   cand_tri [V, 9K] tables and reads the rows itself: one warp per query,
//   lane l takes slots l, l+32, ... with coalesced component-major loads,
//   then a warp-shuffle lexicographic min on (d², face id, slot).
//
// K5 icp_surface_distances replaces _make_kernel / _dist2_call in the same
// file (reached through surface_distances_pallas, pack_triangles and
// tile_bounds): the dense point→triangle min d² and argmin face of every
// query against every face, with the same Ericson cascade as K4.  Ties go to
// the lowest face index, as the Pallas kernel's net rule does (lowest lane
// within a 128-face tile, strictly smaller d² across tiles).
//   What bounds it: FP32 throughput.  ~100 operations per (query, face) pair
//   and 2,048 × 800 × (3,199 + 3,872) ≈ 1.2·10¹⁰ pairs per BFM step; the
//   bytes (queries, vertices, cells) are a few MB.
//   Design: one thread per query, one block per (128-query tile, chain).
//   Faces stream through shared memory in tiles of 128 as SoA rows; the
//   block gathers each tile's corners itself from the vertex array (shared,
//   or one per chain) and the [F, 3] cells, so the [B, 9, Fp] triangle soup
//   of pack_triangles never exists in device memory.  Each thread keeps a
//   running (min, argmin) in registers and scans faces in ascending order
//   with a strict <.  The ragged last tile is masked instead of padded with
//   far triangles; that changes no result.  With cull set, the block
//   reduces the tile's corner AABB in shared memory (tile_bounds) and skips
//   the tile when no query of the block can beat its running best against
//   the box; results are the same as without.
//
// K8 icp_coarse_nearest_dot replaces _make_coarse_mxu_kernel /
// _coarse_mxu_call in the same file (reached through coarse_nearest_mxu, the
// reference's ICP_TPU_COARSE_MXU=1): the shortlist's coarse anchor in dot
// form, ids = argminᵥ ‖v‖² − 2q·v over one shared surface, with the table
// va = (−2x, −2y, −2z, ‖v‖²) per vertex (pack_points_aug).  The sum is
// s = ((qx·ax + qy·ay) + qz·az) + ‖v‖², each product and sum rounded on its
// own, ties to the lowest id (the Pallas kernel's net rule: lowest lane
// within a chunk, strictly smaller across chunks).
//   What bounds it: FP32 issue rate, 6 operations per (query, vertex) pair
//   (256 × 404 × 1,622 pairs = 1.0 GFLOP at the smoke's shapes, 0.015 ms at
//   67 TFLOP/s); bytes are tiny.  The TPU ran the product on the MXU at
//   HIGHEST precision; tensor-core TF32 or bf16 inputs here would hit the
//   anchor error the reference measured (2.3e2 mm², closest_point_pallas.py
//   :449-457), so the products stay in FP32 on the CUDA cores.
//   Design: as K3, one thread per query and one block per (128-query tile,
//   chain); the [V, 4] table is staged through shared memory as float4 in
//   tiles of min(V, 2,048) vertices (dynamic shared memory, so femur's 1,622
//   take 26 KB and not 32: shared memory is what limits the blocks an SM
//   holds) and every thread reads the same vertex at a time (a broadcast);
//   a running minimum with a strict < over ascending ids.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kNvThreads = 128;
constexpr int kNvChunk = 2048;
constexpr int kDotChunk = 2048;  // K8's most vertices per shared-memory tile (32 KB)
constexpr int kRefineWarps = 8;
constexpr int kDenseTile = 128;  // faces per tile and queries per block (TF, TP)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf32() { return __int_as_float(0x7f800000); }

__global__ void nearest_vertices_kernel(const float* __restrict__ q,
                                        const float* __restrict__ pts,
                                        int* __restrict__ ids, int p, int v,
                                        long long pts_batch_stride) {
  __shared__ float sv[kNvChunk * 3];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = qi < p;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qq = q + ((size_t)b * p + qi) * 3;
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }
  const float* pb = pts + (size_t)b * pts_batch_stride;
  float best = inf32();
  int best_id = 0;
  for (int lo = 0; lo < v; lo += kNvChunk) {
    const int n = min(kNvChunk, v - lo);
    __syncthreads();
    for (int t = threadIdx.x; t < n * 3; t += blockDim.x) sv[t] = pb[(size_t)lo * 3 + t];
    __syncthreads();
    if (active) {
      for (int u = 0; u < n; ++u) {
        const float dx = qx - sv[3 * u];
        const float dy = qy - sv[3 * u + 1];
        const float dz = qz - sv[3 * u + 2];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best) {
          best = d2;
          best_id = lo + u;
        }
      }
    }
  }
  if (active) ids[(size_t)b * p + qi] = best_id;
}

// K8: blockDim.x == kNvThreads queries of chain blockIdx.y
__global__ void coarse_nearest_dot_kernel(const float* __restrict__ q,
                                          const float* __restrict__ va,
                                          int* __restrict__ ids, int p, int v,
                                          int chunk) {
  extern __shared__ float4 sva[];  // chunk vertices
  const int b = blockIdx.y;
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = qi < p;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qq = q + ((size_t)b * p + qi) * 3;
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }
  float best = inf32();
  int best_id = 0;
  for (int lo = 0; lo < v; lo += chunk) {
    const int n = min(chunk, v - lo);
    __syncthreads();  // the previous tile is consumed
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float* row = va + (size_t)(lo + t) * 4;
      sva[t] = make_float4(row[0], row[1], row[2], row[3]);
    }
    __syncthreads();
    if (active) {
      for (int u = 0; u < n; ++u) {
        const float4 a = sva[u];
        const float s = ((qx * a.x + qy * a.y) + qz * a.z) + a.w;
        if (s < best) {
          best = s;
          best_id = lo + u;
        }
      }
    }
  }
  if (active) ids[(size_t)b * p + qi] = best_id;
}

__device__ __forceinline__ float safe_div(float num, float den) {
  return num / (fabsf(den) < 1e-30f ? 1.0f : den);
}

// jnp.clip(x, 0, 1): NaN stays NaN
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// _tile_dist2 (closest_point_pallas.py:58-119), term for term
__device__ __forceinline__ float point_tri_dist2(float qx, float qy, float qz, const float* c) {
  const float ax = c[0], ay = c[1], az = c[2];
  const float bx = c[3], by = c[4], bz = c[5];
  const float cx = c[6], cy = c[7], cz = c[8];
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float apx = qx - ax, apy = qy - ay, apz = qz - az;
  const float bpx = qx - bx, bpy = qy - by, bpz = qz - bz;
  const float cpx = qx - cx, cpy = qy - cy, cpz = qz - cz;

  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float d3 = abx * bpx + aby * bpy + abz * bpz;
  const float d4 = acx * bpx + acy * bpy + acz * bpz;
  const float d5 = abx * cpx + aby * cpy + abz * cpz;
  const float d6 = acx * cpx + acy * cpy + acz * cpz;

  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;

  const float denom = safe_div(1.0f, va + vb + vc);
  float v = vb * denom;
  float w = vc * denom;
  if (va <= 0.0f && (d4 - d3) >= 0.0f && (d5 - d6) >= 0.0f) {  // edge BC
    const float w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6));
    v = 1.0f - w_bc;
    w = w_bc;
  }
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {  // edge AC
    v = 0.0f;
    w = safe_div(d2, d2 - d6);
  }
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {  // edge AB
    v = safe_div(d1, d1 - d3);
    w = 0.0f;
  }
  if (d6 >= 0.0f && d5 <= d6) {  // vertex C
    v = 0.0f;
    w = 1.0f;
  }
  if (d3 >= 0.0f && d4 <= d3) {  // vertex B
    v = 1.0f;
    w = 0.0f;
  }
  if (d1 <= 0.0f && d2 <= 0.0f) {  // vertex A
    v = 0.0f;
    w = 0.0f;
  }
  v = clip01(v);
  w = clip01(w);
  const float s = v + w;
  const float scale = s > 1.0f ? 1.0f / fmaxf(s, 1e-30f) : 1.0f;
  v = v * scale;
  w = w * scale;
  const float dx = qx - ((ax + v * abx) + w * acx);
  const float dy = qy - ((ay + v * aby) + w * acy);
  const float dz = qz - ((az + v * abz) + w * acz);
  return dx * dx + dy * dy + dz * dz;
}

// lexicographic (d², face id, slot) order
__device__ __forceinline__ bool lex_less(float da, int fa, int ka, float db, int fb, int kb) {
  if (da < db) return true;
  if (da == db) return fa < fb || (fa == fb && ka < kb);
  return false;
}

__global__ void refine_shortlist_kernel(const float* __restrict__ q,
                                        const int* __restrict__ coarse,
                                        const int* __restrict__ cand,
                                        const float* __restrict__ cand_tri,
                                        int* __restrict__ fidx,
                                        float* __restrict__ wtri, long long n_queries,
                                        int v, int k) {
  const int lane = threadIdx.x & 31;
  const long long gq = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (gq >= n_queries) return;  // whole warps leave
  const float qx = q[gq * 3], qy = q[gq * 3 + 1], qz = q[gq * 3 + 2];
  // out-of-range rows clamp, as an XLA gather does
  const int row = min(max(coarse[gq], 0), v - 1);
  const int* crow = cand + (size_t)row * k;
  const float* trow = cand_tri + (size_t)row * 9 * k;

  float bd = inf32();
  int bf = INT_MAX, bk = INT_MAX;
  for (int s = lane; s < k; s += 32) {
    float c[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) c[i] = trow[i * k + s];
    const float d2 = point_tri_dist2(qx, qy, qz, c);
    const int f = crow[s];
    // the first slot is taken unconditionally so a NaN distance still
    // leaves a valid slot (the reference then picks slot 0, as lane 0 does)
    if (s == lane || lex_less(d2, f, s, bd, bf, bk)) {
      bd = d2;
      bf = f;
      bk = s;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, bd, off);
    const int of = __shfl_xor_sync(kFull, bf, off);
    const int ok = __shfl_xor_sync(kFull, bk, off);
    if (lex_less(od, of, ok, bd, bf, bk)) {
      bd = od;
      bf = of;
      bk = ok;
    }
  }
  bf = __shfl_sync(kFull, bf, 0);
  bk = __shfl_sync(kFull, bk, 0);
  if (lane == 0) fidx[gq] = bf;
  if (lane < 9) wtri[gq * 9 + lane] = trow[lane * k + bk];
}

// blockDim.x == kDenseTile: thread t stages face lo + t of each tile
__global__ void surface_distances_kernel(const float* __restrict__ q,
                                         long long q_batch_stride,
                                         const float* __restrict__ pts,
                                         long long pts_batch_stride,
                                         const int* __restrict__ cells,
                                         float* __restrict__ d2_out,
                                         int* __restrict__ idx_out, int p, int f,
                                         int cull) {
  __shared__ float st[9][kDenseTile];  // tile corners, SoA: ax ay az bx ... cz
  __shared__ float red[kDenseTile / 32][6];  // per-warp tile box (cull only)
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int qi = blockIdx.x * kDenseTile + t;
  const bool active = qi < p;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qq = q + (size_t)b * q_batch_stride + (size_t)qi * 3;
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }
  const float* pb = pts + (size_t)b * pts_batch_stride;
  float best = inf32();
  int best_id = 0;
  for (int lo = 0; lo < f; lo += kDenseTile) {
    const int n = min(kDenseTile, f - lo);
    __syncthreads();  // the previous tile is consumed
    if (t < n) {
      const int* cf = cells + (size_t)(lo + t) * 3;
#pragma unroll
      for (int corner = 0; corner < 3; ++corner) {
        const float* v = pb + (size_t)cf[corner] * 3;
        st[3 * corner][t] = v[0];
        st[3 * corner + 1][t] = v[1];
        st[3 * corner + 2][t] = v[2];
      }
    }
    __syncthreads();
    if (cull) {
      // the tile's box: each thread its face's corners, then a warp and a
      // block reduction; a thread without a face contributes an empty box
      float box[6];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        box[a] = t < n ? fminf(fminf(st[a][t], st[3 + a][t]), st[6 + a][t]) : inf32();
        box[3 + a] = t < n ? fmaxf(fmaxf(st[a][t], st[3 + a][t]), st[6 + a][t]) : -inf32();
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          box[a] = fminf(box[a], __shfl_xor_sync(kFull, box[a], off));
          box[3 + a] = fmaxf(box[3 + a], __shfl_xor_sync(kFull, box[3 + a], off));
        }
      }
      if ((t & 31) == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) red[t >> 5][a] = box[a];
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float lo_a = red[0][a], hi_a = red[0][3 + a];
        for (int w = 1; w < kDenseTile / 32; ++w) {
          lo_a = fminf(lo_a, red[w][a]);
          hi_a = fmaxf(hi_a, red[w][3 + a]);
        }
        box[a] = lo_a;
        box[3 + a] = hi_a;
      }
      // squared distance from the query to the box (tile_bounds' test)
      const float dx = fmaxf(fmaxf(box[0] - qx, qx - box[3]), 0.0f);
      const float dy = fmaxf(fmaxf(box[1] - qy, qy - box[4]), 0.0f);
      const float dz = fmaxf(fmaxf(box[2] - qz, qz - box[5]), 0.0f);
      const float lb2 = dx * dx + dy * dy + dz * dz;
      if (!__syncthreads_or(active && lb2 < best)) continue;  // block-uniform
    }
    if (active) {
      for (int u = 0; u < n; ++u) {
        float c[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) c[i] = st[i][u];
        const float d2 = point_tri_dist2(qx, qy, qz, c);
        if (d2 < best) {
          best = d2;
          best_id = lo + u;
        }
      }
    }
  }
  if (active) {
    d2_out[(size_t)b * p + qi] = best;
    idx_out[(size_t)b * p + qi] = best_id;
  }
}

}  // namespace

extern "C" {

int icp_nearest_vertices(const float* q, const float* pts, int* ids, int batch, int p,
                         int v, int pts_batched, void* stream) {
  if (batch == 0 || p == 0) return cudaSuccess;
  const dim3 grid((p + kNvThreads - 1) / kNvThreads, batch);
  const long long stride = pts_batched ? 3LL * v : 0LL;
  nearest_vertices_kernel<<<grid, kNvThreads, 0, (cudaStream_t)stream>>>(
      q, pts, ids, p, v, stride);
  return cudaGetLastError();
}

int icp_refine_shortlist(const float* q, const int* coarse, const int* cand,
                         const float* cand_tri, int* fidx, float* wtri, int n_queries,
                         int v, int k, void* stream) {
  if (n_queries == 0) return cudaSuccess;
  const int blocks = (n_queries + kRefineWarps - 1) / kRefineWarps;
  refine_shortlist_kernel<<<blocks, kRefineWarps * 32, 0, (cudaStream_t)stream>>>(
      q, coarse, cand, cand_tri, fidx, wtri, n_queries, v, k);
  return cudaGetLastError();
}

int icp_surface_distances(const float* q, const float* pts, const int* cells, float* d2,
                          int* idx, int batch, int p, int v, int f, int q_batched,
                          int pts_batched, int cull, void* stream) {
  if (batch == 0 || p == 0) return cudaSuccess;
  const dim3 grid((p + kDenseTile - 1) / kDenseTile, batch);
  surface_distances_kernel<<<grid, kDenseTile, 0, (cudaStream_t)stream>>>(
      q, q_batched ? 3LL * p : 0LL, pts, pts_batched ? 3LL * v : 0LL, cells, d2, idx,
      p, f, cull);
  return cudaGetLastError();
}

int icp_coarse_nearest_dot(const float* q, const float* va, int* ids, int batch, int p,
                           int v, void* stream) {
  if (batch == 0 || p == 0 || v == 0) return cudaSuccess;
  const dim3 grid((p + kNvThreads - 1) / kNvThreads, batch);
  const int chunk = v < kDotChunk ? v : kDotChunk;
  coarse_nearest_dot_kernel<<<grid, kNvThreads, chunk * sizeof(float4),
                              (cudaStream_t)stream>>>(q, va, ids, p, v, chunk);
  return cudaGetLastError();
}

}  // extern "C"
