// K3, K4, K5 and K8 of the port: the nearest vertex, the shortlist refine,
// the dense closest-point query and the dot-form coarse nearest vertex.
// Compiled with -fmad=false: the tie rules compare float32 squared distances
// for equality, so every product and sum rounds on its own, in the order the
// reference writes them, exactly as the plain PyTorch twins in
// ops/closest_point_cuda.py do.
//
// K3 icp_nearest_vertices replaces _make_nv_kernel / _nv_call in
// icp_proposal_tpu/ops/closest_point_pallas.py (reached through
// nearest_vertices_pallas): ids = argminᵥ ((dx·dx + dy·dy) + dz·dz), ties to
// the lowest id, a NaN d² never winning and a query with no finite d² taking
// id 0 (the Pallas kernel returns 2³⁰ there; ids stay in range here).  The
// vertex set is shared (the shortlist's coarse pass: 2,048 × 404 queries
// against 1,622 vertices on the femur step) or one per chain (the ICP target
// direction: 2,048 × 202 queries, each chain against its own 1,622).
//   What bounds it: instruction issue.  A pair takes 3 subtractions, 3
//   products and 2 sums that may not fuse (-fmad=false), 8 FP32 operations;
//   the bytes are a few MB.  So a pair must cost few instructions beyond
//   those 8: shared loads, compares and selects are what the design cuts,
//   with no idle lanes and no restaging of a vertex set.
//   Design: nearest_vertices_kernel<Pair, Q>, blocks of kNvWarps warps.
//   * A lane holds Q queries in registers; a vertex is staged as a float4
//     row, so one 16-byte broadcast (LDS.128) feeds Q pairs.
//   * A pair adds one fminf to its query's running minimum over a group of
//     kNvGroup = 32 vertices (fminf drops NaN); after the group, a minimum
//     strictly below the best so far records the group (an earlier group
//     keeps a tie).  At the end of a staged chunk each query whose best moved
//     rescans that one group, lowest id first, for the value: the operations
//     are the same, so they round the same.  9 issued instructions a pair
//     instead of 11, plus 1/Q of a load and the per-group bookkeeping.
//   * Shared set: the block stages it once (one chunk) and its warps walk
//     the flat list of B·P queries in units of 32·Q (kNvSharedQ), so no
//     chain leaves a ragged edge; unit b + grid·(w + kNvWarps·k) goes to warp
//     w of block b in round k, so a short last round spreads over all blocks.
//   * Per-chain sets: the fewest units of ≤ 32·kNvMaxQ queries that cover P,
//     with the least Q for them (P = 202: one unit, Q = 7: 224 lanes' worth
//     for 202 queries), and the block's warps scan slices of the chunk for
//     the same units; the slices merge by the least (d², id) in shared
//     memory, which is exact.  A block walks chains b, b + grid, ... and
//     stages the next chain's chunk with cp.async into a second buffer while
//     it scans the current one.  V beyond kNvChunk is scanned chunk by chunk
//     through the same two buffers (for a shared set too).
//   * Blocks: as many as the SMs hold at once (occupancy calculator), at most
//     one per item.  No tensor cores: TF32 or bf16 products change the ids
//     (closest_point_pallas.py:449-457).
//   The pair is a policy: EuclidPair here, DotPair for K8 below, each with
//   its own pad row and staging.
//
// K4 icp_refine_shortlist replaces _make_refine_kernel / _refine_call in the
// same file (reached through refine_shortlist_pallas): the exact Ericson
// point→triangle cascade (_tile_dist2, closest_point_pallas.py:58-119, same
// operation order, _safe_div included) over the K candidate faces of each
// query's coarse vertex; the winner is the least d², then the smallest face
// id, then the lowest candidate slot, and a NaN d² in any slot makes slot 0
// the winner (jnp.min in the reference propagates the NaN, so no slot ties
// with it and every tied face id is 2³⁰).
//   What bounds it: the cascade's instruction issue, once the rows are near.
//   The TPU path pregathers the [B, P, 9K] candidate corners
//   (surface_index.py:202-203).  Read per shortlist slot from a [V, 9K]
//   table, a query pulls 2,560 B through L2 (2.1 GB a call at 2,048 × 404
//   queries), though those are the same ~1,600 rows read ~500 times each:
//   the table holds each face's corners K times over.  The faces themselves
//   (3,240 on the femur target) take 155 KB as three float4 rows a face,
//   which fits the L1 of an SM that uses no shared memory.  The cascade
//   (-fmad=false, IEEE division) then issues ~250 instructions a pair on
//   sm_90a (kernel_turns.py --sass), about 15 for each of its five
//   divisions, and that issue rate is what an H100 runs K4 at.
//   Design: refine_shortlist_kernel.
//   * The kernel reads the query's cand row (K ids) and each candidate's
//     corners from the face table [F, 12] by face id, through the
//     read-only path (ld.global.nc), with the shared-memory carve-out at its
//     minimum so that L1 holds the table; ~300 B a query from L2.  Nothing
//     limits F: a larger surface only misses in L1 more often.
//   * kRefineLanes lanes a query (slots l, l + L, ...), so a lane runs
//     several cascades and the merge takes log₂ L shuffle levels.  Each lane
//     issues the next slot's corners and the slot after's face id before
//     the current cascade, so the loads overlap the arithmetic, through two
//     register buffers that alternate, so no corners are copied.
//   * The merge: a lane keeps the least (d², face id, slot) of its non-NaN
//     slots, a total order, so any lane mapping gives the same winner; a
//     warp vote on "some slot was NaN" replaces it by slot 0.
//   * The table is (a, b, c) in three float4 rows a face; corners 0..8 of
//     the winner's row are its corners (wtri).  A fourth row with the edges
//     b − a and c − a saves 6 subtractions a pair but no longer fits L1 and
//     was slower.
//   kRefineLanes (and K8's kDotQ) were chosen by timing builds that override
//   them with -D (kernel_turns.py --probe).
//
// K5 icp_surface_distances replaces _make_kernel / _dist2_call in the same
// file (reached through surface_distances_pallas, pack_triangles and
// tile_bounds): the point→triangle min d² and argmin face of every query
// over every face, with the same Ericson cascade as K4.  The winner is the
// least d², then the lowest face index (the Pallas kernel's net rule: lowest
// lane within a 128-face tile, strictly smaller d² across tiles); a NaN d²
// never wins, so a NaN query gets (+inf, face 0).
//   What bounds it: instruction issue on the pairs it runs the cascade on.
//   The cascade issues 233 instructions a pair on sm_90a in the lanes' own
//   loop below and 324 in the packed rounds, shuffles and merge included
//   (-fmad=false and five IEEE divisions; kernel_turns.py --k5 --sass reads
//   them from the SASS; K4's loop issues 249), and a dense scan of a BFM
//   step is 2,048 × 800 × (3,202 + 3,872) ≈ 1.16·10¹⁰ pairs; the bytes
//   (queries, vertices, cells) are a few MB.  So the lever is the number of
//   cascades: most faces lie far from a given query.
//   Design: exact nearest-first tile culling per warp, then a per-face test
//   inside each visited tile.
//   * A pre-pass (tile_boxes_kernel) computes the corner AABB of each tile
//     of 32 consecutive faces once per surface (once per call for a shared
//     surface, once per chain for per-chain surfaces, gathered through
//     cells: no triangle soup) and the largest vertex norm the box can hold.
//     The tile is 32 faces and not the reference's 128: on the face
//     stand-in (a sphere less a cap) 128-face boxes left ~40 % of the
//     (query, face) pairs to evaluate and 32-face boxes ~20 %, counted by a
//     float32 replay of this kernel's visit logic on the CPU; the ranking
//     then covers 101 or 121 tiles, four keys a lane.
//   * Each warp is one unit of work: 32 consecutive queries (Morton-sorted
//     on the BFM path, so a compact patch).  It computes the distance from
//     its queries' AABB to every tile box and visits the tiles nearest
//     first, by repeated warp argmin over those keys in its own slice of
//     shared memory.
//   * A tile is skipped when no lane's own box distance lb² is within its
//     running best plus the skip margin (__any_sync); the warp stops when
//     the nearest remaining key exceeds every lane's best plus margin (a
//     query's lb² is never below its warp's key: rounding is monotone).  No
//     block barrier anywhere: warps of a block run apart.
//   * A visited tile's faces pass through the warp's own 3 KB of shared
//     memory, one face per lane, as a, b, c, ab = b − a, ac = c − a (the
//     same subtractions as in the cascade, done once per face instead of
//     once per pair, so bitwise the same) and the face's own corner box, in
//     six float4 rows of 32 faces (row k of face u at k·32 + u, so lanes
//     reading different faces rarely share a bank); beside it 4 KB of
//     scratch a warp.  The gather (cells, then corners) of the tile to
//     consider next is issued into registers before the current tile is
//     evaluated, so its latency overlaps the arithmetic; when that tile is
//     then skipped, the gather is wasted and the next visit gathers anew.
//     Registers and not cp.async, because ab, ac and the box are formed
//     from the corners before they are stored.
//   * Inside a visited tile each lane tests every face's box against its
//     query with the tile test's box_dist2 and the threshold from before
//     the tile (a superset of what could still win): bit u of its mask is
//     set where lb² ≤ best + margin, and the lb² go to the warp's scratch.
//     Where over 32 pairs survive (always in the first tile, whose
//     thresholds are +inf), each lane first runs the cascade on its own
//     nearest kept face, then keeps only the faces whose lb² are within its
//     new best plus the margin: one round that usually leaves a few faces a
//     query where it kept the whole tile.  The surviving pairs are numbered
//     by a warp prefix sum over the masks' popcounts and listed in the
//     scratch, by lane, then face; rounds of 32 run one pair a lane (the
//     query's coordinates by shuffle), and a segmented shuffle min over
//     each run of one query's pairs hands the run's least (d², id) to the
//     query's lane.  Where those rounds would not be fewer than 4/5 of the
//     most faces one lane kept, each lane runs its own kept faces in turn
//     instead, which needs no shuffles and never takes more rounds than the
//     faces any lane kept.  The choice follows the observed counts, so a
//     query about equally far from every face (the centre of a sphere)
//     pays the tests and nothing more: it runs no more cascades than the
//     dense scan.
//   * Any visit or evaluation order gives the dense result because a face
//     wins on d² < best || (d² == best && id < best_id), a total order on
//     the non-NaN d², and a NaN d² never wins.
//   Skip margin: skip when lb² > best + 2⁻¹⁷·(‖q‖ + maxᵥ‖v‖)² + 2⁻¹²⁶.  With
//   u = 2⁻²⁴ and M the largest vertex norm, every product and sum rounded on
//   its own (-fmad=false): ab, ac and the closest point a + v·ab + w·ac are
//   each within ~20uM per coordinate of a point of the triangle (v, w
//   clipped, v + w ≤ 1 + 3u), so within 35uM of the tile box; the cascade's
//   final d² is at least (1 − 5u) of the squared distance of its computed
//   point, and the computed lb² at most (1 + 5u) of the true one.  Hence a
//   computed d² ≥ lb² − 81u·(‖q‖ + M)², while the margin is 128u·(‖q‖ + M)²:
//   a skipped tile holds no face whose d² could reach the running best,
//   ties included.  The same holds for one face's own corner box: the
//   triangle lies in it and its corners' norms are at most the warp's
//   largest, so a face whose lb² exceeds best + margin is skipped exactly
//   (a face with a NaN or infinite corner has a NaN or infinite d² and
//   never wins, whatever its box).  The 2⁻¹²⁶ term covers the absolute
//   rounding of subnormal results.  cull = 0 visits every tile in ascending
//   order (the dense scan the checks compare the culled kernel with).
//
// K8 icp_coarse_nearest_dot replaces _make_coarse_mxu_kernel /
// _coarse_mxu_call in the same file (reached through coarse_nearest_mxu, the
// reference's ICP_TPU_COARSE_MXU=1): the shortlist's coarse anchor in dot
// form, ids = argminᵥ ‖v‖² − 2q·v over one shared surface, with the table
// va = (−2x, −2y, −2z, ‖v‖²) per vertex (pack_points_aug).  The sum is
// s = ((qx·ax + qy·ay) + qz·az) + ‖v‖², each product and sum rounded on its
// own, ties to the lowest id (the Pallas kernel's net rule: lowest lane
// within a chunk, strictly smaller across chunks).
//   A NaN s never wins and a query with no finite s gets id 0, as in K3.
//   What bounds it: instruction issue, 6 FP32 operations per (query,
//   vertex) pair that may not fuse (2,048 × 404 × 1,622 = 1.34·10⁹ pairs a
//   call on the femur path); bytes are tiny.  The TPU ran the product on the
//   MXU at HIGHEST precision; tensor-core TF32 or bf16 inputs here would hit
//   the anchor error the reference measured (2.3e2 mm², closest_point_pallas
//   .py:449-457), so the products stay in FP32 on the CUDA cores.
//   Design: K3's scan in its shared mode with the pair DotPair,
//   nearest_vertices_kernel<DotPair, kDotQ>: the [V, 4] rows staged with one
//   16-byte cp.async a row, pad rows (0, 0, 0, +inf), Q queries a lane, one
//   LDS.128 feeding Q pairs of 6 operations and one fminf, group minima and
//   a rescan of the winning group (the same operations, so the same
//   rounding and the ids of a strict < over ascending ids), over the flat
//   list of B·P queries (no limit on B).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <map>
#include <mutex>
#include <utility>

// the defaults of two launch choices, which kernel_turns.py --probe
// overrides with -D in builds of its own
#ifndef ICP_DOT_Q
#define ICP_DOT_Q 4
#endif
#ifndef ICP_REFINE_LANES
#define ICP_REFINE_LANES 4
#endif

namespace {

constexpr int kNvWarps = 8;      // K3: warps per block
constexpr int kNvGroup = 32;     // K3: vertices per running-minimum group
constexpr int kNvChunk = 2048;   // K3: most vertices per staged chunk (32 KB as float4)
constexpr int kNvMaxQ = 8;       // K3: most queries a lane holds
constexpr int kNvSharedQ = 4;    // K3: queries a lane holds for a shared vertex set
constexpr int kDotQ = ICP_DOT_Q;  // K8: queries a lane holds (shared set only)
constexpr int kRefineWarps = 8;  // K4: warps per block
constexpr int kRefineLanes = ICP_REFINE_LANES;  // K4: lanes per query, a power of 2
constexpr int kTileFaces = 32;   // K5: faces per culling tile, one per lane
constexpr int kCpWarps = 4;      // K5: warps per block, 32 queries each
constexpr int kStageRows = 6;    // K5: float4 rows a staged face (a b c ab ac, box)
constexpr int kPairSlots = 32 * kTileFaces;  // K5: most surviving pairs a tile
constexpr int kScratchFloats = 32 * (kTileFaces + 1);  // K5: a warp's lb², then its pairs
static_assert(kScratchFloats * sizeof(float) >= kPairSlots * sizeof(unsigned short),
              "the pair list fits where the lb² were");
constexpr float kSkipScale = 7.62939453125e-06f;  // K5 skip margin: 2⁻¹⁷
constexpr float kSkipFloor = 1.17549435e-38f;     // and 2⁻¹²⁶
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float inf32() { return __int_as_float(0x7f800000); }

// The scan below takes the pair as a policy: its value from a vertex staged
// as a float4 row, every product and sum rounded on its own (-fmad=false);
// a padding row whose value is +inf (or NaN) for every query, so it never
// wins; and the floats a source row holds (kWidth).
// K3: ((dx·dx + dy·dy) + dz·dz) from rows (x, y, z) of [V, 3].
struct EuclidPair {
  static constexpr int kWidth = 3;
  __device__ static float eval(float qx, float qy, float qz, float4 v) {
    const float dx = qx - v.x, dy = qy - v.y, dz = qz - v.z;
    return dx * dx + dy * dy + dz * dz;
  }
  __device__ static float4 pad() { return make_float4(inf32(), inf32(), inf32(), 0.0f); }
};
// K8: ((qx·ax + qy·ay) + qz·az) + ‖v‖² from rows (−2x, −2y, −2z, ‖v‖²) of
// [V, 4]
struct DotPair {
  static constexpr int kWidth = 4;
  __device__ static float eval(float qx, float qy, float qz, float4 v) {
    return ((qx * v.x + qy * v.y) + qz * v.z) + v.w;
  }
  __device__ static float4 pad() { return make_float4(0.0f, 0.0f, 0.0f, inf32()); }
};

// K3 launch parameters (nv_configure fills them)
struct NvParams {
  const float* q;    // [B·P, 3]
  const float* pts;  // [V, W] or [B, V, W], W = Pair::kWidth
  int* ids;          // [B·P]
  int batch, p, v;
  int per_chain;     // one vertex set per chain
  int resident;      // shared set in one chunk: staged once per block
  int chunk;         // vertices per staged chunk, a multiple of kNvGroup
  int n_chunks;
  long long units;   // warp units of 32·Q queries: in all (shared) or per chain
  int uw;            // per chain: units an item covers
  int slices;        // per chain: warps that split a chunk for the same unit
  int items_per_chain;
  long long n_items;  // per chain: batch · items_per_chain
};

__device__ __forceinline__ void cp_async4(unsigned smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// one staged row as a single 16-byte shared load (LDS.128) from its
// shared-space address; through a generic pointer, with w unused, the
// compiler emitted two generic loads a row
__device__ __forceinline__ float4 lds128(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// the block copies vertices [0, n) of src ([n, kWidth]) into the float4 rows
// at shared address dst (generic dstp) and pads the rows up to the next
// kNvGroup with pad rows.  Rows of 3 floats take one 4-byte cp.async a
// float (a 16-byte copy would be misaligned); rows of 4 (16-byte aligned,
// which the wrapper checks) one 16-byte cp.async a row.
template <class Pair>
__device__ __forceinline__ void nv_stage(unsigned dst, float4* dstp, const float* src,
                                         int n) {
  if constexpr (Pair::kWidth == 4) {
    for (int row = threadIdx.x; row < n; row += blockDim.x)
      cp_async16(dst + 16 * row, src + 4 * row);
  } else {
    for (int e = threadIdx.x; e < 3 * n; e += blockDim.x) {
      const int row = e / 3;
      cp_async4(dst + 16 * row + 4 * (e - 3 * row), src + e);
    }
  }
  const int n_pad = (n + kNvGroup - 1) / kNvGroup * kNvGroup;
  for (int row = n + threadIdx.x; row < n_pad; row += blockDim.x) dstp[row] = Pair::pad();
}

// One warp's scan of groups [g0, g1) of the staged chunk at shared address
// sv for the Q queries a lane holds.  Per pair: the pair value and one
// fminf into the group's running minimum m (fminf drops a NaN).  Per group
// and query: when m is below best (strict: an earlier group keeps a tie),
// best = m and bg = the group.  The id is found later by rescanning group
// bg.
template <class Pair, int Q>
__device__ __forceinline__ void nv_scan(unsigned sv, int g0, int g1, const float (&qx)[Q],
                                        const float (&qy)[Q], const float (&qz)[Q],
                                        float (&best)[Q], int (&bg)[Q]) {
  for (int g = g0; g < g1; ++g) {
    const unsigned row = sv + g * kNvGroup * 16;
    float m[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) m[k] = inf32();
#pragma unroll 16
    for (int u = 0; u < kNvGroup; ++u) {
      const float4 vv = lds128(row + 16 * u);  // one broadcast feeds Q pairs
#pragma unroll
      for (int k = 0; k < Q; ++k) m[k] = fminf(m[k], Pair::eval(qx[k], qy[k], qz[k], vv));
    }
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (m[k] < best[k]) {
        best[k] = m[k];
        bg[k] = g;
      }
    }
  }
}

// The lowest u with value == best in group g of the chunk at sv: the value
// is recomputed with the same operations, so it rounds the same
template <class Pair>
__device__ __forceinline__ int nv_rescan(unsigned sv, int g, float qx, float qy, float qz,
                                         float best) {
  const unsigned row = sv + g * kNvGroup * 16;
  int hit = 0;
#pragma unroll 4
  for (int u = kNvGroup - 1; u >= 0; --u)
    hit = Pair::eval(qx, qy, qz, lds128(row + 16 * u)) == best ? u : hit;
  return hit;
}

// K3: blockDim.x == kNvWarps·32.  The block walks its items b, b + grid,
// ...  For a shared vertex set an item is kNvWarps warp units of 32·Q
// queries of the flat list of B·P queries (warp w of the block's k-th item
// takes unit b + grid·(w + kNvWarps·k), so a short last round spreads over
// all blocks); each lane keeps its queries' best across chunks and rescans
// in its own registers.  For per-chain sets an item is up to uw units of one
// chain; with slices > 1 the block's warps split every chunk for the same
// units, merge the slices' (group minimum, group) by the least value in
// shared memory (a lower slice keeps a tie: its groups come first), and one
// thread per query rescans the winning group and keeps the best across
// chunks in shared memory.
template <class Pair, int Q>
__global__ void __launch_bounds__(kNvWarps * 32) nearest_vertices_kernel(NvParams a) {
  extern __shared__ float4 nv_smem[];
  constexpr int kSlot = 32 * Q;  // queries of one unit
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = blockIdx.x, grid = gridDim.x;
  const unsigned smem = (unsigned)__cvta_generic_to_shared(nv_smem);
  // behind the chunk buffers (one resident, else two): [warps][kSlot] each
  float* md = reinterpret_cast<float*>(nv_smem + (a.resident ? 1 : 2) * a.chunk);
  int* mg = reinterpret_cast<int*>(md + kNvWarps * kSlot);
  float* cb = reinterpret_cast<float*>(mg + kNvWarps * kSlot);  // [uw·kSlot]
  int* ci = reinterpret_cast<int*>(cb + a.uw * kSlot);          // [uw·kSlot]
  long long n_mine;  // this block's items (the same for all its threads)
  if (a.per_chain) {
    n_mine = a.n_items > b ? (a.n_items - b + grid - 1) / grid : 0;
  } else {
    const long long stride = grid * kNvWarps;
    n_mine = a.units > b ? (a.units - b + stride - 1) / stride : 0;
  }
  const long long n_steps = n_mine * a.n_chunks;
  if (n_steps == 0) return;  // the whole block leaves
  auto stage = [&](long long step) {  // the chunk of `step` into buffer step & 1
    const long long k = step / a.n_chunks;
    const int lo = (int)(step - k * a.n_chunks) * a.chunk;
    constexpr long long w = Pair::kWidth;
    const float* src =
        a.per_chain ? a.pts + (b + grid * k) / a.items_per_chain * w * a.v : a.pts;
    const int buf = (int)(step & 1) * a.chunk;
    nv_stage<Pair>(smem + 16 * buf, nv_smem + buf, src + w * lo, min(a.chunk, a.v - lo));
  };
  stage(0);
  cp_async_commit();
  if (a.resident) {
    cp_async_wait<0>();
    __syncthreads();
  }
  const bool merged = a.slices > 1;
  long long step = 0;
  for (long long k = 0; k < n_mine; ++k) {
    // this warp's queries in item k: flat ids qbase + lane + 32·j (j < Q)
    // below qend, and the slice of each chunk it scans
    long long qbase, qend, chain = 0, ubase = 0;
    int slice = 0;
    bool valid;
    if (a.per_chain) {
      const long long it = b + grid * k;
      chain = it / a.items_per_chain;
      ubase = (it - chain * a.items_per_chain) * a.uw;
      slice = warp / a.uw;
      const long long unit = ubase + warp % a.uw;
      valid = slice < a.slices && unit < a.units;
      qbase = chain * a.p + unit * kSlot;
      qend = chain * a.p + a.p;
    } else {
      const long long unit = b + grid * (warp + kNvWarps * k);
      valid = unit < a.units;
      qbase = unit * kSlot;
      qend = (long long)a.batch * a.p;
    }
    float qx[Q], qy[Q], qz[Q], best[Q];
    int bid[Q], bg[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const long long qi = qbase + lane + 32 * j;
      const bool ok = valid && qi < qend;
      qx[j] = ok ? __ldg(a.q + qi * 3) : 0.0f;
      qy[j] = ok ? __ldg(a.q + qi * 3 + 1) : 0.0f;
      qz[j] = ok ? __ldg(a.q + qi * 3 + 2) : 0.0f;
      best[j] = inf32();
      bid[j] = 0;  // no finite value: id 0
      bg[j] = -1;
    }
    if (merged) {
      for (int t = threadIdx.x; t < a.uw * kSlot; t += blockDim.x) {
        cb[t] = inf32();
        ci[t] = 0;
      }
    }
    for (int c = 0; c < a.n_chunks; ++c, ++step) {
      unsigned sv = smem;
      if (!a.resident) {
        if (step + 1 < n_steps) stage(step + 1);  // overlaps this step's scan
        cp_async_commit();
        cp_async_wait<1>();  // this step's chunk has landed
        __syncthreads();
        sv = smem + 16 * (unsigned)((step & 1) * a.chunk);
      }
      const int lo = c * a.chunk;
      const int n_groups = (min(a.chunk, a.v - lo) + kNvGroup - 1) / kNvGroup;
      const bool last = c == a.n_chunks - 1;
      if (!merged) {
        if (valid) {
          nv_scan<Pair, Q>(sv, 0, n_groups, qx, qy, qz, best, bg);
#pragma unroll
          for (int j = 0; j < Q; ++j) {
            if (bg[j] >= 0) {  // the best moved in this chunk
              bid[j] = lo + bg[j] * kNvGroup +
                       nv_rescan<Pair>(sv, bg[j], qx[j], qy[j], qz[j], best[j]);
              bg[j] = -1;
            }
            const long long qi = qbase + lane + 32 * j;
            if (last && qi < qend) a.ids[qi] = bid[j];
          }
        }
      } else {
        // this slice's least value and its group in the chunk, per query
        if (valid) {
#pragma unroll
          for (int j = 0; j < Q; ++j) best[j] = inf32(), bg[j] = -1;
          nv_scan<Pair, Q>(sv, slice * n_groups / a.slices, (slice + 1) * n_groups / a.slices,
                           qx, qy, qz, best, bg);
        }
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          md[warp * kSlot + 32 * j + lane] = best[j];
          mg[warp * kSlot + 32 * j + lane] = bg[j];
        }
        __syncthreads();
        for (int t = threadIdx.x; t < a.uw * kSlot; t += blockDim.x) {
          const int ul = t / kSlot, o = t - ul * kSlot;
          const long long qoff = (ubase + ul) * kSlot + o;
          if (ubase + ul >= a.units || qoff >= a.p) continue;
          float val = inf32();
          int g = -1;
          for (int sl = 0; sl < a.slices; ++sl) {
            const float vs = md[(sl * a.uw + ul) * kSlot + o];
            if (vs < val) {
              val = vs;
              g = mg[(sl * a.uw + ul) * kSlot + o];
            }
          }
          if (val < cb[t]) {  // strict: an earlier chunk keeps a tie
            const float* qq = a.q + (chain * a.p + qoff) * 3;
            cb[t] = val;
            ci[t] = lo + g * kNvGroup +
                    nv_rescan<Pair>(sv, g, __ldg(qq), __ldg(qq + 1), __ldg(qq + 2), val);
          }
          if (last) a.ids[chain * a.p + qoff] = ci[t];
        }
      }
      if (!a.resident) __syncthreads();  // the buffer and the merge area are free again
    }
  }
}

__device__ __forceinline__ float safe_div(float num, float den) {
  return num / (fabsf(den) < 1e-30f ? 1.0f : den);
}

// jnp.clip(x, 0, 1): NaN stays NaN
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// _tile_dist2 (closest_point_pallas.py:58-119), term for term, with the
// edges ab = b − a and ac = c − a given
__device__ __forceinline__ float point_tri_dist2_edges(float qx, float qy, float qz,
                                                       float ax, float ay, float az,
                                                       float bx, float by, float bz,
                                                       float cx, float cy, float cz,
                                                       float abx, float aby, float abz,
                                                       float acx, float acy, float acz) {
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

// (d², face id) order.  The reference's third key, the lowest slot, never
// changes the result here: slots of one face read the same table row, so
// they have the same d² and the same corners.
__device__ __forceinline__ bool lex_less(float da, int fa, float db, int fb) {
  return da < db || (da == db && fa < fb);
}

constexpr int kFaceRows = 3;  // K4: float4 rows a face in the table

// the rows of face f of the table (out-of-range ids clamp, as an XLA gather
// does), through the read-only path
__device__ __forceinline__ void load_face(float4 (&r)[kFaceRows], const float4* faces, int f,
                                          int n_faces) {
  const float4* p = faces + (size_t)min(max(f, 0), n_faces - 1) * kFaceRows;
#pragma unroll
  for (int i = 0; i < kFaceRows; ++i) r[i] = __ldg(p + i);
}

// d² from a query to the face held as (ax ay az bx)(by bz cx cy)(cz · · ·),
// the edges formed here as in _tile_dist2
__device__ __forceinline__ float face_dist2(float qx, float qy, float qz,
                                            const float4 (&r)[kFaceRows]) {
  const float ax = r[0].x, ay = r[0].y, az = r[0].z, bx = r[0].w, by = r[1].x;
  const float bz = r[1].y, cx = r[1].z, cy = r[1].w, cz = r[2].x;
  return point_tri_dist2_edges(qx, qy, qz, ax, ay, az, bx, by, bz, cx, cy, cz, bx - ax,
                               by - ay, bz - az, cx - ax, cy - ay, cz - az);
}

// K4: blockDim.x == kRefineWarps·32; lanes [L·g, L·g + L) of the warps in
// order take query g, lane j of a group the slots j, j + L, ... < k
// (L = kRefineLanes).
__global__ void __launch_bounds__(kRefineWarps * 32)
    refine_shortlist_kernel(const float* __restrict__ q, const int* __restrict__ coarse,
                            const int* __restrict__ cand, const float4* __restrict__ faces,
                            int* __restrict__ fidx, float* __restrict__ wtri,
                            long long n_queries, int v, int n_faces, int k) {
  constexpr int L = kRefineLanes;
  static_assert(L >= 1 && L <= 32 && (L & (L - 1)) == 0, "a group is an aligned part of a warp");
  constexpr unsigned kGroupBits = L == 32 ? kFull : (1u << (L % 32)) - 1u;
  const int lane = threadIdx.x & 31, j = lane & (L - 1);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((t - lane) / L >= n_queries) return;  // whole warps leave
  const long long gq = t / L;
  const bool active = gq < n_queries;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  const int* crow = cand;
  int n_mine = 0;  // this lane's slots
  if (active) {
    qx = __ldg(q + 3 * gq);
    qy = __ldg(q + 3 * gq + 1);
    qz = __ldg(q + 3 * gq + 2);
    // out-of-range rows clamp, as an XLA gather does
    crow = cand + (size_t)min(max(__ldg(coarse + gq), 0), v - 1) * k;
    n_mine = j < k ? (k - 1 - j) / L + 1 : 0;
  }
  float bd = inf32();
  int bf = INT_MAX;
  bool nan_seen = false;
  auto take = [&](float d2, int f) {
    if (isnan(d2)) {
      nan_seen = true;
    } else if (lex_less(d2, f, bd, bf)) {
      bd = d2;
      bf = f;
    }
  };
  // two slots a turn through two register buffers, so no corners are
  // copied: slot i + 1's corners and slot i + 2's face id load during slot
  // i's cascade, slot i + 2's corners and slot i + 3's face id during slot
  // i + 1's
  float4 ra[kFaceRows], rb[kFaceRows];
  int fa = n_mine > 0 ? __ldg(crow + j) : 0;      // the face of slot i
  int fb = n_mine > 1 ? __ldg(crow + j + L) : 0;  // of slot i + 1
  if (n_mine > 0) load_face(ra, faces, fa, n_faces);
  for (int i = 0; i < n_mine; i += 2) {
    if (i + 1 < n_mine) load_face(rb, faces, fb, n_faces);
    const int fc = i + 2 < n_mine ? __ldg(crow + j + (i + 2) * L) : 0;
    take(face_dist2(qx, qy, qz, ra), fa);
    if (i + 1 == n_mine) break;
    if (i + 2 < n_mine) load_face(ra, faces, fc, n_faces);
    const int fd = i + 3 < n_mine ? __ldg(crow + j + (i + 3) * L) : 0;
    take(face_dist2(qx, qy, qz, rb), fb);
    fa = fc;
    fb = fd;
  }
  // the least (d², face id) over the group: xor partners below L stay in it
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, bd, off);
    const int of = __shfl_xor_sync(kFull, bf, off);
    if (lex_less(od, of, bd, bf)) {
      bd = od;
      bf = of;
    }
  }
  // a NaN d² in any slot of the query: slot 0 wins, as in the reference
  if (__ballot_sync(kFull, nan_seen) & (kGroupBits << (lane & ~(L - 1)))) bf = __ldg(crow);
  if (!active) return;
  if (j == 0) fidx[gq] = bf;
  const float* row =
      reinterpret_cast<const float*>(faces + (size_t)min(max(bf, 0), n_faces - 1) * kFaceRows);
  for (int e = j; e < 9; e += L) wtri[gq * 9 + e] = __ldg(row + e);
}

// K5 pre-pass: blockDim.x == kCpWarps·32, warp w of block x computes tile
// x·kCpWarps + w of surface blockIdx.y (lane l its face l):
// boxes[s, tile] = (lo x y z, hi x y z, the norm of the box's farthest
// corner from the origin (≥ every vertex norm in it), 0).  A tile whose
// corners are all NaN gets the empty box (+inf, −inf) and norm +inf.
__global__ void tile_boxes_kernel(const float* __restrict__ pts, long long pts_batch_stride,
                                  const int* __restrict__ cells, int f, int n_tiles,
                                  float* __restrict__ boxes) {
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kCpWarps + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;  // whole warps leave
  const int face = tile * kTileFaces + lane;
  const float* pb = pts + (size_t)blockIdx.y * pts_batch_stride;
  float box[6] = {inf32(), inf32(), inf32(), -inf32(), -inf32(), -inf32()};
  if (face < f) {
#pragma unroll
    for (int corner = 0; corner < 3; ++corner) {
      const float* v = pb + (size_t)cells[(size_t)face * 3 + corner] * 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        box[a] = fminf(box[a], v[a]);
        box[3 + a] = fmaxf(box[3 + a], v[a]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], __shfl_xor_sync(kFull, box[a], off));
      box[3 + a] = fmaxf(box[3 + a], __shfl_xor_sync(kFull, box[3 + a], off));
    }
  }
  if (lane == 0) {
    float* out = boxes + ((size_t)blockIdx.y * n_tiles + tile) * 8;
    float m2 = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      out[a] = box[a];
      out[3 + a] = box[3 + a];
      const float m = fmaxf(fabsf(box[a]), fabsf(box[3 + a]));
      m2 = m2 + m * m;
    }
    out[6] = sqrtf(m2);
    out[7] = 0.0f;
  }
}

// the squared distance from a box lo..hi (a point: lo == hi) to the box
// bx[0..5]; fmaxf(·, 0) maps a NaN difference to 0, so it is never NaN
__device__ __forceinline__ float box_dist2(const float* bx, float lx, float ly, float lz,
                                           float hx, float hy, float hz) {
  const float gx = fmaxf(fmaxf(bx[0] - hx, lx - bx[3]), 0.0f);
  const float gy = fmaxf(fmaxf(bx[1] - hy, ly - bx[4]), 0.0f);
  const float gz = fmaxf(fmaxf(bx[2] - hz, lz - bx[5]), 0.0f);
  return gx * gx + gy * gy + gz * gz;
}

// the corners of face `face` (zeros where !ok)
__device__ __forceinline__ void gather_face(float (&g)[9], const float* pb,
                                            const int* cells, int face, bool ok) {
  if (ok) {
    const int* cf = cells + (size_t)face * 3;
    const int i0 = cf[0], i1 = cf[1], i2 = cf[2];
    const float* a = pb + (size_t)i0 * 3;
    const float* b = pb + (size_t)i1 * 3;
    const float* c = pb + (size_t)i2 * 3;
    g[0] = a[0]; g[1] = a[1]; g[2] = a[2];
    g[3] = b[0]; g[4] = b[1]; g[5] = b[2];
    g[6] = c[0]; g[7] = c[1]; g[8] = c[2];
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) g[i] = 0.0f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// the nearest tile not yet taken: the least (key, tile) over keys[0, n),
// NaN marking a taken tile; the same on every lane; tile INT_MAX when none
__device__ __forceinline__ int nearest_tile(const float* keys, int n, int lane,
                                            float& key) {
  int tile = INT_MAX;
  key = 0.0f;
  for (int t = lane; t < n; t += 32) {
    const float k = keys[t];
    if (!isnan(k) && (tile == INT_MAX || k < key)) {
      key = k;
      tile = t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ok = __shfl_xor_sync(kFull, key, off);
    const int ot = __shfl_xor_sync(kFull, tile, off);
    if (ot != INT_MAX && (tile == INT_MAX || ok < key || (ok == key && ot < tile))) {
      key = ok;
      tile = ot;
    }
  }
  return tile;
}

// K5: blockDim.x == kCpWarps·32, warp w of block x takes queries
// (x·kCpWarps + w)·32 .. +31 of chain blockIdx.y.  boxes == nullptr: the
// dense scan.  visits, when given, gains (active queries × tiles visited,
// active queries × faces visited, (active query, face) pairs the cascade
// ran on) per warp.
__global__ void __launch_bounds__(kCpWarps * 32)
    surface_distances_kernel(const float* __restrict__ q, long long q_batch_stride,
                             const float* __restrict__ pts, long long pts_batch_stride,
                             const int* __restrict__ cells,
                             const float* __restrict__ boxes, long long boxes_batch_stride,
                             float* __restrict__ d2_out, int* __restrict__ idx_out, int p,
                             int f, int n_tiles, unsigned long long* __restrict__ visits) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * kCpWarps + warp) * 32;
  if (q0 >= p) return;  // whole warps leave; nothing synchronises the block
  // a tile as rows (a, b.x) (b.y b.z, c.x c.y) (c.z, ab) (ac, ·) (lo, hi.x)
  // (hi.y hi.z, · ·): row k of face u at stage[k·32 + u]
  float4* stage = smem4 + warp * kStageRows * kTileFaces;
  // the lb² of the faces each lane keeps (row lane, padded against bank
  // conflicts), then in the same place the packed pairs, (lane << 5) | face
  float* const scratch_base =
      reinterpret_cast<float*>(smem4 + kCpWarps * kStageRows * kTileFaces);
  float* scratch = scratch_base + warp * kScratchFloats;
  unsigned short* pairs = reinterpret_cast<unsigned short*>(scratch);
  float* keys = scratch_base + kCpWarps * kScratchFloats + warp * n_tiles;
  const int qi = q0 + lane;
  const bool active = qi < p;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* qq = q + (size_t)b * q_batch_stride + (size_t)qi * 3;
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }
  const float* pb = pts + (size_t)b * pts_batch_stride;
  const bool cull = boxes != nullptr;
  const float* bb = cull ? boxes + (size_t)b * boxes_batch_stride : nullptr;
  // a NaN query keeps (+inf, 0) whatever is visited: it asks for nothing
  const bool live = active && !(isnan(qx) || isnan(qy) || isnan(qz));
  float best = inf32();
  int best_id = 0;
  float margin = 0.0f;
  // lb² > thr: nothing in the box can win; +inf before the first tile,
  // −inf on a dead lane, else finite
  float thr = live ? inf32() : -inf32();
  float key = 0.0f;
  int tile = n_tiles > 0 ? 0 : INT_MAX;  // the tile to consider next
  if (cull) {
    const float lx = warp_min(live ? qx : inf32()), hx = warp_max(live ? qx : -inf32());
    const float ly = warp_min(live ? qy : inf32()), hy = warp_max(live ? qy : -inf32());
    const float lz = warp_min(live ? qz : inf32()), hz = warp_max(live ? qz : -inf32());
    float vmax = 0.0f;
    for (int t = lane; t < n_tiles; t += 32) {
      const float* bx = bb + (size_t)t * 8;
      keys[t] = box_dist2(bx, lx, ly, lz, hx, hy, hz);
      vmax = fmaxf(vmax, bx[6]);
    }
    vmax = warp_max(vmax);
    const float s = sqrtf(qx * qx + qy * qy + qz * qz) + vmax;
    margin = kSkipScale * (s * s) + kSkipFloor;
    __syncwarp();
    tile = nearest_tile(keys, n_tiles, lane, key);
  }
  // d² from (px, py, pz) to staged face u
  auto dist2 = [&](int u, float px, float py, float pz) {
    const float4 f0 = stage[u], f1 = stage[kTileFaces + u];
    const float4 f2 = stage[2 * kTileFaces + u], f3 = stage[3 * kTileFaces + u];
    return point_tri_dist2_edges(px, py, pz, f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w,
                                 f2.x, f2.y, f2.z, f2.w, f3.x, f3.y, f3.z);
  };
  auto take = [&](float d2, int id) {
    if (d2 < best || (d2 == best && id < best_id)) {
      best = d2;
      best_id = id;
    }
  };
  unsigned long long n_seen = 0, n_faces = 0;  // tiles visited, faces in them
  unsigned long long n_ran = 0;                // this lane's query's cascades
  float g[9];        // the corners of one face of tile `fetched`, one face per lane
  int fetched = -1;  // the tile whose gather g holds
  while (tile != INT_MAX) {
    const int visit = tile;
    if (cull) {
      if (key > warp_max(thr)) break;  // every tile left is beyond every best
      if (lane == 0) keys[visit] = __int_as_float(0x7fc00000);  // taken
      __syncwarp();
      tile = nearest_tile(keys, n_tiles, lane, key);  // the one to consider next
      const float lb2 = box_dist2(bb + (size_t)visit * 8, qx, qy, qz, qx, qy, qz);
      if (!__any_sync(kFull, lb2 <= thr)) continue;
    } else {
      tile = visit + 1 < n_tiles ? visit + 1 : INT_MAX;
    }
    const int lo = visit * kTileFaces;
    const int n = min(kTileFaces, f - lo);
    if (fetched != visit) gather_face(g, pb, cells, lo + lane, lane < n);
    ++n_seen;
    n_faces += n;
    __syncwarp();  // the previous tile and its pairs are consumed
    stage[lane] = make_float4(g[0], g[1], g[2], g[3]);
    stage[kTileFaces + lane] = make_float4(g[4], g[5], g[6], g[7]);
    stage[2 * kTileFaces + lane] = make_float4(g[8], g[3] - g[0], g[4] - g[1], g[5] - g[2]);
    stage[3 * kTileFaces + lane] = make_float4(g[6] - g[0], g[7] - g[1], g[8] - g[2], 0.0f);
    if (cull) {  // the face's corner box, as tile_boxes_kernel forms a tile's
      float box[6];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        box[a] = fminf(fminf(fminf(inf32(), g[a]), g[3 + a]), g[6 + a]);
        box[3 + a] = fmaxf(fmaxf(fmaxf(-inf32(), g[a]), g[3 + a]), g[6 + a]);
      }
      stage[4 * kTileFaces + lane] = make_float4(box[0], box[1], box[2], box[3]);
      stage[5 * kTileFaces + lane] = make_float4(box[4], box[5], 0.0f, 0.0f);
    }
    __syncwarp();
    // the gather of the tile considered next overlaps this tile's arithmetic
    fetched = tile;
    if (tile != INT_MAX) {
      const int nlo = tile * kTileFaces;
      gather_face(g, pb, cells, nlo + lane, nlo + lane < f);
    }
    unsigned mine = n == 32 ? kFull : (1u << n) - 1u;  // the faces this lane's query keeps
    bool packed = false;
    int n_pairs = 0, first = 0;
    if (cull) {
      // each face's box against this lane's threshold: the lb² of the kept
      // faces to the scratch, and the nearest of them
      float* lbs = scratch + lane * (kTileFaces + 1);
      mine = 0u;
      int seed = -1;
      float seed_lb = 0.0f;
      for (int u = 0; u < n; ++u) {
        const float4 b0 = stage[4 * kTileFaces + u], b1 = stage[5 * kTileFaces + u];
        const float bx[6] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y};
        const float lb = box_dist2(bx, qx, qy, qz, qx, qy, qz);
        if (lb <= thr) {
          mine |= 1u << u;
          lbs[u] = lb;
          if (seed < 0 || lb < seed_lb) {
            seed = u;
            seed_lb = lb;
          }
        }
      }
      if (__reduce_add_sync(kFull, __popc(mine)) > 32) {
        // two rounds or more: each lane first runs its nearest kept face,
        // then keeps what can still win against that result
        const bool has = mine != 0u;
        const float d = dist2(has ? seed : 0, qx, qy, qz);
        if (has) take(d, lo + seed);
        n_ran += has;
        const float now = best + margin;
        unsigned kept = 0u;
        for (unsigned m = has ? mine & ~(1u << seed) : 0u; m != 0u; m &= m - 1u) {
          const int u = __ffs(m) - 1;
          if (lbs[u] <= now) kept |= 1u << u;
        }
        mine = kept;
      }
      __syncwarp();  // the lb² are read before the pair list takes their place
      int incl = __popc(mine);  // pairs of lanes 0..lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
      }
      n_pairs = __shfl_sync(kFull, incl, 31);
      first = incl - __popc(mine);
      // a packed round costs about 5/4 of a round of the lanes' own loops
      packed = 5 * ((n_pairs + 31) >> 5) < 4 * (int)__reduce_max_sync(kFull, __popc(mine));
    }
    n_ran += __popc(mine);
    if (!packed) {  // each lane over its own kept faces, lowest first
      const int rounds = (int)__reduce_max_sync(kFull, __popc(mine));
      unsigned m = mine;
      for (int k = 0; k < rounds; ++k, m &= m - 1u) {
        const int u = m != 0u ? __ffs(m) - 1 : 0;
        const float d = dist2(u, qx, qy, qz);
        if (m != 0u) take(d, lo + u);
      }
    } else {
      int at = first;
      for (unsigned m = mine; m != 0u; m &= m - 1u)
        pairs[at++] = (unsigned short)((lane << 5) | (__ffs(m) - 1));
      __syncwarp();
      for (int r0 = 0; r0 < n_pairs; r0 += 32) {
        const bool has = r0 + lane < n_pairs;
        const int pr = has ? pairs[r0 + lane] : 0;
        const int own = has ? pr >> 5 : -1, u = pr & 31;
        const int src = has ? own : lane;
        float d = dist2(u, __shfl_sync(kFull, qx, src), __shfl_sync(kFull, qy, src),
                        __shfl_sync(kFull, qz, src));
        int id = lo + u;
        if (!has || isnan(d)) {  // never wins
          d = inf32();
          id = INT_MAX;
        }
        // the least (d², id) from each lane to the end of its query's run
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float od = __shfl_down_sync(kFull, d, off);
          const int oid = __shfl_down_sync(kFull, id, off);
          const int oown = __shfl_down_sync(kFull, own, off);
          if (lane + off < 32 && oown == own && lex_less(od, oid, d, id)) {
            d = od;
            id = oid;
          }
        }
        // this lane's query's run in this round starts at max(first, r0)
        const bool run = mine != 0u && first < r0 + 32 && first + __popc(mine) > r0;
        const int head = run ? max(first, r0) - r0 : lane;
        const float hd = __shfl_sync(kFull, d, head);
        const int hid = __shfl_sync(kFull, id, head);
        if (run) take(hd, hid);
      }
    }
    if (live) thr = best + margin;
  }
  if (visits != nullptr) {
    const unsigned long long n_active = __popc(__ballot_sync(kFull, active));
    unsigned long long ran = active ? n_ran : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ran += __shfl_xor_sync(kFull, ran, off);
    if (lane == 0) {
      atomicAdd(&visits[0], n_active * n_seen);
      atomicAdd(&visits[1], n_active * n_faces);
      atomicAdd(&visits[2], ran);
    }
  }
  if (active) {
    d2_out[(size_t)b * p + qi] = best;
    idx_out[(size_t)b * p + qi] = best_id;
  }
}

// K3 and K8 host side: K3's instance for Q queries a lane (Q = 1..kNvMaxQ:
// a per-chain set takes the Q that fits P), or K8's (dot; Q = kDotQ only)
const void* nv_kernel(int dot, int q) {
  if (dot) return q == kDotQ ? (const void*)nearest_vertices_kernel<DotPair, kDotQ> : nullptr;
  switch (q) {
    case 1: return (const void*)nearest_vertices_kernel<EuclidPair, 1>;
    case 2: return (const void*)nearest_vertices_kernel<EuclidPair, 2>;
    case 3: return (const void*)nearest_vertices_kernel<EuclidPair, 3>;
    case 4: return (const void*)nearest_vertices_kernel<EuclidPair, 4>;
    case 5: return (const void*)nearest_vertices_kernel<EuclidPair, 5>;
    case 6: return (const void*)nearest_vertices_kernel<EuclidPair, 6>;
    case 7: return (const void*)nearest_vertices_kernel<EuclidPair, 7>;
    case 8: return (const void*)nearest_vertices_kernel<EuclidPair, 8>;
  }
  return nullptr;
}

// the most dynamic shared memory a K3 block takes: two chunk buffers, the
// slices' minima and the carried bests at the largest Q
constexpr int kNvMaxSmem =
    2 * kNvChunk * (int)sizeof(float4) + (kNvWarps + kNvWarps) * 32 * kNvMaxQ * 8;

// per device, read once: the SM count, the shared-memory ceiling raised for
// every instance, and blocks per SM by (pair, Q, shared bytes)
std::mutex nv_mu;
std::map<int, int> nv_sms;                            // device → SMs
std::map<std::pair<int, long long>, int> nv_occupancy;  // (device, pair·2⁴⁰ + Q·2³² + bytes) → blocks

cudaError_t nv_blocks_per_sm(int dot, int q, int smem, int* sms, int* ctas) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(nv_mu);
  auto it = nv_sms.find(dev);
  if (it == nv_sms.end()) {
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    for (int k = 0; k <= kNvMaxQ && e == cudaSuccess; ++k)  // k = 0: K8's instance
      e = cudaFuncSetAttribute(k ? nv_kernel(0, k) : nv_kernel(1, kDotQ),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kNvMaxSmem);
    if (e != cudaSuccess) return e;
    it = nv_sms.emplace(dev, n).first;
  }
  *sms = it->second;
  const std::pair<int, long long> key(
      dev, ((long long)dot << 40) + ((long long)q << 32) + smem);
  auto oc = nv_occupancy.find(key);
  if (oc == nv_occupancy.end()) {
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, nv_kernel(dot, q), kNvWarps * 32,
                                                      smem);
    if (e != cudaSuccess) return e;
    oc = nv_occupancy.emplace(key, n).first;
  }
  *ctas = oc->second;
  return cudaSuccess;
}

// The launch for B chains of P queries against V vertices, shared or one
// set per chain: parameters, Q, blocks, dynamic shared bytes, blocks per SM.
// Shared: Q = kNvSharedQ (K3) or kDotQ (K8).  Per chain (K3 only): the fewest warp units of at most kNvMaxQ·32
// queries that cover P, then the least Q for that many units (P = 202: one
// unit of Q = 7, 224 lanes' worth for 202 queries), and the block's other
// warps scan vertex slices of the same units.
cudaError_t nv_configure(int batch, int p, int v, int per_chain, int dot, NvParams* a,
                         int* q, int* grid, int* smem, int* ctas) {
  NvParams c{};
  c.batch = batch, c.p = p, c.v = v, c.per_chain = per_chain;
  long long n_items;
  if (!per_chain) {
    *q = dot ? kDotQ : kNvSharedQ;
    c.units = ((long long)batch * p + 32 * *q - 1) / (32 * *q);
    c.uw = kNvWarps, c.slices = 1, c.items_per_chain = 1;
    n_items = (c.units + kNvWarps - 1) / kNvWarps;
  } else {
    const int u = (p + 32 * kNvMaxQ - 1) / (32 * kNvMaxQ);
    *q = (p + 32 * u - 1) / (32 * u);
    c.units = u;
    if (u >= kNvWarps) {
      c.uw = kNvWarps, c.slices = 1, c.items_per_chain = (u + kNvWarps - 1) / kNvWarps;
    } else {
      c.uw = u, c.slices = kNvWarps / u, c.items_per_chain = 1;
    }
    n_items = (long long)batch * c.items_per_chain;
  }
  c.n_items = n_items;
  c.chunk = min(kNvChunk, (v + kNvGroup - 1) / kNvGroup * kNvGroup);
  c.n_chunks = (v + c.chunk - 1) / c.chunk;
  c.resident = !per_chain && c.n_chunks == 1;
  *smem = (c.resident ? 1 : 2) * c.chunk * (int)sizeof(float4) +
          (c.slices > 1 ? (kNvWarps + c.uw) * 32 * *q * 8 : 0);
  int sms = 0;
  cudaError_t e = nv_blocks_per_sm(dot, *q, *smem, &sms, ctas);
  if (e != cudaSuccess) return e;
  if (*ctas < 1) return cudaErrorInvalidConfiguration;
  const long long most = (long long)sms * *ctas;
  *grid = (int)(n_items < most ? n_items : most);
  *a = c;
  return cudaSuccess;
}

cudaError_t nv_launch(const float* q, const float* pts, int* ids, int batch, int p, int v,
                      int per_chain, int dot, cudaStream_t st) {
  NvParams a;
  int qn = 0, grid = 0, smem = 0, ctas = 0;
  cudaError_t e = nv_configure(batch, p, v, per_chain, dot, &a, &qn, &grid, &smem, &ctas);
  if (e != cudaSuccess) return e;
  a.q = q, a.pts = pts, a.ids = ids;
  void* args[] = {&a};
  e = cudaLaunchKernel(nv_kernel(dot, qn), dim3(grid), dim3(kNvWarps * 32), args, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K4 host side: its shared-memory carve-out set to the least once per
// device, so that L1 takes what shared memory leaves
std::mutex refine_mu;
std::map<int, bool> refine_ready;

cudaError_t refine_prepare() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(refine_mu);
  if (refine_ready.count(dev)) return cudaSuccess;
  e = cudaFuncSetAttribute((const void*)refine_shortlist_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxL1);
  if (e == cudaSuccess) refine_ready[dev] = true;
  return e;
}

}  // namespace

extern "C" {

int icp_nearest_vertices(const float* q, const float* pts, int* ids, int batch, int p,
                         int v, int pts_batched, void* stream) {
  if (batch == 0 || p == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (v == 0) return cudaMemsetAsync(ids, 0, (size_t)batch * p * sizeof(int), st);
  return nv_launch(q, pts, ids, batch, p, v, pts_batched, 0, st);
}

// K8: va [V, 4] rows 16-byte aligned, one set shared by all chains
int icp_coarse_nearest_dot(const float* q, const float* va, int* ids, int batch, int p, int v,
                           void* stream) {
  if (batch == 0 || p == 0 || v == 0) return cudaSuccess;
  return nv_launch(q, va, ids, batch, p, v, 0, 1, (cudaStream_t)stream);
}

// K3's or K8's (dot) launch as the calls above make it: out = (Q, threads
// per block, blocks, dynamic shared bytes per block, blocks per SM)
int icp_nearest_vertices_config(int batch, int p, int v, int pts_batched, int dot, int* out) {
  NvParams a;
  if (batch <= 0 || p <= 0 || v <= 0 || (dot && pts_batched)) return cudaErrorInvalidValue;
  cudaError_t e =
      nv_configure(batch, p, v, pts_batched, dot, &a, &out[0], &out[2], &out[3], &out[4]);
  out[1] = kNvWarps * 32;
  return e;
}

// K4: faces [F, 12] rows 16-byte aligned
int icp_refine_shortlist(const float* q, const int* coarse, const int* cand,
                         const float* faces, int* fidx, float* wtri, int n_queries, int v,
                         int f, int k, void* stream) {
  if (n_queries == 0) return cudaSuccess;
  cudaError_t e = refine_prepare();
  if (e != cudaSuccess) return e;
  long long n = n_queries;
  const float4* table = reinterpret_cast<const float4*>(faces);
  void* args[] = {&q, &coarse, &cand, &table, &fidx, &wtri, &n, &v, &f, &k};
  const long long blocks = (n * kRefineLanes + kRefineWarps * 32 - 1) / (kRefineWarps * 32);
  e = cudaLaunchKernel((const void*)refine_shortlist_kernel, dim3((unsigned)blocks),
                       dim3(kRefineWarps * 32), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K4's launch as icp_refine_shortlist makes it: out = (lanes a query,
// threads per block, blocks, registers a thread, blocks per SM)
int icp_refine_shortlist_config(int n_queries, int* out) {
  if (n_queries <= 0) return cudaErrorInvalidValue;
  cudaError_t e = refine_prepare();
  if (e != cudaSuccess) return e;
  out[0] = kRefineLanes;
  out[1] = kRefineWarps * 32;
  out[2] = (int)(((long long)n_queries * out[0] + out[1] - 1) / out[1]);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, (const void*)refine_shortlist_kernel);
  if (e != cudaSuccess) return e;
  out[3] = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], refine_shortlist_kernel,
                                                       out[1], 0);
}

// boxes: scratch of n_tiles·8 floats per surface (one surface, or batch
// with pts_batched), used when cull; visits: nullptr or three counters
int icp_surface_distances(const float* q, const float* pts, const int* cells, float* boxes,
                          unsigned long long* visits, float* d2, int* idx, int batch, int p,
                          int v, int f, int q_batched, int pts_batched, int cull,
                          void* stream) {
  if (batch == 0 || p == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (f + kTileFaces - 1) / kTileFaces;
  const long long pts_stride = pts_batched ? 3LL * v : 0LL;
  if (cull && n_tiles > 0) {
    const dim3 grid((n_tiles + kCpWarps - 1) / kCpWarps, pts_batched ? batch : 1);
    tile_boxes_kernel<<<grid, kCpWarps * 32, 0, st>>>(pts, pts_stride, cells, f, n_tiles,
                                                      boxes);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int bytes = kCpWarps * (kStageRows * kTileFaces * (int)sizeof(float4) +
                                kScratchFloats * (int)sizeof(float) +
                                (cull ? n_tiles * (int)sizeof(float) : 0));
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        surface_distances_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p + kCpWarps * 32 - 1) / (kCpWarps * 32), batch);
  surface_distances_kernel<<<grid, kCpWarps * 32, bytes, st>>>(
      q, q_batched ? 3LL * p : 0LL, pts, pts_stride, cells, cull ? boxes : nullptr,
      pts_batched ? 8LL * n_tiles : 0LL, d2, idx, p, f, n_tiles, visits);
  return cudaGetLastError();
}

}  // extern "C"
