// K9 and K10 of the port: the shortlist index build, exact float64
// point→triangle distances from every target vertex to every face.
//
// They replace icp_proposal_tpu/native/point_tri.cpp, a host C++ kernel of
// the JAX package (OpenMP, loaded with ctypes; not a Pallas kernel), which
// icp_proposal_tpu/ops/surface_index.py uses to build the index whenever its
// library loads:
//   K9  icp_shortlist_topk (point_tri.cpp:114-145): per query, the K faces
//       of least d², ascending by (d², face id): ties go to the lower face
//       id, as native's std::partial_sort comparator orders them.
//   K10 icp_point_tri_d2 (point_tri.cpp:100-112): the full [N, F] matrix.
// Both evaluate one __device__ function, point_tri_d2, which is the cascade
// of point_tri.cpp:49-97 operation for operation: the same region order,
// the same subtractions and dot products in the same order, and
// 1.0 / (va + vb + vc) followed by products for the face interior.  The
// build's -fmad=false keeps every product and sum rounding on its own, and
// float64 division is correctly rounded on the card, so d² is bitwise that
// of the plain twin (icp_proposal_tpu_torch/native) and of native built
// with -ffp-contract=off.
//
// NaN: a NaN d² sorts after every number, NaN entries among themselves by
// face id (the twin's stable sort does the same).  Native's comparator is
// not a strict weak order once a d² is NaN, so its order is undefined there.
//
// What bounds it: the cascade's float64 operations, V·F pairs of 24 to 78
// operations each by region (the femur stand-in target: 1,622 × 3,240 =
// 5.3 M pairs), each its own instruction under -fmad=false and each IEEE
// division several (8 FP64 instructions, a reciprocal 5, in SASS), over
// the H100's FP64 issue rate outside the tensor cores (half the 34 TFLOP/s
// that counts an FMA as two), or, for K10, the [N, F] float64 output over
// HBM bandwidth, whichever is larger.  A warp whose lanes end the cascade
// in different regions runs the longest of their paths.
//   K9 selects and does not sort.  A warp takes a query.  The block's
//   warps share a ring of kTopkDepth shared-memory slots, each holding a
//   part of kTopkStep faces; the last warp to release a slot refills it
//   with cp.async, and an mbarrier tells the warps when it has landed, so
//   a face is read from L2 once for the block and no warp waits for a
//   slower one by less than the ring's depth.  The block starts at the part
//   nearest its queries and wraps around, so their best K show up early.
//   A lane computes the d² of one face of a round of 32; a ballot
//   keeps the faces below the warp's threshold (tau, cut), the (key, id)
//   of its K-th entry so far, and appends them to the warp's buffer of cap
//   entries (raw d² bits and id).  When a round would overflow it, the warp
//   selects: the K-th key T by a walk down the binary trie of the keys'
//   high words, then of the low words of those tied there (one pass a
//   branch point counts the values with the bit clear and takes the AND
//   and OR of both halves, which give the next bit), and the lowest ids
//   among the entries tied at T by a walk over their ids; then it keeps
//   those entries in place and (tau, cut) becomes the K-th entry.  So the
//   order in which faces arrive does not matter: native's tie rule at the
//   K-th slot holds whatever the start.  After the last part the warp
//   selects once more, sorts the K winners by (key, id) with a bitonic
//   sort of K padded to a power of two and stores them.  The order key is
//   the d² bits with the sign cleared (d² ≥ +0), every NaN one key above
//   +inf, with the face id after it: numbers before NaN, then d², then id,
//   a total order.  A selection costs O(cap) a branch point and frees
//   cap − K slots, so the work is O(F) a query.
//   K10 runs a 2-D grid: a thread holds one face's corners in registers
//   and loops over a block of kD2Queries queries staged in shared memory;
//   a warp's stores are 32 consecutive d² of a row.
// Every entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>

#include <atomic>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kTopkWarps = 8;        // K9: warps a block, a query each
constexpr int kTopkThreads = 32 * kTopkWarps;
constexpr int kTopkStep = 128;       // K9: faces a ring slot holds, a part
constexpr int kTopkDepth = 6;        // K9: ring slots
constexpr int kTopkMaxK = 1024;      // K9: largest K
constexpr int kTopkMoreMin = 256;    // K9: a buffer's room beyond K: K, at
constexpr int kTopkMoreMax = 512;    //     least kTopkMoreMin, at most kTopkMoreMax
constexpr int kTopkInts = (kTopkDepth + 2) / 2 * 2;  // K9: release counts, the start; even
constexpr int kD2Threads = 128;      // K10: faces a block, one a thread
constexpr int kD2Queries = 16;       // K10: queries a block stages at a time
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;
constexpr u64 kNanKey = 0x7ff0000000000001ULL;  // every NaN: one key above +inf
constexpr u64 kAbove = ~0ULL;                   // above every key: tau before a selection

struct V3 {
  double x, y, z;
};

__device__ __forceinline__ V3 sub3(const V3& a, const V3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ double dot3(const V3& a, const V3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// point_tri.cpp:49-97, operation for operation
__device__ __forceinline__ double point_tri_d2(const V3& p, const V3& a, const V3& b,
                                               const V3& c) {
  const V3 ab = sub3(b, a), ac = sub3(c, a), ap = sub3(p, a);
  const double d1 = dot3(ab, ap), d2 = dot3(ac, ap);
  if (d1 <= 0.0 && d2 <= 0.0) return dot3(ap, ap);  // vertex region A
  const V3 bp = sub3(p, b);
  const double d3 = dot3(ab, bp), d4 = dot3(ac, bp);
  if (d3 >= 0.0 && d4 <= d3) return dot3(bp, bp);  // vertex region B
  const double vc = d1 * d4 - d3 * d2;
  if (vc <= 0.0 && d1 >= 0.0 && d3 <= 0.0) {
    const double v = d1 / (d1 - d3);  // edge AB
    const V3 d = {ap.x - v * ab.x, ap.y - v * ab.y, ap.z - v * ab.z};
    return dot3(d, d);
  }
  const V3 cp = sub3(p, c);
  const double d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  if (d6 >= 0.0 && d5 <= d6) return dot3(cp, cp);  // vertex region C
  const double vb = d5 * d2 - d1 * d6;
  if (vb <= 0.0 && d2 >= 0.0 && d6 <= 0.0) {
    const double w = d2 / (d2 - d6);  // edge AC
    const V3 d = {ap.x - w * ac.x, ap.y - w * ac.y, ap.z - w * ac.z};
    return dot3(d, d);
  }
  const double va = d3 * d6 - d5 * d4;
  if (va <= 0.0 && (d4 - d3) >= 0.0 && (d5 - d6) >= 0.0) {
    const double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));  // edge BC
    const V3 bc = sub3(c, b);
    const V3 d = {bp.x - w * bc.x, bp.y - w * bc.y, bp.z - w * bc.z};
    return dot3(d, d);
  }
  // face interior
  const double denom = 1.0 / (va + vb + vc);
  const double v = vb * denom, w = vc * denom;
  const V3 d = {ap.x - v * ab.x - w * ac.x, ap.y - v * ab.y - w * ac.y,
                ap.z - v * ab.z - w * ac.z};
  return dot3(d, d);
}

// K9's order key of a d² given as its bits: the bits with the sign cleared
// (d² ≥ +0; -0 as +0), every NaN kNanKey
__device__ __forceinline__ u64 order_key(u64 bits) {
  const u64 a = bits & 0x7fffffffffffffffULL;
  return a < kNanKey ? a : kNanKey;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}
__device__ __forceinline__ u64 warp_and(u64 x) {
  return ((u64)__reduce_and_sync(kFull, (unsigned)(x >> 32)) << 32) |
         __reduce_and_sync(kFull, (unsigned)x);
}
__device__ __forceinline__ u64 warp_or(u64 x) {
  return ((u64)__reduce_or_sync(kFull, (unsigned)(x >> 32)) << 32) |
         __reduce_or_sync(kFull, (unsigned)x);
}
__device__ __forceinline__ void cp_async8(unsigned smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem), "l"(gmem));
}
// an mbarrier in shared memory (address `bar`): init with the arrivals a
// phase takes; the executing thread's earlier cp.async copies arrive once
// when they have all landed (.noinc: counted in the init); wait for the
// phase of parity `parity` to complete
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive_copies(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The warp's k-th smallest of the 32-bit values val(s) of the entries s
// < n with in(s) (at least k of them), by a walk down the values' binary
// trie: the values in range share their bits above the highest bit where
// the AND and the OR of the range differ; one pass counts those with that
// bit clear, which says on which side the k-th lies, and takes the AND and
// OR of both sides, which give the next bit.  As many passes as branch
// points on the way, at most 32.  → V; r: its rank among the values
// equal to V.
template <class In, class Val>
__device__ __forceinline__ unsigned warp_select32(int n, int k, In in, Val val, int& r) {
  const unsigned lane = threadIdx.x & 31;
  unsigned a = ~0u, o = 0;
  for (int s = lane; s < n; s += 32)
    if (in(s)) {
      const unsigned v = val(s);
      a &= v;
      o |= v;
    }
  a = __reduce_and_sync(kFull, a);
  o = __reduce_or_sync(kFull, o);
  r = k;  // the rank sought among the values in range
  while (a != o) {
    const unsigned bit = 1u << (31 - __clz(a ^ o)), above = ~(bit | (bit - 1));
    unsigned c = 0, a0 = ~0u, o0 = 0, a1 = ~0u, o1 = 0;
    for (int s = lane; s < n; s += 32) {
      if (!in(s)) continue;
      const unsigned v = val(s);
      if ((v ^ a) & above) continue;  // out of range
      if (v & bit) {
        a1 &= v;
        o1 |= v;
      } else {
        ++c;
        a0 &= v;
        o0 |= v;
      }
    }
    c = __reduce_add_sync(kFull, c);
    a0 = __reduce_and_sync(kFull, a0);
    o0 = __reduce_or_sync(kFull, o0);
    a1 = __reduce_and_sync(kFull, a1);
    o1 = __reduce_or_sync(kFull, o1);
    if ((unsigned)r <= c) {
      a = a0;
      o = o0;
    } else {
      r -= c;
      a = a1;
      o = o1;
    }
  }
  return a;  // every value in range is V
}

// The warp's n entries (x raw d² bits, id) reduced in place to its k best
// in the order (key, id), whatever order they are in → (T, cut): the k-th
// entry's key and id.  T by a walk over the keys' high words, then over
// the low words of those that tie there; ties at T keep their lowest ids,
// found by a walk over the tied ids when they do not all fit.
__device__ __forceinline__ u64 warp_reduce_to_k(u64* x, int* id, int& n, int k, int& cut) {
  const unsigned lane = threadIdx.x & 31, below = lanes_below();
  auto all = [](int) { return true; };
  int r;
  const unsigned hi = warp_select32(n, k, all, [&](int s) {
    return (unsigned)(order_key(x[s]) >> 32); }, r);
  const unsigned lo = warp_select32(
      n, r, [&](int s) { return (unsigned)(order_key(x[s]) >> 32) == hi; },
      [&](int s) { return (unsigned)order_key(x[s]); }, r);
  const u64 t = (u64)hi << 32 | lo;
  unsigned tied = 0;
  int top = INT_MIN;
  for (int s = lane; s < n; s += 32)
    if (order_key(x[s]) == t) {
      ++tied;
      top = max(top, id[s]);
    }
  tied = __reduce_add_sync(kFull, tied);
  cut = __reduce_max_sync(kFull, top);
  if (tied > (unsigned)r) {
    int r2;
    cut = (int)warp_select32(
        n, r, [&](int s) { return order_key(x[s]) == t; },
        [&](int s) { return (unsigned)id[s]; }, r2);
  }
  int kept = 0;
  for (int base = 0; base < n; base += 32) {
    const int s = base + lane;
    u64 v = 0;
    int i = 0;
    bool keep = false;
    if (s < n) {
      v = x[s];
      i = id[s];
      const u64 key = order_key(v);
      keep = key < t || (key == t && i <= cut);
    }
    const unsigned kb = __ballot_sync(kFull, keep);
    __syncwarp();  // the round is read before any of it is overwritten
    if (keep) {
      const int o = kept + __popc(kb & below);
      x[o] = v;
      id[o] = i;
    }
    kept += __popc(kb);
    __syncwarp();
  }
  n = kept;
  return t;
}

// (ka, ia) after (kb, ib) in the order (key, id)
__device__ __forceinline__ bool after(u64 ka, int ia, u64 kb, int ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// the warp copies part u (faces [u·kTopkStep, + kTopkStep)) into the ring
// slot at dst, then its lanes' copies arrive on the slot's barrier when
// they land
__device__ __forceinline__ void fill_slot(unsigned dst, unsigned bar,
                                          const double* __restrict__ tri, int f, int u) {
  const unsigned lane = threadIdx.x & 31;
  const long long base = (long long)u * kTopkStep;
  const int nf = (int)min((long long)kTopkStep, f - base);
  const double* src = tri + 9 * base;
  for (int e = lane; e < 9 * nf; e += 32) cp_async8(dst + 8 * e, src + e);
  mbar_arrive_copies(bar);
}

// the block's queries' centroid → the part nearest to it (by a corner of
// the part's middle face), the lowest on a tie: the block starts there and
// wraps around, so the best K show up early and tau tightens at once
__device__ __forceinline__ int choose_start(const double* __restrict__ tri, int f, int parts,
                                            const double* qs, int nq) {
  const unsigned lane = threadIdx.x & 31;
  double g[3] = {0.0, 0.0, 0.0};
  for (int i = 0; i < nq; ++i)
    for (int c = 0; c < 3; ++c) g[c] += qs[3 * i + c];
  for (int c = 0; c < 3; ++c) g[c] /= nq;
  double best = INFINITY;
  int at = 0;
  for (int u = lane; u < parts; u += 32) {
    const long long base = (long long)u * kTopkStep;
    const double* c = tri + 9 * (base + min((long long)kTopkStep, f - base) / 2);
    const double dx = c[0] - g[0], dy = c[1] - g[1], dz = c[2] - g[2];
    const double d = dx * dx + dy * dy + dz * dz;
    if (d < best) {  // a NaN corner is never nearer
      best = d;
      at = u;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const double b2 = __shfl_down_sync(kFull, best, o);
    const int a2 = __shfl_down_sync(kFull, at, o);
    if (b2 < best || (b2 == best && a2 < at)) {
      best = b2;
      at = a2;
    }
  }
  return at;  // lane 0's
}

// (launch bounds with one block a multiprocessor: without it ptxas held K9
// and K10 to 80 registers and spilled; with it neither spills)
// dynamic shared memory: the ring (kTopkDepth slots of kTopkStep faces),
// its barriers, the block's queries, the slots' release counts, the start
// part, then each warp's cap raw d² bits and cap ids
__global__ void __launch_bounds__(kTopkThreads, 1)
    shortlist_topk_kernel(const double* __restrict__ queries, const double* __restrict__ tri,
                          int* __restrict__ out_idx, double* __restrict__ out_d2, int n, int f,
                          int k, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ring = reinterpret_cast<double*>(smem);
  u64* bars = reinterpret_cast<u64*>(ring + kTopkDepth * 9 * kTopkStep);
  double* qs = reinterpret_cast<double*>(bars + kTopkDepth);  // the block's queries
  int* released = reinterpret_cast<int*>(qs + 3 * kTopkWarps);
  int* start = released + kTopkDepth;
  u64* bx_all = reinterpret_cast<u64*>(released + kTopkInts);  // kTopkInts is even
  const int warp = threadIdx.x >> 5;
  const unsigned lane = threadIdx.x & 31, below = lanes_below();
  u64* bx = bx_all + warp * cap;
  int* bi = reinterpret_cast<int*>(bx_all + kTopkWarps * cap) + warp * cap;
  const long long q = (long long)blockIdx.x * kTopkWarps + warp;
  const bool active = q < n;  // warp-uniform; an idle warp still takes part in the ring
  const int parts = (int)(((long long)f + kTopkStep - 1) / kTopkStep);
  V3 p = {0.0, 0.0, 0.0};
  if (active) p = {queries[3 * q], queries[3 * q + 1], queries[3 * q + 2]};
  const unsigned ring_at = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned bars_at = (unsigned)__cvta_generic_to_shared(bars);

  if (threadIdx.x < kTopkDepth) {
    mbar_init(bars_at + 8 * threadIdx.x, 32);  // a phase: one warp's 32 lanes' copies
    released[threadIdx.x] = 0;
  }
  if (lane == 0) {
    qs[3 * warp] = p.x;
    qs[3 * warp + 1] = p.y;
    qs[3 * warp + 2] = p.z;
  }
  __syncthreads();
  if (warp == 0) {
    const int nq = (int)min((long long)kTopkWarps, n - (long long)blockIdx.x * kTopkWarps);
    const int first = __shfl_sync(kFull, choose_start(tri, f, parts, qs, nq), 0);
    if (lane == 0) *start = first;
    for (int t = 0; t < kTopkDepth && t < parts; ++t)
      fill_slot(ring_at + t * 9 * kTopkStep * 8, bars_at + 8 * t, tri, f, (first + t) % parts);
  }
  __syncthreads();  // the start is set
  const int first = *start;

  int cnt = 0, cut = INT_MAX;
  u64 tau = kAbove;  // with cut: the k-th entry so far; a face enters below it
  for (int t = 0; t < parts; ++t) {
    const int slot = t % kTopkDepth;
    mbar_wait(bars_at + 8 * slot, (unsigned)(t / kTopkDepth) & 1u);
    const long long base = (long long)((first + t) % parts) * kTopkStep;
    const int nf = active ? (int)min((long long)kTopkStep, f - base) : 0;
    const double* tile = ring + slot * 9 * kTopkStep;
    for (int r0 = 0; r0 < nf; r0 += 32) {
      const int j = r0 + lane;
      const int id = (int)(base + j);
      u64 v = 0, key = kAbove;
      if (j < nf) {
        const double* c = tile + 9 * j;
        const V3 a = {c[0], c[1], c[2]}, b = {c[3], c[4], c[5]}, cc = {c[6], c[7], c[8]};
        v = (u64)__double_as_longlong(point_tri_d2(p, a, b, cc));
        key = order_key(v);
      }
      bool enter = j < nf && (key < tau || (key == tau && id < cut));
      unsigned in = __ballot_sync(kFull, enter);
      if (in == 0) continue;
      if (cnt + __popc(in) > cap) {  // full: keep the k best, tighten (tau, cut)
        tau = warp_reduce_to_k(bx, bi, cnt, k, cut);
        enter = j < nf && (key < tau || (key == tau && id < cut));
        in = __ballot_sync(kFull, enter);
      }
      if (enter) {
        const int o = cnt + __popc(in & below);
        bx[o] = v;
        bi[o] = id;
      }
      cnt += __popc(in);
      __syncwarp();
    }
    // release the slot; the last of the block's warps to release it fills
    // it with the part kTopkDepth further on
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = atomicAdd(&released[slot], 1) % kTopkWarps == kTopkWarps - 1;
    }
    if (__shfl_sync(kFull, last, 0) && t + kTopkDepth < parts)
      fill_slot(ring_at + slot * 9 * kTopkStep * 8, bars_at + 8 * slot, tri, f,
                (first + t + kTopkDepth) % parts);
  }

  if (!active) return;
  if (cnt > k) warp_reduce_to_k(bx, bi, cnt, k, cut);
  // bitonic sort of the k winners by (key, id), padded to a power of two
  int pw = 1;
  while (pw < k) pw <<= 1;
  for (int e = k + lane; e < pw; e += 32) {
    bx[e] = kAbove;  // a NaN's bits (kNanKey) with id INT_MAX: after every entry
    bi[e] = INT_MAX;
  }
  __syncwarp();
  for (int size = 2; size <= pw; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int e = lane; e < pw / 2; e += 32) {
        const int lo = 2 * e - (e & (stride - 1)), hi = lo + stride;
        const u64 xl = bx[lo], xh = bx[hi];
        const int il = bi[lo], ih = bi[hi];
        const bool swap = ((lo & size) == 0)
                              ? after(order_key(xl), il, order_key(xh), ih)
                              : after(order_key(xh), ih, order_key(xl), il);
        if (swap) {
          bx[lo] = xh;
          bx[hi] = xl;
          bi[lo] = ih;
          bi[hi] = il;
        }
      }
      __syncwarp();
    }
  }
  for (int e = lane; e < k; e += 32) {
    out_idx[q * k + e] = bi[e];
    out_d2[q * k + e] = __longlong_as_double((long long)bx[e]);
  }
}

__global__ void __launch_bounds__(kD2Threads, 1)
    point_tri_d2_kernel(const double* __restrict__ queries, const double* __restrict__ tri,
                        double* __restrict__ out, int n, int f) {
  __shared__ double sq[3 * kD2Queries];
  const long long j = (long long)blockIdx.x * kD2Threads + threadIdx.x;
  const bool live = j < f;
  V3 a = {0.0, 0.0, 0.0}, b = a, c = a;
  if (live) {
    const double* t = tri + 9 * j;
    a = {t[0], t[1], t[2]};
    b = {t[3], t[4], t[5]};
    c = {t[6], t[7], t[8]};
  }
  for (long long q0 = (long long)blockIdx.y * kD2Queries; q0 < n;
       q0 += (long long)gridDim.y * kD2Queries) {
    const int nq = (int)min((long long)kD2Queries, n - q0);
    __syncthreads();  // the previous block of queries is read
    for (int e = threadIdx.x; e < 3 * nq; e += kD2Threads) sq[e] = queries[3 * q0 + e];
    __syncthreads();
    if (!live) continue;
    double* row = out + q0 * f + j;
    for (int i = 0; i < nq; ++i, row += f) {
      const V3 p = {sq[3 * i], sq[3 * i + 1], sq[3 * i + 2]};
      *row = point_tri_d2(p, a, b, c);
    }
  }
}

// K9's candidate buffer a warp: room for K and for K more (at least
// kTopkMoreMin, at most kTopkMoreMax), in whole rounds of 32; so at least K
// padded to a power of two (the sort), and K + 32 (a round after a selection)
int topk_capacity(int k) {
  const int more = k < kTopkMoreMin ? kTopkMoreMin : (k > kTopkMoreMax ? kTopkMoreMax : k);
  return (k + more + 31) / 32 * 32;
}

size_t topk_smem_bytes(int cap) {
  return (size_t)kTopkDepth * 9 * kTopkStep * sizeof(double) + kTopkDepth * sizeof(u64) +
         3 * kTopkWarps * sizeof(double) + kTopkInts * sizeof(int) +
         (size_t)kTopkWarps * cap * (sizeof(u64) + sizeof(int));
}

// K9's opt-in shared memory, raised once a device to what K = kTopkMaxK
// takes
cudaError_t allow_topk_smem() {
  constexpr int kDevices = 64;
  static std::atomic<bool> allowed[kDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < kDevices && allowed[dev].load())) return e;
  e = cudaFuncSetAttribute((const void*)shortlist_topk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)topk_smem_bytes(topk_capacity(kTopkMaxK)));
  if (e == cudaSuccess && dev < kDevices) allowed[dev].store(true);
  return e;
}

}  // namespace

extern "C" {

// K9: queries [n, 3], tri [f, 9] float64; idx [n, k] int32, d2 [n, k]
// float64; 0 < k ≤ min(f, kTopkMaxK)
int icp_shortlist_topk(const double* queries, const double* tri, int* idx, double* d2, int n,
                       int f, int k, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  if (k < 0 || k > f || k > kTopkMaxK) return cudaErrorInvalidValue;
  const cudaError_t e = allow_topk_smem();
  if (e != cudaSuccess) return e;
  const int cap = topk_capacity(k);
  const unsigned blocks = (unsigned)((n + kTopkWarps - 1) / kTopkWarps);
  shortlist_topk_kernel<<<blocks, kTopkThreads, topk_smem_bytes(cap), (cudaStream_t)stream>>>(
      queries, tri, idx, d2, n, f, k, cap);
  return cudaGetLastError();
}

// K10: queries [n, 3], tri [f, 9] float64; d2 [n, f] float64
int icp_point_tri_d2(const double* queries, const double* tri, double* d2, int n, int f,
                     void* stream) {
  if ((long long)n * f == 0) return cudaSuccess;
  const unsigned fb = (unsigned)((f + kD2Threads - 1) / kD2Threads);
  const long long qb = ((long long)n + kD2Queries - 1) / kD2Queries;
  const dim3 grid(fb, (unsigned)(qb < 65535 ? qb : 65535));  // y strides over the rest
  point_tri_d2_kernel<<<grid, kD2Threads, 0, (cudaStream_t)stream>>>(queries, tri, d2, n, f);
  return cudaGetLastError();
}

}  // extern "C"
