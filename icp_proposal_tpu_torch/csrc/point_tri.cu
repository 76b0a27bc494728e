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
// 5.3 M pairs), over the H100's FP64 rate outside the tensor cores, or, for
// K10, the [N, F] float64 output over HBM bandwidth, whichever is larger.
//   Design (simple and exact first): K9 runs one block per query vertex.
//   Faces stream through a shared buffer of kTopkSort (d², id) entries in
//   tiles of kTopkSort − K faces: the first K entries hold the running
//   top-K, the rest one tile's d², computed one face a thread.  A bitonic
//   sort of the whole buffer by (NaN last, d², id), a total order, leaves
//   the best K of both in the first K entries.  Any F is taken (tiles);
//   K ≤ kTopkMaxK.  K10 is one thread per (query, face) pair, its store
//   coalesced along the faces.
//
// Every entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when that is not 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kTopkThreads = 256;  // K9: threads a block (one query)
constexpr int kTopkSort = 2048;    // K9: (d², id) entries in the shared buffer
constexpr int kTopkMaxK = 1024;    // K9: largest K; a tile then holds 1,024 faces
constexpr int kD2Threads = 256;    // K10: threads a block

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

__device__ __forceinline__ double face_d2(const V3& p, const double* __restrict__ tri,
                                          long long j) {
  const double* t = tri + 9 * j;
  const V3 a = {t[0], t[1], t[2]}, b = {t[3], t[4], t[5]}, c = {t[6], t[7], t[8]};
  return point_tri_d2(p, a, b, c);
}

// (ad, ai) before (bd, bi): numbers before NaN, then d², then id
__device__ __forceinline__ bool before(double ad, int ai, double bd, int bi) {
  const bool an = isnan(ad), bn = isnan(bd);
  if (an != bn) return bn;
  if (!an && ad != bd) return ad < bd;
  return ai < bi;
}

__global__ void __launch_bounds__(kTopkThreads)
    shortlist_topk_kernel(const double* __restrict__ queries, const double* __restrict__ tri,
                          int* __restrict__ out_idx, double* __restrict__ out_d2, int f,
                          int k) {
  __shared__ double sd[kTopkSort];
  __shared__ int si[kTopkSort];
  const long long q = blockIdx.x;
  const V3 p = {queries[3 * q], queries[3 * q + 1], queries[3 * q + 2]};
  const double pad = __longlong_as_double(0x7ff8000000000000LL);  // NaN, id INT_MAX
  for (int s = threadIdx.x; s < k; s += kTopkThreads) {
    sd[s] = pad;
    si[s] = INT_MAX;
  }
  const int tile = kTopkSort - k;
  for (int base = 0; base < f; base += tile) {
    for (int s = k + threadIdx.x; s < kTopkSort; s += kTopkThreads) {
      const int j = base + (s - k);
      if (j < f) {
        sd[s] = face_d2(p, tri, j);
        si[s] = j;
      } else {
        sd[s] = pad;
        si[s] = INT_MAX;
      }
    }
    __syncthreads();
    // bitonic sort of the whole buffer, ascending
    for (int size = 2; size <= kTopkSort; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < kTopkSort / 2; t += kTopkThreads) {
          const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
          const bool up = (lo & size) == 0;
          const double dl = sd[lo], dh = sd[hi];
          const int il = si[lo], ih = si[hi];
          if (up ? before(dh, ih, dl, il) : before(dl, il, dh, ih)) {
            sd[lo] = dh;
            sd[hi] = dl;
            si[lo] = ih;
            si[hi] = il;
          }
        }
        __syncthreads();
      }
    }
  }
  for (int s = threadIdx.x; s < k; s += kTopkThreads) {
    out_idx[q * k + s] = si[s];
    out_d2[q * k + s] = sd[s];
  }
}

__global__ void __launch_bounds__(kD2Threads)
    point_tri_d2_kernel(const double* __restrict__ queries, const double* __restrict__ tri,
                        double* __restrict__ out, long long n, long long f) {
  const long long total = n * f;
  for (long long t = blockIdx.x * (long long)kD2Threads + threadIdx.x; t < total;
       t += (long long)gridDim.x * kD2Threads) {
    const long long i = t / f, j = t - i * f;
    const V3 p = {queries[3 * i], queries[3 * i + 1], queries[3 * i + 2]};
    out[t] = face_d2(p, tri, j);
  }
}

}  // namespace

extern "C" {

// K9: queries [n, 3], tri [f, 9] float64; idx [n, k] int32, d2 [n, k]
// float64; 0 < k ≤ min(f, kTopkMaxK)
int icp_shortlist_topk(const double* queries, const double* tri, int* idx, double* d2, int n,
                       int f, int k, void* stream) {
  if (n == 0 || k == 0) return cudaSuccess;
  if (k < 0 || k > f || k > kTopkMaxK) return cudaErrorInvalidValue;
  shortlist_topk_kernel<<<n, kTopkThreads, 0, (cudaStream_t)stream>>>(queries, tri, idx, d2,
                                                                     f, k);
  return cudaGetLastError();
}

// K10: queries [n, 3], tri [f, 9] float64; d2 [n, f] float64
int icp_point_tri_d2(const double* queries, const double* tri, double* d2, int n, int f,
                     void* stream) {
  const long long total = (long long)n * f;
  if (total == 0) return cudaSuccess;
  long long blocks = (total + kD2Threads - 1) / kD2Threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // the loop strides over the rest
  point_tri_d2_kernel<<<(unsigned)blocks, kD2Threads, 0, (cudaStream_t)stream>>>(
      queries, tri, d2, n, f);
  return cudaGetLastError();
}

}  // extern "C"
