// Weighted segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/segment_aggregate.py::segment_aggregate (Pallas; the
// scatter recast as a weighted one-hot matmul on the MXU, grid (D/bd, P/bp)
// with P innermost accumulating a (K, bd) tile in VMEM scratch).
//
//   out[c, k, :] = sum_{p : ids[c, p] == k} w[c, p] * data[c, p, :]
//
// ids outside [0, K) contribute nothing; w == nullptr means weight 1. Ids
// are read as the caller gives them (int32 or int64), so a call is one
// launch with no cast before it.
//
// What bounds it on the card: bytes. Every data element is read once and
// takes one multiply and one add; K*D floats are written. A one-hot matmul
// would spend K times the useful flops, and would group the rows by the
// GEMM's blocking instead of adding them in order.
//
// The order of every sum is fixed, and it is the plain version's
// (``index_add_``): out[c, k, d] = ((+0 + w_1 x_1) + w_2 x_2) + ... over the
// rows with id k in increasing row order, each product rounded before its
// add (__fmul_rn, then __fadd_rn: never contracted into an FMA). So a
// segment's sum has the same bits wherever its rows sit (at any offset, in
// any cohort block of a stacked call, across any chunk boundary), two
// launches are bit-identical, and the card gives the CPU's bits. No float
// atomics: every output element has one owner.
//
// Design. Row order leaves no parallelism over one segment's rows, so the
// work is split over (segment, column vector) pairs only, and each pair is
// one thread's chain of adds, kept in registers.
//  - A block owns one cohort, one segment and a span of column vectors;
//    the planner in kernels/segment_aggregate.py picks the span. It lists
//    the segment's rows once, in row order, and sweeps its whole span with
//    the list: each warp loads the ids of a contiguous range of rows (4
//    steps of loads in flight) and compacts the matching rows with a ballot
//    a step, and the ranges are joined in warp order (up to 128 rows, warp
//    0 lists them all alone, with no barrier between).
//  - A column is read as one vector of VB bytes (16, 8, 4, or 2 for an odd
//    bf16 row): the largest that divides the row's bytes and the data's
//    address, so every row of every cohort starts on a whole vector and a
//    row never has a ragged start or tail. The planner takes a narrower
//    vector where the pairs would not fill two waves of the SMs: a thread
//    keeps as many rows in flight whatever VB is, so more, narrower
//    chains keep more bytes in flight.
//  - Each thread takes (segment, vector) pairs of its block in turn. A
//    batch loads R rows of U pairs with ld.global.nc straight from HBM
//    (each load predicated on its row), then adds them in row order; each
//    output vector is written once. Every lane runs the batch's adds
//    (masked), so R follows the segments' mean length: 32 rows of 1 pair
//    from 8 rows a segment, 8 rows of 1 pair, or 2 rows of 4 pairs for
//    segments under 4 rows; 16-byte vectors take 4 rows of 2 pairs, so a
//    2-row segment (the LM leaves' aggregation) has 4 loads of 16 bytes in
//    flight a thread.
//  - Past kChunk rows the lists are built a chunk at a time; a later chunk
//    continues each sum from the value the earlier ones stored in the
//    output (written and read back by the same thread, so exact), never
//    starting a partial sum of its own.
#include "common.cuh"

using namespace auxo;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kChunk = 4096;  // rows whose list a block holds at once

// The VB-byte vector of a row as 32-bit words (a 2-byte vector in one).
template <int VB>
struct Words {
  static constexpr int n = VB >= 4 ? VB / 4 : 1;
};

// Element e of a vector as a float (a bf16 is the high half of its f32:
// exact; the lower-addressed bf16 sits in a word's low half).
template <typename T, int VB>
__device__ __forceinline__ float element(const unsigned (&w)[Words<VB>::n], int e) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[e]);
  else if constexpr (VB == 2) return __uint_as_float(w[0] << 16);
  else return (e & 1) ? __uint_as_float(w[e >> 1] & 0xffff0000u) : __uint_as_float(w[e >> 1] << 16);
}

// The VB-byte vector at p in global memory (ld.global.nc) as 32-bit words
// (a 2-byte vector in one).
template <int VB>
__device__ __forceinline__ void load_words(const void* p, unsigned (&w)[Words<VB>::n]) {
  if constexpr (VB == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (VB == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x, w[1] = u.y;
  } else if constexpr (VB == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

template <int E>
__device__ __forceinline__ void store_sums(float* o, const float (&a)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E / 4; ++j)
      reinterpret_cast<float4*>(o)[j] = make_float4(a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
  } else {
    o[0] = a[0];
  }
}

template <int E>
__device__ __forceinline__ void load_sums(const float* o, float (&a)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(o)[j];
      a[4 * j] = f.x, a[4 * j + 1] = f.y, a[4 * j + 2] = f.z, a[4 * j + 3] = f.w;
    }
  } else if constexpr (E == 2) {
    const float2 f = *reinterpret_cast<const float2*>(o);
    a[0] = f.x, a[1] = f.y;
  } else {
    a[0] = o[0];
  }
}

// Shared memory of a block: each warp's count of listed rows and the
// list's length (cnt[nw]), then per chunk row its weight, a scratch row
// index, and the list (chunk rows, in order).
struct Lists {
  int* cnt;  // [nw + 1]
  float* w;  // [chunk]
  int* tmp;  // [chunk]
  int* row;  // [chunk]
};

__device__ __forceinline__ Lists carve(unsigned char* smem, int chunk) {
  const int nw = blockDim.x >> 5;
  Lists l;
  l.cnt = reinterpret_cast<int*>(smem);
  l.w = reinterpret_cast<float*>(l.cnt + nw + 1);
  l.tmp = reinterpret_cast<int*>(l.w + chunk);
  l.row = l.tmp + chunk;
  return l;
}

constexpr int kIdsInFlight = 4;  // steps of ids (and weights) a warp loads at once

// The list of rows [p0, p0 + n) of one cohort whose id is `seg`: chunk rows
// (p - p0) in increasing order at row[0, cnt[nw]), their weights at w[p -
// p0]. Every thread calls; the list is read after the caller's next
// barrier.
template <typename I>
__device__ void build_list(const I* __restrict__ ib, const float* __restrict__ wb, int p0, int n,
                           int seg, const Lists& l) {
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  // up to kIdsInFlight steps of rows, warp 0 lists them all, straight into
  // the list; else warp w walks the rows [lo, hi) in order, the ranges in
  // the warps' order, and compacts them into tmp[lo, lo + c) first
  const bool solo = n <= 32 * kIdsInFlight;
  const int per = solo ? n : ((n + nw - 1) / nw + 31) & ~31;
  const int lo = min(n, warp * per), hi = min(n, lo + per);
  int* dst = solo ? l.row : l.tmp;
  int c = 0;
  for (int b = lo; b < hi; b += 32 * kIdsInFlight) {
    bool hit[kIdsInFlight];
    float wt[kIdsInFlight];
#pragma unroll
    for (int t = 0; t < kIdsInFlight; ++t) {
      const int p = b + 32 * t + lane;
      hit[t] = false;
      if (p < hi) {
        hit[t] = __ldg(ib + p0 + p) == (I)seg;
        if (wb) wt[t] = __ldg(wb + p0 + p);
      }
    }
#pragma unroll
    for (int t = 0; t < kIdsInFlight; ++t) {
      const unsigned bits = __ballot_sync(0xffffffffu, hit[t]);
      if (hit[t]) {
        const int p = b + 32 * t + lane;
        dst[lo + c + __popc(bits & below)] = p;
        if (wb) l.w[p] = wt[t];
      }
      c += __popc(bits);
    }
  }
  if (solo) {
    if (threadIdx.x == 0) l.cnt[nw] = c;
    return;
  }
  if (lane == 0) l.cnt[warp] = c;
  __syncthreads();
  int start = 0, total = 0;
  for (int v = 0; v < nw; ++v) {
    const int x = l.cnt[v];
    start += v < warp ? x : 0;
    total += x;
  }
  for (int k = lane; k < c; k += 32) l.row[start + k] = l.tmp[lo + k];
  if (threadIdx.x == 0) l.cnt[nw] = total;
}

// grid (K x nspan, C), block `threads` (a multiple of 32, at most 256).
// Block (x, c) owns cohort c, segment x / nspan and vectors [v0, v0 +
// span) of each row (fewer in the last span). Dynamic shared memory: Lists
// for `chunk` rows.
template <typename T, typename I, int VB, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
seg_sum(const T* __restrict__ data, const I* __restrict__ ids, const float* __restrict__ w,
        float* __restrict__ out, int P, int K, int D, int span, int nspan, int chunk) {
  constexpr int E = VB / (int)sizeof(T);  // columns of a vector
  // pairs a thread sums at once and rows of each in flight: 2 of 2
  // 16-byte vectors; 4 pairs of 2 rows where segments are short, else 1
  // pair of ROWS rows
  constexpr int U = VB == 16 ? 2 : (ROWS == 2 ? 4 : 1);
  constexpr int R = VB == 16 ? 4 : ROWS;
  constexpr int NW = Words<VB>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  const int seg = blockIdx.x / nspan, sp = blockIdx.x - seg * nspan;
  const int nv = D / E, v0 = sp * span, nvb = min(span, nv - v0);
  const int cz = blockIdx.y;
  const T* db = data + (size_t)cz * P * D + (size_t)v0 * E;
  const I* ib = ids + (size_t)cz * P;
  const float* wb = w ? w + (size_t)cz * P : nullptr;
  float* ob = out + ((size_t)cz * K + seg) * D + (size_t)v0 * E;
  const Lists l = carve(smem, chunk);
  const int nw = blockDim.x >> 5;
  const int nch = P > 0 ? (P + chunk - 1) / chunk : 1;  // no rows: one pass of zeros
  for (int c = 0; c < nch; ++c) {
    const int p0 = c * chunk;
    build_list(ib, wb, p0, min(chunk, P - p0), seg, l);
    __syncthreads();
    const int n = l.cnt[nw];
    // a later chunk with no rows leaves every sum as it stands
    for (int i0 = threadIdx.x; i0 < (c == 0 || n > 0 ? nvb : 0); i0 += U * blockDim.x) {
      // the thread's vectors j[u] of the span
      int j[U];
      bool own[U];
      float acc[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        j[u] = i0 + u * blockDim.x;
        own[u] = j[u] < nvb;
        if (c == 0 || !own[u]) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[u][e] = 0.f;
        } else {
          load_sums<E>(ob + (size_t)j[u] * E, acc[u]);
        }
      }
      for (int q = 0; q < n; q += R) {
        // a batch of R rows: every load first (each predicated on its row,
        // no branch), then the adds in row order
        unsigned x[U][R][NW];
        int row[R];
#pragma unroll
        for (int r = 0; r < R; ++r) row[r] = l.row[min(q + r, n - 1)];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (own[u] && q + r < n)
              load_words<VB>(db + (size_t)(p0 + row[r]) * D + (size_t)j[u] * E, x[u][r]);
            else
#pragma unroll
              for (int k = 0; k < NW; ++k) x[u][r][k] = 0u;
          }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool in = q + r < n;
          const float wr = wb ? l.w[row[r]] : 1.f;
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float v = element<T, VB>(x[u][r], e);
              const float t = __fadd_rn(acc[u][e], wb ? __fmul_rn(wr, v) : v);
              acc[u][e] = in ? t : acc[u][e];
            }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (own[u]) store_sums<E>(ob + (size_t)j[u] * E, acc[u]);
    }
    __syncthreads();  // the next chunk rebuilds the list
  }
}

template <typename T, typename I, int VB, int ROWS>
int launch(const T* x, const I* ids, const float* w, float* out, int C, int P, int K, int D,
           int threads, int span, int chunk, cudaStream_t stream) {
  const int nv = (int)((long long)D * (long long)sizeof(T) / VB);
  const int nspan = (nv + span - 1) / span;
  const long long blocks = (long long)K * nspan;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)(threads / 32 + 1) + 12 * (size_t)chunk;
  if (int e = set_smem(seg_sum<T, I, VB, ROWS>, smem)) return e;
  const dim3 grid((unsigned)blocks, (unsigned)C);
  seg_sum<T, I, VB, ROWS><<<grid, threads, smem, stream>>>(x, ids, w, out, P, K, D, span, nspan, chunk);
  return (int)cudaGetLastError();
}

template <typename T, typename I, int VB>
int by_rows(const T* x, const I* ids, const float* w, float* out, int C, int P, int K, int D,
            int rows, int threads, int span, int chunk, cudaStream_t s) {
  if (rows != 2 && rows != 8 && rows != 32) return (int)cudaErrorInvalidValue;
  if constexpr (VB == 16 || VB == 2) {  // one batch shape for these
    return launch<T, I, VB, 8>(x, ids, w, out, C, P, K, D, threads, span, chunk, s);
  } else {
    if (rows == 2) return launch<T, I, VB, 2>(x, ids, w, out, C, P, K, D, threads, span, chunk, s);
    if (rows == 8) return launch<T, I, VB, 8>(x, ids, w, out, C, P, K, D, threads, span, chunk, s);
    return launch<T, I, VB, 32>(x, ids, w, out, C, P, K, D, threads, span, chunk, s);
  }
}

template <typename T, typename I>
int by_vector(const void* data, const I* ids, const float* w, float* out, int C, int P, int K,
              int D, int vb, int rows, int threads, int span, int chunk, cudaStream_t s) {
  const T* x = static_cast<const T*>(data);
  switch (vb) {
    case 16: return by_rows<T, I, 16>(x, ids, w, out, C, P, K, D, rows, threads, span, chunk, s);
    case 8: return by_rows<T, I, 8>(x, ids, w, out, C, P, K, D, rows, threads, span, chunk, s);
    case 4: return by_rows<T, I, 4>(x, ids, w, out, C, P, K, D, rows, threads, span, chunk, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return by_rows<T, I, 2>(x, ids, w, out, C, P, K, D, rows, threads, span, chunk, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_ids(const void* data, const void* ids, int id_dtype, const float* w, float* out, int C,
           int P, int K, int D, int vb, int rows, int threads, int span, int chunk, cudaStream_t s) {
  if (id_dtype == 0)
    return by_vector<T, int>(data, static_cast<const int*>(ids), w, out, C, P, K, D, vb, rows,
                             threads, span, chunk, s);
  if (id_dtype == 1)
    return by_vector<T, long long>(data, static_cast<const long long*>(ids), w, out, C, P, K, D,
                                   vb, rows, threads, span, chunk, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// data: (C, P, D), ids: (C, P) int32 (id_dtype 0) or int64 (1), w: (C, P)
// f32 or null, out: (C, K, D) f32; all contiguous. dtype 0 = float32, 1 =
// bfloat16. The plan (kernels/segment_aggregate.py::plan): vec_bytes (16,
// 8, 4 or 2, dividing the row's bytes and the data's address), rows (2, 8
// or 32: rows of a pair in flight), threads (a multiple of 32, at most
// 256), span (vectors of a row a block) and chunk (rows listed at once, at
// most 4096). Returns a cudaError_t. P may be 0 (the kernel then writes
// zeros).
extern "C" int auxo_segment_aggregate(const void* data, const void* ids, const void* w, void* out,
                                      int C, int P, int K, int D, int dtype, int id_dtype,
                                      int vec_bytes, int rows, int threads, int span, int chunk,
                                      void* stream) {
  const int el = dtype == 0 ? 4 : 2;
  if (C <= 0 || C > 65535 || K <= 0 || D <= 0 || P < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (vec_bytes < el || vec_bytes > 16 || (vec_bytes & (vec_bytes - 1)) ||
      ((long long)D * el) % vec_bytes || reinterpret_cast<uintptr_t>(data) % vec_bytes)
    return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || span < 1 || chunk < 1 ||
      chunk > kChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return by_ids<float>(data, ids, id_dtype, wf, o, C, P, K, D, vec_bytes, rows, threads, span,
                         chunk, s);
  return by_ids<__nv_bfloat16>(data, ids, id_dtype, wf, o, C, P, K, D, vec_bytes, rows, threads,
                               span, chunk, s);
}
