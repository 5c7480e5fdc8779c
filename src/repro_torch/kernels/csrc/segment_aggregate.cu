// Weighted segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/segment_aggregate.py::segment_aggregate (Pallas; the
// scatter recast as a weighted one-hot matmul on the MXU, grid (D/bd, P/bp)
// with P innermost accumulating a (K, bd) tile in VMEM scratch).
//
//   out[c, k, :] = sum_{p : ids[c, p] == k} w[c, p] * data[c, p, :]
//
// ids outside [0, K) contribute nothing; w == nullptr means weight 1.
//
// What bounds it on the card: bytes. Every data element is read once and
// takes one multiply and one add; K*D floats are written. A one-hot matmul
// would spend K times the useful flops and buys nothing here.
//
// Design: every output element is reduced in one fixed order, so results
// are bit-identical run to run (no float atomics; index_add_ on CUDA
// reduces with atomics and is not). For K <= 8 a block owns 32 columns of
// one cohort and splits their rows over 8 row groups (threadIdx.y): group
// g sums rows p = g, g + 8, ... in index order with all K accumulators in
// registers, so data is read exactly once and 8x more loads are in flight
// than with one thread per column; the 8 partial sums of each (k, column)
// are then added in group order through shared memory. A warp holds 32
// consecutive columns of one row, so every row read is coalesced. For
// larger K one thread owns one (c, k, d) and walks all rows. Ids and
// weights are staged per P-tile in shared memory. The product is rounded
// before the add (__fmul_rn, never contracted into an FMA), as the plain
// version computes it. grid = (ceil(D / 32), C), or (ceil(D / 256), K, C).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 256;
constexpr int kRegK = 8;
constexpr int kCols = 32;               // columns per block (one warp wide)
constexpr int kGroups = kThreads / kCols;  // row groups per block
static_assert(kRegK <= kGroups, "one row group finishes each output row");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Stage ids/weights of rows [p0, p0 + tp) into shared memory.
__device__ __forceinline__ void stage(int* sid, float* sw, const int* ib,
                                      const float* wb, int p0, int tp, int tid) {
  __syncthreads();  // the previous tile is consumed
  for (int i = tid; i < tp; i += kThreads) {
    sid[i] = ib[p0 + i];
    sw[i] = wb ? wb[p0 + i] : 1.f;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_agg_regs(const T* __restrict__ data, const int* __restrict__ ids,
             const float* __restrict__ w, float* __restrict__ out, int P, int K,
             int D) {
  __shared__ int sid[kTileP];
  __shared__ float sw[kTileP];
  __shared__ float part[kGroups][kRegK][kCols];
  const int cz = blockIdx.y;
  const int col = threadIdx.x;    // 0..31
  const int grp = threadIdx.y;    // 0..7
  const int tid = grp * kCols + col;
  const int d = blockIdx.x * kCols + col;
  const T* db = data + (size_t)cz * P * D;
  const int* ib = ids + (size_t)cz * P;
  const float* wb = w ? w + (size_t)cz * P : nullptr;
  float acc[kRegK];
#pragma unroll
  for (int k = 0; k < kRegK; ++k) acc[k] = 0.f;
  for (int p0 = 0; p0 < P; p0 += kTileP) {
    const int tp = min(kTileP, P - p0);
    stage(sid, sw, ib, wb, p0, tp, tid);
    if (d < D) {
      for (int i = grp; i < tp; i += kGroups) {
        const int s = sid[i];
        if (s < 0 || s >= K) continue;
        const float v = __fmul_rn(sw[i], to_f32(db[(size_t)(p0 + i) * D + d]));
#pragma unroll
        for (int k = 0; k < kRegK; ++k)
          if (k == s) acc[k] += v;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRegK; ++k) part[grp][k][col] = acc[k];
  __syncthreads();
  // row group g finishes output row k = g: the 8 partials in group order
  if (d < D && grp < K) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += part[g][grp][col];
    out[((size_t)cz * K + grp) * D + d] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_agg_generic(const T* __restrict__ data, const int* __restrict__ ids,
                const float* __restrict__ w, float* __restrict__ out, int P,
                int K, int D) {
  __shared__ int sid[kTileP];
  __shared__ float sw[kTileP];
  const int k = blockIdx.y;
  const int cz = blockIdx.z;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const T* db = data + (size_t)cz * P * D;
  const int* ib = ids + (size_t)cz * P;
  const float* wb = w ? w + (size_t)cz * P : nullptr;
  float acc = 0.f;
  for (int p0 = 0; p0 < P; p0 += kTileP) {
    const int tp = min(kTileP, P - p0);
    stage(sid, sw, ib, wb, p0, tp, threadIdx.x);
    if (d < D) {
      for (int i = 0; i < tp; ++i)
        if (sid[i] == k)
          acc += __fmul_rn(sw[i], to_f32(db[(size_t)(p0 + i) * D + d]));
    }
  }
  if (d < D) out[((size_t)cz * K + k) * D + d] = acc;
}

template <typename T>
int launch(const void* data, const int* ids, const float* w, void* out, int C,
           int P, int K, int D, cudaStream_t stream) {
  const T* x = static_cast<const T*>(data);
  float* o = static_cast<float*>(out);
  if (K <= kRegK) {
    const dim3 grid((D + kCols - 1) / kCols, C), block(kCols, kGroups);
    seg_agg_regs<T><<<grid, block, 0, stream>>>(x, ids, w, o, P, K, D);
  } else {
    const dim3 grid((D + kThreads - 1) / kThreads, K, C);
    seg_agg_generic<T><<<grid, kThreads, 0, stream>>>(x, ids, w, o, P, K, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// data: (C, P, D), ids: (C, P) int32, w: (C, P) f32 or null, out: (C, K, D)
// f32; all contiguous. dtype 0 = float32, 1 = bfloat16. Returns a
// cudaError_t. P may be 0 (the kernel then writes zeros).
extern "C" int auxo_segment_aggregate(const void* data, const void* ids,
                                      const void* w, void* out, int C, int P,
                                      int K, int D, int dtype, void* stream) {
  if (C <= 0 || K <= 0 || D <= 0 || P < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) return launch<float>(data, i, wf, out, C, P, K, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(data, i, wf, out, C, P, K, D, s);
  return (int)cudaErrorInvalidValue;
}
