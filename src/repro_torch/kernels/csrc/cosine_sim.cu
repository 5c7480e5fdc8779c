// Pairwise cosine similarity for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cosine_sim.py::cosine_similarity
// (Pallas; grid (P/bp, D/bd) with the D reduction innermost, an MXU
// dot-general per tile, sums carried in VMEM scratch across grid steps).
//
//   sims[c, p, k] = <x_p, c_k> / max(sqrt(|x_p|^2 * |c_k|^2), eps)
//
// What bounds it on the card: bytes. Each x element is read once and takes
// 2K + 2 flops (K <= 8 on the main path), far below the ~20 flop/byte
// float32 ridge; the output is P*K floats. At the main-path shapes
// (P <= 512, D = 128) the whole call is a few hundred KB, so launch latency
// dominates and the design keeps the kernel one launch for every cohort.
//
// Design: one block per (tile of kRows rows, cohort c), the cohort axis on
// gridDim.y. The block stages a D-tile of the K centroids in shared memory
// (upcast to f32 once per block) and sums the K centroid norms once. One
// warp owns one row at a time; its lanes stride over D (coalesced loads)
// and every dot product is reduced by a fixed-order butterfly shuffle.
// Partial sums across D tiles accumulate in shared memory, each element
// owned by lane 0 of one warp and added in tile order, so results are
// bit-identical run to run (no atomics). Sums are not carried between
// blocks: the TPU's sequential grid axis over D becomes the in-block tile
// loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;
constexpr int kSmemBudget = 96 * 1024;  // dynamic shared memory per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cosine_sim_kernel(const T* __restrict__ x, const T* __restrict__ cen,
                  float* __restrict__ out, int P, int K, int D, int tile_d,
                  float eps) {
  extern __shared__ float smem[];
  float* cs = smem;                          // (K, tile_d) centroid tile
  float* c2 = cs + (size_t)K * tile_d;       // (K,) centroid |c|^2
  float* acc = c2 + K;                       // (kRows, K) partial dots
  float* x2 = acc + kRows * K;               // (kRows,) row |x|^2

  const int cz = blockIdx.y;
  const T* xb = x + (size_t)cz * P * D;
  const T* cb = cen + (size_t)cz * K * D;
  float* ob = out + (size_t)cz * P * K;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < K; i += kThreads) c2[i] = 0.f;
  for (int i = threadIdx.x; i < kRows * K; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kRows; i += kThreads) x2[i] = 0.f;

  for (int d0 = 0; d0 < D; d0 += tile_d) {
    const int td = min(tile_d, D - d0);
    __syncthreads();  // the previous tile is consumed, zero-init visible
    for (int i = threadIdx.x; i < K * td; i += kThreads) {
      const int k = i / td, d = i - k * td;
      cs[k * tile_d + d] = to_f32(cb[(size_t)k * D + d0 + d]);
    }
    __syncthreads();
    for (int k = warp; k < K; k += kWarps) {
      float s = 0.f;
      for (int d = lane; d < td; d += 32) {
        const float v = cs[k * tile_d + d];
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) c2[k] += s;
    }
    for (int r = warp; r < kRows; r += kWarps) {
      const int p = row0 + r;
      if (p >= P) break;
      const T* xr = xb + (size_t)p * D + d0;
      float s2 = 0.f;
      for (int d = lane; d < td; d += 32) {
        const float v = to_f32(xr[d]);
        s2 += v * v;
      }
      s2 = warp_sum(s2);
      if (lane == 0) x2[r] += s2;
      for (int k = 0; k < K; ++k) {
        const float* ck = cs + k * tile_d;
        float s = 0.f;
        for (int d = lane; d < td; d += 32) s += to_f32(xr[d]) * ck[d];
        s = warp_sum(s);
        if (lane == 0) acc[r * K + k] += s;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
    const int r = i / K, k = i - r * K, p = row0 + r;
    if (p < P) ob[(size_t)p * K + k] = acc[i] / fmaxf(sqrtf(x2[r] * c2[k]), eps);
  }
}

template <typename T>
int launch(const void* x, const void* c, void* out, int C, int P, int K, int D,
           float eps, cudaStream_t stream) {
  // widest 32-multiple D tile that fits the shared-memory budget
  const int fixed = K + kRows * K + kRows;
  int tile_d = (kSmemBudget / 4 - fixed) / K;
  tile_d = (tile_d / 32) * 32;
  const int d_round = ((D + 31) / 32) * 32;
  if (tile_d > d_round) tile_d = d_round;
  if (tile_d < 32) return (int)cudaErrorInvalidValue;  // K too large
  const size_t smem = sizeof(float) * ((size_t)K * tile_d + fixed);
  if (smem > 48 * 1024) {  // above 48 KB only after an explicit opt-in
    cudaError_t e = cudaFuncSetAttribute(
        cosine_sim_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((P + kRows - 1) / kRows, C);
  cosine_sim_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<float*>(out), P, K, D, tile_d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (C, P, D), c: (C, K, D), out: (C, P, K) f32; all contiguous.
// dtype 0 = float32, 1 = bfloat16 (both inputs). Returns a cudaError_t.
extern "C" int auxo_cosine_similarity(const void* x, const void* c, void* out,
                                      int C, int P, int K, int D, int dtype,
                                      float eps, void* stream) {
  if (C <= 0 || P <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, c, out, C, P, K, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, c, out, C, P, K, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
