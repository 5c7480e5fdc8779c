// Pairwise cosine similarity for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/cosine_sim.py::cosine_similarity
// (Pallas; grid (P/bp, D/bd) with the D reduction innermost, an MXU
// dot-general per tile, sums carried in VMEM scratch across grid steps).
//
//   sims[c, p, k] = <x_p, c_k> / max(sqrt(|x_p|^2 * |c_k|^2), eps)
//
// What bounds it on the card: bytes at the main path (K <= 8: 2K + 2 flops
// per element read, far below the ~20 flop/byte float32 ridge); at K = 16-32
// a row does 32-64 flops per element, so in f32 the CUDA cores and in bf16
// the tensor cores set the pace unless the product is tiled in registers.
//
// Three kernels, one launch per call:
//  - rows (f32 K <= 8, bf16 K < 8: the main path): one warp per row, no
//    shared memory and no barrier. Each lane loads 16-byte vectors of x and
//    of every centroid at the same columns (the centroids through L1,
//    shared by the block's warps), so |x|^2, the K dots and the K centroid
//    norms come from the same registers in one pass, and the 2K + 1
//    partials are reduced together by one interleaved butterfly (16 or 32
//    slots halved at each step: 16 or 31 shuffles, not 5(2K + 1)). Blocks
//    of 1-8 warps, the most that still fill a wave.
//  - f32 tiled (K > 8): a block takes 32 rows x 32 centroids; a 4 x 4
//    register tile of rows x centroids per thread (exact FMA, no TF32),
//    fed from a ring of 6 shared-memory D tiles filled by cp.async, each
//    tile split over 4 k-groups of threads whose sums are added in order
//    at the end; |x|^2 and |c|^2 come from the same tiles.
//  - bf16 tensor cores (K >= 8): mma.sync m16n8k16 with float32
//    accumulation, rows on M, centroids on N, D the reduction; a block of
//    8 warps takes 32 rows x 32 centroids, each warp 16 rows and one k16
//    step of every 64-wide tile (ring of 6 tiles by cp.async, fragments by
//    ldmatrix), the 4 k-groups' sums added in order at the end; the norms
//    in float32 from the same tiles.
// Each output is written once by one thread; every sum has a fixed order
// (no atomics), so two launches are bit-identical.
#include "common.cuh"

using namespace auxo;

namespace {

constexpr int kRowsMaxK = 8;

// ----------------------------------------------------------- rows kernel
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC > 1) {
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  } else {
    v[0] = to_f32(p[0]);
  }
}

// One row per warp, no shared memory and no barrier. A lane takes VEC
// elements at a time (16 bytes, or 1 when the rows are not 16-byte
// aligned) of x and of every centroid at the same columns (the centroids
// come through L1, shared by the block's warps). KM >= K centroids are
// read (k >= K re-reads centroid K - 1 and is never written), so every
// load is unconditional and all of them are in flight at once. Slot 0
// sums |x|^2, slots 1..KM the dots, slots KM+1..2KM the centroid norms,
// all reduced by one reduce_slots over NS >= 2KM + 1 slots.
template <typename T, int VEC, int KM>
__global__ void __launch_bounds__(256)
cos_rows(const T* __restrict__ x, const T* __restrict__ cen, float* __restrict__ out, int P,
         int K, int D, float eps) {
  constexpr int NS = KM == 2 ? 8 : KM == 4 ? 16 : 32;
  constexpr int kLanesPerSlot = 32 / NS;
  const int W = blockDim.x / 32, lane = threadIdx.x % 32;
  const int cz = blockIdx.y, p = blockIdx.x * W + threadIdx.x / 32;
  if (p >= P) return;
  const T* xr = x + ((size_t)cz * P + p) * D;
  const T* cb = cen + (size_t)cz * K * D;
  float a[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) a[j] = 0.f;
  for (int d = lane * VEC; d < D; d += 32 * VEC) {
    float xv[VEC], cv[KM][VEC];
    load_vec<T, VEC>(xr + d, xv);
#pragma unroll
    for (int k = 0; k < KM; ++k) load_vec<T, VEC>(cb + (size_t)min(k, K - 1) * D + d, cv[k]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[0] = fmaf(xv[e], xv[e], a[0]);
#pragma unroll
    for (int k = 0; k < KM; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        a[1 + k] = fmaf(xv[e], cv[k][e], a[1 + k]);
        a[1 + KM + k] = fmaf(cv[k][e], cv[k][e], a[1 + KM + k]);
      }
  }
  const float tot = reduce_slots<NS>(a, lane);
  const int slot = lane / kLanesPerSlot;
  const bool writer = lane % kLanesPerSlot == 0 && slot >= 1 && slot <= K;
  const int cs = 1 + KM + (writer ? slot - 1 : 0);  // the slot of this centroid's norm
  const float x2 = __shfl_sync(0xffffffffu, tot, 0);
  const float c2 = __shfl_sync(0xffffffffu, tot, cs * kLanesPerSlot);
  if (writer) out[((size_t)cz * P + p) * K + slot - 1] = tot / fmaxf(sqrtf(x2 * c2), eps);
}

// -------------------------------------------------------- f32 tiled kernel
constexpr int kTN = 32;     // centroids of a block
constexpr int kTK = 32;     // D of an f32 tile
constexpr int kTPad = kTK + 4;
constexpr int kStages = 6;  // tiles in flight: the ring of both tiled kernels
constexpr int kTM = 32;     // rows of a block
constexpr int kKS = 4;      // k-groups: warps that split each D tile

// Stage rows [r0, r0 + nr) x columns [d0, d0 + kTK) of a (R, D) f32 matrix;
// rows past R and columns past D are zero. vec: 16-byte copies allowed.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int r0, int nr, int R,
                                          int D, int d0, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nr * (kTK / 4); i += blockDim.x) {
      const int r = i / (kTK / 4), c = (i % (kTK / 4)) * 4;
      const bool ok = r0 + r < R && d0 + c < D;
      cp_async<16>(dst + r * kTPad + c, ok ? src + (size_t)(r0 + r) * D + d0 + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nr * kTK; i += blockDim.x) {
      const int r = i / kTK, c = i % kTK;
      const bool ok = r0 + r < R && d0 + c < D;
      cp_async<4>(dst + r * kTPad + c, ok ? src + (size_t)(r0 + r) * D + d0 + c : src, ok ? 4 : 0);
    }
  }
}

// Sum of squares of n floats (a multiple of 4) in shared memory, in order.
template <int N>
__device__ __forceinline__ float sumsq_f32(const float* v, float acc) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(v + k);
    acc = fmaf(q.x, q.x, acc);
    acc = fmaf(q.y, q.y, acc);
    acc = fmaf(q.z, q.z, acc);
    acc = fmaf(q.w, q.w, acc);
  }
  return acc;
}

// 256 threads in kKS = 4 k-groups of 64. Thread (tx, ty) of a k-group owns
// rows ty + 8i and centroids tx + 8j (i, j < 4) of the block's 32 x 32
// tile, over columns [8kg, 8kg + 8) of every 32-wide D tile, which come
// through a ring of kStages tiles; the four k-groups' sums are then added
// in k-group order. |x|^2: k-group 0, two threads a row, one half of each
// tile each; |c|^2: k-group 1, two threads a centroid, likewise.
__global__ void __launch_bounds__(256)
cos_tiled_f32(const float* __restrict__ x, const float* __restrict__ cen, float* __restrict__ out,
              int P, int K, int D, float eps, bool vec) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                              // [kStages][kTM][kTPad]
  float* cs = xs + kStages * kTM * kTPad;      // [kStages][kTN][kTPad]
  float* x2h = cs + kStages * kTN * kTPad;     // [2][kTM] halves of |x|^2
  float* c2h = x2h + 2 * kTM;                  // [2][kTN] halves of |c|^2
  const int tid = threadIdx.x, kg = tid / 64, t = tid % 64, tx = t % 8, ty = t / 8;
  const int cz = blockIdx.z, r0 = blockIdx.x * kTM, k0 = blockIdx.y * kTN;
  const float* xb = x + (size_t)cz * P * D;
  const float* cb = cen + (size_t)cz * K * D + (size_t)k0 * D;
  const int Kb = min(kTN, K - k0);
  const int nrow = ty + 8 * (tx & 3), half = tx >> 2;  // the norm this thread sums
  float acc[4][4] = {};
  float nsq = 0.f;
  const int nt = (D + kTK - 1) / kTK;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) {
      stage_f32(xs + s * kTM * kTPad, xb, r0, kTM, P, D, s * kTK, vec);
      stage_f32(cs + s * kTN * kTPad, cb, 0, kTN, Kb, D, s * kTK, vec);
    }
    cp_commit();
  }
  for (int it = 0; it < nt; ++it) {
    const int b = it % kStages, tn = it + kStages - 1;
    if (tn < nt) {
      stage_f32(xs + (tn % kStages) * kTM * kTPad, xb, r0, kTM, P, D, tn * kTK, vec);
      stage_f32(cs + (tn % kStages) * kTN * kTPad, cb, 0, kTN, Kb, D, tn * kTK, vec);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    const float* xt = xs + b * kTM * kTPad;
    const float* ct = cs + b * kTN * kTPad;
#pragma unroll
    for (int k = 8 * kg; k < 8 * kg + 8; k += 4) {
      float4 xa[4], ca[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = *reinterpret_cast<const float4*>(xt + (ty + 8 * i) * kTPad + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) ca[j] = *reinterpret_cast<const float4*>(ct + (tx + 8 * j) * kTPad + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][j];
          s = fmaf(xa[i].x, ca[j].x, s);
          s = fmaf(xa[i].y, ca[j].y, s);
          s = fmaf(xa[i].z, ca[j].z, s);
          s = fmaf(xa[i].w, ca[j].w, s);
          acc[i][j] = s;
        }
    }
    if (kg == 0) nsq = sumsq_f32<kTK / 2>(xt + nrow * kTPad + half * (kTK / 2), nsq);
    if (kg == 1) nsq = sumsq_f32<kTK / 2>(ct + (t >> 1) * kTPad + (t & 1) * (kTK / 2), nsq);
    __syncthreads();  // this slot is refilled next step
  }
  if (kg == 0) x2h[half * kTM + nrow] = nsq;
  if (kg == 1) c2h[(t & 1) * kTN + (t >> 1)] = nsq;
  float* red = xs;  // the ring is free: k-groups 1..3 leave their sums here
  if (kg > 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[((kg - 1) * 16 + i * 4 + j) * 64 + t] = acc[i][j];
  __syncthreads();
  if (kg > 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i, p = r0 + r;
    const float xx = x2h[r] + x2h[kTM + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = acc[i][j];
#pragma unroll
      for (int g = 1; g < kKS; ++g) a += red[((g - 1) * 16 + i * 4 + j) * 64 + t];
      const int c = tx + 8 * j;
      if (p >= P || c >= Kb) continue;
      const float cc = c2h[c] + c2h[kTN + c];
      out[((size_t)cz * P + p) * K + k0 + c] = a / fmaxf(sqrtf(xx * cc), eps);
    }
  }
}

// ------------------------------------------------ bf16 tensor-core kernel
constexpr int kMK = 64;          // D of a bf16 tile
constexpr int kMPad = kMK + 8;   // 144-byte rows: ldmatrix without bank conflicts

// Stage rows [r0, r0 + nr) x [d0, d0 + 64) of a (R, D) bf16 matrix; zero
// past R and D. vec: rows 16-byte aligned (D % 8 == 0), else 2-byte loads.
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int nr, int R, int D, int d0, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < nr * (kMK / 8); i += blockDim.x) {
      const int r = i / (kMK / 8), c = (i % (kMK / 8)) * 8;
      const bool ok = r0 + r < R && d0 + c < D;
      cp_async<16>(dst + r * kMPad + c, ok ? src + (size_t)(r0 + r) * D + d0 + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nr * kMK; i += blockDim.x) {
      const int r = i / kMK, c = i % kMK;
      const bool ok = r0 + r < R && d0 + c < D;
      dst[r * kMPad + c] = ok ? src[(size_t)(r0 + r) * D + d0 + c] : __float2bfloat16(0.f);
    }
  }
}

// Sum of squares of N bf16 (a multiple of 8) in shared memory, in order, f32.
template <int N>
__device__ __forceinline__ float sumsq_bf16(const __nv_bfloat16* v, float acc) {
#pragma unroll
  for (int k = 0; k < N; k += 8) {
    float f[8];
    Vec<__nv_bfloat16>::unpack(*reinterpret_cast<const uint4*>(v + k), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(f[e], f[e], acc);
  }
  return acc;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 warps: warp w is row warp w % 2 (rows [16(w % 2), 16(w % 2) + 16) of
// the block's 32) and k-group kg = w / 2, and takes k16 step kg of every
// 64-wide D tile (ring of kStages tiles) for all 32 centroids (4 n-tiles
// of 8); the k-groups' sums are added in k-group order. |x|^2: k-group 0,
// two lanes a row, one half of each tile each; |c|^2: k-group 1, two
// threads a centroid, likewise.
__global__ void __launch_bounds__(256)
cos_mma_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ cen,
             float* __restrict__ out, int P, int K, int D, float eps, bool vec) {
  extern __shared__ __align__(16) unsigned char smraw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smraw);       // [kStages][kTM][kMPad]
  __nv_bfloat16* cs = xs + kStages * kTM * kMPad;                     // [kStages][kTN][kMPad]
  float* x2 = reinterpret_cast<float*>(cs + kStages * kTN * kMPad);  // [kTM]
  float* c2h = x2 + kTM;                                              // [2][kTN]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp % 2, kg = warp / 2, t = tid % 64;
  const int cz = blockIdx.z, r0 = blockIdx.x * kTM, k0 = blockIdx.y * kTN;
  const __nv_bfloat16* xb = x + (size_t)cz * P * D;
  const __nv_bfloat16* cb = cen + (size_t)cz * K * D + (size_t)k0 * D;
  const int Kb = min(kTN, K - k0);
  const int nrow = rw * 16 + (lane >> 1), half = lane & 1;  // |x|^2 of k-group 0
  float acc[4][4] = {};
  float nsq = 0.f;
  const int nt = (D + kMK - 1) / kMK;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) {
      stage_bf16(xs + s * kTM * kMPad, xb, r0, kTM, P, D, s * kMK, vec);
      stage_bf16(cs + s * kTN * kMPad, cb, 0, kTN, Kb, D, s * kMK, vec);
    }
    cp_commit();
  }
  for (int it = 0; it < nt; ++it) {
    const int b = it % kStages, tn = it + kStages - 1;
    if (tn < nt) {
      stage_bf16(xs + (tn % kStages) * kTM * kMPad, xb, r0, kTM, P, D, tn * kMK, vec);
      stage_bf16(cs + (tn % kStages) * kTN * kMPad, cb, 0, kTN, Kb, D, tn * kMK, vec);
    }
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    const __nv_bfloat16* xt = xs + b * kTM * kMPad;
    const __nv_bfloat16* ct = cs + b * kTN * kMPad;
    const int kk = 16 * kg;
    unsigned a[4], b01[4], b23[4];
    ldmatrix_x4(a, xt + (rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kMPad + kk + (lane >> 4) * 8);
    const int brow = (lane & 7) + (lane >> 4) * 8, bk = kk + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(b01, ct + brow * kMPad + bk);
    ldmatrix_x4(b23, ct + (16 + brow) * kMPad + bk);
    mma_bf16(acc[0], a, b01[0], b01[1]);
    mma_bf16(acc[1], a, b01[2], b01[3]);
    mma_bf16(acc[2], a, b23[0], b23[1]);
    mma_bf16(acc[3], a, b23[2], b23[3]);
    if (kg == 0) nsq = sumsq_bf16<kMK / 2>(xt + nrow * kMPad + half * (kMK / 2), nsq);
    if (kg == 1) nsq = sumsq_bf16<kMK / 2>(ct + (t >> 1) * kMPad + (t & 1) * (kMK / 2), nsq);
    __syncthreads();
  }
  float* red = reinterpret_cast<float*>(smraw);  // the ring is free: k-groups 1..3 leave their sums here
  if (kg == 0) {
    nsq += __shfl_xor_sync(0xffffffffu, nsq, 1);  // the row's two halves
    if (half == 0) x2[nrow] = nsq;
  }
  if (kg == 1) c2h[(t & 1) * kTN + (t >> 1)] = nsq;
  if (kg > 0)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(((kg - 1) * 2 + rw) * 16 + j * 4 + e) * 32 + lane] = acc[j][e];
  __syncthreads();
  if (kg > 0) return;
  // accumulator (n-tile j): c0, c1 at row g, c2, c3 at row g + 8; columns
  // 8j + 2q, 8j + 2q + 1 (g = lane / 4, q = lane % 4)
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = acc[j][e];
#pragma unroll
      for (int u = 1; u < kKS; ++u) v += red[(((u - 1) * 2 + rw) * 16 + j * 4 + e) * 32 + lane];
      const int r = rw * 16 + g + (e >> 1) * 8, c = 8 * j + 2 * q + (e & 1), p = r0 + r;
      if (p >= P || c >= Kb) continue;
      const float cc = c2h[c] + c2h[kTN + c];
      out[((size_t)cz * P + p) * K + k0 + c] = v / fmaxf(sqrtf(x2[r] * cc), eps);
    }
}

// Warps a block (one row each): the most in {8, 4, 2, 1} whose grid of
// `rows` rows still fills `sms` SMs.
int warps_for(long long rows, int sms) {
  int w = 8;
  while (w > 1 && rows / w < sms) w >>= 1;
  return w;
}

template <typename T, int VEC>
int launch_rows_vec(const T* x, const T* c, float* out, int C, int P, int K, int D, float eps,
                    int sms, cudaStream_t s) {
  const int W = warps_for((long long)C * P, sms);
  const dim3 grid(ceil_div(P, W), C);
  if (K <= 2)
    cos_rows<T, VEC, 2><<<grid, 32 * W, 0, s>>>(x, c, out, P, K, D, eps);
  else if (K <= 4)
    cos_rows<T, VEC, 4><<<grid, 32 * W, 0, s>>>(x, c, out, P, K, D, eps);
  else
    cos_rows<T, VEC, 8><<<grid, 32 * W, 0, s>>>(x, c, out, P, K, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const T* x, const T* c, float* out, int C, int P, int K, int D, float eps,
                bool vec, int sms, cudaStream_t s) {
  if (vec) return launch_rows_vec<T, Vec<T>::n>(x, c, out, C, P, K, D, eps, sms, s);
  return launch_rows_vec<T, 1>(x, c, out, C, P, K, D, eps, sms, s);
}

}  // namespace

// x: (C, P, D), c: (C, K, D), out: (C, P, K) f32; all contiguous. dtype 0 =
// float32, 1 = bfloat16 (both inputs). vec: both pointers and the row
// length in bytes are 16-byte aligned. sms: the card's SM count (sizes the
// grid). Returns a cudaError_t.
extern "C" int auxo_cosine_similarity(const void* x, const void* c, void* out, int C, int P, int K,
                                      int D, int dtype, float eps, int vec, int sms, void* stream) {
  if (C <= 0 || P <= 0 || K <= 0 || D < 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* cf = static_cast<const float*>(c);
    if (K <= kRowsMaxK) return launch_rows<float>(xf, cf, o, C, P, K, D, eps, vec, sms, s);
    const size_t smem = sizeof(float) * (kStages * (size_t)(kTM + kTN) * kTPad + 2 * kTM + 2 * kTN);
    if (int e = set_smem(cos_tiled_f32, smem)) return e;
    cos_tiled_f32<<<dim3(ceil_div(P, kTM), ceil_div(K, kTN), C), 256, smem, s>>>(xf, cf, o, P, K, D,
                                                                                 eps, vec);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(c);
    if (K < kRowsMaxK) return launch_rows<__nv_bfloat16>(xb, cb, o, C, P, K, D, eps, vec, sms, s);
    const size_t smem = sizeof(__nv_bfloat16) * kStages * (size_t)(kTM + kTN) * kMPad +
                        sizeof(float) * (kTM + 2 * kTN);
    if (int e = set_smem(cos_mma_bf16, smem)) return e;
    cos_mma_bf16<<<dim3(ceil_div(P, kTM), ceil_div(K, kTN), C), 256, smem, s>>>(xb, cb, o, P, K, D,
                                                                               eps, vec);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
