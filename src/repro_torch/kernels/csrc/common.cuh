// Device helpers shared by the segment-sum and cosine kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace auxo {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of T as floats
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x), v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z), v[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {  // a bf16 is the high half of its f32: exact
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// cp.async of N bytes (4, 8 or 16) into shared memory; src_bytes < N
// zero-fills the rest (0: nothing is read).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One step of reduce_slots: the H upper or lower slots kept, the other H
// swapped with the lane at offset H * LPS (LPS lanes share a slot at the end).
template <int H, int LPS, int NS>
__device__ __forceinline__ void reduce_step(float (&a)[NS], int lane) {
  constexpr int o = H * LPS;
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? a[i] : a[i + H];
    const float keep = up ? a[i + H] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
  if constexpr (H > 1) reduce_step<H / 2, LPS>(a, lane);
}

// NS slots (8, 16 or 32) of every lane summed over the warp at once: each
// step keeps half of the slots and swaps the other half with the partner
// lane, then plain steps sum the lanes that share a slot. Lane L ends with
// the total of slot L / (32 / NS). Each slot is summed in the order of an
// xor butterfly over the lanes, offsets 16, 8, 4, 2, 1 (float addition
// commutes, so keeping either half gives the same bits).
template <int NS>
__device__ __forceinline__ float reduce_slots(float (&a)[NS], int lane) {
  constexpr int kLanesPerSlot = 32 / NS;
  reduce_step<NS / 2, kLanesPerSlot>(a, lane);
  float v = a[0];
#pragma unroll
  for (int o = kLanesPerSlot / 2; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

}  // namespace auxo
