// Split-KV GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (Pallas; grid (B, S/bs) with the KV axis innermost and
// sequential on one core, the running max m, normaliser l and accumulator
// acc carried in VMEM scratch from one KV block to the next).
//
//   out[b, h] = softmax_t(<q[b,h], k[b,t,h/g]> / sqrt(hd), t < length[b]) · v[b,t,h/g]
//
// Positions t >= length[b] score -1e30, as in the reference. When
// length[b] > 0 they contribute exactly 0 (exp(-1e30 - m) underflows), so a
// block never reads them: the kernel moves sum_b length[b] tokens of K and
// V, not B * S. length[b] <= 0 keeps the reference's meaning: every score is
// -1e30 and the output is the mean of V over all S positions.
//
// What bounds it on the card: bytes. Every K/V element read takes 2 flops
// per query head of its group (4 on the main path), far below the float32
// ridge. At the main-path call (B = 8 lanes, length <= 33, H = 32,
// Hkv = 8, hd = 64, f32) one call reads about 1.1 MB, so launch latency
// bounds it. At a long cache (B = 8, S = 32768, same heads, f32) it reads
// 1.074 GB: a byte bound of 0.321 ms at 3.35 TB/s.
//
// Design. The TPU's sequential grid axis over S would leave the card idle
// at decode shapes (B * Hkv = 64 blocks on 132 SMs), so the KV axis is cut
// into n_split contiguous chunks instead (split-KV): grid (B * Hkv,
// n_split), one block per (sequence, KV head, chunk) that owns the g = H/Hkv
// query heads of that KV head. The wrapper picks n_split from the shape so
// that the grid fills the card about twice over. A block streams its chunk
// through shared memory in tiles of kTile tokens with 16-byte loads (one
// token's head row is hd contiguous elements; the batch and sequence
// strides are arguments, so one layer's slice of the paged cache is read
// in place), and keeps m, l and acc per query head in float32. A second
// small kernel merges the partials of each (sequence, KV head) in split
// order: m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
// out = acc / max(l, 1e-30). Every sum has one owner and a fixed order and
// nothing uses atomics, so a call is bit-identical from run to run.
// expf (not __expf) and a division by sqrt(hd) keep the float32 results
// within 2e-5 of the reference. No tensor cores: with 4 query heads per KV
// head, an MMA tile would be mostly empty.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // tokens per shared-memory tile: one per lane in the softmax step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes of a K or V row -> float32 in shared memory
__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

__host__ __device__ constexpr size_t smem_floats(int hd, int g) {
  return 2 * (size_t)kTile * hd + 2 * (size_t)g * hd + (size_t)g * kTile + 3 * (size_t)g;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int S, int Hkv, int g,
                    long long k_sb, long long k_ss, long long v_sb, long long v_ss,
                    int n_split) {
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // (kTile, HD), 16-byte aligned
  float* v_s = k_s + kTile * HD;                  // (kTile, HD)
  float* q_s = v_s + kTile * HD;                  // (g, HD)
  float* acc_s = q_s + g * HD;                    // (g, HD)
  float* p_s = acc_s + g * HD;                    // (g, kTile) scores, then probabilities
  float* m_s = p_s + g * kTile;                   // (g,) running max
  float* l_s = m_s + g;                           // (g,) running normaliser
  float* a_s = l_s + g;                           // (g,) this tile's rescale factor

  const int bn = blockIdx.x, split = blockIdx.y;
  const int b = bn / Hkv, n = bn - b * Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int len = length[b];
  const bool masked_all = len <= 0;  // the reference's length == 0: all of S, all -1e30
  const int n_eff = masked_all ? S : min(len, S);
  const int chunk = (n_eff + n_split - 1) / n_split;
  const int start = min(split * chunk, n_eff);
  const int end = min(start + chunk, n_eff);

  const T* qb = q + ((size_t)bn * g) * HD;  // heads n*g .. n*g+g-1 of sequence b
  for (int i = tid; i < g * HD; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int j = tid; j < g; j += kThreads) {
    m_s[j] = -INFINITY;
    l_s[j] = 0.f;
  }
  __syncthreads();

  const T* kb = k + (size_t)b * k_sb + (size_t)n * HD;
  const T* vb = v + (size_t)b * v_sb + (size_t)n * HD;
  const float sqrt_hd = sqrtf((float)HD);  // divide, as the reference does
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int tn = min(kTile, end - t0);
    // stage the tile's K and V rows, 16 bytes per thread and step
    for (int u = tid; u < tn * kPerRow; u += kThreads) {
      const int i = u / kPerRow, c = (u - i * kPerRow) * kVec;
      const long long t = t0 + i;
      load16(kb + t * k_ss + c, k_s + i * HD + c);
      load16(vb + t * v_ss + c, v_s + i * HD + c);
    }
    __syncthreads();
    // scores: warp w takes tokens w, w + kWarps, ...; its lanes stride over hd
    for (int i = warp; i < tn; i += kWarps) {
      for (int j = 0; j < g; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = lane; d < HD; d += 32) s = fmaf(q_s[j * HD + d], k_s[i * HD + d], s);
        s = warp_sum(s);
        if (lane == 0) p_s[j * kTile + i] = masked_all ? -1e30f : s / sqrt_hd;
      }
    }
    __syncthreads();
    // online softmax: warp w takes heads w, w + kWarps, ...; lane i holds token i
    for (int j = warp; j < g; j += kWarps) {
      const bool ok = lane < tn;
      const float s = ok ? p_s[j * kTile + lane] : -INFINITY;
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, warp_max(s));  // finite: the tile has a token
      const float p = ok ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      if (ok) p_s[j * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        m_s[j] = m_new;
        l_s[j] = l_s[j] * alpha + psum;
        a_s[j] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p · V: one owner per (head, dim), tokens in order
    for (int e = tid; e < g * HD; e += kThreads) {
      const int j = e / HD, d = e - j * HD;
      const float* pj = p_s + j * kTile;
      float a = acc_s[e] * a_s[j];
      for (int i = 0; i < tn; ++i) a = fmaf(pj[i], v_s[i * HD + d], a);
      acc_s[e] = a;
    }
    __syncthreads();
  }

  // an empty chunk leaves m = -inf, l = 0, acc = 0: weight 0 in the merge
  const size_t row = (size_t)bn * n_split + split;
  for (int j = tid; j < g; j += kThreads) {
    part_m[row * g + j] = m_s[j];
    part_l[row * g + j] = l_s[j];
  }
  for (int e = tid; e < g * HD; e += kThreads) part_acc[row * g * HD + e] = acc_s[e];
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out, int g,
                    int n_split) {
  const int bn = blockIdx.x;
  const float* pm = part_m + (size_t)bn * n_split * g;
  const float* pl = part_l + (size_t)bn * n_split * g;
  const float* pa = part_acc + (size_t)bn * n_split * g * HD;
  T* ob = out + (size_t)bn * g * HD;  // (b, n*g + j) rows of the (B, H, hd) output
  for (int e = threadIdx.x; e < g * HD; e += kThreads) {
    const int j = e / HD;
    float m = -INFINITY;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, pm[s * g + j]);  // finite: split 0 is never empty
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(pm[s * g + j] - m);
      l = fmaf(pl[s * g + j], w, l);
      a = fmaf(pa[(size_t)s * g * HD + e], w, a);
    }
    from_f32(a / fmaxf(l, 1e-30f), ob + e);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* length, void* out,
           void* part_m, void* part_l, void* part_acc, int B, int H, int Hkv, int S,
           long long k_sb, long long k_ss, long long v_sb, long long v_ss, int n_split,
           cudaStream_t stream) {
  const int g = H / Hkv;
  const size_t smem = sizeof(float) * smem_floats(HD, g);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;  // too many heads per KV head
  if (smem > 48 * 1024) {  // above 48 KB only after an explicit opt-in
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * Hkv, n_split);
  decode_split_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(length), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), S, Hkv, g, k_sb, k_ss,
      v_sb, v_ss, n_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge_kernel<T, HD><<<B * Hkv, kThreads, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), g, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int by_hd(int hd, const void* q, const void* k, const void* v, const void* length, void* out,
          void* pm, void* pl, void* pa, int B, int H, int Hkv, int S, long long k_sb,
          long long k_ss, long long v_sb, long long v_ss, int n_split, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, length, out, pm, pl, pa, B, H, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, s);
    case 32: return launch<T, 32>(q, k, v, length, out, pm, pl, pa, B, H, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, s);
    case 64: return launch<T, 64>(q, k, v, length, out, pm, pl, pa, B, H, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, s);
    case 128: return launch<T, 128>(q, k, v, length, out, pm, pl, pa, B, H, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, hd) contiguous; k, v: (B, S, Hkv, hd) with element (b, s, n, d)
// at b * *_sb + s * *_ss + n * hd + d (16-byte aligned rows); length: (B,)
// int32; out: (B, H, hd) in q's dtype; part_m, part_l: (B * Hkv, n_split,
// H / Hkv) f32 and part_acc: (B * Hkv, n_split, H / Hkv, hd) f32 scratch.
// dtype 0 = float32, 1 = bfloat16 (q, k, v and out). Returns a cudaError_t.
extern "C" int auxo_decode_attention(const void* q, const void* k, const void* v,
                                     const void* length, void* out, void* part_m,
                                     void* part_l, void* part_acc, int B, int H, int Hkv,
                                     int hd, int S, long long k_sb, long long k_ss,
                                     long long v_sb, long long v_ss, int n_split, int dtype,
                                     void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || n_split < 1 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_hd<float>(hd, q, k, v, length, out, part_m, part_l, part_acc, B, H, Hkv, S,
                        k_sb, k_ss, v_sb, v_ss, n_split, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, k, v, length, out, part_m, part_l, part_acc, B, H,
                                Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, s);
  return (int)cudaErrorInvalidValue;
}
