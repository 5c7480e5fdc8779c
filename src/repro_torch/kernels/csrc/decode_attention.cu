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
// length[b] > 0 they contribute exactly 0 (exp(-1e30 - m) underflows), so
// no block reads them: a call moves sum_b length[b] tokens of K and V, not
// B * S. length[b] <= 0 keeps the reference's meaning: every score is
// -1e30 and the output is the mean of V over all S positions.
//
// What bounds it: bytes. Each K/V element read takes 2 flops per query head
// of its group (g = 1..16, so 2-32 flops per element, 1-8 per byte in f32
// and 1-16 in bf16), far under the ridges of both the CUDA cores (20
// flops/byte in f32) and the tensor cores (295 in bf16). At B = 8,
// S = 32768, Hkv = 8, hd = 64 a call reads 1.074 GB in f32 (0.321 ms at
// 3.35 TB/s) and 0.537 GB in bf16 (0.160 ms). At the main path's call
// (B = 8, S = 128, length <= 33) it reads about 1 MB, and launch latency
// bounds it.
//
// Design, point by point against what held the first version back:
// 1. Copies overlap compute. Every warp owns a ring of kStages slots in
//    shared memory, each holding 16 tokens of K and 16 of V in their own
//    dtype, filled by 16-byte cp.async.cg copies (zero-filled past the
//    chunk's end). While a warp computes on one slot, the next
//    kStages - 1 are in flight: at hd 64, 7 of 8 slots in bf16 (one
//    block per SM, 112 KB in flight) and 2 of 3 in f32 (two blocks per SM,
//    128 KB in flight).
//    Rows are padded by 16 bytes, so ldmatrix and the f32 row reads hit 8
//    different banks.
// 2. No block barrier in the loop. Warp w takes tokens [16 w, 16 w + 16)
//    of every 64-token step of the block's chunk and keeps its own online
//    softmax (m, l, acc), so it needs only __syncwarp. The 4 warps' states
//    merge once, at the end, in warp order.
// 3-5. bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulate)
//    in the transposed form: S^T (16 tokens x 8 heads) = K (16 x hd) ·
//    Q^T (hd x 8), so the tokens fill the M rows and the g query heads
//    (padded to 8; two N tiles for g = 12, 16) the N columns. The softmax
//    stays in f32 registers; P is rounded to bf16 for the product, as flash
//    attention does, moved from the accumulator layout into the B operand's
//    by movmatrix.trans, and O^T (hd x 8) += V^T (hd x 16) · P^T (16 x 8),
//    with V^T read by ldmatrix.trans. f32 stays exact f32 on the CUDA cores
//    (no TF32): a lane owns one token's scores for half the heads (q
//    broadcast from shared memory, no shuffle on the dot product), then
//    one to four output dims of every head in P · V, 16 tokens in order.
// 6. Splits by work, one launch where one split does. The wrapper
//    (plan_splits) cuts S into chunks of a fixed number of tokens, from
//    the shapes and this kernel's resident blocks per SM alone (one wave
//    of blocks: a partial second wave costs up to 40%); a block whose
//    chunk starts past its sequence's length exits at once, so ragged
//    lengths cost what they hold.
//    With one split (the main path's 128-token page; 128 sequences of
//    32k) the block writes the output itself and nothing else is
//    allocated. With more, a second small kernel merges the partial
//    softmaxes of each (sequence, KV head) in split order:
//    m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m).
// Every sum has one owner and a fixed order and nothing uses float
// atomics, so a call is bit-identical from run to run. expf (not __expf)
// and a division by sqrt(hd) keep f32 within 2e-5 of the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                // tokens of one warp step
constexpr int kTile = kWarps * kRows;    // tokens of one block step (TILE in the wrapper)
// Ring shape, from a sweep on an H100 (tools/decode_attention_sweep.py):
// bytes of K/V ring per block (which sets the blocks per SM) and slots
// per warp ring. bf16 runs one block per SM with 8 slots of 16 tokens per
// warp (112 KB in flight per SM at hd 64); f32 two blocks per SM with 3.
constexpr int kRingBudgetBf16 = 150 * 1024;
constexpr int kRingBudgetF32 = 112 * 1024;
constexpr int kMaxStagesBf16 = 8;
constexpr int kMaxStagesF32 = 6;
constexpr int kMaxGroup = 16;            // query heads per KV head

template <typename T, int HD>
struct Layout {
  static constexpr int kStride = HD + 16 / (int)sizeof(T);  // elements per row, 16 bytes padded
  static constexpr int kSlot = 2 * kRows * kStride;           // K rows, then V rows
  static constexpr int kChunks = HD * (int)sizeof(T) / 16;    // 16-byte copies per row = per lane and step
  static constexpr int kBudget = sizeof(T) == 2 ? kRingBudgetBf16 : kRingBudgetF32;
  static constexpr int kMax = sizeof(T) == 2 ? kMaxStagesBf16 : kMaxStagesF32;
  static constexpr int kFit = kBudget / (kWarps * kSlot * (int)sizeof(T));
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > kMax ? kMax : kFit);
  static constexpr size_t kRingBytes = (size_t)kWarps * kStages * kSlot * sizeof(T);
};

__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, L2 fetching the 256-byte
// block around them; zeros when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// d += a (16x16, row) · b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the transpose of an 8x8 b16 matrix held one row pair per lane
__device__ __forceinline__ unsigned transpose8x8(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// one warp's copy of 16 K rows and 16 V rows (tokens t0 .. t0 + 15) into a slot
template <typename T, int HD>
__device__ __forceinline__ void load_step(T* slot, const T* kb, const T* vb, long long k_ss,
                                          long long v_ss, int t0, int end, int lane) {
  using L = Layout<T, HD>;
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    const int u = c * 32 + lane;
    const int kv = u / (kRows * L::kChunks);
    const int rem = u - kv * kRows * L::kChunks;
    const int r = rem / L::kChunks;
    const int col = (rem - r * L::kChunks) * kVec;
    const bool ok = t0 + r < end;
    const long long t = ok ? t0 + r : t0;  // a valid address even when nothing is read
    const T* src = (kv == 0 ? kb + t * k_ss : vb + t * v_ss) + col;
    cp_async16(slot + (kv * kRows + r) * L::kStride + col, src, ok);
  }
}

// The online-softmax state of one warp over its tokens, bf16 on the tensor
// cores. Lane (gid = lane / 4, tig = lane % 4) holds heads nt*8 + 2 tig + c
// (c = 0, 1) of N tile nt and output dims mt*16 + gid (+8) of M tile mt.
template <int HD, int NT>
struct Bf16Warp {
  unsigned qf[HD / 16][NT][2];  // B fragments of Q^T
  float acc[HD / 16][NT][4];    // O^T (hd x heads)
  float m[NT][2], l[NT][2];     // l sums this lane's tokens only until finish()

  __device__ __forceinline__ void init(const __nv_bfloat16* qb, int g, int lane) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = nt * 8 + gid;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const unsigned* qp = reinterpret_cast<const unsigned*>(qb + j * HD + kk * 16 + 2 * tig);
        qf[kk][nt][0] = j < g ? qp[0] : 0u;
        qf[kk][nt][1] = j < g ? qp[4] : 0u;  // dims + 8
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        m[nt][c] = -INFINITY;
        l[nt][c] = 0.f;
      }
#pragma unroll
      for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }

  template <int Stride>
  __device__ __forceinline__ void step(const __nv_bfloat16* ks, const __nv_bfloat16* vs, int t0,
                                       int end, bool masked_all, float sqrt_hd, int lane) {
    const int gid = lane >> 2, i4 = lane >> 3, r8 = lane & 7;
    float c[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
    // S^T = K · Q^T, hd in steps of 16
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a[4];
      ldsm_x4(a, ks + (r8 + (i4 & 1) * 8) * Stride + kk * 16 + (i4 >> 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(c[nt], a, qf[kk][nt][0], qf[kk][nt][1]);
    }
    // online softmax of tokens t0 + gid and t0 + gid + 8
    const bool ok0 = t0 + gid < end, ok1 = t0 + gid + 8 < end;
    unsigned pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float s0 = ok0 ? (masked_all ? -1e30f : c[nt][cc] / sqrt_hd) : -INFINITY;
        const float s1 = ok1 ? (masked_all ? -1e30f : c[nt][2 + cc] / sqrt_hd) : -INFINITY;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[nt][cc], mx);  // finite: token t0 is valid
        const float alpha = expf(m[nt][cc] - m_new);  // 0 on the first step
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        m[nt][cc] = m_new;
        l[nt][cc] = l[nt][cc] * alpha + (p0 + p1);
        c[nt][cc] = p0;
        c[nt][2 + cc] = p1;
#pragma unroll
        for (int mt = 0; mt < HD / 16; ++mt) {
          acc[mt][nt][cc] *= alpha;
          acc[mt][nt][2 + cc] *= alpha;
        }
      }
      // P (tokens x heads, accumulator layout) -> P^T as the B operand
      pb[nt][0] = transpose8x8(pack_bf16(c[nt][0], c[nt][1]));  // tokens 0-7
      pb[nt][1] = transpose8x8(pack_bf16(c[nt][2], c[nt][3]));  // tokens 8-15
    }
    // O^T += V^T · P^T, hd in M tiles of 16
#pragma unroll
    for (int mt = 0; mt < HD / 16; ++mt) {
      unsigned a[4];
      ldsm_x4_trans(a, vs + (r8 + (i4 >> 1) * 8) * Stride + mt * 16 + (i4 & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, pb[nt][0], pb[nt][1]);
    }
  }

  // this warp's (m, l, acc) of heads < g into shared memory
  __device__ __forceinline__ void finish(float* wm, float* wl, float* wacc, int g, int lane) {
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float s = l[nt][cc];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        const int j = nt * 8 + 2 * tig + cc;
        if (j >= g) continue;
        if (gid == 0) {
          wm[j] = m[nt][cc];
          wl[j] = s;
        }
#pragma unroll
        for (int mt = 0; mt < HD / 16; ++mt) {
          wacc[j * HD + mt * 16 + gid] = acc[mt][nt][cc];
          wacc[j * HD + mt * 16 + gid + 8] = acc[mt][nt][2 + cc];
        }
      }
  }
};

// The same state in exact f32 on the CUDA cores. Lane (r = lane % 16,
// half = lane / 16) scores token r against heads half, half + 2, ...; in
// P · V it owns dims lane * kDpl .. + kDpl - 1 of every head.
template <int HD, int NT>
struct F32Warp {
  static constexpr int kHeads = 8 * NT;
  static constexpr int kDpl = HD >= 32 ? HD / 32 : 1;
  float acc[kHeads][kDpl];
  float m[kHeads / 2], l[kHeads / 2];  // l sums this lane's token only until finish()

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < kHeads / 2; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kHeads; ++j)
#pragma unroll
      for (int e = 0; e < kDpl; ++e) acc[j][e] = 0.f;
  }

  // q_s: (g, HD) f32; p_s: (kMaxGroup, 16) probabilities and a_s: (kMaxGroup,)
  // rescale factors of this warp
  template <int Stride>
  __device__ __forceinline__ void step(const float* ks, const float* vs, const float* q_s,
                                       float* p_s, float* a_s, int g, int t0, int end,
                                       bool masked_all, float sqrt_hd, int lane) {
    const int r = lane & 15, half = lane >> 4;
    const bool ok = t0 + r < end;
    float s[kHeads / 2];
#pragma unroll
    for (int i = 0; i < kHeads / 2; ++i) s[i] = 0.f;
    const float* kr = ks + r * Stride;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < kHeads / 2; ++i) {
        const int j = half + 2 * i;
        if (j < g) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + j * HD + d);
          s[i] = fmaf(qv.x, kv.x, s[i]);
          s[i] = fmaf(qv.y, kv.y, s[i]);
          s[i] = fmaf(qv.z, kv.z, s[i]);
          s[i] = fmaf(qv.w, kv.w, s[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kHeads / 2; ++i) {
      const int j = half + 2 * i;
      const float sc = ok ? (masked_all ? -1e30f : s[i] / sqrt_hd) : -INFINITY;
      float mx = sc;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[i], mx);  // finite: token t0 is valid
      const float alpha = expf(m[i] - m_new);
      const float p = expf(sc - m_new);
      m[i] = m_new;
      l[i] = l[i] * alpha + p;
      if (j < g) {
        p_s[j * kRows + r] = p;
        if (r == 0) a_s[j] = alpha;
      }
    }
    __syncwarp();
    if (lane * kDpl < HD) {
      const int d0 = lane * kDpl;
#pragma unroll
      for (int j = 0; j < kHeads; ++j) {
        if (j < g) {
          const float a = a_s[j];
#pragma unroll
          for (int e = 0; e < kDpl; ++e) acc[j][e] *= a;
        }
      }
#pragma unroll 4
      for (int t = 0; t < kRows; ++t) {
        float v[kDpl];
#pragma unroll
        for (int e = 0; e < kDpl; ++e) v[e] = vs[t * Stride + d0 + e];
#pragma unroll
        for (int j = 0; j < kHeads; ++j) {
          if (j < g) {
            const float p = p_s[j * kRows + t];
#pragma unroll
            for (int e = 0; e < kDpl; ++e) acc[j][e] = fmaf(p, v[e], acc[j][e]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void finish(float* wm, float* wl, float* wacc, int g, int lane) {
    const int r = lane & 15, half = lane >> 4;
#pragma unroll
    for (int i = 0; i < kHeads / 2; ++i) {
      float s = l[i];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      const int j = half + 2 * i;
      if (j < g && r == 0) {
        wm[j] = m[i];
        wl[j] = s;
      }
    }
    if (lane * kDpl < HD) {
#pragma unroll
      for (int j = 0; j < kHeads; ++j)
        if (j < g)
#pragma unroll
          for (int e = 0; e < kDpl; ++e) wacc[j * HD + lane * kDpl + e] = acc[j][e];
    }
  }
};

// Dynamic shared memory: the warps' K/V rings (reused for the warps'
// partial states at the end), then for f32 q (g, HD) and each warp's
// (kMaxGroup, 16) probabilities and (kMaxGroup,) rescale factors.
template <typename T, int HD>
__host__ __device__ constexpr size_t ring_bytes(int g) {
  const size_t merge = sizeof(float) * (size_t)kWarps * g * (HD + 2);
  return Layout<T, HD>::kRingBytes > merge ? Layout<T, HD>::kRingBytes : merge;
}
template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes(int g) {
  return ring_bytes<T, HD>(g) +
         (sizeof(T) == 4 ? sizeof(float) * ((size_t)g * HD + kWarps * kMaxGroup * (kRows + 1)) : 0);
}

template <typename T, int HD, int NT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ length, T* __restrict__ out, float* __restrict__ part,
                    int pairs, int S, int Hkv, int g, long long k_sb, long long k_ss,
                    long long v_sb, long long v_ss, int n_split, int chunk) {
  using L = Layout<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int bn = blockIdx.x, split = blockIdx.y;
  const int b = bn / Hkv, n = bn - b * Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int len = length[b];
  const bool masked_all = len <= 0;  // the reference's length == 0: all of S, all -1e30
  const int n_eff = masked_all ? S : min(len, S);
  const int start = split * chunk;
  if (start >= n_eff) return;  // past this sequence's tokens: no work, no partial
  const int end = min(start + chunk, n_eff);

  T* ring = reinterpret_cast<T*>(smem) + (size_t)warp * L::kStages * L::kSlot;
  const T* qb = q + (size_t)bn * g * HD;  // heads n*g .. n*g + g - 1 of sequence b
  const T* kb = k + (size_t)b * k_sb + (size_t)n * HD;
  const T* vb = v + (size_t)b * v_sb + (size_t)n * HD;
  const float sqrt_hd = sqrtf((float)HD);  // divide, as the reference does

  const int first = start + warp * kRows;  // this warp's first token
  const int n_steps = first < end ? (end - first + kTile - 1) / kTile : 0;
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < n_steps) load_step<T, HD>(ring + i * L::kSlot, kb, vb, k_ss, v_ss, first + i * kTile, end, lane);
    cp_async_commit();
  }

  float* wm = reinterpret_cast<float*>(smem);  // after the loop: (kWarps, g) maxima,
  float* wl = wm + kWarps * g;                 // (kWarps, g) normalisers and
  float* wacc = wl + kWarps * g;               // (kWarps, g, HD) accumulators

  // step i of this warp: refill the slot step i - 1 left with step
  // i + kStages - 1, wait for step i, compute on it
  auto run = [&](auto&& compute) {
    for (int i = 0; i < n_steps; ++i) {
      const int nxt = i + L::kStages - 1;
      if (nxt < n_steps)
        load_step<T, HD>(ring + (nxt % L::kStages) * L::kSlot, kb, vb, k_ss, v_ss, first + nxt * kTile, end, lane);
      cp_async_commit();
      cp_async_wait<L::kStages - 1>();  // step i has landed
      __syncwarp();
      const T* ks = ring + (i % L::kStages) * L::kSlot;
      compute(ks, ks + kRows * L::kStride, first + i * kTile);
      __syncwarp();  // every lane is done with the slot before it is refilled
    }
    cp_async_wait<0>();
    __syncthreads();  // the rings are free: reuse them for the warps' states
  };
  if constexpr (sizeof(T) == 2) {
    Bf16Warp<HD, NT> st;
    st.init(reinterpret_cast<const __nv_bfloat16*>(qb), g, lane);
    run([&](const T* ks, const T* vs, int t0) {
      st.template step<L::kStride>(ks, vs, t0, end, masked_all, sqrt_hd, lane);
    });
    st.finish(wm + warp * g, wl + warp * g, wacc + (size_t)warp * g * HD, g, lane);
  } else {
    float* q_s = reinterpret_cast<float*>(smem + ring_bytes<T, HD>(g));  // (g, HD)
    float* p_s = q_s + g * HD + warp * kMaxGroup * (kRows + 1);           // (kMaxGroup, kRows)
    float* a_s = p_s + kMaxGroup * kRows;                                 // (kMaxGroup,)
    for (int i = tid; i < g * HD; i += kThreads) q_s[i] = qb[i];
    __syncthreads();
    F32Warp<HD, NT> st;
    st.init();
    run([&](const T* ks, const T* vs, int t0) {
      st.template step<L::kStride>(ks, vs, q_s, p_s, a_s, g, t0, end, masked_all, sqrt_hd, lane);
    });
    st.finish(wm + warp * g, wl + warp * g, wacc + (size_t)warp * g * HD, g, lane);
  }
  __syncthreads();

  // the warps' states, merged in warp order (a warp with no tokens has
  // m = -inf, l = 0, acc = 0: weight 0)
  float* pm = part + ((size_t)bn * n_split + split) * g;
  float* pl = pm + (size_t)pairs * n_split * g;
  float* pa = part + 2 * (size_t)pairs * n_split * g + ((size_t)bn * n_split + split) * g * HD;
  for (int e = tid; e < g * HD; e += kThreads) {
    const int j = e / HD, d = e - j * HD;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * g + j]);  // finite: warp 0 has tokens
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(wm[w * g + j] - mm);
      ll = fmaf(wl[w * g + j], wt, ll);
      aa = fmaf(wacc[(w * g + j) * HD + d], wt, aa);
    }
    if (n_split == 1) {
      store(aa / fmaxf(ll, 1e-30f), out + (size_t)bn * g * HD + e);
    } else {
      pa[e] = aa;
      if (d == 0) {
        pm[j] = mm;
        pl[j] = ll;
      }
    }
  }
}

// The partial softmaxes of each (sequence, KV head), merged in split order;
// splits past the sequence's length wrote nothing and are not read.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part, const int* __restrict__ length,
                    T* __restrict__ out, int pairs, int S, int Hkv, int g, int n_split, int chunk) {
  const int bn = blockIdx.x, b = bn / Hkv;
  const int len = length[b];
  const int n_eff = len <= 0 ? S : min(len, S);
  const int n_act = (n_eff + chunk - 1) / chunk;  // >= 1: split 0 is never empty
  const float* pm = part + (size_t)bn * n_split * g;
  const float* pl = pm + (size_t)pairs * n_split * g;
  const float* pa = part + 2 * (size_t)pairs * n_split * g + (size_t)bn * n_split * g * HD;
  T* ob = out + (size_t)bn * g * HD;  // (b, n*g + j) rows of the (B, H, hd) output
  for (int e = threadIdx.x; e < g * HD; e += kThreads) {
    const int j = e / HD;
    float m = -INFINITY;
    for (int s = 0; s < n_act; ++s) m = fmaxf(m, pm[s * g + j]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_act; ++s) {
      const float w = expf(pm[s * g + j] - m);
      l = fmaf(pl[s * g + j], w, l);
      a = fmaf(pa[(size_t)s * g * HD + e], w, a);
    }
    store(a / fmaxf(l, 1e-30f), ob + e);
  }
}

// the split kernel's opt-in to more than 48 KB of shared memory, once per device
template <typename T, int HD, int NT>
cudaError_t opt_in() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static bool done[64] = {};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  auto kernel = decode_split_kernel<T, HD, NT>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

template <typename T, int HD, int NT>
int blocks_per_sm(int g) {
  cudaError_t e = opt_in<T, HD, NT>();
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, decode_split_kernel<T, HD, NT>, kThreads,
                                                    smem_bytes<T, HD>(g));
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, int HD, int NT>
int launch(const void* q, const void* k, const void* v, const void* length, void* out,
           void* part, int B, int Hkv, int g, int S, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, int n_split, int chunk, cudaStream_t stream) {
  auto kernel = decode_split_kernel<T, HD, NT>;
  const size_t smem = smem_bytes<T, HD>(g);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in<T, HD, NT>();
  if (e != cudaSuccess) return (int)e;
  const int pairs = B * Hkv;
  kernel<<<dim3(pairs, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(length), static_cast<T*>(out), static_cast<float*>(part), pairs, S,
      Hkv, g, k_sb, k_ss, v_sb, v_ss, n_split, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  decode_merge_kernel<T, HD><<<pairs, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(length), static_cast<T*>(out),
      pairs, S, Hkv, g, n_split, chunk);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_group(int g, const void* q, const void* k, const void* v, const void* length, void* out,
             void* part, int B, int Hkv, int S, long long k_sb, long long k_ss, long long v_sb,
             long long v_ss, int n_split, int chunk, cudaStream_t s) {
  if (g <= 8)
    return launch<T, HD, 1>(q, k, v, length, out, part, B, Hkv, g, S, k_sb, k_ss, v_sb, v_ss, n_split, chunk, s);
  return launch<T, HD, 2>(q, k, v, length, out, part, B, Hkv, g, S, k_sb, k_ss, v_sb, v_ss, n_split, chunk, s);
}

template <typename T>
int by_hd(int hd, int g, const void* q, const void* k, const void* v, const void* length,
          void* out, void* part, int B, int Hkv, int S, long long k_sb, long long k_ss,
          long long v_sb, long long v_ss, int n_split, int chunk, cudaStream_t s) {
  switch (hd) {
    case 16: return by_group<T, 16>(g, q, k, v, length, out, part, B, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, chunk, s);
    case 32: return by_group<T, 32>(g, q, k, v, length, out, part, B, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, chunk, s);
    case 64: return by_group<T, 64>(g, q, k, v, length, out, part, B, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, chunk, s);
    case 128: return by_group<T, 128>(g, q, k, v, length, out, part, B, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int occupancy_by_hd(int hd, int g) {
  const bool two = g > 8;
  switch (hd) {
    case 16: return two ? blocks_per_sm<T, 16, 2>(g) : blocks_per_sm<T, 16, 1>(g);
    case 32: return two ? blocks_per_sm<T, 32, 2>(g) : blocks_per_sm<T, 32, 1>(g);
    case 64: return two ? blocks_per_sm<T, 64, 2>(g) : blocks_per_sm<T, 64, 1>(g);
    case 128: return two ? blocks_per_sm<T, 128, 2>(g) : blocks_per_sm<T, 128, 1>(g);
    default: return -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Blocks of the split kernel that one SM of the current device holds at
// once, for head_dim hd, g = H / Hkv query heads per KV head (<= 16) and
// dtype (0 = float32, 1 = bfloat16); a negative cudaError_t on failure.
extern "C" int auxo_decode_blocks_per_sm(int hd, int g, int dtype) {
  if (g < 1 || g > kMaxGroup) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return occupancy_by_hd<float>(hd, g);
  if (dtype == 1) return occupancy_by_hd<__nv_bfloat16>(hd, g);
  return -(int)cudaErrorInvalidValue;
}

// q: (B, H, hd) contiguous; k, v: (B, S, Hkv, hd) with element (b, s, n, d)
// at b * *_sb + s * *_ss + n * hd + d (16-byte aligned rows); length: (B,)
// int32; out: (B, H, hd) in q's dtype. The KV axis is cut into n_split
// chunks of `chunk` tokens (n_split * chunk >= S; chunk a multiple of 64
// unless n_split == 1). part: with n_split > 1, f32 scratch of
// B * Hkv * n_split * (H / Hkv) * (hd + 2) floats (maxima, normalisers,
// accumulators); unused with one split. dtype 0 = float32, 1 = bfloat16
// (q, k, v and out). H / Hkv <= 16. Returns a cudaError_t.
extern "C" int auxo_decode_attention(const void* q, const void* k, const void* v,
                                     const void* length, void* out, void* part, int B, int H,
                                     int Hkv, int hd, int S, long long k_sb, long long k_ss,
                                     long long v_sb, long long v_ss, int n_split, int chunk,
                                     int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxGroup || n_split < 1 ||
      n_split > 65535 || chunk < 1 || (long long)n_split * chunk < S ||
      (n_split > 1 && (chunk % kTile != 0 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int g = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_hd<float>(hd, g, q, k, v, length, out, part, B, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, chunk, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, g, q, k, v, length, out, part, B, Hkv, S, k_sb, k_ss, v_sb, v_ss, n_split, chunk, s);
  return (int)cudaErrorInvalidValue;
}
