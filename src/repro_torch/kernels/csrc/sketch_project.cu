// The gradient sketch's projection for Hopper (sm_90a): each threefry
// Rademacher sign made in registers and multiplied into the rows at once.
//
// Replaces no TPU kernel. The JAX package draws each block's (block, d)
// Rademacher matrix with jax.random and multiplies by it
// (src/repro/core/sketch.py), leaving the draw to XLA. The port's plain
// version (kernels/ref.py::sketch_project) does the same on the card as one
// eager op per threefry round: ~300 launches and ~170 MB of int32
// temporaries and float32 matrix a block, 928 blocks a round of granite's
// last-block sketch. Here the matrix is never written.
//
//   out[r, c] = (sum_{g < n} x[r, g] * s(g, c)) * (1 / sqrt(max(n, 1)))
//   s(g, c)   = -1 where bit 31 of x0 ^ x1 is set, else +1, with
//               (x0, x1) = threefry2x32(key_i, hi and lo words of (g % block) * d + c),
//   key_i     = threefry2x32((0, seed), (0, i)) = fold_in(key(seed), i), i = g / block.
// These are jax.random's bits, as the plain version draws them: the sign of
// every element is the plain matrix's, bit for bit. Each value is multiplied
// by +-1.0 inside a fused multiply-add, which rounds only the sum: the same
// bits as adding the value with its sign flipped.
//
// What bounds it on the card: int32 instructions. A sign is one threefry-2x32
// block function: 20 rounds of an add, a rotate and a xor, and 5 key
// injections, ~66 integer instructions (the count read from the SASS is in
// PERF.md), against one fused multiply-add per row. The rows are read once, 4 bytes a value, against d
// hashes a value: at d 128 the card's 64 int32 lanes an SM run out long
// before its bytes do (~36 ms of hashing for granite's last block at d 128
// against 0.15 ms of reads).
//
// Design:
//  - Every rotate is one funnel shift (__funnelshift_l), a key injection that
//    meets the next round's add folds into one IADD3, and the sign test and
//    mask are one LOP3; a counter is one integer multiply-add.
//  - A thread owns one column c of the output and walks rows; neighbouring
//    threads take neighbouring columns, so neighbouring counters. A block of
//    256 threads covers W = min(d, 256) columns with 256 / W row lanes (at
//    most 16), and a chunk of rows of one projection block (a power of two
//    that divides the block, so one key a CTA, made in the kernel).
//  - The block stages its rows' values in shared memory (16 KB a stage);
//    each thread reads its row's values by broadcast and keeps the R partial
//    sums of its column in float32 registers over the whole chunk, so the R
//    adds a sign are noise beside the hash.
//  - Any R: up to 16 rows in one pass (RC, a power of two, rows past R read
//    as zero), more rows in passes of 16, each pass hashing again.
//  - Every sum has a fixed order, and no float atomics: a thread adds its
//    rows in chains of 16 folded into chains of 16 (so no single chain grows
//    long and the float32 rounding stays near that of a blocked product);
//    the row lanes of a CTA are added in lane order into one partial per CTA
//    and column; a second kernel adds the CTAs' partials in a fixed order
//    (contiguous runs a warp, chains of 16, then the warps in order). Two
//    launches give the same bits.
//  - Launches: one per pass plus the reduction, so 2 for R <= 16. Scratch:
//    the partials, CTAs x R x d floats (2 MB for granite's largest leaf at R
//    2, d 128).
#include "common.cuh"

using namespace auxo;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 16;       // row lanes of a CTA
constexpr int kMaxRows = 16;        // rows of x a pass takes
constexpr int kChain = 16;          // adds a chain takes before it folds one level up
constexpr int kStageFloats = 4096;  // row values staged at a time (16 KB)
constexpr int kReduceWarps = 32;
constexpr unsigned kParity = 0x1BD11BDAu;
constexpr unsigned kSignBit = 0x80000000u;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) { return __funnelshift_l(x, x, r); }

// The 20-round threefry-2x32 block function of key (k0, k1) on the counter
// words (x0, x1), in place; k2 = k0 ^ k1 ^ kParity.
__device__ __forceinline__ void threefry(unsigned k0, unsigned k1, unsigned k2, unsigned& x0,
                                         unsigned& x1) {
  x0 += k0;
  x1 += k1;
#define AUXO_ROUND(r) \
  x0 += x1;           \
  x1 = rotl(x1, r);   \
  x1 ^= x0;
  AUXO_ROUND(13) AUXO_ROUND(15) AUXO_ROUND(26) AUXO_ROUND(6)
  x0 += k1, x1 += k2 + 1u;
  AUXO_ROUND(17) AUXO_ROUND(29) AUXO_ROUND(16) AUXO_ROUND(24)
  x0 += k2, x1 += k0 + 2u;
  AUXO_ROUND(13) AUXO_ROUND(15) AUXO_ROUND(26) AUXO_ROUND(6)
  x0 += k0, x1 += k1 + 3u;
  AUXO_ROUND(17) AUXO_ROUND(29) AUXO_ROUND(16) AUXO_ROUND(24)
  x0 += k1, x1 += k2 + 4u;
  AUXO_ROUND(13) AUXO_ROUND(15) AUXO_ROUND(26) AUXO_ROUND(6)
  x0 += k2, x1 += k0 + 5u;
#undef AUXO_ROUND
}

// The sign bit of element (r, c) of a block under key (k0, k1, k2).
template <bool WIDE>
__device__ __forceinline__ unsigned sign_bit(unsigned k0, unsigned k1, unsigned k2, unsigned r,
                                             int d, int c) {
  unsigned x0, x1;
  if constexpr (WIDE) {
    const unsigned long long ctr = (unsigned long long)r * (unsigned)d + (unsigned)c;
    x0 = (unsigned)(ctr >> 32), x1 = (unsigned)ctr;
  } else {
    x0 = 0u, x1 = r * (unsigned)d + (unsigned)c;
  }
  threefry(k0, k1, k2, x0, x1);
  return (x0 ^ x1) & kSignBit;
}

template <int RC>
__device__ __forceinline__ void fold(float (&into)[RC], float (&from)[RC]) {
#pragma unroll
  for (int i = 0; i < RC; ++i) into[i] += from[i], from[i] = 0.f;
}

// One pass: the CTA (chunk, column tile) adds rows [g0, g0 + chunk) of x's
// `rows` rows (RC >= rows registers a thread; x points at the pass's first
// row, `stride` elements apart) times their signs into one partial per
// column and row: part[chunk index][row_out + rr][c].
template <int RC, bool WIDE>
__global__ void __launch_bounds__(kThreads) project_kernel(const void* __restrict__ x, int bf16,
                                                           long long stride, int rows, long long n,
                                                           int block, int d, unsigned seed,
                                                           int chunk, float* __restrict__ part,
                                                           int R, int row_out) {
  __shared__ __align__(16) float stage[kStageFloats];
  constexpr int TS = kStageFloats / RC;  // rows a stage holds
  const int W = min(d, kThreads);
  const int lanes = min(kMaxLanes, kThreads / W);
  const int t = threadIdx.x;
  const int lane = t / W;
  const int col = t - lane * W;
  const int c = blockIdx.y * W + col;
  const bool active = lane < lanes && c < d;
  const long long g0 = (long long)blockIdx.x * chunk;
  const int here = (int)min((long long)chunk, n - g0);
  const unsigned bi = (unsigned)(g0 / block);
  const unsigned rb = (unsigned)(g0 - (long long)bi * block);  // the chunk's first row in its block
  // the block's key, fold_in(key(seed), bi): key(seed) is the words (0, seed)
  unsigned k0 = 0u, k1 = bi;
  threefry(0u, seed, seed ^ kParity, k0, k1);
  const unsigned k2 = k0 ^ k1 ^ kParity;

  float acc[RC], mid[RC], in[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i) acc[i] = mid[i] = in[i] = 0.f;
  int chains = 0;
  for (int t0 = 0; t0 < here; t0 += TS) {
    const int ts = min(TS, here - t0);
    __syncthreads();  // the last stage is read
    for (int e = t; e < RC * ts; e += kThreads) {
      const int rr = e / ts, q = e - rr * ts;
      float v = 0.f;
      if (rr < rows) {
        const long long off = (long long)rr * stride + g0 + t0 + q;
        v = bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[off])
                 : static_cast<const float*>(x)[off];
      }
      stage[q * RC + rr] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int q = lane; q < ts; q += kChain * lanes) {
      const int m = min(kChain, (ts - q + lanes - 1) / lanes);
#pragma unroll 2
      for (int u = 0; u < m; ++u) {
        const int qq = q + u * lanes;
        // +-1.0: the sign bit over 1.0's bits (no bit in common, so an add)
        const float sg = __uint_as_float(sign_bit<WIDE>(k0, k1, k2, rb + (unsigned)(t0 + qq), d, c) +
                                         0x3f800000u);
        const float* v = stage + qq * RC;
#pragma unroll
        for (int i = 0; i < RC; ++i) in[i] = fmaf(v[i], sg, in[i]);  // in + (+-v), rounded once
      }
      fold(mid, in);
      if (++chains == kChain) fold(acc, mid), chains = 0;
    }
  }
  fold(acc, mid);
  // the row lanes' sums in lane order: one partial per column and row
  __syncthreads();
  if (active) {
#pragma unroll
    for (int i = 0; i < RC; ++i) stage[t * RC + i] = acc[i];
  }
  __syncthreads();
  if (!active || lane != 0) return;
  for (int i = 0; i < rows; ++i) {
    float s = stage[col * RC + i];
    for (int l = 1; l < lanes; ++l) s += stage[(l * W + col) * RC + i];
    part[((long long)blockIdx.x * R + row_out + i) * d + c] = s;
  }
}

// out[o] = (sum over the G chunks of part[g][o]) * scale, o < outs = R * d:
// 32 outputs a CTA, one a lane; warp w adds a contiguous run of chunks in
// chains of 16, then the warps' sums are added in warp order.
__global__ void __launch_bounds__(kReduceWarps * 32) reduce_kernel(const float* __restrict__ part,
                                                                   int G, int outs, float scale,
                                                                   float* __restrict__ out) {
  __shared__ float sums[kReduceWarps][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + lane;
  const int per = (G + kReduceWarps - 1) / kReduceWarps;
  const int lo = min(G, w * per), hi = min(G, lo + per);
  float acc = 0.f;
  if (o < outs) {
    for (int g = lo; g < hi; g += kChain) {
      const int m = min(kChain, hi - g);
      float in = 0.f;
#pragma unroll 16
      for (int u = 0; u < m; ++u) in += part[(long long)(g + u) * outs + o];
      acc += in;
    }
  }
  sums[w][lane] = acc;
  __syncthreads();
  if (w != 0 || o >= outs) return;
  float s = sums[0][lane];
  for (int k = 1; k < kReduceWarps; ++k) s += sums[k][lane];
  out[o] = s * scale;
}

template <bool WIDE>
int launch_pass(int rc, dim3 grid, cudaStream_t s, const void* x, int bf16, long long stride,
                int rows, long long n, int block, int d, unsigned seed, int chunk, float* part,
                int R, int row_out) {
  switch (rc) {
#define AUXO_PASS(RC)                                                                    \
  case RC:                                                                               \
    project_kernel<RC, WIDE><<<grid, kThreads, 0, s>>>(x, bf16, stride, rows, n, block, d, \
                                                       seed, chunk, part, R, row_out);   \
    break;
    AUXO_PASS(1) AUXO_PASS(2) AUXO_PASS(4) AUXO_PASS(8) AUXO_PASS(16)
#undef AUXO_PASS
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: R rows of n values (float32 or bfloat16, dtype 0 or 1), `stride`
// elements apart, each row contiguous; part: (ceil(n / chunk), R, d) float32
// scratch; out: (R, d) float32. `block` is the projection block (a power of
// two from 128 to 65536), `chunk` a power of two that divides it; `scale` is
// 1 / sqrt(max(n, 1)) in float32. ceil(R / 16) pass launches, then the reduction.
extern "C" int auxo_sketch_project(const void* x, int dtype, long long stride, int R, long long n,
                                   int block, int d, unsigned seed, int chunk, float* part,
                                   float scale, float* out, void* stream) {
  if (R <= 0 || n <= 0 || d <= 0 || (dtype != 0 && dtype != 1) || stride < 0)
    return (int)cudaErrorInvalidValue;
  if (block < 128 || block > 65536 || (block & (block - 1)) || chunk <= 0 || chunk > block ||
      (chunk & (chunk - 1)))
    return (int)cudaErrorInvalidValue;
  const long long G = (n + chunk - 1) / chunk;
  const int W = d < kThreads ? d : kThreads;
  const long long tiles = (d + W - 1) / W;
  if (G > 0x7fffffffLL || tiles > 65535 || (long long)R * d > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = (long long)block * d > (1LL << 31);  // counters past 31 bits
  const int el = dtype == 0 ? 4 : 2;
  const dim3 grid((unsigned)G, (unsigned)tiles);
  for (int r0 = 0; r0 < R; r0 += kMaxRows) {
    const int rows = R - r0 < kMaxRows ? R - r0 : kMaxRows;
    int rc = 1;
    while (rc < rows) rc *= 2;
    const void* xr = static_cast<const char*>(x) + (long long)r0 * stride * el;
    const int e = wide ? launch_pass<true>(rc, grid, s, xr, dtype, stride, rows, n, block, d, seed,
                                           chunk, part, R, r0)
                       : launch_pass<false>(rc, grid, s, xr, dtype, stride, rows, n, block, d,
                                            seed, chunk, part, R, r0);
    if (e) return e;
  }
  const int outs = R * d;
  reduce_kernel<<<ceil_div(outs, 32), kReduceWarps * 32, 0, s>>>(part, (int)G, outs, scale, out);
  return (int)cudaGetLastError();
}
