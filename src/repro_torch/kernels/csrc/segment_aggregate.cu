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
// would spend K times the useful flops and buys nothing here.
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
// Design (one pass over the data for any K and any D).
//  - Rows go in chunks of 256, one id per thread. A block-wide stable
//    counting sort (8-bit digits, one pass for K < 256; each warp counts
//    its rows by a ballot per digit, or a match past 32 digits) lists each
//    segment's rows in index order. A block owns a 128-byte column tile of
//    one cohort (32 f32 or 64 bf16 columns; fewer when D is narrower).
//    The chunk's rows come to shared memory by 16-byte cp.async from the
//    16-byte boundary below each row's tile bytes (so any D takes
//    full-width copies), issued while the ids load, so they fly during the
//    sort, and the next chunk's while this one is summed (two ring slots).
//  - Then `lanes` threads sum one segment (32 for a full tile; as few as
//    one for D = 1), each owning 4 bytes of the row: the segment's rows in
//    index order, one after another, starting from +0 in the first chunk
//    and from the running sum the earlier chunks left (in a (K, columns)
//    tile of shared memory, or in the block's own output columns when it
//    is too large) in every later one. A chunk thus continues each sum;
//    it never starts a partial sum of its own.
//  - Row order leaves no parallelism over one segment's rows. When the
//    column tiles of all cohorts fill less than a wave and P spans several
//    chunks, the wrapper splits the *segments* over up to 8 blocks of each
//    column tile (grid y): block y sums segments [y K / n, (y + 1) K / n)
//    over every chunk, as a call of its own whose other ids are dropped.
//    The staged rows are read n times (mostly from L2); nothing is added
//    across blocks.
#include "common.cuh"

using namespace auxo;

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads;  // rows of a chunk: one id per thread
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 128;  // bytes of a row a block owns
constexpr int kDigitBits = 8;
constexpr int kMaxSplit = 8;             // segment groups of a column tile
constexpr size_t kAccBytes = 48 * 1024;  // the (K, columns) tile, at most

struct SortSmem {
  int cnt[(1 << kDigitBits) * kWarps];  // per (digit, warp) counts, digit-major
  int wtot[kWarps];
  int key[kChunk];  // sorted segment of each position (K = dropped)
  int row[kChunk];  // chunk row of each position
};

__device__ __forceinline__ int block_exclusive_scan(int v, int* wtot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) wtot[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += wtot[w];
  __syncthreads();  // wtot is reused by the next scan
  return before + inc - v;
}

// Counts each (digit, warp) pair; returns the thread's rank among the equal
// digits of its warp (lane order). Up to 32 digits: one ballot per digit,
// so every counter is written and none needs zeroing; more: the counters
// are zeroed and the lowest lane of each set of equal digits writes its
// count.
__device__ __forceinline__ int count_digits(int digit, int nb, int* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (nb <= 32) {
    unsigned mine = 0;
    int c = 0;
    for (int j = 0; j < nb; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, digit == j);
      if (lane == j) c = __popc(b);
      if (digit == j) mine = b;
    }
    if (lane < nb) cnt[lane * kWarps + warp] = c;
    return __popc(mine & below);
  }
  for (int i = threadIdx.x; i < nb * kWarps; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const unsigned peers = __match_any_sync(0xffffffffu, digit);
  const int rank = __popc(peers & below);
  if (rank == 0) cnt[digit * kWarps + warp] = __popc(peers);
  return rank;
}

// Exclusive scan of the n counters in place: one warp when they are few,
// else the block (every thread calls; n is a power of two).
__device__ void scan_counts(int* cnt, int n, int* wtot) {
  const int tid = threadIdx.x;
  if (n <= 32 * kWarps) {
    if (tid >= 32) return;
    const int per = n > 32 ? n / 32 : 1, first = tid * per;
    int sum = 0;
    if (first < n)
      for (int j = 0; j < per; ++j) sum += cnt[first + j];
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (tid >= o) inc += t;
    }
    int off = inc - sum;
    if (first < n)
      for (int j = 0; j < per; ++j) {
        const int c = cnt[first + j];
        cnt[first + j] = off;
        off += c;
      }
    return;
  }
  const int per = n / kThreads, first = tid * per;
  int sum = 0;
  for (int j = 0; j < per; ++j) sum += cnt[first + j];
  int off = block_exclusive_scan(sum, wtot);
  for (int j = 0; j < per; ++j) {
    const int c = cnt[first + j];
    cnt[first + j] = off;
    off += c;
  }
}

// One stable counting-sort pass of the block's (key, row) pairs by key bits
// [shift, shift + bits): thread t holds the t-th pair before and after
// (after the last pass, only s.key / s.row do, visible after a barrier).
// Equal digits keep their order: by lane within a warp, by warp across.
__device__ void sort_pass(int& key, int& row, int shift, int bits, bool last, SortSmem& s) {
  const int tid = threadIdx.x;
  const int nb = 1 << bits;
  const int digit = (key >> shift) & (nb - 1);
  const int rank = count_digits(digit, nb, s.cnt);
  __syncthreads();
  scan_counts(s.cnt, nb * kWarps, s.wtot);
  __syncthreads();
  const int pos = s.cnt[digit * kWarps + (tid >> 5)] + rank;
  s.key[pos] = key;
  s.row[pos] = row;
  if (!last) {
    __syncthreads();
    key = s.key[tid];
    row = s.row[tid];
  }
}

// Sorts the chunk's rows by segment key (K = dropped) into s.key / s.row;
// they are read after the caller's next barrier.
__device__ void sort_chunk(int key, int key_bits, SortSmem& s) {
  int row = threadIdx.x;
  for (int shift = 0; shift < key_bits; shift += kDigitBits)
    sort_pass(key, row, shift, min(kDigitBits, key_bits - shift), shift + kDigitBits >= key_bits, s);
}

__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// First sorted position of segment s (s = K: the count of valid rows). One
// pass leaves the bucket starts in the counters; more passes search.
__device__ __forceinline__ int seg_start(const SortSmem& ss, int s, int key_bits) {
  return key_bits <= kDigitBits ? ss.cnt[s * kWarps] : lower_bound(ss.key, kChunk, s);
}

// ------------------------------------------------------------ staged rows
constexpr int kSlot = kRowBytes + 16;  // a staged row: its 128 bytes from a 16-byte boundary

// Where a row's tile bytes start within its slot: their offset from the
// 16-byte boundary below them.
template <typename T>
__device__ __forceinline__ int row_shift(const T* row, int col0) {
  return (int)(reinterpret_cast<uintptr_t>(row + col0) & 15);
}

// Copy rows [0, rows) of the block's column tile (db points at the chunk's
// first row) into `ring`: row r's bytes [col0, col0 + 128) (fewer past D)
// land in slot r from byte row_shift on, so every copy is a full 16-byte
// cp.async from an aligned address, whatever D is; a copy stops at the
// row's last needed byte, so nothing past the tensor's end is read.
template <typename T>
__device__ void stage_tile(unsigned char* ring, const T* db, int rows, int D, int col0) {
  constexpr int kPieces = kSlot / 16;
  // in 64 bits: (D - col0) bytes pass 2**31 on the first tiles of a row of
  // more than 2**29 f32 columns (a granite-3-2b MLP leaf, 671M values)
  const int bytes = (int)min((long long)kRowBytes, (long long)(D - col0) * (long long)sizeof(T));
  for (int i = threadIdx.x; i < rows * kPieces; i += kThreads) {
    const int r = i / kPieces, j = i % kPieces;
    const uintptr_t start = reinterpret_cast<uintptr_t>(db + (size_t)r * D + col0);
    const uintptr_t g = (start & ~(uintptr_t)15) + 16 * j;
    const long long need = (long long)(start + bytes) - (long long)g;  // bytes wanted from g on
    if (need > 0)
      cp_async<16>(ring + r * kSlot + 16 * j, reinterpret_cast<const void*>(g), (int)min(16LL, need));
  }
}

// A lane's 4 bytes of a staged row as floats: one f32 or two bf16.
__device__ __forceinline__ void load_lane(const unsigned char* p, float (&v)[1]) {
  v[0] = *reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ void load_lane(const unsigned char* p, float (&v)[2]) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);  // 2-byte aligned
  v[0] = __uint_as_float((unsigned)h[0] << 16);
  v[1] = __uint_as_float((unsigned)h[1] << 16);
}

struct BlockSmem {
  SortSmem sort;
  float w[kChunk];             // weight of each chunk row
  int roff[kChunk];            // sorted position: its row's first tile byte in the slot
  float ws[kChunk];            // sorted position: its row's weight
};

// grid (column tiles, segment groups, C). A block owns a 128-byte column
// tile of one cohort and the segments [s0, s1) of its group; 2**lane_bits
// threads (1..32) sum one segment, lane l owning bytes
// [4l, 4l + 4) of the tile (one f32 or two bf16 columns). Dynamic shared
// memory: BlockSmem, ring_slots tiles of ring_rows staged rows, then the
// (s1 - s0, columns) accumulator when acc_in_smem (else the block's own
// rows and columns of the output hold the running sums).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
seg_sum(const T* __restrict__ data, const I* __restrict__ ids, const float* __restrict__ w,
        float* __restrict__ out, int P, int K, int D, int key_bits, int lane_bits, int ring_rows,
        int ring_slots, bool acc_in_smem) {
  constexpr int V = 4 / (int)sizeof(T);
  constexpr int kCols = kRowBytes / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  BlockSmem& sm = *reinterpret_cast<BlockSmem*>(smem);
  unsigned char* ring = smem + sizeof(BlockSmem);
  const size_t slot_bytes = (size_t)ring_rows * kSlot;
  float* tile = reinterpret_cast<float*>(ring + ring_slots * slot_bytes);  // (Kb, kCols)
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kCols;
  const int s0 = (int)((long long)blockIdx.y * K / gridDim.y);
  const int Kb = (int)((long long)(blockIdx.y + 1) * K / gridDim.y) - s0;  // this block's segments
  const int cz = blockIdx.z;
  const T* db = data + (size_t)cz * P * D;
  const I* ib = ids + (size_t)cz * P;
  const float* wb = w ? w + (size_t)cz * P : nullptr;
  float* ob = out + ((size_t)cz * K + s0) * D;
  const int nch = (P + kChunk - 1) / kChunk;
  // the running sums: Kb rows of `stride` floats, columns >= lim past D
  const int lim = min(kCols, D - col0);
  float* acc = acc_in_smem ? tile : ob + col0;
  const int stride = acc_in_smem ? kCols : D;
  if (nch == 0)  // no rows: zeros
    for (int i = tid; i < Kb * kCols; i += kThreads)
      if (i % kCols < lim) acc[(size_t)(i / kCols) * stride + i % kCols] = 0.f;
  // the first chunk's ids and weights go out first; its copies are issued
  // while they fly
  I raw = tid < min(kChunk, P) ? ib[tid] : (I)-1;
  float wt = (wb && tid < min(kChunk, P)) ? wb[tid] : 1.f;
  for (int c = 0; c < nch; ++c) {
    const int p0 = c * kChunk, tp = min(kChunk, P - p0);
    const int slot = c % ring_slots;
    const unsigned char* tl = ring + slot * slot_bytes;
    if (c == 0) stage_tile<T>(ring, db, tp, D, col0);
    cp_commit();
    // the next chunk's copies, ids and weights fly during this chunk's sort
    // and sums
    I raw_next = (I)-1;
    float wt_next = 1.f;
    if (c + 1 < nch) {
      const int p1 = p0 + kChunk, tp1 = min(kChunk, P - p1);
      stage_tile<T>(ring + ((c + 1) % ring_slots) * slot_bytes, db + (size_t)p1 * D, tp1, D, col0);
      if (tid < tp1) {
        raw_next = ib[p1 + tid];
        if (wb) wt_next = wb[p1 + tid];
      }
    }
    cp_commit();
    sm.w[tid] = wt;
    // this block's segments are keys 0..Kb-1; every other id is dropped (Kb)
    sort_chunk(raw >= (I)s0 && raw < (I)(s0 + Kb) ? (int)(raw - (I)s0) : Kb, key_bits, sm.sort);
    __syncthreads();
    const int n = seg_start(sm.sort, Kb, key_bits);
    if (tid < n) {
      const int r = sm.sort.row[tid];
      sm.roff[tid] = r * kSlot + row_shift(db + (size_t)(p0 + r) * D, col0);
      sm.ws[tid] = sm.w[r];
    }
    cp_wait<1>();  // this chunk's rows have landed (the next chunk's may still fly)
    __syncthreads();
    // 2**lane_bits threads a segment: its rows added in index order onto the sum
    // the earlier chunks left (+0 in the first chunk)
    for (int i = tid; i < Kb << lane_bits; i += kThreads) {
      const int s = i >> lane_bits, ln = i & ((1 << lane_bits) - 1);
      if (ln * V >= lim) continue;
      const int st = seg_start(sm.sort, s, key_bits), en = seg_start(sm.sort, s + 1, key_bits);
      if (c > 0 && st == en) continue;
      float* o = acc + (size_t)s * stride + ln * V;
      float sum[V], v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) sum[e] = (c > 0 && ln * V + e < lim) ? o[e] : 0.f;
#pragma unroll 4
      for (int q = st; q < en; ++q) {
        load_lane(tl + sm.roff[q] + ln * 4, v);
        const float wq = sm.ws[q];
#pragma unroll
        for (int e = 0; e < V; ++e) sum[e] = __fadd_rn(sum[e], __fmul_rn(wq, v[e]));
      }
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (ln * V + e < lim) o[e] = sum[e];
    }
    __syncthreads();  // the sort arrays, weights and this slot are reused
    raw = raw_next;
    wt = wt_next;
  }

  if (!acc_in_smem) return;
  for (int i = tid; i < Kb * kCols; i += kThreads) {
    const int s = i / kCols, c = i % kCols;
    if (c < lim) ob[(size_t)s * D + col0 + c] = tile[i];
  }
}

template <typename T, typename I>
int launch(const T* x, const I* ids, const float* w, float* out, int C, int P, int K, int D,
           int nsplit, cudaStream_t stream) {
  if (nsplit < 1 || nsplit > kMaxSplit || nsplit > K) return (int)cudaErrorInvalidValue;
  const int kb = (K + nsplit - 1) / nsplit;            // segments of the largest group
  const int key_bits = 32 - __builtin_clz((unsigned)kb);  // keys 0..kb, kb = dropped
  const int cols = kRowBytes / (int)sizeof(T);
  // threads a segment: the 4-byte lanes that a tile's columns fill, rounded
  // up to a power of two (32 from 128 bytes on)
  const int need = (int)((min((long long)D, (long long)cols) * (long long)sizeof(T) + 3) / 4);
  int lane_bits = 0;
  while ((1 << lane_bits) < need) ++lane_bits;
  const size_t acc_bytes = sizeof(float) * (size_t)kb * cols;
  const int nch = (P + kChunk - 1) / kChunk;
  // one chunk: every sum is stored once, straight to the output; more: the
  // running sums live in shared memory (if the tile fits)
  const bool acc_in_smem = acc_bytes <= kAccBytes && nch > 1;
  const int ring_rows = max(1, min(kChunk, P)), ring_slots = nch > 1 ? 2 : 1;
  const size_t smem = sizeof(BlockSmem) + (size_t)ring_slots * ring_rows * kSlot +
                      (acc_in_smem ? acc_bytes : 0);
  if (int e = set_smem(seg_sum<T, I>, smem)) return e;
  const dim3 grid((D + cols - 1) / cols, nsplit, C);
  seg_sum<T, I><<<grid, kThreads, smem, stream>>>(x, ids, w, out, P, K, D, key_bits, lane_bits,
                                                  ring_rows, ring_slots, acc_in_smem);
  return (int)cudaGetLastError();
}

template <typename T>
int by_ids(const void* data, const void* ids, int id_dtype, const float* w, float* out, int C,
           int P, int K, int D, int nsplit, cudaStream_t s) {
  const T* x = static_cast<const T*>(data);
  if (id_dtype == 0)
    return launch<T, int>(x, static_cast<const int*>(ids), w, out, C, P, K, D, nsplit, s);
  if (id_dtype == 1)
    return launch<T, long long>(x, static_cast<const long long*>(ids), w, out, C, P, K, D,
                                nsplit, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// data: (C, P, D), ids: (C, P) int32 (id_dtype 0) or int64 (1), w: (C, P)
// f32 or null, out: (C, K, D) f32; all contiguous. dtype 0 = float32, 1 =
// bfloat16. nsplit (1..min(8, K)) splits the K segments over that many
// blocks per column tile. Returns a cudaError_t. P may be 0 (the kernel
// then writes zeros).
extern "C" int auxo_segment_aggregate(const void* data, const void* ids, const void* w, void* out,
                                      int C, int P, int K, int D, int dtype, int id_dtype,
                                      int nsplit, void* stream) {
  if (C <= 0 || K <= 0 || D <= 0 || P < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return by_ids<float>(data, ids, id_dtype, wf, o, C, P, K, D, nsplit, s);
  if (dtype == 1) return by_ids<__nv_bfloat16>(data, ids, id_dtype, wf, o, C, P, K, D, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
