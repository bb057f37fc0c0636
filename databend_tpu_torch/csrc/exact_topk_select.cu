// exact_topk_select: the distance epilogue, the masks and the tie-rule top-k
// of exact KNN in one pass over the product block, for Hopper.
//
// It replaces the part of the XLA program exact_topk
// (databend_tpu/storage/fuse/table.py:1084-1099) after the dot: the
// distances, the index mask of the pad rows and jax.lax.top_k(-d, k); the
// same in _scan_topk_program and _scan_topk_filtered_program
// (databend_tpu/service/prepared.py:255, :303; the filtered one's row mask
// too) and in each chunk of chunked_topk_smallest
// (databend_tpu/ops/topk.py:56-127). No Pallas kernel stands behind it: the
// reference leaves this to XLA, which fuses it. Function:
//   qx [b, N] f32 (the product block, rows contiguous), qq [b] and xx [N] f32
//   (l2 and l2_sq only), keep [b, N] or [1, N] bytes (optional), n_valid
//   -> vals [b, k] f32 and ids [b, k] int64: per query the k smallest of
//   d[q, i] = +inf                  if i >= n_valid or keep[q, i] == 0
//             l2_sq: max((qq[q] - 2 qx) + xx[i], 0)
//             l2:    sqrt of that
//             cosine: 1 - qx        ip: -qx
//   in lax.top_k(-d, k)'s order: by the total order of f32 on -d (so -0.0
//   against +0.0 as ops/topk.py:_order_key orders them), equal values by
//   ascending position, the lowest positions kept at the k-th place; the
//   +inf cells are ranked by position like any other value.
// Each operation is rounded as torch's eager kernels round it: __fmul_rn,
// __fsub_rn, __fadd_rn and __fsqrt_rn keep nvcc from contracting them into
// a fused multiply-add, and the clamp is torch's clamp_min on the card
// (NaN through, else fmaxf(v, 0)). So the distances are bit-equal to
// ops/distance.py:finish_distance, and the selection to its plain version.
//
// Bound. Its bytes are one read of qx (and keep, and xx, qq) and the write
// of the [b, k] result: at b = 256, N = 1M one 1.02 GB block, 0.31 ms at
// 3.35 TB/s. Its operations (a few f32 operations and one u64 compare a
// cell) are far below the bytes. So the design is a stream: every cell is
// read once with 16-byte loads and dropped in registers unless it may be
// among the k smallest.
//
// The design (block_kernel; the plan is ops/exact_topk.py:_plan):
//  * One ordering key. Each (query, position) gets the u64 key
//    (ord(-d) << 32) | (0xffffffff - i), ord the order-preserving map of f32
//    bits to u32 (as csrc/impact_bm25_scores.cu:make_key). Keys are
//    distinct, and the k largest keys are exactly lax.top_k(-d, k)'s answer,
//    ties and the +inf cells included. No real key is 0, the empty key.
//  * A threshold: every key of the query's top k is at least it (0 at the
//    start; after a cut, the k-th largest key held: the k-th key of a subset
//    is never above the k-th of the whole). A cell whose key is below it is
//    dropped, in any order of the cells.
//  * A coarse filter first. Most cells cannot pass, so the stream computes
//    no distance and no key: per cell only a coarse value monotone in the
//    distance (l2: (qq - 2 qx) + xx, before the clamp and the square root;
//    cosine and ip: the distance) against a bound derived from the
//    threshold (coarse_bound). Only a lane where some cell may pass
//    finishes its cells' distances from the coarse values (the same
//    roundings: bit-equal) and forms their keys.
//  * 16-byte loads of qx (scalar ones on a row that is not 16-byte aligned,
//    and on a ragged end), and an L2 prefetch of the next round, which puts
//    more bytes in flight than the loads' registers hold.
//  * A block takes one (query, segment) of `seg` positions, `ways` segments
//    a query (as many as keep the batch within one wave of BLOCKS_A_SM
//    blocks an SM). Its 8 warps read the segment ROUND positions a round,
//    STEP each, and keep one buffer of BUF keys in shared memory with one
//    threshold.
//  * A passing cell costs its lane: a lane with a candidate forms its
//    keys and appends them with one shared atomic (append); a lane without
//    one does nothing more. (A warp prefix sum instead ran slower; the
//    first design, a warp a strip that ran a ballot for each of its lanes'
//    cells once any cell passed, stayed at 13-23% of its bound at k = 101
//    and 128.)
//  * A cut is a radix select, not a sort (block_cut): 8-bit digits from the
//    top, a 256-bin histogram a pass, a suffix sum over the bins, until the
//    bucket that holds the k-th key is whole; then the keys at or above it
//    are compacted to k and the threshold becomes the least of them. A
//    round ends in one __syncthreads_or, which cuts once the buffer holds
//    more than min(CUT_AT, CUT_K * k) keys: the first cut, after the first
//    round, seeds the threshold with the k-th of ROUND cells, and later
//    ones tighten it.
//  * The output is ranked, not sorted: each of the k keys counts the keys
//    above it.
//  * ways > 1: a block publishes its k largest keys (part), raises the
//    query's threshold in device memory after each cut (atomicMax; every
//    block reads it once a round), and takes a ticket; the last block of
//    the query merges the lists, keys at or above the query's threshold,
//    with the same append and cut. No second launch; the thresholds and
//    tickets are zeroed by one memset.
// It neither synchronises with the host nor writes a second [b, N] block.
// What holds it (PERF.md, the --diagnose counters): at the HNSW build's
// k = 101 most rounds of a warp have a candidate (the threshold is the k-th
// of the cells seen so far), and their appends and the cuts cost about as
// much as the stream; at b = 8 the launch, the first round's cut of ROUND
// keys and the merge, not bytes.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 8;               // warps of a block
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 2;              // 16-byte loads of qx a lane has in flight
constexpr int STEP = 32 * 4 * UNROLL;  // positions a warp reads an iteration
constexpr int MAX_K = 128;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == 256, "block_cut keeps one radix bin a thread");
constexpr int ROUND = WARPS * STEP;    // positions a block reads a round
constexpr int BUF = 2 * ROUND;         // keys a block's buffer holds
constexpr int CUT_AT = BUF - ROUND;    // the most a block holds before a round
constexpr int CUT_K = 8;               // a block cuts once it holds more than
                                       // min(CUT_AT, CUT_K * k) keys
constexpr int BLOCKS_A_SM = 4;         // block_kernel's blocks an SM

#ifdef EXACT_TOPK_DIAG
// Counters of a diagnostic build (-DEXACT_TOPK_DIAG; chip_smoke.py
// --diagnose), summed over launches until read: [0] warp iterations with a
// candidate, [1] lane appends that took a key, [2] keys taken, [3] cuts,
// [4] radix passes, [5] blocks that ran, [6] of them ending with threshold
// 0; and the sum of their final thresholds' distances.
__device__ unsigned long long g_diag[7];
__device__ double g_diag_thr;
#define DIAG_ADD(i, v) atomicAdd(&g_diag[i], static_cast<unsigned long long>(v))
#else
#define DIAG_ADD(i, v) ((void)0)
#endif

enum Metric { L2 = 0, L2_SQ = 1, COSINE = 2, IP = 3 };

// torch's finish_distance, each operation rounded as its eager kernel
// rounds it (see the top of the file), in two steps: a coarse value
// monotone in the distance that needs no clamp and no square root (l2 and
// l2_sq: (qq - 2 qx) + xx; cosine and ip: the distance itself), then the
// distance from it.
template <int METRIC>
__device__ __forceinline__ float coarse(float qx, float qq, float xx) {
  if (METRIC == COSINE) return __fsub_rn(1.0f, qx);
  if (METRIC == IP) return -qx;
  return __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, qx)), xx);
}

template <int METRIC>
__device__ __forceinline__ float finish(float c) {
  if (METRIC == COSINE || METRIC == IP) return c;
  const float t = c != c ? c : fmaxf(c, 0.0f);
  return METRIC == L2 ? __fsqrt_rn(t) : t;
}

__device__ __forceinline__ u64 make_key(float v, long long i) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | (0xffffffffu - static_cast<unsigned>(i));
}

// The distance and the position a key holds (the key holds -d: negated
// back exactly, signed zeros included).
__device__ __forceinline__ float key_value(u64 key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  return -__uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

__device__ __forceinline__ long long key_pos(u64 key) {
  return static_cast<long long>(0xffffffffu - static_cast<unsigned>(key));
}

// The largest coarse value whose cell may still pass the threshold `thr`:
// a cell whose coarse value is above it has a distance above the
// threshold's, so its key is below `thr`. l2's bound is the square of the
// next float above the threshold's distance, rounded up: t > that bound
// gives sqrt(t) above that float, so sqrt_rn(t) is at least it.
template <int METRIC>
__device__ __forceinline__ float coarse_bound(u64 thr) {
  const float INF = __int_as_float(0x7f800000);
  if (thr == 0) return INF;                  // nothing kept yet
  const float d = key_value(thr);
  if (METRIC != L2) return d;
  const float up = nextafterf(d, INF);
  return __fmul_ru(up, up);
}

// The coarse values of one lane's four positions i .. i + 3: `nin` of them
// in the span, `nok` before n_valid. 16-byte loads where the row allows.
// Masked cells are +inf (they pass only while the threshold is +inf, and
// finish(+inf) is +inf); cells past the span NaN (they never pass).
template <int METRIC>
__device__ __forceinline__ void coarse4(const float* row, const float* xx,
                                        const unsigned char* krow, float qq,
                                        long long i, int nin, int nok,
                                        bool vec, float (&c)[4]) {
  constexpr bool NORMS = METRIC == L2 || METRIC == L2_SQ;
  const float INF = __int_as_float(0x7f800000);
  float v[4], w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  unsigned kb = 0x01010101u;
  if (vec && nin == 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(row + i));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    if (NORMS) {
      const float4 x4 = __ldg(reinterpret_cast<const float4*>(xx + i));
      w[0] = x4.x; w[1] = x4.y; w[2] = x4.z; w[3] = x4.w;
    }
    if (krow != nullptr)
      kb = __ldcs(reinterpret_cast<const unsigned*>(krow + i));
  } else {
    kb = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = e < nin ? __ldcs(row + i + e) : 0.0f;
      if (NORMS) w[e] = e < nin ? __ldg(xx + i + e) : 0.0f;
      const unsigned kept = krow == nullptr ? 1u : e < nin ? krow[i + e] : 0u;
      kb |= kept << (8 * e);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool kept = e < nok && ((kb >> (8 * e)) & 0xffu) != 0;
    c[e] = e >= nin ? __int_as_float(0x7fffffff)
                    : kept ? coarse<METRIC>(v[e], qq, w[e]) : INF;
  }
}

// ------------------------------------------------------------- the block
// A block's shared state: the buffer and its count, the threshold (every
// key of the query's top k is at least thr), and the radix select's
// scratch.
struct BlockShared {
  u64 buf[BUF];
  u64 sel[MAX_K];
  u64 thr;
  u64 kth;
  int hist[256];
  int wsum[WARPS];
  int cnt, nsel, digit, need, bucket, last;
};

// Append a lane's nonzero keys (8 at most) to the block's buffer: one
// shared atomic for the lane's count, then its stores. The caller keeps
// the room: at most cut_at <= CUT_AT keys before a round, ROUND keys a
// round. Returns whether the buffer now holds more than cut_at keys (true
// in some lane exactly when it does: the lane that added last sees the
// final count).
__device__ __forceinline__ bool append(BlockShared& s, const u64 (&key)[8],
                                       int cut_at) {
  int n = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) n += key[t] != 0ull;
  if (n == 0) return false;
  int at = atomicAdd(&s.cnt, n);
#pragma unroll
  for (int t = 0; t < 8; ++t)
    if (key[t] != 0ull) s.buf[at++] = key[t];
  DIAG_ADD(1, 1);
  DIAG_ADD(2, n);
  return at > cut_at;
}

// Cut the block's buffer (cnt > k distinct keys) to its k largest keys, in
// no order, and raise the threshold to the least of them. A radix select:
// 8-bit digits from the top; a pass counts the digits of the keys that
// share the prefix chosen so far (plain shared atomics: on the card they
// beat combining a warp's equal digits with __match_any_sync first), finds
// by a suffix sum over the 256 bins (one a thread) the digit whose bucket
// holds the k-th key, and stops once that bucket is wholly among the k.
// The keys whose top bits are at or above the prefix are then exactly the
// k. Called by every thread after a barrier; ends with one.
__device__ void block_cut(BlockShared& s, int k, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int cnt = s.cnt;
  u64 prefix = 0, pmask = 0;
  int need = k;       // keys still wanted from the bucket of `prefix`
  for (int shift = 56; shift >= 0; shift -= 8) {
    s.hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < cnt; i += THREADS) {
      const u64 key = s.buf[i];
      if ((key & pmask) == prefix)
        atomicAdd(&s.hist[(key >> shift) & 0xffu], 1);
    }
    __syncthreads();
    // suf: the keys of the bucket whose digit is at least tid's
    const int h = s.hist[tid];
    int suf = h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_down_sync(FULL, suf, o);
      if (lane + o < 32) suf += v;
    }
    if (lane == 0) s.wsum[warp] = suf;
    __syncthreads();
    for (int w = warp + 1; w < WARPS; ++w) suf += s.wsum[w];
    if (suf >= need && suf - h < need) {
      s.digit = tid;
      s.need = need - (suf - h);
      s.bucket = h;
    }
    __syncthreads();
    DIAG_ADD(4, tid == 0);
    prefix |= static_cast<u64>(s.digit) << shift;
    pmask |= 0xffull << shift;
    need = s.need;
    if (s.bucket == need) break;        // the same in every thread
  }
  if (tid == 0) {
    s.nsel = 0;
    s.kth = ~0ull;
    DIAG_ADD(3, 1);
  }
  __syncthreads();
  u64 least = ~0ull;     // the least key this thread kept
  for (int i = tid; i - tid < cnt; i += THREADS) {
    u64 key = 0ull;
    bool in = false;
    if (i < cnt) {
      key = s.buf[i];
      in = (key & pmask) >= prefix;
    }
    const unsigned m = __ballot_sync(FULL, in);
    if (m == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(&s.nsel, __popc(m));
    base = __shfl_sync(FULL, base, 0);
    if (in) {
      const int at = base + __popc(m & ((1u << lane) - 1u));
      if (at < MAX_K) s.sel[at] = key;
      least = key < least ? key : least;
    }
  }
  // one shared atomic a warp
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 other = __shfl_xor_sync(FULL, least, o);
    least = other < least ? other : least;
  }
  if (lane == 0 && least != ~0ull) atomicMin(&s.kth, least);
  __syncthreads();
  for (int j = tid; j < k; j += THREADS) s.buf[j] = s.sel[j];
  if (tid == 0) {
    s.cnt = k;
    if (s.kth > s.thr) s.thr = s.kth;
  }
  __syncthreads();
}

// Write the block's cnt (= k) keys to row q of vals and ids, each at its
// rank: the number of keys above it.
__device__ __forceinline__ void write_ranked(const BlockShared& s, int k,
                                             int q, float* vals,
                                             long long* ids, int tid) {
  const int cnt = s.cnt;
  for (int j = tid; j < cnt; j += THREADS) {
    const u64 key = s.buf[j];
    int rank = 0;
    for (int i = 0; i < cnt; ++i) rank += s.buf[i] > key;
    const size_t at = static_cast<size_t>(q) * k + rank;
    vals[at] = key_value(key);
    ids[at] = key_pos(key);
  }
}

// Block (q * ways + g) takes segment g of query q. See the top of the file.
// ways > 1: part holds the blocks' lists (k keys each) and their counts;
// q_thrs and tickets a word each per query, zeroed before the launch.
template <int METRIC>
__global__ void __launch_bounds__(THREADS, BLOCKS_A_SM)
block_kernel(const float* __restrict__ qx, const float* __restrict__ qq,
             const float* __restrict__ xx,
             const unsigned char* __restrict__ keep, long long keep_ld,
             long long n, long long n_valid, int k, long long seg, int ways,
             int vec, u64* __restrict__ part, u64* __restrict__ part_cnt,
             u64* __restrict__ q_thrs, u64* __restrict__ tickets,
             float* __restrict__ vals, long long* __restrict__ ids) {
  constexpr bool NORMS = METRIC == L2 || METRIC == L2_SQ;
  __shared__ BlockShared s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x / ways;
  const long long lo = static_cast<long long>(blockIdx.x % ways) * seg;
  const long long end = lo + seg < n ? lo + seg : n;
  const float* row = qx + static_cast<size_t>(q) * n;
  const unsigned char* krow =
      keep != nullptr ? keep + static_cast<size_t>(q) * keep_ld : nullptr;
  const float qqv = NORMS ? qq[q] : 0.0f;
  u64* q_thr = ways > 1 ? q_thrs + q : nullptr;
  const int cut_at = CUT_K * k < CUT_AT ? CUT_K * k : CUT_AT;
  if (tid == 0) {
    s.cnt = 0;
    s.thr = 0;
  }
  __syncthreads();
  for (long long base = lo; base < end; base += ROUND) {
    const long long wb = base + warp * STEP;
    // a line of 32 cells a lane, the next round's
    if (lane < STEP / 32) {
      const long long p = wb + ROUND + lane * 32;
      if (p < end) asm volatile("prefetch.global.L2 [%0];" ::"l"(row + p));
    }
    u64 thr = s.thr;
    if (q_thr != nullptr) {
      const u64 seen = __ldcg(q_thr);
      thr = seen > thr ? seen : thr;
    }
    float c[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = wb + (u * 32 + lane) * 4;
      const long long in = end - i, ok = n_valid - i;
      coarse4<METRIC>(row, xx, krow, qqv, i,
                      in <= 0 ? 0 : in >= 4 ? 4 : static_cast<int>(in),
                      ok <= 0 ? 0 : ok >= 4 ? 4 : static_cast<int>(ok),
                      vec != 0, c[u]);
    }
    const float bound = coarse_bound<METRIC>(thr);
    bool maybe = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) maybe |= c[u][e] <= bound;
#ifdef EXACT_TOPK_DIAG
    if (__any_sync(FULL, maybe) && lane == 0) DIAG_ADD(0, 1);
#endif
    bool full = false;
    if (maybe) {
      u64 key[4 * UNROLL];
#pragma unroll
      for (int t = 0; t < 4 * UNROLL; ++t) {
        const float ct = c[t >> 2][t & 3];
        const long long i = wb + ((t >> 2) * 32 + lane) * 4 + (t & 3);
        const u64 kt = ct <= bound ? make_key(-finish<METRIC>(ct), i) : 0ull;
        key[t] = kt >= thr ? kt : 0ull;
      }
      full = append(s, key, cut_at);
    }
    if (__syncthreads_or(full)) {
      block_cut(s, k, tid);
      if (q_thr != nullptr && tid == 0) atomicMax(q_thr, s.thr);
    }
  }
  // the last round ended in a barrier
  if (s.cnt > k) {
    block_cut(s, k, tid);
    if (q_thr != nullptr && tid == 0) atomicMax(q_thr, s.thr);
  }
#ifdef EXACT_TOPK_DIAG
  if (tid == 0) {
    DIAG_ADD(5, 1);
    DIAG_ADD(6, s.thr == 0);
    if (s.thr != 0)
      atomicAdd(&g_diag_thr, static_cast<double>(key_value(s.thr)));
  }
#endif
  if (ways == 1) {
    write_ranked(s, k, q, vals, ids, tid);
    return;
  }
  // publish this segment's list, then take a ticket
  const int cnt = s.cnt;
  u64* mine = part + static_cast<size_t>(blockIdx.x) * k;
  for (int j = tid; j < cnt; j += THREADS) mine[j] = s.buf[j];
  if (tid == 0) part_cnt[blockIdx.x] = static_cast<u64>(cnt);
  __threadfence();
  __syncthreads();
  if (tid == 0) s.last = atomicAdd(tickets + q, 1ull) == ways - 1ull;
  __syncthreads();
  if (!s.last) return;
  __threadfence();
  // the last block of query q merges the query's lists: the keys at or
  // above the query's threshold, ROUND entries a round
  u64 thr = __ldcg(q_thr);
  thr = s.thr > thr ? s.thr : thr;
  if (tid == 0) s.cnt = 0;
  __syncthreads();
  const long long total = static_cast<long long>(ways) * k;
  const u64* lists = part + static_cast<size_t>(q) * ways * k;
  const u64* counts = part_cnt + static_cast<size_t>(q) * ways;
  for (long long e0 = 0; e0 < total; e0 += ROUND) {
    u64 key[4 * UNROLL];
    bool any = false;
#pragma unroll
    for (int t = 0; t < 4 * UNROLL; ++t) {
      const long long e = e0 + warp * STEP + t * 32 + lane;
      u64 kt = 0ull;
      if (e < total && static_cast<u64>(e % k) < __ldcg(counts + e / k))
        kt = __ldcg(lists + e);
      key[t] = kt >= thr ? kt : 0ull;
      any |= key[t] != 0ull;
    }
    const bool full = any && append(s, key, cut_at);
    if (__syncthreads_or(full)) block_cut(s, k, tid);
  }
  if (s.cnt > k) block_cut(s, k, tid);
  write_ranked(s, k, q, vals, ids, tid);
}

__global__ void empty_kernel() {}

// ------------------------------------------------------------- launches
// The scratch of a call with ways > 1, in 8-byte words: the lists [b *
// ways * k], their counts [b * ways], then the thresholds [b] and tickets
// [b]. The thresholds and tickets start each call at zero.
u64* thresholds(u64* part, int b, int ways, int k) {
  return part + static_cast<size_t>(b) * ways * (k + 1);
}

cudaError_t zero_thresholds(u64* part, int b, int ways, int k,
                            cudaStream_t stream) {
  return cudaMemsetAsync(thresholds(part, b, ways, k), 0, 2 * b * sizeof(u64),
                         stream);
}

template <int METRIC>
int launch(const float* qx, const float* qq, const float* xx,
           const unsigned char* keep, long long keep_ld, long long n,
           long long n_valid, int b, int k, long long seg, int ways, int vec,
           u64* part, float* vals, long long* ids, cudaStream_t stream) {
  u64* counts = part + static_cast<size_t>(b) * ways * k;
  u64* thrs = thresholds(part, b, ways, k);
  if (ways > 1) {
    const cudaError_t err = zero_thresholds(part, b, ways, k, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  block_kernel<METRIC><<<static_cast<unsigned>(b) * ways, THREADS, 0,
                         stream>>>(qx, qq, xx, keep, keep_ld, n, n_valid, k,
                                   seg, ways, vec, part, counts, thrs,
                                   thrs + b, vals, ids);
  return static_cast<int>(cudaGetLastError());
}

constexpr int ERR_SHAPE = -1;

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 when launched, a cudaError_t (> 0) or
// ERR_SHAPE. qx [b, N] f32 contiguous; qq [b] and xx [N] f32 (read for
// metric 0 = l2 and 1 = l2_sq; 2 = cosine, 3 = ip); keep NULL or a byte
// per cell with row stride keep_ld (0: one row for every query); columns
// at or past n_valid score +inf. (seg, ways) is the plan
// (ops/exact_topk.py:_plan): seg a multiple of ROUND, ways = ceil(N /
// seg). vec: qx rows, xx and keep may be read 16 (keep: 4) bytes at a
// time (N % 4 == 0 and aligned pointers). part: scratch of b * (ways * (k
// + 1) + 2) 8-byte words with ways > 1 (NULL allowed with ways = 1); vals
// [b, k] f32 and ids [b, k] int64. 1 <= k <= min(MAX_K, N), N < 2^32.
int exact_topk_select_launch(const void* qx, const void* qq, const void* xx,
                             const void* keep, long long keep_ld, int metric,
                             long long n, long long n_valid, int b, int k,
                             long long seg, int ways, int vec, void* part,
                             void* vals, void* ids, void* stream) {
  const bool norms = metric == L2 || metric == L2_SQ;
  if (metric < L2 || metric > IP || n < 1 || n >= (1ll << 32) || b < 1 ||
      k < 1 || k > MAX_K || k > n || n_valid < 0 || n_valid > n || seg < 1 ||
      seg % ROUND != 0 || ways < 1 || (n + seg - 1) / seg != ways ||
      static_cast<long long>(b) * ways > 0x7fffffffll ||
      (keep_ld != 0 && keep_ld != n) ||
      (norms && (qq == nullptr || xx == nullptr)) ||
      (ways > 1 && part == nullptr))
    return ERR_SHAPE;
  auto go = launch<IP>;
  if (metric == L2) go = launch<L2>;
  else if (metric == L2_SQ) go = launch<L2_SQ>;
  else if (metric == COSINE) go = launch<COSINE>;
  return go(static_cast<const float*>(qx), static_cast<const float*>(qq),
            static_cast<const float*>(xx),
            static_cast<const unsigned char*>(keep), keep_ld, n, n_valid, b,
            k, seg, ways, vec, static_cast<u64*>(part),
            static_cast<float*>(vals), static_cast<long long*>(ids),
            static_cast<cudaStream_t>(stream));
}

// An empty kernel on `stream`: the launch floor a call cannot go under.
int exact_topk_select_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The largest k, and the positions a block reads a round: the plan's
// segments are multiples of it (ops/exact_topk.py must agree).
int exact_topk_select_max_k() { return MAX_K; }
int exact_topk_select_round() { return ROUND; }

const char* exact_topk_select_error_string(int err) {
  if (err == ERR_SHAPE) return "shape outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef EXACT_TOPK_DIAG
// Copy the counters (7 words) and the threshold sum out, then zero them;
// 0 or a cudaError_t. Synchronises with the device.
int exact_topk_select_diag(unsigned long long* out, double* thr_sum) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_diag, sizeof(g_diag));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(thr_sum, g_diag_thr, sizeof(double));
  static const unsigned long long zeros[7] = {};
  static const double zero = 0.0;
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_diag, zeros, sizeof(zeros));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_diag_thr, &zero, sizeof(double));
  return static_cast<int>(err);
}

// The memset alone that a call with ways > 1 makes before its launch, on
// the same scratch: for timing it apart from the kernel.
int exact_topk_select_zero(void* part, int b, int ways, int k, void* stream) {
  return static_cast<int>(zero_thresholds(static_cast<u64*>(part), b, ways, k,
                                          static_cast<cudaStream_t>(stream)));
}
#endif

}  // extern "C"
