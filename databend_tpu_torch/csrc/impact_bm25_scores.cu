// impact_bm25_scores and impact_bm25_topk: BM25 scoring of a query batch over
// a block's doc-major layout, for Hopper. Two entry points share one scoring
// loop (score_doc):
//
// impact_bm25_scores_launch writes the dense [b, n_pad] scores. It replaces
// the tile step of the XLA programs _impact_topk_program and
// _impact_fused_topk_program (databend_tpu/index/inverted/device.py:385-427
// and :432-488, the `step` bodies): there a [tile, L, b, m] equality tensor
// of doc slots against query terms is built and reduced twice, which XLA
// fuses and eager PyTorch would materialise. No Pallas kernel stands behind
// it. Same function:
//   term_ids [n_pad, L] int32 (pad docs and pad slots -2), sat [n_pad, L] f32
//   (no NaN), qterms [b, m] int32 (pad -1, pads after a query's real terms),
//   idf [b, m] f32, qgroup [b, m] int32 (pad -1), need [b] f32, optionally
//   dist [b, n_pad] f32 with w_s, w_d
//   -> out [b, n_pad] f32,
//   score(q, d) = sum over j = 0..m-1, in that order, of
//                 idf[q, j] * sat[d, s]  for the slot s with
//                 term_ids[d, s] == qterms[q, j]  (at most one: the layout
//                 writes each posting of a doc into one slot),
//   out[q, d]   = score, or w_s * score + w_d * dist[q, d] when dist is given,
//                 if the number of matched groups >= need[q], else -inf.
//   The terms of a group are adjacent along j, so the matched groups are the
//   runs of equal qgroup ids with at least one matching term: no bit mask,
//   and no limit on the number of groups.
// Products and sums are single f32 operations (no fused multiply-add), as in
// the plain PyTorch version, so docs with equal terms and saturations get
// bit-equal scores: the tie rule of the top-k after this kernel needs that.
//
// impact_bm25_topk_launch computes the same scores and, in the same pass, the
// k largest per query: the whole of those two programs, their final
// jax.lax.top_k(dense, k) (device.py:424, :486) included. Output vals [b, k]
// f32 and ids [b, k] int64, in lax.top_k's order: by the total order of f32
// descending (-0.0 below +0.0), equal scores by ascending doc. The [b, n_pad]
// score block never exists.
//
// Bound of impact_bm25_scores. At n_pad = 262,144, L = 8, b = 128, m = 4 the
// call moves 151 MB (one read of term_ids and sat, one write of the
// [b, n_pad] scores): 0.045 ms at 3.35 TB/s. One compare-select per (real
// doc slot, real query term), 0.8 G for docs of three terms and queries of
// two, takes 0.012 ms at 132 SMs x 64 int32 lanes x 1.98 GHz: bytes bind
// there, operations for long docs and wide queries (L = 64, m = 8). The
// kernel itself is held by neither: a compare-select is two instructions of
// the half-rate integer pipe, and the per-term and per-query bookkeeping
// costs as much again (PERF.md).
//
// Bound of impact_bm25_topk. Its bytes are one read of term_ids and sat (and
// of the [b, n_pad] dist term when fused) and the [b, k] result: 17 MB,
// 0.005 ms, at the shape above; fused, 151 MB. Its operations are the same
// 0.8 G compare-selects, 0.012 ms: operations bind the text call, bytes the
// fused one. The design answers the operations bound by doing little per
// (query, doc) beyond the scoring itself: a compare of a 64-bit key against
// the query's threshold and a warp vote. It reaches 3% of that bound
// (PERF.md): the scoring's bookkeeping and the selection, not the
// compare-selects, hold it.
//
// Design of the scoring (a simple one: making it fast is later work).
//  * The docs' rows. For L = 8, 16, 32 a lane keeps its doc's term ids and
//    saturations in registers (16-byte loads, every byte of a row used) and
//    the slot loop unrolls into compare + select pairs. For longer rows the
//    block copies 32 rows into shared memory, transposed and padded to
//    33 words a slot so that neither the copy nor the lanes' reads collide
//    on a bank: 264 bytes a slot, 135 KB at L = 512. There the slot loop
//    reads term ids only and the one matching saturation after it.
//    L is the bucket of the block's longest doc and most docs are shorter,
//    so that loop stops at the last slot that holds a real term in any doc
//    of the 32 (rounded up to the loop's step); for short rows the same
//    test cost as much as it saved.
//  * The query operands arrive packed, one 16-byte entry {term, idf, group}
//    per query term (the wrapper interleaves the three arrays), and are read
//    from global memory through the read-only cache, every lane of a warp
//    the same address (one broadcast transaction per term): shared memory
//    does not grow with b * m, and a fuzzy query of many terms needs no
//    chunking. A query's loop ends at its first pad term; the exit is
//    uniform across the warp.
//  * One compare and one select per (slot, term): the matched saturation
//    starts as NaN, so "some slot matched" is `v == v` and needs no second
//    compare per slot.
//
// impact_bm25_scores: a block owns a strip of 32 docs, one per lane, and all
// queries; its 8 warps take the queries in turns. A warp's 32 lanes write
// out[q, d0 .. d0 + 31], 128 contiguous bytes. When the docs alone do not
// fill the card, gridDim.y splits the queries too.
//
// impact_bm25_topk, a first right version of a selecting kernel:
//  * One ordering key. Each (query, doc) gets the u64 key
//    (ord(score) << 32) | (0xffffffff - doc), ord the order-preserving map of
//    f32 bits to u32. Keys are distinct, and the k largest keys are exactly
//    lax.top_k's answer, ties and the -inf fill included: no second pass
//    over tied values.
//  * Phase one (topk_strip_kernel). A block walks a sub-strip of
//    32 x `chunks` docs in ascending order, 32 docs (one per lane) at a
//    time, for up to 4 queries a warp (a block's queries dealt to its warps
//    in turn, so that a small batch still keeps every warp busy); blocks of
//    neighbouring ids share the sub-strip, so its rows come from L1 or L2
//    after the first warp. A doc that ties the running k-th score comes
//    later than it and so has a smaller key: one compare against the
//    query's threshold rejects it. BM25 over short texts ties by the
//    thousand, and after the first chunks almost every doc ends there.
//  * Each query of a warp has a buffer of 32 * R keys (R = 2, 4, 8 for k
//    up to 32, 96, 128: at least k + 32) in shared memory, private to the
//    warp: the lanes above the threshold append with __ballot_sync +
//    __popc. When a ballot would overflow the buffer, the warp cuts it to
//    its k largest keys (a bitonic sort of the buffer in registers, R keys
//    a lane, partners trading through shuffles), and the threshold rises to
//    the k-th key. At the end of its sub-strip the warp cuts once more and
//    writes the sorted top k (0 keys where the sub-strip held fewer docs)
//    to part [b, nsub, k]. No atomics.
//  * A warp takes its queries in turn over each chunk's row (held in
//    registers), each scored and offered before the next. Their thresholds
//    and counts live in shared memory and the loop is not unrolled: the
//    kernel holds one copy of the scoring and of the selection. (Unrolled,
//    with a copy of the sorting network for each query, the kernel was
//    several times larger and no faster; appending through shared-memory
//    atomics between cuts, with no warp-wide operation in the hot loop,
//    was no faster either: PERF.md.)
//  * Phase two (topk_merge_kernel), a block per query: its 8 warps each scan
//    a share of the query's nsub * k keys with the same buffer and
//    threshold, warp 0 merges the others' top k, and unpacks the sorted
//    keys to (vals, ids).
//  * Sub-strips are 32 x 32 docs, halved (to 4 x 32 at least) while fewer
//    than TARGET_WARPS warps would work: small batches spread over more
//    sub-strips, and phase two reads more keys.
//  * k is at most MAX_K = 128 (the wrapper sends larger k to
//    impact_bm25_scores and the tie-rule top-k). At k = 128 and 8 warps a
//    block's buffers take 64 KB, which beside the 135 KB of rows at
//    L = 512 still fits the SM.
//
// Times and their bounds: chip_smoke.py prints them, PERF.md keeps them.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int DOCS = 32;      // docs of a strip, one per lane
constexpr int ROW_PAD = 33;   // words per slot of the transposed rows
constexpr int MAX_L = 512;
constexpr int FILL_BLOCKS = 4 * 132;   // blocks wanted before queries split
constexpr int QPW = 4;        // queries a warp of topk_strip_kernel owns
constexpr int MAX_K = 128;
constexpr int MAX_CHUNKS = 32;         // 32-doc chunks of a sub-strip
constexpr int MIN_CHUNKS = 4;
constexpr int TARGET_WARPS = 2048;     // phase-one warps wanted
constexpr unsigned FULL = 0xffffffffu;

// A lane's doc row: LR > 0 slots in registers. LR == 0: the rows of the 32
// docs live in shared memory as s_ids[slot * ROW_PAD + lane], s_sat likewise.
template <int LR>
struct Row {
  static constexpr int NR = LR > 0 ? LR : 1;
  int ids[NR];
  float st[NR];
};

template <int LR>
__device__ __forceinline__ void load_row(const int* __restrict__ term_ids,
                                         const float* __restrict__ sat,
                                         long long d, bool live, Row<LR>& r) {
  const int4* pi = reinterpret_cast<const int4*>(term_ids + d * LR);
  const float4* ps = reinterpret_cast<const float4*>(sat + d * LR);
#pragma unroll
  for (int v = 0; v < LR / 4; ++v) {
    int4 a = make_int4(-2, -2, -2, -2);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      a = __ldg(pi + v);
      f = __ldg(ps + v);
    }
    r.ids[4 * v + 0] = a.x; r.ids[4 * v + 1] = a.y;
    r.ids[4 * v + 2] = a.z; r.ids[4 * v + 3] = a.w;
    r.st[4 * v + 0] = f.x; r.st[4 * v + 1] = f.y;
    r.st[4 * v + 2] = f.z; r.st[4 * v + 3] = f.w;
  }
}

// Long rows: the block copies the rows of docs doc0 .. doc0 + 31 into shared
// memory (`rows`: L * ROW_PAD ids, then as many saturations) and returns the
// slots to scan: every real term of those docs lies below it. Every thread
// of the block calls it; it ends with the rows visible to all.
__device__ __forceinline__ int stage_rows(unsigned char* rows,
                                          const int* __restrict__ term_ids,
                                          const float* __restrict__ sat,
                                          long long doc0, int n_pad, int L) {
  __shared__ int s_used;
  int* w_ids = reinterpret_cast<int*>(rows);
  float* w_sat = reinterpret_cast<float*>(rows) +
                 static_cast<size_t>(L) * ROW_PAD;
  const long long base = doc0 * L;
  int used = 0;
  __syncthreads();            // the previous rows and s_used are read
  if (threadIdx.x == 0) s_used = 0;
  for (int i = threadIdx.x; i < DOCS * L; i += blockDim.x) {
    const int doc = i / L;
    const int slot = i - doc * L;
    const bool in = doc0 + doc < n_pad;
    const int id = in ? __ldg(term_ids + base + i) : -2;
    w_ids[slot * ROW_PAD + doc] = id;
    w_sat[slot * ROW_PAD + doc] = in ? __ldg(sat + base + i) : 0.f;
    if (id >= 0 && slot >= used) used = slot + 1;
  }
  __syncthreads();
  used = __reduce_max_sync(FULL, used);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_used, used);
  __syncthreads();
  return (s_used + 7) & ~7;
}

// The score of this lane's doc for the query whose packed terms start at
// `qp`, and the number of its term groups that matched.
template <int LR>
__device__ __forceinline__ float score_doc(const int4* __restrict__ qp, int m,
                                           const Row<LR>& r,
                                           const unsigned char* rows, int L,
                                           int used, int lane, int& groups) {
  const int* s_ids = reinterpret_cast<const int*>(rows);
  const float* s_sat = reinterpret_cast<const float*>(rows) +
                       static_cast<size_t>(L) * ROW_PAD;
  float score = 0.f;
  groups = 0;
  int cur = INT_MIN;          // no group id: the first term opens a run
  bool run_hit = false;
#pragma unroll 2
  for (int j = 0; j < m; ++j) {
    const int4 e = __ldg(qp + j);       // {term, idf, group, unused}
    const int t = e.x;
    if (t < 0) break;         // pad terms trail the real ones
    float v = __int_as_float(0x7fc00000);   // NaN: no slot matched yet
    if constexpr (LR > 0) {
#pragma unroll
      for (int s = 0; s < LR; ++s) v = r.ids[s] == t ? r.st[s] : v;
    } else {
      int at = -1;            // the matching slot: ids only, then one sat
#pragma unroll 8
      for (int s = 0; s < used; ++s)
        at = s_ids[s * ROW_PAD + lane] == t ? s : at;
      if (at >= 0) v = s_sat[at * ROW_PAD + lane];
    }
    const bool hit = v == v;
    score = __fadd_rn(score, __fmul_rn(__int_as_float(e.y), hit ? v : 0.f));
    if (e.z != cur) {         // uniform across the warp
      groups += run_hit ? 1 : 0;
      run_hit = false;
      cur = e.z;
    }
    run_hit |= hit;
  }
  groups += run_hit ? 1 : 0;
  return score;
}

// The ranked value of (q, d): the score, or the fused combination, masked to
// -inf below `need` matched groups (last: the weights may be negative, -inf
// is never multiplied).
__device__ __forceinline__ float ranked(float score, int groups, float need,
                                        const float* __restrict__ dist,
                                        size_t at, float w_s, float w_d) {
  float val = score;
  if (dist != nullptr)
    val = __fadd_rn(__fmul_rn(w_s, score), __fmul_rn(w_d, __ldg(dist + at)));
  return static_cast<float>(groups) >= need ? val : __int_as_float(0xff800000);
}

// The second launch bound (blocks wanted on an SM) tells ptxas how many
// registers a variant may use: left to itself it once squeezed the L = 8
// variant into 32 registers and spilled.
template <int LR>
__global__ void __launch_bounds__(THREADS, LR == 8 ? 5 : LR == 16 ? 4
                                           : LR == 32 ? 2 : 1)
impact_kernel(const int* __restrict__ term_ids, const float* __restrict__ sat,
              const int4* __restrict__ qpack, const float* __restrict__ need,
              const float* __restrict__ dist, float w_s, float w_d,
              float* __restrict__ out, int n_pad, int L, int b, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long doc0 = static_cast<long long>(blockIdx.x) * DOCS;
  const long long d = doc0 + lane;
  const bool live = d < n_pad;

  Row<LR> r;
  int used = 0;
  if constexpr (LR > 0)
    load_row<LR>(term_ids, sat, d, live, r);
  else
    used = stage_rows(smem, term_ids, sat, doc0, n_pad, L);

  for (int q = blockIdx.y * WARPS + warp; q < b; q += gridDim.y * WARPS) {
    int groups;
    const float score = score_doc<LR>(qpack + static_cast<size_t>(q) * m, m,
                                      r, smem, L, used, lane, groups);
    if (live) {
      const size_t at = static_cast<size_t>(q) * n_pad + d;
      out[at] = ranked(score, groups, __ldg(need + q), dist, at, w_s, w_d);
    }
  }
}

// ------------------------------------------------------------- selection
__device__ __forceinline__ u64 make_key(float v, long long d) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | (0xffffffffu - static_cast<unsigned>(d));
}

// Sort the warp's 32 * R keys descending: element e = r * 32 + lane lives
// in v[r]. A bitonic network: partners at distance j < 32 trade through a
// shuffle, at j >= 32 within a lane's registers.
template <int R>
__device__ __forceinline__ void warp_sort_desc(u64 (&v)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // a run of `size` elements is sorted descending when bit `size` of
        // its index is clear, ascending otherwise: the last run descends
        const bool desc = ((r * 32 + lane) & size) == 0;
        if (j >= 32) {
          const int pr = r ^ (j >> 5);
          if (pr > r) {       // r holds the lower index of the pair
            const u64 lo = v[r], hi = v[pr];
            const bool swap = desc ? lo < hi : lo > hi;
            v[r] = swap ? hi : lo;
            v[pr] = swap ? lo : hi;
          }
        } else {
          const u64 other = __shfl_xor_sync(FULL, v[r], j);
          const bool lower = (lane & j) == 0;
          const bool keep_max = lower == desc;
          v[r] = keep_max ? (v[r] > other ? v[r] : other)
                          : (v[r] < other ? v[r] : other);
        }
      }
    }
  }
}

// Cut a warp's buffer of `cnt` <= 32 * R distinct keys to its min(cnt, k)
// largest, sorted descending at buf[0 ..]; returns that count. Called by
// the whole warp, where no doc row is held in registers.
template <int R>
__device__ __forceinline__ int cut(u64* buf, int cnt, int k, int lane) {
  __syncwarp();
  u64 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    v[r] = e < cnt ? buf[e] : 0ull;   // 0 sorts below every real key
  }
  warp_sort_desc<R>(v, lane);
  const int keep = cnt < k ? cnt : k;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r * 32 + lane < keep) buf[r * 32 + lane] = v[r];
  __syncwarp();
  return keep;
}

// Offer one key a lane (0: none) to a warp's buffer of 32 * R keys. `cnt`
// and `thr` are the same in every lane; 32 * R >= k + 32, so after a cut a
// whole ballot fits.
template <int R>
__device__ __forceinline__ void offer(u64 key, u64* buf, int& cnt, u64& thr,
                                      int k, int lane) {
  unsigned mask = __ballot_sync(FULL, key > thr);
  if (mask == 0) return;
  if (cnt + __popc(mask) > 32 * R) {
    cnt = cut<R>(buf, cnt, k, lane);
    if (cnt == k) thr = buf[k - 1];
    mask = __ballot_sync(FULL, key > thr);
  }
  if (key > thr) buf[cnt + __popc(mask & ((1u << lane) - 1u))] = key;
  cnt += __popc(mask);
}

// Blocks wanted on an SM, as for impact_kernel: three for short rows, two
// where the sort of a k > 96 buffer (R = 8) needs the registers.
template <int LR, int R>
__global__ void __launch_bounds__(THREADS, LR == 8 && R < 8 ? 3
                                           : LR == 0 ? 1 : 2)
topk_strip_kernel(const int* __restrict__ term_ids,
                  const float* __restrict__ sat,
                  const int4* __restrict__ qpack,
                  const float* __restrict__ need,
                  const float* __restrict__ dist, float w_s, float w_d,
                  u64* __restrict__ part, int n_pad, int L, int b, int m,
                  int k, int chunks, int nsub, int gq) {
  constexpr int CAP = 32 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int sub = blockIdx.x / gq;
  // the warp's queries: q0 + i * warps for i < QPW
  const int q0 = (blockIdx.x - sub * gq) * warps * QPW + warp;
  // per warp: QPW buffers, then the queries' thresholds and counts
  u64* sel = reinterpret_cast<u64*>(smem) +
             static_cast<size_t>(warp) * QPW * (CAP + 1);
  u64* s_thr = sel + QPW * CAP;
  int* s_cnt = reinterpret_cast<int*>(
      reinterpret_cast<u64*>(smem) + static_cast<size_t>(warps) * QPW *
                                         (CAP + 1)) + warp * QPW;
  unsigned char* rows = reinterpret_cast<unsigned char*>(
      reinterpret_cast<int*>(smem + static_cast<size_t>(warps) * QPW *
                                        (CAP + 1) * sizeof(u64)) +
      ((warps * QPW + 3) & ~3));
  if (lane < QPW) {
    s_thr[lane] = 0;          // every real key is above 0
    s_cnt[lane] = 0;
  }
  __syncwarp();
  const long long first = static_cast<long long>(sub) * chunks * DOCS;
  for (int c = 0; c < chunks; ++c) {
    const long long doc0 = first + static_cast<long long>(c) * DOCS;
    if (doc0 >= n_pad) break;           // uniform across the block
    const long long d = doc0 + lane;
    const bool live = d < n_pad;
    Row<LR> r;
    int used = 0;
    if constexpr (LR > 0)
      load_row<LR>(term_ids, sat, d, live, r);
    else
      used = stage_rows(rows, term_ids, sat, doc0, n_pad, L);
    // a loop, not unrolled: one copy of the scoring and of the selection
    // in the kernel's code (four copies of the cut's sorting network
    // overflowed the instruction cache)
#pragma unroll 1
    for (int i = 0; i < QPW; ++i) {
      const int q = q0 + i * warps;
      if (q >= b) break;      // uniform across the warp
      int groups;
      const float score = score_doc<LR>(qpack + static_cast<size_t>(q) * m,
                                        m, r, rows, L, used, lane, groups);
      u64 key = 0;
      if (live)
        key = make_key(ranked(score, groups, __ldg(need + q), dist,
                              static_cast<size_t>(q) * n_pad + d, w_s, w_d),
                       d);
      u64 thr = s_thr[i];
      int cnt = s_cnt[i];
      offer<R>(key, sel + i * CAP, cnt, thr, k, lane);
      __syncwarp();
      if (lane == 0) {
        s_thr[i] = thr;
        s_cnt[i] = cnt;
      }
      __syncwarp();
    }
  }
#pragma unroll 1
  for (int i = 0; i < QPW; ++i) {
    const int q = q0 + i * warps;
    if (q >= b) break;
    u64* buf = sel + i * CAP;
    const int keep = cut<R>(buf, s_cnt[i], k, lane);
    u64* out = part + (static_cast<size_t>(q) * nsub + sub) * k;
    for (int j = lane; j < k; j += 32) out[j] = j < keep ? buf[j] : 0ull;
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS)
topk_merge_kernel(const u64* __restrict__ part, int nsub, int k,
                  float* __restrict__ vals, long long* __restrict__ ids) {
  constexpr int CAP = 32 * R;
  __shared__ u64 s_buf[WARPS][CAP];
  __shared__ int s_cnt[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x;
  u64* buf = s_buf[warp];
  const u64* src = part + static_cast<size_t>(q) * nsub * k;
  const long long total = static_cast<long long>(nsub) * k;
  u64 thr = 0;
  int cnt = 0;
  for (long long at = static_cast<long long>(warp) * 32 + lane;
       at - lane < total; at += WARPS * 32)
    offer<R>(at < total ? __ldg(src + at) : 0ull, buf, cnt, thr, k, lane);
  cnt = cut<R>(buf, cnt, k, lane);
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (warp != 0) return;
  if (cnt == k) thr = buf[k - 1];
  for (int w = 1; w < WARPS; ++w) {
    const int n = s_cnt[w];
    for (int j = 0; j < n; j += 32)
      offer<R>(j + lane < n ? s_buf[w][j + lane] : 0ull, buf, cnt, thr, k,
               lane);
  }
  // k <= n_pad: the sub-strips held at least k real keys between them
  cut<R>(buf, cnt, k, lane);
  for (int j = lane; j < k; j += 32) {
    const size_t at = static_cast<size_t>(q) * k + j;
    const u64 key = buf[j];
    const unsigned hi = static_cast<unsigned>(key >> 32);
    vals[at] = __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
    ids[at] = static_cast<long long>(0xffffffffu - static_cast<unsigned>(key));
  }
}

template <int LR>
int launch(const int* term_ids, const float* sat, const int4* qpack,
           const float* need, const float* dist, float w_s, float w_d,
           float* out, int n_pad, int L, int b, int m, cudaStream_t stream) {
  auto kernel = impact_kernel<LR>;
  size_t smem_bytes = 0;
  if (LR == 0) {
    smem_bytes = static_cast<size_t>(2) * L * ROW_PAD * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * MAX_L * ROW_PAD * static_cast<int>(sizeof(int)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int gx = (n_pad + DOCS - 1) / DOCS;
  const int qblocks = (b + WARPS - 1) / WARPS;
  int gy = 1;
  if (gx < FILL_BLOCKS) {
    gy = (FILL_BLOCKS + gx - 1) / gx;
    if (gy > qblocks) gy = qblocks;
    if (gy > 65535) gy = 65535;
  }
  kernel<<<dim3(gx, gy), THREADS, smem_bytes, stream>>>(
      term_ids, sat, qpack, need, dist, w_s, w_d, out, n_pad, L, b, m);
  return static_cast<int>(cudaGetLastError());
}

// How impact_bm25_topk cuts the work: 32-doc chunks of a sub-strip, the
// number of sub-strips, warps a block, blocks a sub-strip, and R: a
// buffer holds 32 * R keys, at least k + 32.
struct Geometry {
  int chunks, nsub, warps, gq, r;
};

Geometry topk_geometry(int n_pad, int L, int b, int k) {
  Geometry g;
  const int qsets = (b + QPW - 1) / QPW;
  // a warp for each query of a small batch; long rows are staged by the
  // whole block: keep 8 warps for the copy
  g.warps = L > 32 || b > WARPS ? WARPS : b;
  g.gq = (b + g.warps * QPW - 1) / (g.warps * QPW);
  g.chunks = MAX_CHUNKS;
  while (g.chunks > MIN_CHUNKS &&
         static_cast<long long>((n_pad + DOCS * g.chunks - 1) /
                                (DOCS * g.chunks)) * qsets < TARGET_WARPS)
    g.chunks /= 2;
  g.nsub = (n_pad + DOCS * g.chunks - 1) / (DOCS * g.chunks);
  g.r = k <= 32 ? 2 : k <= 96 ? 4 : 8;
  return g;
}

template <int LR, int R>
int launch_topk(const Geometry& g, const int* term_ids, const float* sat,
                const int4* qpack, const float* need, const float* dist,
                float w_s, float w_d, u64* part, float* vals, long long* ids,
                int n_pad, int L, int b, int m, int k, cudaStream_t stream) {
  auto strip = topk_strip_kernel<LR, R>;
  // buffers, thresholds, counts (rounded to 16 bytes), then long rows
  size_t smem_bytes = static_cast<size_t>(g.warps) * QPW * (32 * R + 1) *
                          sizeof(u64) +
                      ((g.warps * QPW + 3) & ~3) * sizeof(int);
  if (LR == 0) smem_bytes += static_cast<size_t>(2) * L * ROW_PAD * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      strip, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  strip<<<g.nsub * g.gq, 32 * g.warps, smem_bytes, stream>>>(
      term_ids, sat, qpack, need, dist, w_s, w_d, part, n_pad, L, b, m, k,
      g.chunks, g.nsub, g.gq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<R><<<b, THREADS, 0, stream>>>(part, g.nsub, k, vals, ids);
  return static_cast<int>(cudaGetLastError());
}

template <int LR>
int launch_topk(const int* term_ids, const float* sat, const int4* qpack,
                const float* need, const float* dist, float w_s, float w_d,
                u64* part, float* vals, long long* ids, int n_pad, int L,
                int b, int m, int k, cudaStream_t stream) {
  const Geometry g = topk_geometry(n_pad, L, b, k);
  switch (g.r) {
    case 2:
      return launch_topk<LR, 2>(g, term_ids, sat, qpack, need, dist, w_s,
                                w_d, part, vals, ids, n_pad, L, b, m, k,
                                stream);
    case 4:
      return launch_topk<LR, 4>(g, term_ids, sat, qpack, need, dist, w_s,
                                w_d, part, vals, ids, n_pad, L, b, m, k,
                                stream);
    default:
      return launch_topk<LR, 8>(g, term_ids, sat, qpack, need, dist, w_s,
                                w_d, part, vals, ids, n_pad, L, b, m, k,
                                stream);
  }
}

constexpr int ERR_SHAPE = -1;

bool shape_ok(int n_pad, int L, int b, int m) {
  return L % 8 == 0 && L >= 8 && L <= MAX_L && b >= 1 && m >= 1 && n_pad >= 1;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 when launched, a cudaError_t (> 0) or
// ERR_SHAPE. `qpack` holds b * m entries of four 32-bit words {term id, idf
// as f32 bits, group id, unused}. `dist` may be NULL (then w_s and w_d are
// not read). The caller guarantees contiguous device buffers, term_ids, sat
// and qpack at addresses that are multiples of 16, L % 8 == 0 with
// 8 <= L <= 512, and b, m, n_pad >= 1.
int impact_bm25_scores_launch(const void* term_ids, const void* sat,
                              const void* qpack, const void* need,
                              const void* dist, float w_s, float w_d,
                              void* out, int n_pad, int L, int b, int m,
                              void* stream) {
  if (!shape_ok(n_pad, L, b, m)) return ERR_SHAPE;
  const int* ti = static_cast<const int*>(term_ids);
  const float* sa = static_cast<const float*>(sat);
  const int4* qp = static_cast<const int4*>(qpack);
  const float* nd = static_cast<const float*>(need);
  const float* di = static_cast<const float*>(dist);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 8:
      return launch<8>(ti, sa, qp, nd, di, w_s, w_d, o, n_pad, L, b, m, st);
    case 16:
      return launch<16>(ti, sa, qp, nd, di, w_s, w_d, o, n_pad, L, b, m, st);
    case 32:
      return launch<32>(ti, sa, qp, nd, di, w_s, w_d, o, n_pad, L, b, m, st);
    default:
      return launch<0>(ti, sa, qp, nd, di, w_s, w_d, o, n_pad, L, b, m, st);
  }
}

// The largest k impact_bm25_topk_launch takes.
int impact_bm25_topk_max_k() { return MAX_K; }

// The 8-byte words of scratch impact_bm25_topk_launch needs at this shape,
// or ERR_SHAPE.
long long impact_bm25_topk_workspace(int n_pad, int L, int b, int k) {
  if (!shape_ok(n_pad, L, b, 1) || k < 1 || k > MAX_K || k > n_pad)
    return ERR_SHAPE;
  return static_cast<long long>(b) * topk_geometry(n_pad, L, b, k).nsub * k;
}

// The k largest ranked values per query (see the top of the file) into
// vals [b, k] f32 and ids [b, k] int64, through `part`, a scratch buffer of
// impact_bm25_topk_workspace(n_pad, L, b, k) words. Operands and return
// codes as impact_bm25_scores_launch, and 1 <= k <= min(MAX_K, n_pad).
int impact_bm25_topk_launch(const void* term_ids, const void* sat,
                            const void* qpack, const void* need,
                            const void* dist, float w_s, float w_d,
                            void* part, void* vals, void* ids, int n_pad,
                            int L, int b, int m, int k, void* stream) {
  if (!shape_ok(n_pad, L, b, m) || k < 1 || k > MAX_K || k > n_pad)
    return ERR_SHAPE;
  const int* ti = static_cast<const int*>(term_ids);
  const float* sa = static_cast<const float*>(sat);
  const int4* qp = static_cast<const int4*>(qpack);
  const float* nd = static_cast<const float*>(need);
  const float* di = static_cast<const float*>(dist);
  u64* pa = static_cast<u64*>(part);
  float* va = static_cast<float*>(vals);
  long long* ix = static_cast<long long*>(ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 8:
      return launch_topk<8>(ti, sa, qp, nd, di, w_s, w_d, pa, va, ix, n_pad,
                            L, b, m, k, st);
    case 16:
      return launch_topk<16>(ti, sa, qp, nd, di, w_s, w_d, pa, va, ix, n_pad,
                             L, b, m, k, st);
    case 32:
      return launch_topk<32>(ti, sa, qp, nd, di, w_s, w_d, pa, va, ix, n_pad,
                             L, b, m, k, st);
    default:
      return launch_topk<0>(ti, sa, qp, nd, di, w_s, w_d, pa, va, ix, n_pad,
                            L, b, m, k, st);
  }
}

const char* impact_bm25_scores_error_string(int err) {
  if (err == ERR_SHAPE) return "shape outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
