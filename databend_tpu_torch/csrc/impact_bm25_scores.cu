// impact_bm25_scores and impact_bm25_topk: BM25 scoring of a query batch over
// a block's doc-major layout, for Hopper.
//
// impact_bm25_scores_launch writes the dense [b, n_pad] scores. It replaces
// the tile step of the XLA programs _impact_topk_program and
// _impact_fused_topk_program (databend_tpu/index/inverted/device.py:384-428
// and :431-488, the `step` bodies at :409 and :457): there a
// [tile, L, b, m] equality tensor of doc slots against query terms is built
// and reduced twice, which XLA fuses and eager PyTorch would materialise. No
// Pallas kernel stands behind it. Same function:
//   term_ids [n_pad, L] int32 (pad docs and pad slots -2), sat [n_pad, L] f32
//   (no NaN), qpack [b, m] entries {term (pad -1, pads after a query's real
//   terms), idf, group (pad -1), vocabulary row (below)}, need [b] f32,
//   optionally dist [b, n_pad] f32 with w_s, w_d
//   -> out [b, n_pad] f32,
//   score(q, d) = sum over j = 0..m-1, in that order, of
//                 idf[q, j] * sat[d, s]  for the slot s with
//                 term_ids[d, s] == term[q, j]  (at most one: the layout
//                 writes each posting of a doc into one slot),
//   out[q, d]   = score, or w_s * score + w_d * dist[q, d] when dist is given,
//                 if the number of matched groups >= need[q], else -inf.
//   The terms of a group are adjacent along j, so the matched groups are the
//   runs of equal group ids with at least one matching term: no bit mask,
//   and no limit on the number of groups.
// Products and sums are single f32 operations (no fused multiply-add), in
// term order, as in the plain PyTorch version: the kernel's output is
// bit-equal to it, and docs with equal terms and saturations get equal
// scores (the tie rule of the top-k after this kernel needs that). Tensor
// cores are out: a TF32 or bf16 product changes the bits.
//
// impact_bm25_topk_launch computes the same scores and, in the same pass, the
// k largest per query: the whole of those two programs, their final
// jax.lax.top_k(dense, k) (device.py:424, :486) included. Output vals [b, k]
// f32 and ids [b, k] int64, in lax.top_k's order: by the total order of f32
// descending (-0.0 below +0.0), equal scores by ascending doc. The [b, n_pad]
// score block never exists.
//
// Bound of impact_bm25_scores. Its bytes are one read of term_ids, of the
// saturations the query terms ask for (and of dist when fused) and one
// write of the [b, n_pad] block; its operations one f32 product and one sum
// per (query, doc, real query term). Bytes bind at every shape of the path:
// at n_pad = 262,144, L = 8, b = 128, m = 4 the write does (146 MB, 0.044
// ms at 3.35 TB/s); at b = 8 the read and the write (19 MB, 0.0056 ms); at
// L = 512, b = 8 the read of the ids (0.55 GB, 0.16 ms).
// The first version compared every query term with all L slots of its doc:
// L compare-selects (two instructions each of the half-rate integer pipe)
// and the per-term bookkeeping for every (query, doc, term), about 100 M
// warp instructions at b = 128, which held it at 0.20 ms, a fifth of its
// bound (PERF.md).
//
// Design of impact_bm25_scores (scores_kernel): look each doc slot up once
// in the vocabulary of the query batch, in place of L compare-selects per
// query term, and spend the rest on the scores alone.
//  * Units. The queries run in units of `gq` queries and chunks of `mc`
//    terms, gq * mc <= UNIT_ENTRIES entries: the whole batch in one unit up
//    to b * m = 512 (b = 128, m = 4). The rule is a function of (b, m)
//    alone (ops/impact_bm25.py:query_units), so the host can pack for it. A
//    query carries its score across its chunks in registers (chunks > 1
//    only where gq <= 8, for queries of hundreds of fuzzy terms).
//  * The vocabulary. The host sorts the distinct real terms of each (unit,
//    chunk) and writes each entry's row in that vocabulary into the fourth
//    word of qpack (pack_query_terms checks it); a block scatters the
//    vocabulary into shared memory from the entries themselves and stages
//    the entries as {byte offset of the term's table row, bit 0 set where
//    the term opens a new group; idf}, each query's count of real terms and
//    its need.
//  * The table. Per strip of docs, once for all the unit's queries, the
//    block reads the strip's rows with 16-byte loads, contiguous across the
//    block (the first of them read ahead while the previous strip is
//    scored), looks the four slots up with four binary searches in
//    lockstep, and writes each found slot's saturation into a shared table
//    [vocabulary row, doc]; every other cell holds NaN, and a staged pad
//    points at a row of NaN with idf +0.0, which leaves score and groups
//    as they are. The saturations are read only for the 16 bytes of slots
//    that hold a hit. The shared memory holds UNIT_ENTRIES + 1 rows of one
//    32-doc sub-strip (80 KB with the entries: two blocks of 16 warps an
//    SM); a unit whose vocabulary is smaller widens the strip to as many
//    sub-strips as its rows fit (up to MAX_SUBS): b = 128 queries over a
//    vocabulary of tens of words take 256 docs a strip.
//  * Per (query, sub-strip) item a quarter-warp, four docs a lane: one
//    staged entry and one 16-byte load of the lane's four cells per term
//    (a row is 16-byte aligned; a quarter-warp reads 128 contiguous bytes,
//    no bank conflict), then four products, sums and group updates; a
//    query whose groups are all single terms counts a hit as a matched
//    group. "Some slot matched" is `x == x`. A lane writes 16 bytes a query
//    with streaming stores (the block is read once, by the selection) and
//    reads the fused mode's distances likewise.
//  * Persistent blocks, two an SM, walk the strips; the staging is done
//    once a block (each chunk's again per strip when there are several).
//    When the strips alone do not fill the card, gridDim.z splits a unit's
//    items too.
// It reaches 62% of its bound at the shape above (PERF.md): the
// instructions per (query, doc) and the latency of the table's loads hold
// the rest.
//
// impact_bm25_topk, a first right version of a selecting kernel:
//  * Scoring (score_doc). For L = 8, 16, 32 a lane keeps its doc's term ids
//    and saturations in registers (16-byte loads) and compares each query
//    term with every slot (compare + select pairs). For longer rows the block
//    copies 32 rows into shared memory, transposed and padded to 33 words a
//    slot so that neither the copy nor the lanes' reads collide on a bank:
//    264 bytes a slot, 135 KB at L = 512. There the slot loop reads term ids
//    only and the one matching saturation after it, and stops at the last
//    slot that holds a real term in any doc of the 32. The packed entries
//    are read through the read-only cache, every lane of a warp the same
//    address. Its bytes are one read of term_ids and sat (and of dist when
//    fused) and the [b, k] result: 17 MB, 0.005 ms, at the shape above;
//    fused, 151 MB. Its operations are 0.8 G compare-selects, 0.012 ms:
//    operations bind the text call, bytes the fused one. It reaches 3% of
//    that bound (PERF.md): the scoring's bookkeeping and the selection hold
//    it.
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
// Each kernel variant is opted in to the shared memory it may need once a
// device (allow_smem). Times and their bounds: chip_smoke.py and
// scripts/impact_scores_ab.py print them, PERF.md keeps them.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int DOCS = 32;      // docs of a strip, one per lane
constexpr int ROW_PAD = 33;   // words per slot of the transposed rows
constexpr int MAX_L = 512;
constexpr int UNIT_ENTRIES = 512;      // (query, term) entries of a unit
constexpr int SW = 16;                 // warps of a scores block
constexpr int S_THREADS = SW * 32;
constexpr int S_BLOCKS = 2;            // scores blocks an SM holds
constexpr int MAX_SUBS = 8;            // 32-doc sub-strips of a strip
constexpr int SCORES_SMEM = 112 * 1024;   // a block's budget: two an SM
constexpr int QUAD = 4;                // items a warp scores at once
constexpr int TPAD = 4;                // a table row: 32 * subs + TPAD words
constexpr int MAX_DEVICES = 64;
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

// ---------------------------------------------------------------- scores
// Shared memory of scores_kernel for a unit of gq queries and mc terms a
// chunk over strips of `subs` sub-strips: the table (gq * mc + 1 rows of
// 32 * subs + TPAD words, 16-byte aligned), the staged entries (int2
// each), the vocabulary (an int each), and per query its need (a float),
// its real terms in the chunk and whether a group has several (an int
// each).
__host__ __device__ constexpr size_t scores_table_bytes(int cap, int subs) {
  return static_cast<size_t>(cap + 1) * (DOCS * subs + TPAD) * sizeof(float);
}

__host__ __device__ constexpr size_t scores_smem(int gq, int mc, int subs) {
  return scores_table_bytes(gq * mc, subs) +
         static_cast<size_t>(gq) * mc * (sizeof(int2) + sizeof(int)) +
         static_cast<size_t>(gq) * (sizeof(float) + 2 * sizeof(int));
}

// Writes the saturations of one 16-byte group of doc slots (of local doc
// `doc`) into the rows of their terms: four binary searches in lockstep
// over the sorted vocabulary voc[0 .. nv), nv >= 1.
__device__ __forceinline__ void fill_group(float* tab, int ts, const int* voc,
                                           int nv, int doc, int4 a,
                                           const float4* sp,
                                           const float4* pre) {
  const int t[4] = {a.x, a.y, a.z, a.w};
  int lo[4] = {0, 0, 0, 0};
  for (int n = nv; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int s = 0; s < 4; ++s)
      lo[s] = voc[lo[s] + half] <= t[s] ? lo[s] + half : lo[s];
    n -= half;
  }
  bool any = false;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    lo[s] = voc[lo[s]] == t[s] ? lo[s] : -1;   // pad slots (-2) miss
    any |= lo[s] >= 0;
  }
  if (!any) return;
  const float4 f = pre != nullptr ? *pre : __ldg(sp);
  float* col = tab + doc;
  if (lo[0] >= 0) col[lo[0] * ts] = f.x;
  if (lo[1] >= 0) col[lo[1] * ts] = f.y;
  if (lo[2] >= 0) col[lo[2] * ts] = f.z;
  if (lo[3] >= 0) col[lo[3] * ts] = f.w;
}

// Block (x, y, z) walks the strips x, x + gridDim.x, .. for unit y (queries
// y * gq ..). The unit's (query, sub-strip) items go four to a warp, a
// quarter-warp an item and four docs a lane; the block takes the quads
// z * SW + warp, stepping by gridDim.z * SW. See the top of the file.
__global__ void __launch_bounds__(S_THREADS, S_BLOCKS)
scores_kernel(const int* __restrict__ term_ids, const float* __restrict__ sat,
              const int4* __restrict__ qpack, const float* __restrict__ need,
              const float* __restrict__ dist, float w_s, float w_d,
              float* __restrict__ out, int n_pad, int L, int b, int m, int gq,
              int mc, int subs0, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nv[2];     // a stage's vocabulary size, by its parity
  const int cap = gq * mc;
  // the table's words: (cap + 1) rows of the plan's strips; a vocabulary
  // of nv rows takes strips as wide as nv + 1 rows fit, one chunk given
  const int words = (cap + 1) * (DOCS * subs0 + TPAD);
  float* tab = reinterpret_cast<float*>(smem);
  int2* ent = reinterpret_cast<int2*>(smem + scores_table_bytes(cap, subs0));
  int* voc = reinterpret_cast<int*>(ent + cap);
  float* s_need = reinterpret_cast<float*>(voc + cap);
  int* s_cnt = reinterpret_cast<int*>(s_need + gq);
  int* s_multi = s_cnt + gq;    // a query has a group of several terms
  const int4* ids4 = reinterpret_cast<const int4*>(term_ids);
  const float4* sat4 = reinterpret_cast<const float4*>(sat);
  const float nan = __int_as_float(0x7fc00000);
  const float ninf = __int_as_float(0xff800000);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quarter = lane >> 3;          // the lane's item of the quad
  const int col = (lane & 7) * 4;         // its first doc in the sub-strip
  const int q0 = blockIdx.y * gq;
  const int nq = b - q0 < gq ? b - q0 : gq;
  const int chunks = (m + mc - 1) / mc;
  const int qstep = gridDim.z * SW;

  for (int i = threadIdx.x; i < words; i += S_THREADS) tab[i] = nan;
  for (int i = threadIdx.x; i < nq; i += S_THREADS) {
    s_need[i] = __ldg(need + q0 + i);
    s_multi[i] = 0;
  }
  if (threadIdx.x < 2) s_nv[threadIdx.x] = 0;
  __syncthreads();

  int stages = 0;
  int nv = 0;
  int subs = subs0, ts = DOCS * subs0 + TPAD, sdocs = DOCS * subs0;  // subs0: a power of two
  // Stage the unit's entries of chunk c, its vocabulary and each query's
  // real terms in the chunk; then the layout: nv rows of ts words, row nv
  // the NaN row of pads (and of entries outside the contract).
  auto stage = [&](int j0, int nj) {
    int mine = 0;
    for (int i = threadIdx.x; i < nq * mc; i += S_THREADS) {
      const int ql = i / mc;
      const int jj = i - ql * mc;
      int2 st = make_int2(cap << 1, 0);     // a pad: adds +0.0
      const int4* at = qpack + (static_cast<size_t>(q0) + ql) * m + j0 + jj;
      const bool real = jj < nj && __ldg(&at->x) >= 0;
      if (real) {
        const int4 e = __ldg(at);
        int v = e.w;
        if (v >= 0 && v < cap) {
          voc[v] = e.x;         // entries of one row agree (the host checks)
          mine = v + 1 > mine ? v + 1 : mine;
        } else {
          v = cap;
        }
        const bool opens =
            j0 + jj == 0 ||
            __ldg(reinterpret_cast<const int*>(at - 1) + 2) != e.z;
        st = make_int2(v << 1 | (opens ? 1 : 0), e.y);
        if (!opens) s_multi[ql] = 1;
      }
      // pads trail the real terms: the last real one (or a first pad)
      // gives the count
      const bool next = jj + 1 < nj && __ldg(&at[1].x) >= 0;
      if (real ? !next : jj == 0) s_cnt[ql] = real ? jj + 1 : 0;
      ent[i] = st;
    }
    mine = __reduce_max_sync(FULL, mine);
    if (lane == 0) atomicMax(&s_nv[stages & 1], mine);
    __syncthreads();
    nv = s_nv[stages & 1];
    if (threadIdx.x == 0) s_nv[(stages + 1) & 1] = 0;
    ++stages;
    if (chunks == 1) {         // the widest power of two that fits
      const int fit = (words / (nv + 1) - TPAD) / DOCS;
      while (subs < MAX_SUBS && 2 * subs <= fit) subs *= 2;
      ts = DOCS * subs + TPAD;
      sdocs = DOCS * subs;
    }
    // the entries' byte offsets of their rows, bit 0 the new-group flag;
    // read after the next barrier
    for (int i = threadIdx.x; i < nq * mc; i += S_THREADS) {
      const int v = ent[i].x >> 1;
      ent[i].x = (v == cap ? nv : v) * ts * static_cast<int>(sizeof(float)) |
                 (ent[i].x & 1);
    }
  };

  // A strip's first S_THREADS 16-byte groups of slots, read ahead.
  int4 pid;
  float4 psat;
  auto prefetch = [&](int strip) {
    const int strips = (n_pad + sdocs - 1) / sdocs;
    long long n4 = 0;
    if (strip < strips) {
      const long long left = n_pad - static_cast<long long>(strip) * sdocs;
      n4 = (left < sdocs ? left : sdocs) * L / 4;
    }
    const long long g0 = static_cast<long long>(strip) * sdocs * L / 4;
    const bool in = threadIdx.x < n4;
    pid = in ? __ldg(ids4 + g0 + threadIdx.x) : make_int4(-2, -2, -2, -2);
    psat = in ? __ldg(sat4 + g0 + threadIdx.x)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  if (chunks == 1) stage(0, m);
  const int strips = (n_pad + sdocs - 1) / sdocs;
  const int items = nq * subs;
  const int quads = (items + QUAD - 1) / QUAD;
  const int sshift = __ffs(subs) - 1;     // item = query * subs + sub
  // a lane's four docs of its item, carried across chunks (then a warp
  // has one quad)
  float sc[4];
  int gr[4], rh[4];
  prefetch(blockIdx.x);
  for (int strip = blockIdx.x; strip < strips; strip += gridDim.x) {
    const long long doc0 = static_cast<long long>(strip) * sdocs;
    const int ndocs = n_pad - doc0 < sdocs ? static_cast<int>(n_pad - doc0)
                                           : sdocs;
    const int n4 = ndocs * L / 4;         // L % 8 == 0
    for (int c = 0; c < chunks; ++c) {
      if (chunks > 1) stage(c * mc, m - c * mc < mc ? m - c * mc : mc);
      // 1. The strip's doc slots, 16 bytes at a time, contiguous across the
      //    block: each real term of the vocabulary writes its slot's
      //    saturation into its row (the rows hold NaN here).
      if (nv > 0) {
        const long long g0 = doc0 * L / 4;
        const int per_doc = L / 4;
        if (static_cast<int>(threadIdx.x) < n4)
          fill_group(tab, ts, voc, nv, threadIdx.x / per_doc, pid, nullptr,
                     &psat);
#pragma unroll 4
        for (int i = threadIdx.x + S_THREADS; i < n4; i += S_THREADS)
          fill_group(tab, ts, voc, nv, i / per_doc, __ldg(ids4 + g0 + i),
                     sat4 + g0 + i, nullptr);
      }
      __syncthreads();
      // the next strip's first slots (this strip's again for the next
      // chunk), in flight while the warps score
      prefetch(c + 1 < chunks ? strip : strip + gridDim.x);
      // 2. Each warp scores its quads.
      const bool last = c == chunks - 1;
      for (int qd = blockIdx.z * SW + warp; qd < quads; qd += qstep) {
        const int item = qd * QUAD + quarter;
        const bool mine_item = item < items;
        const int it = mine_item ? item : items - 1;
        const int ql = it >> sshift;
        const int sub = it & (subs - 1);
        const long long d = doc0 + sub * DOCS + col;
        // the fused mode's distances, in flight while the terms are scored
        float4 dv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (dist != nullptr && last && mine_item) {
          const float* dp = dist + (static_cast<size_t>(q0) + ql) * n_pad + d;
          if (vec && d + 3 < n_pad) {
            dv = __ldcs(reinterpret_cast<const float4*>(dp));
          } else {
            if (d < n_pad) dv.x = __ldcs(dp);
            if (d + 1 < n_pad) dv.y = __ldcs(dp + 1);
            if (d + 2 < n_pad) dv.z = __ldcs(dp + 2);
            if (d + 3 < n_pad) dv.w = __ldcs(dp + 3);
          }
        }
        if (c == 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            sc[k] = 0.f;
            gr[k] = 0;
            rh[k] = 0;
          }
        }
        const int cnt = s_cnt[ql];
        const int2* qe = ent + ql * mc;
        const char* cell =
            reinterpret_cast<const char*>(tab + sub * DOCS + col);
        // past its count an item reads its staged pads: the NaN row and
        // idf +0.0, which leave score and groups as they are
        const int n_terms = __reduce_max_sync(FULL, cnt);
        if (chunks == 1 && !__any_sync(FULL, s_multi[ql])) {
          // every group one term: a hit is a matched group
#pragma unroll 2
          for (int jj = 0; jj < n_terms; ++jj) {
            const int2 e = qe[jj];
            const float4 x =
                *reinterpret_cast<const float4*>(cell + (e.x & ~3));
            const float idf = __int_as_float(e.y);
            const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const bool hit = xv[k] == xv[k];
              sc[k] = __fadd_rn(sc[k], __fmul_rn(idf, hit ? xv[k] : 0.f));
              gr[k] += hit ? 1 : 0;
            }
          }
        } else {
#pragma unroll 2
          for (int jj = 0; jj < n_terms; ++jj) {
            const int2 e = qe[jj];
            const float4 x =
                *reinterpret_cast<const float4*>(cell + (e.x & ~3));
            const float idf = __int_as_float(e.y);
            const bool opens = e.x & 1;
            const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const bool hit = xv[k] == xv[k];
              if (opens) {
                gr[k] += rh[k];
                rh[k] = 0;
              }
              sc[k] = __fadd_rn(sc[k],
                                __fmul_rn(idf, hit ? xv[k] : 0.f));
              rh[k] |= hit ? 1 : 0;
            }
          }
        }
        if (!last || !mine_item) continue;
        const float nd = s_need[ql];
        const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float val = sc[k];
          if (dist != nullptr)
            val = __fadd_rn(__fmul_rn(w_s, sc[k]), __fmul_rn(w_d, dd[k]));
          // the mask last: the weights may be negative, -inf is never
          // multiplied
          o[k] = static_cast<float>(gr[k] + rh[k]) >= nd ? val : ninf;
        }
        float* op = out + (static_cast<size_t>(q0) + ql) * n_pad + d;
        if (vec && d + 3 < n_pad) {
          __stcs(reinterpret_cast<float4*>(op),
                 make_float4(o[0], o[1], o[2], o[3]));
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (d + k < n_pad) __stcs(op + k, o[k]);
        }
      }
      __syncthreads();
      // 3. NaN again in the rows of this vocabulary.
      for (int i = threadIdx.x; i < nv * ts; i += S_THREADS) tab[i] = nan;
      __syncthreads();
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

// Opts `kernel` in to `bytes` of dynamic shared memory on the current
// device, once a device (the attribute holds from then on); `done` is the
// kernel's own.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < MAX_DEVICES;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// A plan of scores_kernel (ops/impact_bm25.py:_scores_plan): units of gq
// queries, chunks of mc terms, strips of `subs` sub-strips, a unit's quads
// over qsplit blocks. A warp carries its quad across chunks, so chunks need
// gq * subs <= QUAD * SW and qsplit = 1.
bool scores_plan_ok(int b, int m, int gq, int mc, int subs, int qsplit) {
  if (gq < 1 || gq > b || mc < 1 || mc > m ||
      static_cast<long long>(gq) * mc > UNIT_ENTRIES || subs < 1 ||
      subs > MAX_SUBS || (subs & (subs - 1)) != 0 ||
      scores_smem(gq, mc, subs) > SCORES_SMEM)
    return false;
  const int quads = (gq * subs + QUAD - 1) / QUAD;
  if ((b + gq - 1) / gq > 65535 || qsplit < 1 ||
      qsplit > (quads + SW - 1) / SW)
    return false;
  return mc == m || (gq * subs <= QUAD * SW && qsplit == 1);
}

int launch_scores(const int* term_ids, const float* sat, const int4* qpack,
                  const float* need, const float* dist, float w_s, float w_d,
                  float* out, int n_pad, int L, int b, int m, int gq, int mc,
                  int subs, int qsplit, cudaStream_t stream) {
  static std::atomic<bool> done[MAX_DEVICES];
  cudaError_t err = allow_smem(scores_kernel, SCORES_SMEM, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: S_BLOCKS an SM over the units and query splits
  const int units = (b + gq - 1) / gq;
  const int strips = (n_pad + DOCS * subs - 1) / (DOCS * subs);
  long long gx = static_cast<long long>(S_BLOCKS) * sms / (units * qsplit);
  gx = gx < 1 ? 1 : gx > strips ? strips : gx;
  // 16-byte rows of out and dist
  const int vec = n_pad % 4 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0 &&
                  reinterpret_cast<size_t>(dist) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(gx), units, qsplit);
  scores_kernel<<<grid, S_THREADS, scores_smem(gq, mc, subs), stream>>>(
      term_ids, sat, qpack, need, dist, w_s, w_d, out, n_pad, L, b, m, gq, mc,
      subs, vec);
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

// Shared memory of topk_strip_kernel: buffers, thresholds, counts (rounded
// to 16 bytes), then long rows.
size_t topk_smem(int warps, int L, int LR, int R) {
  size_t bytes = static_cast<size_t>(warps) * QPW * (32 * R + 1) *
                     sizeof(u64) +
                 ((warps * QPW + 3) & ~3) * sizeof(int);
  if (LR == 0) bytes += static_cast<size_t>(2) * L * ROW_PAD * sizeof(int);
  return bytes;
}

template <int LR, int R>
int launch_topk(const Geometry& g, const int* term_ids, const float* sat,
                const int4* qpack, const float* need, const float* dist,
                float w_s, float w_d, u64* part, float* vals, long long* ids,
                int n_pad, int L, int b, int m, int k, cudaStream_t stream) {
  auto strip = topk_strip_kernel<LR, R>;
  static std::atomic<bool> done[MAX_DEVICES];
  cudaError_t err = allow_smem(strip, topk_smem(WARPS, MAX_L, LR, R), done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_bytes = topk_smem(g.warps, L, LR, R);
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
// as f32 bits, group id, vocabulary row}: the row of the term in the sorted
// distinct real terms of its unit and chunk (see the top of the file), -1
// on pad terms. (gq, mc, subs, qsplit) is the plan (queries a unit, terms a
// chunk, 32-doc sub-strips a strip, blocks a unit's items take), from
// ops/impact_bm25.py:_scores_plan, by whose units the rows were packed. `dist` may be NULL (then w_s and w_d are not
// read). The caller guarantees contiguous device buffers, term_ids, sat and
// qpack at addresses that are multiples of 16, L % 8 == 0 with
// 8 <= L <= 512, and b, m, n_pad >= 1.
int impact_bm25_scores_launch(const void* term_ids, const void* sat,
                              const void* qpack, const void* need,
                              const void* dist, float w_s, float w_d,
                              void* out, int n_pad, int L, int b, int m,
                              int gq, int mc, int subs, int qsplit,
                              void* stream) {
  if (!shape_ok(n_pad, L, b, m) ||
      !scores_plan_ok(b, m, gq, mc, subs, qsplit))
    return ERR_SHAPE;
  return launch_scores(
      static_cast<const int*>(term_ids), static_cast<const float*>(sat),
      static_cast<const int4*>(qpack), static_cast<const float*>(need),
      static_cast<const float*>(dist), w_s, w_d, static_cast<float*>(out),
      n_pad, L, b, m, gq, mc, subs, qsplit,
      static_cast<cudaStream_t>(stream));
}

// The most (query, term) entries a unit of impact_bm25_scores_launch holds.
int impact_bm25_scores_unit_entries() { return UNIT_ENTRIES; }

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
