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
// Bound of impact_bm25_topk, from the function's work, whatever design
// runs it (chip_smoke.impact_bound, the same count as the scores kernel's
// but for the output): its bytes are one read of term_ids, of the
// saturations the query terms ask for (and of dist when fused) and the
// [b, k] result; its operations one f32 product and one sum per (query,
// doc, real query term) and one key compare per (query, doc). At the
// serving shape the operations bind; fused, and at L = 512, the reads do.
// (The first design was counted by its own work, one compare-select per
// (real doc slot, real query term); chip_smoke.py prints that count
// beside.)
//
// Design of impact_bm25_topk (topk_kernel): the scores kernel's walk over
// the strips, its table and its per-item scoring (walk_strips, score_item;
// one copy of that code serves both entry points), and the selection where
// the scores are, in registers.
//  * Slots. A block's 64 quarter-warps each own at most one slot: a query
//    of the unit and a way, one of the `ways` residues of the sub-strips of
//    a strip that the slot scores (sub = way, way + ways, ..). A block takes
//    `group` of the unit's queries (group * ways <= 64); a unit's queries
//    take qsplit = ceil(gq / group) blocks, each building the strip's table
//    itself: the build is one lookup a slot, cheap beside scoring the
//    queries, and a slot's buffer must sit beside the table. Small batches
//    take more ways (b = 8: 8 ways; b = 1: 64), so that every quarter works.
//  * One ordering key. Each (query, doc) gets the u64 key
//    (ord(score) << 32) | (0xffffffff - doc), ord the order-preserving map of
//    f32 bits to u32. Keys are distinct, and the k largest keys are exactly
//    lax.top_k's answer, ties and the -inf fill included. Docs past n_pad get
//    key 0, below every real key.
//  * Selection. A lane builds its four docs' keys in registers once the
//    query's last chunk is scored and compares them with its slot's
//    threshold, held in a register (the quarter's lanes hold the same one);
//    one warp vote skips the rest when no lane of the warp passes. The keys
//    are distinct, so the compare is right in any doc order: the k-th key of
//    a subset is never above the k-th of the whole. A doc that ties the k-th
//    score and comes later has a smaller key and ends there; BM25 over short
//    texts ties by the thousand. A survivor is appended to the slot's
//    buffer of 32 * R keys in shared memory (R = 2, 4, 8 for k up to 32,
//    96, 128: at least k + 32) by a shared atomicAdd on the slot's count,
//    with no warp-wide step. Then the warp votes once: a buffer that could
//    not take another item's 32 keys is cut by the whole warp to its k
//    largest (cut<R>: a bitonic sort in registers), and the slot's threshold
//    rises to the k-th key. The slot also raises the query's threshold in
//    device memory (atomicMax) and reads it once an item: a block's k-th
//    key is never above the query's, so no key below any block's k-th is
//    among the k largest, and the slots stop taking survivors sooner.
//  * At the end of its strips a block cuts every slot, merges the slots of
//    each query (a warp a query: the first slot takes the others' keys
//    through offer<R>) and writes the query's top k (0 keys where it saw
//    fewer docs) to part [b, blocks, k]. Phase two (topk_merge_kernel), a
//    block per query, merges the `blocks` partial lists and unpacks the
//    sorted keys to (vals, ids).
//  * One block an SM, with up to 220 KB of shared memory: the scores
//    kernel's table and staging for the unit at the plan's strip width,
//    then the slots' buffers (at b = 128, m = 4 a block takes 64 queries,
//    qsplit 2). At two blocks an SM (64 registers a thread) the kernel
//    spills. The plan (units, group, strips, ways, blocks) is
//    ops/impact_bm25.py:_topk_plan, pure Python; topk_plan_ok checks it.
//  * k is at most MAX_K = 128 (the wrapper sends larger k to
//    impact_bm25_scores and the tie-rule top-k).
// At the serving shape it is 2.3x faster than the first design and 9.6x
// the pair it replaced, far from its bound (PERF.md): the survivors'
// appends and cuts, then the per-item work (scoring, keys, vote) at one
// block an SM, hold it.
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

constexpr int WARPS = 8;               // warps of a topk_merge_kernel block
constexpr int THREADS = WARPS * 32;
constexpr int DOCS = 32;               // docs of a sub-strip
constexpr int MAX_L = 512;
constexpr int UNIT_ENTRIES = 512;      // (query, term) entries of a unit
constexpr int SW = 16;                 // warps of a scores or topk block
constexpr int S_THREADS = SW * 32;
constexpr int S_BLOCKS = 2;            // scores blocks an SM holds
constexpr int MAX_SUBS = 8;            // sub-strips a strip widens to
constexpr int SCORES_SMEM = 112 * 1024;   // a block's budget: two an SM
constexpr int QUAD = 4;                // items a warp scores at once
constexpr int TPAD = 4;                // a table row: 32 * subs + TPAD words
constexpr int MAX_DEVICES = 64;
constexpr int MAX_K = 128;
constexpr int SLOTS = QUAD * SW;       // selection slots of a topk block
constexpr int TOPK_MAX_SUBS = 64;      // sub-strips of a topk plan's strip
constexpr int TOPK_SMEM = 220 * 1024;  // a topk block's budget: one an SM
constexpr unsigned FULL = 0xffffffffu;

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

// Shared memory of topk_kernel: the scores kernel's, rounded to 16 bytes,
// then `slots` buffers of 32 * r keys and a count each.
__host__ __device__ constexpr size_t topk_smem(int gq, int mc, int subs,
                                               int slots, int r) {
  return ((scores_smem(gq, mc, subs) + 15) & ~static_cast<size_t>(15)) +
         static_cast<size_t>(slots) * (32 * r * sizeof(u64) + sizeof(int));
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

// What walk_strips hands the work of a strip and chunk: the unit's staged
// entries (mc a query: {byte offset of the term's table row | new-group
// bit, idf}), each query's need, real terms in the chunk and whether a
// group has several terms; the table (rows of ts words, `subs` sub-strips
// of the strip); the strip's first doc; the chunk, and whether it is the
// queries' last.
struct Walk {
  const int2* ent;
  const float* need;
  const int* cnt;
  const int* multi;
  const float* tab;
  int ts, subs;
  long long doc0;
  int c, chunks;
  bool last;
};

// The walk over the strips shared by scores_kernel and topk_kernel. Block
// (x, y, z) walks the strips x, x + gridDim.x, .. for unit y (queries
// y * gq ..): per strip and chunk it fills the table from the strip's rows
// (FILL row loads in flight a thread), calls body(walk) with every thread
// of the block, and clears the table. The strip's width is fixed before
// the walk: a width the chunk loop could change kept the scores kernel's
// loop bounds out of uniform registers (PERF.md). See the top of the file.
template <int FILL, typename Body>
__device__ __forceinline__ void walk_strips(
    unsigned char* smem, const int* __restrict__ term_ids,
    const float* __restrict__ sat, const int4* __restrict__ qpack,
    const float* __restrict__ need, int n_pad, int L, int b, int m, int gq,
    int mc, int subs0, Body&& body) {
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
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * gq;
  const int nq = b - q0 < gq ? b - q0 : gq;
  const int chunks = (m + mc - 1) / mc;

  for (int i = threadIdx.x; i < words; i += S_THREADS) tab[i] = nan;
  for (int i = threadIdx.x; i < nq; i += S_THREADS) {
    s_need[i] = __ldg(need + q0 + i);
    s_multi[i] = 0;
  }
  if (threadIdx.x < 2) s_nv[threadIdx.x] = 0;
  __syncthreads();

  int stages = 0;
  // Stage the unit's entries of a chunk, its vocabulary and each query's
  // real terms in the chunk; returns the vocabulary's size nv. An entry
  // holds its row (cap: outside the contract) and the new-group flag
  // until place() turns the row into a byte offset.
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
    const int found = s_nv[stages & 1];
    if (threadIdx.x == 0) s_nv[(stages + 1) & 1] = 0;
    ++stages;
    return found;
  };
  // The layout: nv rows of ts words, row nv the NaN row of pads (and of
  // entries outside the contract); the entries' byte offsets of their rows,
  // bit 0 the new-group flag, read after the next barrier.
  auto place = [&](int nv, int ts) {
    for (int i = threadIdx.x; i < nq * mc; i += S_THREADS) {
      const int v = ent[i].x >> 1;
      ent[i].x = (v == cap ? nv : v) * ts * static_cast<int>(sizeof(float)) |
                 (ent[i].x & 1);
    }
  };
  // One chunk: its vocabulary staged once, strips as wide as its nv + 1
  // rows fit (the widest power of two, subs0 one); several: the plan's
  // strips, each chunk staged again per strip. The strip is fixed here,
  // before the walk.
  int nv = chunks == 1 ? stage(0, m) : 0;
  int subs = subs0;
  if (chunks == 1) {
    const int fit = (words / (nv + 1) - TPAD) / DOCS;
    while (subs < MAX_SUBS && 2 * subs <= fit) subs *= 2;
  }
  const int ts = DOCS * subs + TPAD, sdocs = DOCS * subs;
  if (chunks == 1) place(nv, ts);

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

  const int strips = (n_pad + sdocs - 1) / sdocs;
  prefetch(blockIdx.x);
  for (int strip = blockIdx.x; strip < strips; strip += gridDim.x) {
    const long long doc0 = static_cast<long long>(strip) * sdocs;
    const int ndocs = n_pad - doc0 < sdocs ? static_cast<int>(n_pad - doc0)
                                           : sdocs;
    const int n4 = ndocs * L / 4;         // L % 8 == 0
    for (int c = 0; c < chunks; ++c) {
      if (chunks > 1) {
        nv = stage(c * mc, m - c * mc < mc ? m - c * mc : mc);
        place(nv, ts);
      }
      // 1. The strip's doc slots, 16 bytes at a time, contiguous across the
      //    block: each real term of the vocabulary writes its slot's
      //    saturation into its row (the rows hold NaN here).
      if (nv > 0) {
        const long long g0 = doc0 * L / 4;
        const int per_doc = L / 4;
        if (static_cast<int>(threadIdx.x) < n4)
          fill_group(tab, ts, voc, nv, threadIdx.x / per_doc, pid, nullptr,
                     &psat);
#pragma unroll FILL
        for (int i = threadIdx.x + S_THREADS; i < n4; i += S_THREADS)
          fill_group(tab, ts, voc, nv, i / per_doc, __ldg(ids4 + g0 + i),
                     sat4 + g0 + i, nullptr);
      }
      __syncthreads();
      // the next strip's first slots (this strip's again for the next
      // chunk), in flight while the warps score
      prefetch(c + 1 < chunks ? strip : strip + gridDim.x);
      // 2. The work on the strip.
      body(Walk{ent, s_need, s_cnt, s_multi, tab, ts, subs, doc0, c, chunks,
                c == chunks - 1});
      __syncthreads();
      // 3. NaN again in the rows of this vocabulary.
      for (int i = threadIdx.x; i < nv * ts; i += S_THREADS) tab[i] = nan;
      __syncthreads();
    }
  }
}

// One item's terms of the current chunk: a quarter-warp, four docs a lane
// (the cells at `cell`), the query's staged entries at `qe`. Adds into the
// lane's score, matched groups and open-run hit per doc. Past its count an
// item reads its staged pads: the NaN row and idf +0.0, which leave score
// and groups as they are. `single`: every group of the warp's queries is
// one term, so a hit is a matched group (uniform across the warp).
__device__ __forceinline__ void score_item(const int2* qe, const char* cell,
                                           int n_terms, bool single,
                                           float (&sc)[4], int (&gr)[4],
                                           int (&rh)[4]) {
  if (single) {
#pragma unroll 2
    for (int jj = 0; jj < n_terms; ++jj) {
      const int2 e = qe[jj];
      const float4 x = *reinterpret_cast<const float4*>(cell + (e.x & ~3));
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
      const float4 x = *reinterpret_cast<const float4*>(cell + (e.x & ~3));
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
        sc[k] = __fadd_rn(sc[k], __fmul_rn(idf, hit ? xv[k] : 0.f));
        rh[k] |= hit ? 1 : 0;
      }
    }
  }
}

// The fused mode's distances of docs d .. d + 3 of row `dp` (streaming
// loads: the block is read once).
__device__ __forceinline__ float4 load_dist4(const float* dp, long long d,
                                             int n_pad, int vec) {
  float4 dv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && d + 3 < n_pad) {
    dv = __ldcs(reinterpret_cast<const float4*>(dp));
  } else {
    if (d < n_pad) dv.x = __ldcs(dp);
    if (d + 1 < n_pad) dv.y = __ldcs(dp + 1);
    if (d + 2 < n_pad) dv.z = __ldcs(dp + 2);
    if (d + 3 < n_pad) dv.w = __ldcs(dp + 3);
  }
  return dv;
}

// The ranked values of a lane's four docs: the score, or the fused
// combination, masked to -inf below `nd` matched groups (last: the weights
// may be negative, -inf is never multiplied).
__device__ __forceinline__ void ranked4(const float (&sc)[4],
                                        const int (&gr)[4],
                                        const int (&rh)[4], float nd,
                                        bool fused, float4 dv, float w_s,
                                        float w_d, float (&o)[4]) {
  const float ninf = __int_as_float(0xff800000);
  const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float val = sc[k];
    if (fused) val = __fadd_rn(__fmul_rn(w_s, sc[k]), __fmul_rn(w_d, dd[k]));
    o[k] = static_cast<float>(gr[k] + rh[k]) >= nd ? val : ninf;
  }
}

// Per strip the unit's (query, sub-strip) items go four to a warp, a
// quarter-warp an item and four docs a lane; the block takes the quads
// z * SW + warp, stepping by gridDim.z * SW. See the top of the file.
__global__ void __launch_bounds__(S_THREADS, S_BLOCKS)
scores_kernel(const int* __restrict__ term_ids, const float* __restrict__ sat,
              const int4* __restrict__ qpack, const float* __restrict__ need,
              const float* __restrict__ dist, float w_s, float w_d,
              float* __restrict__ out, int n_pad, int L, int b, int m, int gq,
              int mc, int subs0, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quarter = lane >> 3;          // the lane's item of the quad
  const int col = (lane & 7) * 4;         // its first doc in the sub-strip
  const int q0 = blockIdx.y * gq;
  const int nq = b - q0 < gq ? b - q0 : gq;
  const int qstep = gridDim.z * SW;
  // a lane's four docs of its item, carried across chunks (then a warp
  // has one quad)
  float sc[4];
  int gr[4], rh[4];
  walk_strips<4>(smem, term_ids, sat, qpack, need, n_pad, L, b, m, gq, mc,
                 subs0, [&](const Walk& w) {
    const int items = nq * w.subs;
    const int quads = (items + QUAD - 1) / QUAD;
    const int sshift = __ffs(w.subs) - 1;   // item = query * subs + sub
    for (int qd = blockIdx.z * SW + warp; qd < quads; qd += qstep) {
      const int item = qd * QUAD + quarter;
      const bool mine_item = item < items;
      const int it = mine_item ? item : items - 1;
      const int ql = it >> sshift;
      const int sub = it & (w.subs - 1);
      const long long d = w.doc0 + sub * DOCS + col;
      // the fused mode's distances, in flight while the terms are scored
      float4 dv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (dist != nullptr && w.last && mine_item)
        dv = load_dist4(dist + (static_cast<size_t>(q0) + ql) * n_pad + d, d,
                        n_pad, vec);
      if (w.c == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sc[k] = 0.f;
          gr[k] = 0;
          rh[k] = 0;
        }
      }
      score_item(w.ent + ql * mc,
                 reinterpret_cast<const char*>(w.tab + sub * DOCS + col),
                 __reduce_max_sync(FULL, w.cnt[ql]),
                 w.chunks == 1 && !__any_sync(FULL, w.multi[ql]), sc, gr, rh);
      if (!w.last || !mine_item) continue;
      float o[4];
      ranked4(sc, gr, rh, w.need[ql], dist != nullptr, dv, w_s, w_d, o);
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
  });
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

// Cut a buffer of `cnt` <= 32 * R distinct keys to its min(cnt, k)
// largest, sorted descending at buf[0 ..]; returns that count. Called by
// the whole warp.
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

// cut<R>, or the 32-key sort where the buffer holds no more (cnt is the
// same in every lane).
template <int R>
__device__ __forceinline__ int cut_fit(u64* buf, int cnt, int k, int lane) {
  return cnt <= 32 ? cut<1>(buf, cnt, k, lane) : cut<R>(buf, cnt, k, lane);
}

// After a warp's appends (s_nkeys: each slot's count of keys): the warp cuts
// each of its quarters' buffers that could not take another item's 32
// keys; the quarter's threshold rises to the k-th key (`thr` is the same
// in the quarter's lanes), and the query's threshold shared by all blocks
// (`shared_thr`, the quarter's own) to at least that. Called by the whole
// warp, seldom.
template <int R>
__device__ __forceinline__ void cut_full(u64* sel, int* s_nkeys, bool mine,
                                         u64& thr, u64* shared_thr, int k,
                                         int lane, int warp) {
  constexpr int CAP = 32 * R;
  const int quarter = lane >> 3;
  __syncwarp();
  const int cnt = mine ? s_nkeys[warp * QUAD + quarter] : 0;
  unsigned full = __ballot_sync(FULL, cnt > CAP - 32);
  while (full != 0) {
    const int qq = (__ffs(full) - 1) >> 3;
    full &= ~(0xffu << (qq * 8));
    const int s = warp * QUAD + qq;
    u64* qb = sel + static_cast<size_t>(s) * CAP;
    const int keep = cut<R>(qb, s_nkeys[s], k, lane);   // keep == k
    if (quarter == qq) {
      thr = qb[k - 1] > thr ? qb[k - 1] : thr;
      if ((lane & 7) == 0) atomicMax(shared_thr, thr);
    }
    if (lane == 0) s_nkeys[s] = keep;
    __syncwarp();
  }
}

// Block (x, y, z) walks the strips x, x + gridDim.x, .. for unit y and
// selects for the unit's queries z * group .. (group of them): quarter
// (warp, quarter) owns slot s = warp * QUAD + quarter < group * ways, its
// query z * group + s / ways and its way s % ways. FUSED: dist is read; the
// text kernel holds no registers for it. See the top of the file.
template <int R, bool FUSED>
__global__ void __launch_bounds__(S_THREADS, 1)
topk_kernel(const int* __restrict__ term_ids, const float* __restrict__ sat,
            const int4* __restrict__ qpack, const float* __restrict__ need,
            const float* __restrict__ dist, float w_s, float w_d,
            u64* __restrict__ part, u64* __restrict__ shared_thr, int n_pad,
            int L, int b, int m, int k, int gq, int mc, int subs0, int group,
            int ways, int vec) {
  constexpr int CAP = 32 * R;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int quarter = lane >> 3;
  const int col = (lane & 7) * 4;         // the lane's first doc of its item
  const int q0 = blockIdx.y * gq;
  const int nq = b - q0 < gq ? b - q0 : gq;
  const int slots = group * ways;
  const int g0 = blockIdx.z * group;      // the block's first query of the unit
  u64* sel = reinterpret_cast<u64*>(
      smem + ((scores_smem(gq, mc, subs0) + 15) & ~static_cast<size_t>(15)));
  int* s_nkeys = reinterpret_cast<int*>(sel + static_cast<size_t>(slots) * CAP);
  const int slot = warp * QUAD + quarter;
  const bool mine = slot < slots && g0 + slot / ways < nq;
  const int ql = mine ? g0 + slot / ways : 0;    // a real query in any case
  const int way = slot % ways;
  u64* buf = sel + static_cast<size_t>(mine ? slot : 0) * CAP;
  for (int i = threadIdx.x; i < slots; i += S_THREADS) s_nkeys[i] = 0;
  u64 thr = 0;                // every real key is above 0
  // the query's k-th key in some block's slot: no key below it is among
  // the query's k largest
  u64* q_thr = shared_thr + q0 + ql;
  float sc[4];
  int gr[4], rh[4];
  // one block an SM: more row loads in flight a thread (L = 512: the
  // fill holds the walk)
  walk_strips<8>(smem, term_ids, sat, qpack, need, n_pad, L, b, m, gq, mc,
                 subs0, [&](const Walk& w) {
    const int per = w.subs / ways;        // the slot's items in the strip
    const bool single = w.chunks == 1 && !__any_sync(FULL, w.multi[ql]);
    const int n_terms = __reduce_max_sync(FULL, w.cnt[ql]);
    for (int j = 0; j < per; ++j) {
      const int sub = way + j * ways;
      const long long d = w.doc0 + sub * DOCS + col;
      float4 dv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (FUSED && w.last && mine)
        dv = load_dist4(dist + (static_cast<size_t>(q0) + ql) * n_pad + d, d,
                        n_pad, vec);
      // what the other blocks found, in flight while the item is scored
      const u64 seen = w.last && mine ? __ldcg(q_thr) : 0ull;
      if (w.c == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sc[kk] = 0.f;
          gr[kk] = 0;
          rh[kk] = 0;
        }
      }
      score_item(w.ent + ql * mc,
                 reinterpret_cast<const char*>(w.tab + sub * DOCS + col),
                 n_terms, single, sc, gr, rh);
      if (!w.last) continue;    // uniform: carried to the next chunk
      float o[4];
      ranked4(sc, gr, rh, w.need[ql], FUSED, dv, w_s, w_d, o);
      const u64 g = __shfl_sync(FULL, seen, quarter * 8);
      thr = g > thr ? g : thr;
      // the docs this lane has: none past n_pad, none for a quarter
      // without a slot
      const long long left = n_pad - d;
      const int valid =
          !mine || left <= 0 ? 0 : left < 4 ? static_cast<int>(left) : 4;
      bool pass = false;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const u64 key = make_key(o[kk], d + kk);
        if (kk < valid && key > thr) {
          buf[atomicAdd(s_nkeys + slot, 1)] = key;
          pass = true;
        }
      }
      if (__any_sync(FULL, pass))
        cut_full<R>(sel, s_nkeys, mine, thr, q_thr, k, lane, warp);
    }
  });
  // every slot cut to its top k ...
  for (int qq = 0; qq < QUAD; ++qq) {
    const int s = warp * QUAD + qq;
    if (s >= slots) break;      // uniform across the warp
    const int keep = cut_fit<R>(sel + static_cast<size_t>(s) * CAP,
                                s_nkeys[s], k, lane);
    if (lane == 0) s_nkeys[s] = keep;
  }
  __syncthreads();
  // ... then a warp a query: its first slot takes the other ways' keys
  for (int g = warp; g < group && g0 + g < nq; g += SW) {
    u64* acc = sel + static_cast<size_t>(g) * ways * CAP;
    int n = s_nkeys[g * ways];
    u64 t = n == k ? acc[k - 1] : 0ull;
    for (int x = 1; x < ways; ++x) {
      const u64* src = sel + static_cast<size_t>(g * ways + x) * CAP;
      const int ns = s_nkeys[g * ways + x];
      for (int j = 0; j < ns; j += 32)
        offer<R>(j + lane < ns ? src[j + lane] : 0ull, acc, n, t, k, lane);
    }
    if (ways > 1) n = cut<R>(acc, n, k, lane);
    u64* out = part + (static_cast<size_t>(q0 + g0 + g) * gridDim.x +
                       blockIdx.x) * k;
    for (int j = lane; j < k; j += 32) out[j] = j < n ? acc[j] : 0ull;
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
  // k <= n_pad: the blocks held at least k real keys between them
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

// The sort width of a slot's buffer: 32 * r keys, at least k + 32.
int topk_r(int k) { return k <= 32 ? 2 : k <= 96 ? 4 : 8; }

// A plan of topk_kernel (ops/impact_bm25.py:_topk_plan): units of gq
// queries and chunks of mc terms, as the scores kernel's (the host packed
// the vocabulary by them); `group` queries a block, `ways` slots a query
// (group * ways <= SLOTS), strips of `subs` sub-strips (ways divides them;
// with more than one chunk a slot carries its one item across the chunks:
// ways == subs), `blocks` blocks walking the strips of each (unit, group).
bool topk_plan_ok(int n_pad, int b, int m, int k, int gq, int mc, int subs,
                  int group, int ways, int blocks) {
  if (gq < 1 || gq > b || mc < 1 || mc > m ||
      static_cast<long long>(gq) * mc > UNIT_ENTRIES || subs < 1 ||
      subs > TOPK_MAX_SUBS || (subs & (subs - 1)) != 0 || ways < 1 ||
      ways > subs || (ways & (ways - 1)) != 0 || group < 1 || group > gq ||
      group * ways > SLOTS || blocks < 1)
    return false;
  if (topk_smem(gq, mc, subs, group * ways, topk_r(k)) > TOPK_SMEM)
    return false;
  if ((b + gq - 1) / gq > 65535 || (gq + group - 1) / group > 65535)
    return false;
  const long long strips = (n_pad + DOCS * subs - 1) / (DOCS * subs);
  if (blocks > strips) return false;
  return mc == m || ways == subs;
}

template <int R, bool FUSED>
int launch_topk(const int* term_ids, const float* sat, const int4* qpack,
                const float* need, const float* dist, float w_s, float w_d,
                u64* part, float* vals, long long* ids, int n_pad, int L,
                int b, int m, int k, int gq, int mc, int subs, int group,
                int ways, int blocks, cudaStream_t stream) {
  auto kernel = topk_kernel<R, FUSED>;
  static std::atomic<bool> done[MAX_DEVICES];
  cudaError_t err = allow_smem(kernel, TOPK_SMEM, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (b + gq - 1) / gq;
  const int qsplit = (gq + group - 1) / group;
  // 16-byte rows of dist
  const int vec = n_pad % 4 == 0 && reinterpret_cast<size_t>(dist) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(blocks), units, qsplit);
  u64* shared_thr = part + static_cast<size_t>(b) * blocks * k;
  err = cudaMemsetAsync(shared_thr, 0, b * sizeof(u64), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, S_THREADS, topk_smem(gq, mc, subs, group * ways, R),
           stream>>>(term_ids, sat, qpack, need, dist, w_s, w_d, part,
                     shared_thr, n_pad, L, b, m, k, gq, mc, subs, group, ways,
                     vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<R><<<b, THREADS, 0, stream>>>(part, blocks, k, vals, ids);
  return static_cast<int>(cudaGetLastError());
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

// The shared memory of a topk block (gq queries and mc terms a unit, strips
// of `subs` sub-strips, `slots` slots, k of sort width r) and the budget
// of such blocks: ops/impact_bm25.py:_topk_smem and TOPK_SMEM must agree.
long long impact_bm25_topk_smem(int gq, int mc, int subs, int slots, int r) {
  return static_cast<long long>(topk_smem(gq, mc, subs, slots, r));
}
int impact_bm25_topk_budget() { return TOPK_SMEM; }

// The k largest ranked values per query (see the top of the file) into
// vals [b, k] f32 and ids [b, k] int64, through `part`, a scratch buffer of
// b * (blocks * k + 1) 8-byte words. (gq, mc, subs, group, ways, blocks) is the
// plan, from ops/impact_bm25.py:_topk_plan (gq and mc those the vocabulary
// rows were packed by). Operands and return codes as
// impact_bm25_scores_launch, and 1 <= k <= min(MAX_K, n_pad).
int impact_bm25_topk_launch(const void* term_ids, const void* sat,
                            const void* qpack, const void* need,
                            const void* dist, float w_s, float w_d,
                            void* part, void* vals, void* ids, int n_pad,
                            int L, int b, int m, int k, int gq, int mc,
                            int subs, int group, int ways, int blocks,
                            void* stream) {
  if (!shape_ok(n_pad, L, b, m) || k < 1 || k > MAX_K || k > n_pad ||
      !topk_plan_ok(n_pad, b, m, k, gq, mc, subs, group, ways, blocks))
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
  const bool fused = di != nullptr;
  auto launch = fused ? launch_topk<8, true> : launch_topk<8, false>;
  if (topk_r(k) == 2)
    launch = fused ? launch_topk<2, true> : launch_topk<2, false>;
  else if (topk_r(k) == 4)
    launch = fused ? launch_topk<4, true> : launch_topk<4, false>;
  return launch(ti, sa, qp, nd, di, w_s, w_d, pa, va, ix, n_pad, L, b, m, k,
                gq, mc, subs, group, ways, blocks, st);
}

const char* impact_bm25_scores_error_string(int err) {
  if (err == ERR_SHAPE) return "shape outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
