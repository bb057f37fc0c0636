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
// Design.
//  * One ordering key. Each (query, position) gets the u64 key
//    (ord(-d) << 32) | (0xffffffff - i), ord the order-preserving map of f32
//    bits to u32 (as csrc/impact_bm25_scores.cu:make_key). Keys are
//    distinct, and the k largest keys are exactly lax.top_k(-d, k)'s answer,
//    ties and the +inf cells included. No real key is 0, the empty key.
//  * Strips. Each query's N positions are cut into `ways` strips of `strip`
//    positions (ops/exact_topk.py:_plan: twice the warps the card holds, so
//    that b = 1 and b = 8 fill it too); a warp takes one (query, strip) and
//    walks it STEP positions an iteration, UNROLL 16-byte loads a lane in
//    flight (scalar loads on a row that is not 16-byte aligned, and on the
//    ragged end of a strip), and asks L2 for the lines PREFETCH iterations
//    ahead, which puts more bytes in flight than the loads' registers
//    hold.
//  * A coarse filter first. Most cells cannot pass, so the stream computes
//    no distance and no key: per cell only a coarse value monotone in the
//    distance (l2: (qq - 2 qx) + xx, before the clamp and the square root;
//    cosine and ip: the distance) against a bound derived from the
//    threshold (coarse_bound), and one warp vote an iteration. Only an
//    iteration where some cell may pass finishes its cells' distances from
//    the coarse values (the same roundings: bit-equal) and offers their
//    keys. (The first design formed every key, and stayed under half its
//    bound at l2.)
//  * Selection, as the selecting BM25 kernel does it: a threshold in a
//    register, the same in every lane. A passing key is appended to the
//    warp's buffer of 32 * R keys in shared memory (R = 2, 4, 8 for k up
//    to 32, 96, 128: at least k + 32) through a ballot; a ballot that would
//    not fit first cuts the buffer to its k largest (cut<R>: a bitonic sort
//    in registers) and raises the threshold to the k-th. The keys are
//    distinct, so the compare is right in any order of the cells: the k-th
//    key of a subset is never above the k-th of the whole.
//  * A threshold per query that the warps share: a warp that cuts raises
//    the query's threshold in device memory (atomicMax), and every warp
//    reads it once an iteration. No key below a warp's k-th is among the
//    query's k largest, so the query's warps stop taking keys sooner.
//  * Each warp writes its strip's top k (the empty key where it kept
//    fewer) to part [b, ways, k]; phase two (merge_kernel), a block per
//    query, merges the `ways` lists and writes vals and ids.
// Neither phase synchronises with the host or writes a second [b, N] block.
// At the serving shape it reaches 53% of its bound under l2 and 60% under
// cosine and ip (PERF.md); at k = 128 and at the HNSW build's k = 101 the
// cuts of the warps' buffers hold it (23%, 13%).

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 8;               // warps of a block, both kernels
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 2;              // 16-byte loads of qx a lane has in flight
constexpr int STEP = 32 * 4 * UNROLL;  // positions a warp reads an iteration
constexpr int PREFETCH = 4;            // iterations ahead qx is asked into L2
constexpr int MAX_K = 128;
constexpr unsigned FULL = 0xffffffffu;

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

// cut<R>, or the 32-key sort where the buffer holds no more (cnt is the
// same in every lane).
template <int R>
__device__ __forceinline__ int cut_fit(u64* buf, int cnt, int k, int lane) {
  return cnt <= 32 ? cut<1>(buf, cnt, k, lane) : cut<R>(buf, cnt, k, lane);
}

// Offer one key a lane (0: none) to a warp's buffer of 32 * R keys. `cnt`
// and `thr` are the same in every lane; 32 * R >= k + 32, so after a cut a
// whole ballot fits, and a cut always leaves k keys. A cut raises `shared`,
// the query's threshold in device memory, where it is given.
template <int R>
__device__ __forceinline__ void offer(u64 key, u64* buf, int& cnt, u64& thr,
                                      int k, int lane, u64* shared) {
  unsigned mask = __ballot_sync(FULL, key > thr);
  if (mask == 0) return;
  if (cnt + __popc(mask) > 32 * R) {
    cnt = cut<R>(buf, cnt, k, lane);
    thr = buf[k - 1] > thr ? buf[k - 1] : thr;
    if (shared != nullptr && lane == 0) atomicMax(shared, thr);
    mask = __ballot_sync(FULL, key > thr);
  }
  if (key > thr) buf[cnt + __popc(mask & ((1u << lane) - 1u))] = key;
  cnt += __popc(mask);
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
  const unsigned hi = static_cast<unsigned>(thr >> 32);
  const float d =
      -__uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
  if (METRIC != L2) return d;
  const float up = nextafterf(d, INF);
  return __fmul_ru(up, up);
}

// The coarse values of one lane's four positions i .. i + 3: `nin` of them
// in the strip, `nok` before n_valid. 16-byte loads where the row allows.
// Masked cells are +inf (they pass only while the threshold is +inf, and
// finish(+inf) is +inf); cells past the strip NaN (they never pass).
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

// Warp (blockIdx.x * WARPS + warp) takes strip s of query q: item
// q * ways + s. See the top of the file.
template <int R, int METRIC>
__global__ void __launch_bounds__(THREADS, R == 8 ? 3 : 4)
select_kernel(const float* __restrict__ qx, const float* __restrict__ qq,
              const float* __restrict__ xx, const unsigned char* __restrict__ keep,
              long long keep_ld, long long n, long long n_valid, int b, int k,
              long long strip, int ways, int vec, u64* __restrict__ part,
              u64* __restrict__ shared_thr) {
  constexpr int CAP = 32 * R;
  constexpr bool NORMS = METRIC == L2 || METRIC == L2_SQ;
  __shared__ u64 s_buf[WARPS][CAP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (item >= static_cast<long long>(b) * ways) return;   // the whole warp
  const int q = static_cast<int>(item / ways);
  const long long lo = (item % ways) * strip;
  const long long end = lo + strip < n ? lo + strip : n;
  const float* row = qx + static_cast<size_t>(q) * n;
  const unsigned char* krow =
      keep != nullptr ? keep + static_cast<size_t>(q) * keep_ld : nullptr;
  const float qqv = NORMS ? qq[q] : 0.0f;
  u64* buf = s_buf[warp];
  u64* q_thr = shared_thr + q;
  int cnt = 0;
  u64 thr = 0;                // every real key is above 0
  for (long long base = lo; base < end; base += STEP) {
    // a line of 32 cells a lane, PREFETCH iterations ahead: more bytes in
    // flight than the registers of the loads hold
    if (PREFETCH > 0 && lane < STEP / 32) {
      const long long p = base + PREFETCH * STEP + lane * 32;
      if (p < end) asm volatile("prefetch.global.L2 [%0];" ::"l"(row + p));
    }
    // what the query's other warps found, in flight with the loads
    const u64 seen = __ldcg(q_thr);
    float c[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (u * 32 + lane) * 4;
      const long long in = end - i, ok = n_valid - i;
      coarse4<METRIC>(row, xx, krow, qqv, i,
                      in <= 0 ? 0 : in >= 4 ? 4 : static_cast<int>(in),
                      ok <= 0 ? 0 : ok >= 4 ? 4 : static_cast<int>(ok),
                      vec != 0, c[u]);
    }
    thr = seen > thr ? seen : thr;
    const float bound = coarse_bound<METRIC>(thr);
    bool maybe = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) maybe |= c[u][e] <= bound;
    if (!__any_sync(FULL, maybe)) continue;
    // some cell may pass: offer every cell's exact key, 32 at a time (one
    // copy of the offer and its sort: the cell is picked by selects)
#pragma unroll 1
    for (int j = 0; j < 4 * UNROLL; ++j) {
      float cj = 0.0f;
#pragma unroll
      for (int t = 0; t < 4 * UNROLL; ++t)
        if (t == j) cj = c[t >> 2][t & 3];
      const long long i = base + ((j >> 2) * 32 + lane) * 4 + (j & 3);
      offer<R>(cj == cj ? make_key(-finish<METRIC>(cj), i) : 0ull, buf, cnt,
               thr, k, lane, q_thr);
    }
  }
  cnt = cut_fit<R>(buf, cnt, k, lane);
  u64* out = part + static_cast<size_t>(item) * k;
  for (int j = lane; j < k; j += 32) out[j] = j < cnt ? buf[j] : 0ull;
}

// Phase two: block q merges query q's `ways` lists of k keys (8 warps
// offer them in turns, warp 0 takes the others' top k) and unpacks its k
// largest keys to (vals, ids).
template <int R>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const u64* __restrict__ part, int ways, int k,
             float* __restrict__ vals, long long* __restrict__ ids) {
  constexpr int CAP = 32 * R;
  __shared__ u64 s_buf[WARPS][CAP];
  __shared__ int s_cnt[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x;
  u64* buf = s_buf[warp];
  const u64* src = part + static_cast<size_t>(q) * ways * k;
  const long long total = static_cast<long long>(ways) * k;
  u64 thr = 0;
  int cnt = 0;
  for (long long at = static_cast<long long>(warp) * 32 + lane;
       at - lane < total; at += WARPS * 32)
    offer<R>(at < total ? __ldg(src + at) : 0ull, buf, cnt, thr, k, lane,
             nullptr);
  cnt = cut<R>(buf, cnt, k, lane);
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  if (warp != 0) return;
  if (cnt == k) thr = buf[k - 1];
  for (int w = 1; w < WARPS; ++w) {
    const int m = s_cnt[w];
    for (int j = 0; j < m; j += 32)
      offer<R>(j + lane < m ? s_buf[w][j + lane] : 0ull, buf, cnt, thr, k,
               lane, nullptr);
  }
  // k <= N: the strips held at least k real keys between them
  cut<R>(buf, cnt, k, lane);
  for (int j = lane; j < k; j += 32) {
    const size_t at = static_cast<size_t>(q) * k + j;
    const u64 key = buf[j];
    const unsigned hi = static_cast<unsigned>(key >> 32);
    // the key holds -d: negate back (exact, signed zeros included)
    vals[at] = -__uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
    ids[at] = static_cast<long long>(0xffffffffu - static_cast<unsigned>(key));
  }
}

// The sort width of a warp's buffer: 32 * r keys, at least k + 32.
int select_r(int k) { return k <= 32 ? 2 : k <= 96 ? 4 : 8; }

template <int R, int METRIC>
int launch(const float* qx, const float* qq, const float* xx,
           const unsigned char* keep, long long keep_ld, long long n,
           long long n_valid, int b, int k, long long strip, int ways, int vec,
           u64* part, float* vals, long long* ids, cudaStream_t stream) {
  u64* shared_thr = part + static_cast<size_t>(b) * ways * k;
  cudaError_t err = cudaMemsetAsync(shared_thr, 0, b * sizeof(u64), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(b) * ways;
  const unsigned blocks = static_cast<unsigned>((items + WARPS - 1) / WARPS);
  select_kernel<R, METRIC><<<blocks, THREADS, 0, stream>>>(
      qx, qq, xx, keep, keep_ld, n, n_valid, b, k, strip, ways, vec, part,
      shared_thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<R><<<b, THREADS, 0, stream>>>(part, ways, k, vals, ids);
  return static_cast<int>(cudaGetLastError());
}

template <int METRIC>
int launch_r(int k, const float* qx, const float* qq, const float* xx,
             const unsigned char* keep, long long keep_ld, long long n,
             long long n_valid, int b, long long strip, int ways, int vec,
             u64* part, float* vals, long long* ids, cudaStream_t stream) {
  auto go = launch<8, METRIC>;
  if (select_r(k) == 2) go = launch<2, METRIC>;
  else if (select_r(k) == 4) go = launch<4, METRIC>;
  return go(qx, qq, xx, keep, keep_ld, n, n_valid, b, k, strip, ways, vec,
            part, vals, ids, stream);
}

constexpr int ERR_SHAPE = -1;

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 when launched, a cudaError_t (> 0) or
// ERR_SHAPE. qx [b, N] f32 contiguous; qq [b] and xx [N] f32 (read for
// metric 0 = l2 and 1 = l2_sq; 2 = cosine, 3 = ip); keep NULL or a byte
// per cell with row stride keep_ld (0: one row for every query); columns
// at or past n_valid score +inf. (strip, ways) is the plan
// (ops/exact_topk.py:_plan); vec: qx rows, xx and keep may be read 16 (keep:
// 4) bytes at a time (N % 4 == 0 and aligned pointers). part: scratch of
// b * (ways * k + 1) 8-byte words; vals [b, k] f32 and ids [b, k] int64.
// 1 <= k <= min(MAX_K, N), N < 2^32.
int exact_topk_select_launch(const void* qx, const void* qq, const void* xx,
                             const void* keep, long long keep_ld, int metric,
                             long long n, long long n_valid, int b, int k,
                             long long strip, int ways, int vec, void* part,
                             void* vals, void* ids, void* stream) {
  const bool norms = metric == L2 || metric == L2_SQ;
  if (metric < L2 || metric > IP || n < 1 || n >= (1ll << 32) || b < 1 ||
      k < 1 || k > MAX_K || k > n || n_valid < 0 || n_valid > n ||
      strip < 1 || strip % STEP != 0 || ways < 1 ||
      (n + strip - 1) / strip != ways ||
      (static_cast<long long>(b) * ways + WARPS - 1) / WARPS > 0x7fffffffll ||
      (keep_ld != 0 && keep_ld != n) || (norms && (qq == nullptr ||
                                                   xx == nullptr)))
    return ERR_SHAPE;
  const float* q = static_cast<const float*>(qx);
  const float* a = static_cast<const float*>(qq);
  const float* x = static_cast<const float*>(xx);
  const unsigned char* kp = static_cast<const unsigned char*>(keep);
  u64* pa = static_cast<u64*>(part);
  float* va = static_cast<float*>(vals);
  long long* ix = static_cast<long long*>(ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = launch_r<IP>;
  if (metric == L2) go = launch_r<L2>;
  else if (metric == L2_SQ) go = launch_r<L2_SQ>;
  else if (metric == COSINE) go = launch_r<COSINE>;
  return go(k, q, a, x, kp, keep_ld, n, n_valid, b, strip, ways, vec, pa, va,
            ix, st);
}

// The largest k, and the positions a warp reads an iteration: the plan's
// strips are multiples of it (ops/exact_topk.py must agree).
int exact_topk_select_max_k() { return MAX_K; }
int exact_topk_select_step() { return STEP; }

const char* exact_topk_select_error_string(int err) {
  if (err == ERR_SHAPE) return "shape outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
