// flash_rerank: the flash route's exact re-rank in one launch, for Hopper.
//
// It replaces no TPU kernel: the JAX package writes this step
// (databend_tpu/ops/flash_topk.py, flash_topk after the Pallas scan) as XLA
// ops, and so did the port's plain composition (ops/flash_topk.py,
// _flash_rerank_plain). It was added because the card's trace of the
// approximate cell showed the step as the bound: 45 library items a query
// chunk (a gather, elementwise passes, a row sum, stable sorts) at 7.5% of
// the step's bound, 91% of the chunk's device time.
//
// Function, per query q of a chunk of b queries:
//   minima [tiles, b, lanes] f32 (flash_group_minima's output, read in
//   place), q [b, d] f32, x [rows, d] f32 (the real rows; rows past it are
//   read as its last one)
//   1. the `shortlist` smallest of the query's tiles * lanes group minima,
//      equal minima by lowest flat index t * lanes + lane, signed zeros in
//      the total order of f32 (-0.0 below +0.0): ops/topk.py's
//      topk_smallest_lowest_index;
//   2. the member rows of each shortlisted group, cand = t * tile + m * lanes
//      + lane for m < tile / lanes, at position p = s * (tile / lanes) + m
//      (s the group's rank in the shortlist);
//   3. each candidate's f32 distance from x[min(cand, rows - 1)]: sum
//      (x - q)^2 for l2, -sum x * q for ip; +inf where cand >= n_valid (such
//      a row is not read);
//   4. the k smallest (distance, position) pairs, equal distances by lowest
//      position -> vals [b, k] f32 and ids [b, k] int64 = min(cand, rows - 1).
// Both selections order u64 keys (ord(v) << 32) | index, ord the
// order-preserving map of f32 bits to u32 (csrc/exact_topk_select.cu's
// make_key, kept in this file because a build hashes its one source): keys
// are distinct, and the smallest `want` keys are exactly the plain
// version's answer, ties included. Each product and sum is f32 (an FMA a
// term), summed in another order than torch's: on whole-number rows every
// step is exact and the answer is the plain version's bit for bit.
//
// Bound. One chunk must read the query's group minima and every candidate
// row once: at b = 256, 20 groups of 128 rows of 128 f32, 256 * 2,560 rows
// of 512 bytes, 335 MB, 0.10 ms at 3.35 TB/s (portbench's rerank_bound).
// The rows are scattered over the corpus, 512 contiguous bytes each; the
// selections' work is small beside them. So the kernel is a gather bound by
// device memory, and its design keeps rows in flight and reads each once:
//  * A block of 8 warps a query (b blocks of 256 threads, two an SM: the
//    256 queries of a chunk are one wave on 132 SMs).
//  * The shortlist and the top k are block-wide radix selects over the keys
//    (select_smallest): one pass for the bits every key shares, then 8-bit
//    digits from the top, a 256-bin shared histogram a pass, until the
//    bucket that holds the want-th key lies whole in the answer; the keys
//    at or below it are compacted and ranked by counting. The minima are
//    read in place with cached loads; the distances sit in a scratch row
//    that the block wrote and reads back from L1 / L2.
//  * The distances: a warp takes ROWS candidate rows at a time, a lane 16
//    bytes of each (float4 loads that skip L1; scalar loads where d % 4 or
//    an address does not allow them), so that a warp has ROWS * 512 bytes
//    in flight at d = 128 and the SM about 64 KB. A row at or past n_valid
//    is not read. The query row is read through the read-only cache, the
//    lane sums are reduced by shuffles, and lane r writes row r's distance.
// It neither synchronises with the host nor writes a [b, candidates, d]
// block: the library composition it replaces wrote 335 MB a chunk and read
// and wrote it three more times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 8;               // warps of a block: one block a query
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 8;                // candidate rows a warp has in flight
constexpr int BLOCKS_A_SM = 2;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == 256, "a radix pass keeps one bin a thread");

enum Metric { L2 = 0, IP = 1 };

__device__ __forceinline__ u64 make_key(float v, unsigned i) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | i;
}

__device__ __forceinline__ float key_value(u64 key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

// A candidate row's bytes: read once, so they skip L1.
__device__ __forceinline__ float4 load_row4(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float load_row1(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <int METRIC>
__device__ __forceinline__ float term(float x, float q, float acc) {
  if (METRIC == IP) return fmaf(x, q, acc);
  const float diff = x - q;
  return fmaf(diff, diff, acc);
}

// A block's shared state for select_smallest.
struct Shared {
  u64 lo, hi;
  int hist[256];
  int wsum[WARPS];
  int digit, need, bucket, nsel;
};

// The `want` smallest of the n distinct keys key_at(0 .. n - 1), 1 <= want
// <= n, handed to emit(rank, key) in ascending order (rank 0 the smallest).
// A radix select: the keys' common top bits from their least and largest,
// then 8-bit digits from the highest bit where they differ, a histogram of
// the keys that share the prefix chosen so far a pass, the digit whose
// bucket holds the want-th key found by a prefix sum over the bins (one a
// thread), until that bucket lies whole in the answer. The keys whose top
// bits are at or below the prefix are then exactly the answer; they are
// compacted into tmp (`want` words of scratch) and ranked by counting.
// Called by every thread of the block; ends with a barrier.
template <class KeyAt, class Emit>
__device__ void select_smallest(Shared& s, const KeyAt& key_at, int n,
                                int want, u64* tmp, const Emit& emit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s.lo = ~0ull;
    s.hi = 0ull;
    s.nsel = 0;
  }
  __syncthreads();
  u64 lo = ~0ull, hi = 0ull;
  for (int i = tid; i < n; i += THREADS) {
    const u64 key = key_at(i);
    lo = key < lo ? key : lo;
    hi = key > hi ? key : hi;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 a = __shfl_xor_sync(FULL, lo, o);
    const u64 b = __shfl_xor_sync(FULL, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
  if (lane == 0) {
    atomicMin(&s.lo, lo);
    atomicMax(&s.hi, hi);
  }
  __syncthreads();
  const u64 differ = s.lo ^ s.hi;
  int top = differ ? 63 - __clzll(static_cast<long long>(differ)) : -1;
  u64 pmask = top == 63 ? 0ull : ~0ull << (top + 1);
  u64 prefix = s.lo & pmask;
  int need = want;       // keys still wanted from the bucket of `prefix`
  while (top >= 0) {
    const int width = top < 8 ? top + 1 : 8;
    const int shift = top + 1 - width;
    const unsigned dmask = (1u << width) - 1u;
    s.hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += THREADS) {
      const u64 key = key_at(i);
      if ((key & pmask) == prefix)
        atomicAdd(&s.hist[(key >> shift) & dmask], 1);
    }
    __syncthreads();
    // inc: the keys of the bucket whose digit is at most tid's
    const int h = s.hist[tid];
    int inc = h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane == 31) s.wsum[warp] = inc;
    __syncthreads();
    for (int w = 0; w < warp; ++w) inc += s.wsum[w];
    if (inc >= need && inc - h < need) {
      s.digit = tid;
      s.need = need - (inc - h);
      s.bucket = h;
    }
    __syncthreads();
    prefix |= static_cast<u64>(s.digit) << shift;
    pmask |= static_cast<u64>(dmask) << shift;
    need = s.need;
    top = shift - 1;
    if (s.bucket == need) break;        // the same in every thread
  }
  // the answer: every key whose top bits are at or below the prefix
  for (int i0 = 0; i0 < n; i0 += THREADS) {
    const int i = i0 + tid;
    u64 key = 0ull;
    bool in = false;
    if (i < n) {
      key = key_at(i);
      in = (key & pmask) <= prefix;
    }
    const unsigned m = __ballot_sync(FULL, in);
    if (m == 0u) continue;
    int at = 0;
    if (lane == 0) at = atomicAdd(&s.nsel, __popc(m));
    at = __shfl_sync(FULL, at, 0) + __popc(m & ((1u << lane) - 1u));
    if (in) tmp[at] = key;
  }
  __syncthreads();
  for (int j = tid; j < want; j += THREADS) {
    const u64 key = tmp[j];
    int rank = 0;
    for (int i = 0; i < want; ++i) rank += tmp[i] < key;
    emit(rank, key);
  }
  __syncthreads();
}

// The distances of a query's `cands` candidates into dist: warp w takes
// positions w * ROWS + i * WARPS * ROWS .. + ROWS - 1 (see the top of the
// file). bases[s]: the row of member 0 of the s-th shortlisted group.
template <int METRIC, bool VEC>
__device__ void distances(const float* x, const float* qrow, int d,
                          long long last_row, long long n_valid,
                          const long long* bases, int group, int lanes,
                          int cands, float* dist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float INF = __int_as_float(0x7f800000);
  for (int p0 = warp * ROWS; p0 < cands; p0 += WARPS * ROWS) {
    const float* src[ROWS];
    bool live[ROWS];
    int s = p0 / group, m = p0 - s * group;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool in = p0 + r < cands;
      const long long cand =
          in ? bases[s] + static_cast<long long>(m) * lanes : 0;
      live[r] = in && cand < n_valid;
      src[r] = x + (cand < last_row ? cand : last_row) * d;
      if (++m == group) {
        m = 0;
        ++s;
      }
    }
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
    if (VEC) {
      for (int c = lane * 4; c < d; c += 128) {
        const float4 qv = __ldg(reinterpret_cast<const float4*>(qrow + c));
        float4 v[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          v[r] = live[r] ? load_row4(src[r] + c)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          acc[r] = term<METRIC>(v[r].x, qv.x, acc[r]);
          acc[r] = term<METRIC>(v[r].y, qv.y, acc[r]);
          acc[r] = term<METRIC>(v[r].z, qv.z, acc[r]);
          acc[r] = term<METRIC>(v[r].w, qv.w, acc[r]);
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float qv = __ldg(qrow + c);
        float v[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          v[r] = live[r] ? load_row1(src[r] + c) : 0.0f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = term<METRIC>(v[r], qv, acc[r]);
      }
    }
    float mine = INF;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[r] += __shfl_xor_sync(FULL, acc[r], o);
      if (lane == r && live[r]) mine = METRIC == IP ? -acc[r] : acc[r];
    }
    if (lane < ROWS && p0 + lane < cands) dist[p0 + lane] = mine;
  }
}

// Block q re-ranks query q (see the top of the file). Scratch a query:
// bases [shortlist] int64, tmp [max(shortlist, k)] u64, dist [cands] f32.
template <int METRIC, bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_A_SM)
rerank_kernel(const float* __restrict__ minima, const float* __restrict__ qs,
              const float* __restrict__ x, int groups, int lanes, int tile,
              long long b_lanes, int d, long long last_row, long long n_valid,
              int shortlist, int k, long long* bases_all, u64* tmp_all,
              float* dist_all, float* __restrict__ vals,
              long long* __restrict__ ids) {
  __shared__ Shared s;
  const int q = blockIdx.x;
  const int group = tile / lanes;
  const int cands = shortlist * group;
  const int tmp_len = shortlist > k ? shortlist : k;
  long long* bases = bases_all + static_cast<size_t>(q) * shortlist;
  u64* tmp = tmp_all + static_cast<size_t>(q) * tmp_len;
  float* dist = dist_all + static_cast<size_t>(q) * cands;
  const float* mrow = minima + static_cast<size_t>(q) * lanes;

  // 1. the shortlist: group i = t * lanes + lane at mrow[t * b_lanes + lane]
  select_smallest(
      s,
      [&](int i) {
        const int t = i / lanes;
        return make_key(
            __ldg(mrow + static_cast<long long>(t) * b_lanes + (i - t * lanes)),
            static_cast<unsigned>(i));
      },
      groups, shortlist, tmp, [&](int rank, u64 key) {
        const unsigned g = static_cast<unsigned>(key);
        bases[rank] = static_cast<long long>(g / lanes) * tile + g % lanes;
      });
  // 2. the candidates' distances
  distances<METRIC, VEC>(x, qs + static_cast<size_t>(q) * d, d, last_row,
                         n_valid, bases, group, lanes, cands, dist);
  __syncthreads();
  // 3. the k smallest (distance, position)
  float* out_v = vals + static_cast<size_t>(q) * k;
  long long* out_i = ids + static_cast<size_t>(q) * k;
  select_smallest(
      s, [&](int p) { return make_key(dist[p], static_cast<unsigned>(p)); },
      cands, k, tmp, [&](int rank, u64 key) {
        const int p = static_cast<int>(static_cast<unsigned>(key));
        const int sl = p / group;
        const long long cand =
            bases[sl] + static_cast<long long>(p - sl * group) * lanes;
        out_v[rank] = key_value(key);
        out_i[rank] = cand < last_row ? cand : last_row;
      });
}

template <int METRIC, bool VEC>
cudaError_t launch(const float* minima, const float* q, const float* x,
                   int groups, int b, int lanes, int tile, int d,
                   long long last_row, long long n_valid, int shortlist, int k,
                   long long* bases, u64* tmp, float* dist, float* vals,
                   long long* ids, cudaStream_t stream) {
  rerank_kernel<METRIC, VEC><<<static_cast<unsigned>(b), THREADS, 0, stream>>>(
      minima, q, x, groups, lanes, tile, static_cast<long long>(b) * lanes, d,
      last_row, n_valid, shortlist, k, bases, tmp, dist, vals, ids);
  return cudaGetLastError();
}

constexpr int ERR_SHAPE = -1;

}  // namespace

extern "C" {

// 8-byte words of scratch a call needs (ops/flash_topk.py allocates them):
// per query the shortlist's rows, the selections' keys and the distances.
long long flash_rerank_scratch_words(int b, int shortlist, int k, int group) {
  const long long tmp_len = shortlist > k ? shortlist : k;
  const long long cands = static_cast<long long>(shortlist) * group;
  return static_cast<long long>(b) * (shortlist + tmp_len) +
         (static_cast<long long>(b) * cands + 1) / 2;
}

// Launches on `stream`; returns 0 when launched, a cudaError_t (> 0) or
// ERR_SHAPE. minima [tiles, b, lanes], q [b, d] and x [rows, d] f32
// contiguous; metric 0 = l2, 1 = ip; candidates at or past n_valid (<=
// tiles * tile) score +inf; vec: q and x may be read 16 bytes at a time (d %
// 4 == 0, both 16-byte aligned). scratch: scratch_words 8-byte words, at
// least flash_rerank_scratch_words; vals [b, k] f32 and ids [b, k] int64.
// 1 <= shortlist <= tiles * lanes < 2^31, 1 <= k <= shortlist * tile / lanes
// < 2^31, tile % lanes == 0.
int flash_rerank_launch(const void* minima, const void* q, const void* x,
                        void* scratch, long long scratch_words, void* vals,
                        void* ids, int tiles, int b, int lanes, int tile,
                        long long rows, int d, int metric, int shortlist,
                        int k, long long n_valid, int vec, void* stream) {
  if (tiles < 1 || b < 1 || lanes < 1 || tile < lanes || tile % lanes != 0 ||
      rows < 1 || d < 1 || (metric != L2 && metric != IP) || shortlist < 1 ||
      k < 1 || n_valid < 0)
    return ERR_SHAPE;
  const long long groups = static_cast<long long>(tiles) * lanes;
  const long long group = tile / lanes;
  const long long cands = shortlist * group;
  const long long n = static_cast<long long>(tiles) * tile;
  if (groups >= (1ll << 31) || shortlist > groups || cands >= (1ll << 31) ||
      k > cands || n_valid > n || scratch == nullptr ||
      scratch_words <
          flash_rerank_scratch_words(b, shortlist, k, static_cast<int>(group)))
    return ERR_SHAPE;
  if (vec && (d % 4 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return ERR_SHAPE;
  const long long tmp_len = shortlist > k ? shortlist : k;
  long long* bases = static_cast<long long*>(scratch);
  u64* tmp = reinterpret_cast<u64*>(bases + static_cast<long long>(b) * shortlist);
  float* dist = reinterpret_cast<float*>(tmp + b * tmp_len);
  const long long last_row = (rows < n ? rows : n) - 1;
  auto go = launch<L2, true>;
  if (metric == L2 && !vec) go = launch<L2, false>;
  else if (metric == IP) go = vec ? launch<IP, true> : launch<IP, false>;
  return static_cast<int>(
      go(static_cast<const float*>(minima), static_cast<const float*>(q),
         static_cast<const float*>(x), static_cast<int>(groups), b, lanes, tile,
         d, last_row, n_valid, shortlist, k, bases, tmp, dist,
         static_cast<float*>(vals), static_cast<long long*>(ids),
         static_cast<cudaStream_t>(stream)));
}

const char* flash_rerank_error_string(int err) {
  if (err == ERR_SHAPE) return "shape outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
