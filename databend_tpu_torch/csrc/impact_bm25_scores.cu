// impact_bm25_scores: dense doc-major BM25 scores of a query batch, for Hopper.
//
// Replaces the tile step of the XLA programs _impact_topk_program and
// _impact_fused_topk_program (databend_tpu/index/inverted/device.py, the
// `step` bodies): there a [tile, L, b, m] equality tensor of doc slots against
// query terms is built and reduced twice, which XLA fuses and eager PyTorch
// would materialise. No Pallas kernel stands behind it. Same function:
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
// Bound. At n_pad = 262,144, L = 8, b = 128, m = 4 the call moves 151 MB (one
// read of term_ids and sat, one write of the [b, n_pad] scores): 0.045 ms at
// 3.35 TB/s. One compare-select per (real doc slot, real query term), 0.8 G
// for docs of three terms and queries of two, takes 0.012 ms at 132 SMs x
// 64 int32 lanes x 1.98 GHz: bytes bind there, operations for long docs and
// wide queries (L = 64, m = 8). The kernel itself is held by neither: a
// compare-select is two instructions of the half-rate integer pipe, and the
// per-term and per-query bookkeeping costs as much again (PERF.md).
//
// Design (a simple one: making it fast is later work).
//  * A block owns a strip of 32 docs, one per lane, and all queries; its 8
//    warps take the queries in turns. A warp's 32 lanes write
//    out[q, d0 .. d0 + 31], 128 contiguous bytes. When the docs alone do not
//    fill the card, gridDim.y splits the queries too.
//  * The docs' rows. For L = 8, 16, 32 a lane keeps its doc's term ids and
//    saturations in registers (16-byte loads, every byte of a row used) and
//    the slot loop unrolls into compare + select pairs. For longer rows the
//    block copies its 32 rows into shared memory, transposed and padded to
//    33 words a slot so that neither the copy nor the lanes' reads collide
//    on a bank: 264 bytes a slot, 135 KB at L = 512. There the slot loop
//    reads term ids only and the one matching saturation after it.
//    L is the bucket of the block's longest doc and most docs are shorter,
//    so that loop stops at the last slot that holds a real term in any doc
//    of the strip (rounded up to the loop's step); for short rows the same
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
// Times and their bounds: chip_smoke.py prints them, PERF.md keeps them.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int DOCS = 32;      // docs of a strip, one per lane
constexpr int ROW_PAD = 33;   // words per slot of the transposed rows
constexpr int MAX_L = 512;
constexpr int FILL_BLOCKS = 4 * 132;   // blocks wanted before queries split

// LR > 0: rows of LR slots in registers. LR == 0: rows of L slots in shared
// memory as s_ids[slot * ROW_PAD + lane], s_sat likewise.
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
  const long long d = static_cast<long long>(blockIdx.x) * DOCS + lane;
  const bool live = d < n_pad;

  constexpr int NR = LR > 0 ? LR : 4;
  int ids[NR];
  float st[NR];
  // long rows: slots below `used` hold every real term of the strip's docs
  // and the slot loop stops there (rounded up to its unroll step)
  int used = 0;
  const int* s_ids = reinterpret_cast<const int*>(smem);
  const float* s_sat = reinterpret_cast<const float*>(smem) +
                       static_cast<size_t>(L) * ROW_PAD;
  if constexpr (LR > 0) {
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
      ids[4 * v + 0] = a.x; ids[4 * v + 1] = a.y;
      ids[4 * v + 2] = a.z; ids[4 * v + 3] = a.w;
      st[4 * v + 0] = f.x; st[4 * v + 1] = f.y;
      st[4 * v + 2] = f.z; st[4 * v + 3] = f.w;
    }
  } else {
    int* w_ids = reinterpret_cast<int*>(smem);
    float* w_sat = reinterpret_cast<float*>(smem) +
                   static_cast<size_t>(L) * ROW_PAD;
    const long long doc0 = static_cast<long long>(blockIdx.x) * DOCS;
    const long long base = doc0 * L;
    for (int i = threadIdx.x; i < DOCS * L; i += THREADS) {
      const int doc = i / L;
      const int slot = i - doc * L;
      const bool in = doc0 + doc < n_pad;
      const int id = in ? __ldg(term_ids + base + i) : -2;
      w_ids[slot * ROW_PAD + doc] = id;
      w_sat[slot * ROW_PAD + doc] = in ? __ldg(sat + base + i) : 0.f;
      if (id >= 0 && slot >= used) used = slot + 1;
    }
    __shared__ int s_used;
    if (threadIdx.x == 0) s_used = 0;
    __syncthreads();
    used = __reduce_max_sync(0xffffffffu, used);
    if (lane == 0) atomicMax(&s_used, used);
    __syncthreads();
    used = (s_used + 7) & ~7;
  }

  for (int q = blockIdx.y * WARPS + warp; q < b; q += gridDim.y * WARPS) {
    const int4* qp = qpack + static_cast<size_t>(q) * m;
    float score = 0.f;
    int groups = 0;
    int cur = INT_MIN;        // no group id: the first term opens a run
    bool run_hit = false;
#pragma unroll 2
    for (int j = 0; j < m; ++j) {
      const int4 e = __ldg(qp + j);       // {term, idf, group, unused}
      const int t = e.x;
      if (t < 0) break;       // pad terms trail the real ones
      float v = __int_as_float(0x7fc00000);   // NaN: no slot matched yet
      if constexpr (LR > 0) {
#pragma unroll
        for (int s = 0; s < LR; ++s) v = ids[s] == t ? st[s] : v;
      } else {
        int at = -1;          // the matching slot: ids only, then one sat
#pragma unroll 8
        for (int s = 0; s < used; ++s)
          at = s_ids[s * ROW_PAD + lane] == t ? s : at;
        if (at >= 0) v = s_sat[at * ROW_PAD + lane];
      }
      const bool hit = v == v;
      score = __fadd_rn(score, __fmul_rn(__int_as_float(e.y), hit ? v : 0.f));
      if (e.z != cur) {       // uniform across the warp
        groups += run_hit ? 1 : 0;
        run_hit = false;
        cur = e.z;
      }
      run_hit |= hit;
    }
    groups += run_hit ? 1 : 0;
    if (live) {
      const size_t at = static_cast<size_t>(q) * n_pad + d;
      float val = score;
      if (dist != nullptr)
        val = __fadd_rn(__fmul_rn(w_s, score), __fmul_rn(w_d, __ldg(dist + at)));
      // mask last: the weights may be negative, -inf is never multiplied
      out[at] = static_cast<float>(groups) >= __ldg(need + q)
                    ? val : __int_as_float(0xff800000);
    }
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

constexpr int ERR_SHAPE = -1;

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
  if (L % 8 != 0 || L < 8 || L > MAX_L || b < 1 || m < 1 || n_pad < 1)
    return ERR_SHAPE;
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

const char* impact_bm25_scores_error_string(int err) {
  if (err == ERR_SHAPE) return "shape outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
