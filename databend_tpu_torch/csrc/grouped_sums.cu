// grouped_sums: exact int32 sums of K value rows by group id, for Hopper.
//
// Replaces the grouping step of the XLA programs of the device scan-aggregate
// route (databend_tpu/pipeline/device_scan_agg.py, _build_program): the
// "mask" engine's G x K masked sums (`program`, `msum`) and the "matmul"
// engine's one-hot [tile, G] int8 product (`program_matmul`). No Pallas
// kernel stands behind either. Same function:
//   gid [n] int32 in [0, G], rows [K, n] int32  ->  out [K, G + 1] int32,
//   out[k, g] = sum of rows[k, i] over the rows i with gid[i] == g.
// Column G is the pad group the callers send filtered rows to, and drop. A
// row whose id lies outside [0, G] is ignored. The route keeps
// |rows| * n < 2^31, and integer addition is associative, so every order of
// the additions (atomics included) gives the same bits as the plain version.
//
// Bound. One read of gid and rows plus one write of out: at n = 6,000,000 and
// K = 20, 504 MB, 0.15 ms at 3.35 TB/s. One add per (row, value row) is
// 0.12 G int32 adds, far under the card's rate: bytes bind.
//
// Design (a simple one: making it fast is later work).
//  * Warps walk the rows 32 at a time (grid-stride), a lane a row: each value
//    row is read as 128 contiguous bytes a warp, four value rows in flight
//    per lane.
//  * The sums go to a block-private [K, G + 1] histogram in shared memory
//    when it fits in 48 KB (the mask engine: G <= 64), flushed to `out` with
//    one global atomic per non-zero cell; else straight to `out` with global
//    atomics (the matmul engine's large G).
//  * Contention. When all 32 rows of a warp lie in one group (G = 1, or
//    ids in runs), 32 atomics on one address would serialise: the warp adds
//    its values with one reduction (__reduce_add_sync) and one atomic from
//    lane 0, for every value row. With two ids or more each lane adds its
//    own value: a reduction per distinct id and value row costs more than
//    the lane atomics it saves at every mix of ids measured on an H100,
//    TPC-H Q1's among them (PERF.md).
//
// Times and their bounds: chip_smoke.py prints them, PERF.md keeps them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2048 / THREADS;   // the SM's thread limit
constexpr int SMEM_HIST_BYTES = 48 * 1024;      // no opt-in attribute needed
constexpr int ROWS_IN_FLIGHT = 4;               // value rows loaded at once
constexpr unsigned FULL = 0xffffffffu;

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
grouped_sums_kernel(const int* __restrict__ gid, const int* __restrict__ rows,
                    int* __restrict__ out, long long n, int K, int G1) {
  extern __shared__ int hist[];                 // [K, G1] when SMEM
  const int cells = K * G1;
  if (SMEM) {
    for (int c = threadIdx.x; c < cells; c += THREADS) hist[c] = 0;
    __syncthreads();
  }
  int* acc = SMEM ? hist : out;
  const int lane = threadIdx.x & 31;
  const long long first = (static_cast<long long>(blockIdx.x) * WARPS
                           + threadIdx.x / 32) * 32;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * 32;

  // `base` is the same for the warp's lanes: the *_sync calls see all 32
  for (long long base = first; base < n; base += stride) {
    const long long i = base + lane;
    const bool in = i < n;
    int g = in ? __ldg(gid + i) : -1;
    if (static_cast<unsigned>(g) >= static_cast<unsigned>(G1)) g = -1;
    int one_id;                 // every lane holds the same id
    __match_all_sync(FULL, g, &one_id);
    if (one_id && g < 0) continue;

    for (int k0 = 0; k0 < K; k0 += ROWS_IN_FLIGHT) {
      int v[ROWS_IN_FLIGHT];
#pragma unroll
      for (int j = 0; j < ROWS_IN_FLIGHT; ++j)
        v[j] = in && k0 + j < K
                   ? __ldg(rows + static_cast<long long>(k0 + j) * n + i)
                   : 0;
#pragma unroll
      for (int j = 0; j < ROWS_IN_FLIGHT; ++j) {
        if (k0 + j >= K) break;
        int* row_acc = acc + (k0 + j) * G1;
        if (one_id) {
          const int s = __reduce_add_sync(FULL, v[j]);
          if (lane == 0 && s != 0) atomicAdd(row_acc + g, s);
        } else if (g >= 0 && v[j] != 0) {
          atomicAdd(row_acc + g, v[j]);
        }
      }
    }
  }

  if (SMEM) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += THREADS) {
      const int s = hist[c];
      if (s != 0) atomicAdd(out + c, s);
    }
  }
}

constexpr int ERR_SHAPE = -1;

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 when launched, a cudaError_t (> 0) or
// ERR_SHAPE. The caller guarantees contiguous device buffers and `out`
// zeroed, with n >= 1, K >= 1, G1 = G + 1 >= 1 and K * G1 < 2^31.
int grouped_sums_launch(const void* gid, const void* rows, void* out,
                        long long n, int K, int G1, void* stream) {
  if (n < 1 || K < 1 || G1 < 1 ||
      static_cast<long long>(K) * G1 >= (1LL << 31))
    return ERR_SHAPE;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long hist_bytes = static_cast<long long>(K) * G1 * sizeof(int);
  const bool smem = hist_bytes <= SMEM_HIST_BYTES;
  const long long want = (n + THREADS - 1) / THREADS;
  const long long most = static_cast<long long>(sms) * BLOCKS_PER_SM;
  const int blocks = static_cast<int>(want < most ? want : most);
  const int* g = static_cast<const int*>(gid);
  const int* r = static_cast<const int*>(rows);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem)
    grouped_sums_kernel<true><<<blocks, THREADS, hist_bytes, st>>>(
        g, r, o, n, K, G1);
  else
    grouped_sums_kernel<false><<<blocks, THREADS, 0, st>>>(g, r, o, n, K, G1);
  return static_cast<int>(cudaGetLastError());
}

const char* grouped_sums_error_string(int err) {
  if (err == ERR_SHAPE) return "shape outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
