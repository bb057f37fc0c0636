// grouped_sums: exact int32 sums of K value rows by group id, for Hopper.
//
// Replaces the grouping step of the XLA programs of the device scan-aggregate
// route (databend_tpu/pipeline/device_scan_agg.py, _build_program): the
// "mask" engine's G x K masked sums (`program`, `msum`) and the "matmul"
// engine's one-hot [tile, G] int8 product (`program_matmul`). No Pallas
// kernel stands behind either. Same function:
//   gid [n] int32 in [0, G], K value rows [n] int32  ->  out [K, G + 1] int32,
//   out[k, g] = sum of row k at the rows i with gid[i] == g.
// Column G is the pad group the callers send filtered rows to, and drop. A
// row whose id lies outside [0, G] is ignored. The route keeps
// |rows| * n < 2^31, and integer addition is associative, so every order of
// the additions (atomics included) gives the same bits as the plain version.
//
// Bound. One read of gid and the rows plus one write of out: at
// n = 6,000,000 and K = 20, 504 MB, 0.15 ms at 3.35 TB/s. One add per
// (row, value row) is 0.12 G int32 adds, far under the card's rate: bytes
// bind, and the design keeps every add in shared memory so that they do.
//
// Design.
//  * The value rows come as up to MAX_ROWS pointers in a kernel parameter
//    (`__grid_constant__`, no copy to the card and no [K, n] block): the
//    caller's rows are read where they lie.
//  * The [K, G + 1] grid is cut into cells that live in shared memory. A
//    cluster of C blocks (C = 1: one block) holds R value rows of the grid;
//    each block of it owns a contiguous range of W = ceil((G + 1) / C)
//    columns of those rows, an [R, W] histogram in its shared memory (up to
//    227 KB, by opt-in). With S = ceil(K / R) slices of rows, the clusters
//    are dealt to the slices in turn: each cluster reads gid and its
//    slice's rows over its share of the n rows. The plan (C, S, threads,
//    blocks) is chosen by shape in Python (ops/grouped_sums.py, `_plan`);
//    this file executes it. On an H100 an add into another block's shared
//    memory costs about eight reads of a value (about 95 G adds/s over the
//    card, generic atomics and red.shared::cluster alike), so the plan keeps
//    C = 1 wherever one row fits a block, and pays a read of gid a slice
//    instead: clusters (C = 2) serve only grids whose row outgrows a block
//    (G + 1 > 58,112). The kernel takes clusters up to the portable 8.
//  * Past a cluster of two (G + 1 > 116,224, only under raised group caps)
//    the plan gives C = 0, the GLOBAL placement: no shared memory, every
//    add an atomic straight into `out` (the first design's form; on an
//    H100 clusters of 4 and 8 were slower there, by up to 65%, but at one
//    shape where they gained 2%). Every (K, G) of the contract thus has a
//    placement.
//  * Every block of a cluster walks its share of the rows, a warp 32 rows at
//    a time (a lane a row: each value row read as 128 contiguous bytes a
//    warp, the first ROWS_IN_FLIGHT rows loaded beside gid), and adds each
//    value into the owning block's histogram: a local shared atomic when
//    C = 1, else an atomic through cluster.map_shared_rank (distributed
//    shared memory). cluster.sync() after the zeroing (no add reaches a
//    histogram before it is zeroed, nor a block not yet running) and before
//    the flush (every add has landed; after it no block touches another's
//    shared memory, so a block may then flush and leave).
//  * Contention. When all 32 rows of a warp lie in one group (G = 1, or
//    ids in runs), 32 atomics on one address would serialise: the warp adds
//    its values with one reduction (__reduce_add_sync) and one atomic from
//    lane 0, for every value row. With two ids or more each lane adds its
//    own value: a reduction per distinct id costs more than the lane
//    atomics it saves at every mix of ids measured on an H100 (PERF.md).
//  * The flush: each block adds its non-zero cells into `out` (zeroed by the
//    caller) with one global atomic each; the copies of a cell are the
//    clusters of its slice.
//
// Times and their bounds: chip_smoke.py prints them, PERF.md keeps them.

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_ROWS = 64;                  // row pointers a launch takes
constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;                // the portable limit
constexpr int GLOBAL = 0;                     // C of the grid-in-out placement
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_BLOCK_MAX = 232448;        // 227 KB: a block's opt-in limit
constexpr int ROWS_IN_FLIGHT = 4;             // value rows loaded at once
constexpr unsigned FULL = 0xffffffffu;

struct RowPtrs {
  const int* p[MAX_ROWS];
};

// where a launch keeps the grid
enum Place { IN_OUT, ONE_BLOCK, CLUSTER };

template <int P>
__device__ __forceinline__ void sync_all() {
  if constexpr (P == CLUSTER) cg::this_cluster().sync();
  else if constexpr (P == ONE_BLOCK) __syncthreads();
}

// out[k, g] += rows[k][i] over gid[i] == g for this cluster's slice of rows;
// the histogram of each block is its [R, W] cells (see the file's note), or
// out itself under IN_OUT (one slice, R = K, W = G1).
template <int P>
__global__ void __launch_bounds__(MAX_THREADS, 2)
grouped_sums_kernel(const int* __restrict__ gid,
                    const __grid_constant__ RowPtrs rows,
                    int* __restrict__ out, long long n, int K, int G1, int R,
                    int W, int slices) {
  extern __shared__ int smem[];                 // [rows of the slice, W]
  int* const hist = P == IN_OUT ? out : smem;
  int C = 1, rank = 0;
  if constexpr (P == CLUSTER) {
    C = static_cast<int>(cg::this_cluster().num_blocks());
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const int cid = blockIdx.x / C;               // this block's cluster
  const int clusters = gridDim.x / C;
  const int slice = cid % slices;
  const int k0 = slice * R;
  const int kn = min(R, K - k0);
  const int cells = P == IN_OUT ? 0 : kn * W;   // no zeroing, no flush
  for (int c = threadIdx.x; c < cells; c += blockDim.x) hist[c] = 0;
  sync_all<P>();

  // this block's place among the blocks that read the slice's rows
  const long long member = static_cast<long long>(cid / slices) * C + rank;
  const long long members =
      static_cast<long long>((clusters - slice + slices - 1) / slices) * C;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long first = (member * warps + (threadIdx.x >> 5)) * 32;
  const long long stride = members * warps * 32;
  const int* const* ptr = rows.p + k0;

  // `base` is the same for the warp's lanes: the *_sync calls see all 32
  for (long long base = first; base < n; base += stride) {
    const long long i = base + lane;
    const bool in = i < n;
    int g = in ? __ldg(gid + i) : -1;
    int v[ROWS_IN_FLIGHT];                      // in flight beside gid
#pragma unroll
    for (int j = 0; j < ROWS_IN_FLIGHT; ++j)
      v[j] = in && j < kn ? __ldg(ptr[j] + i) : 0;
    if (static_cast<unsigned>(g) >= static_cast<unsigned>(G1)) g = -1;
    int one_id;                 // every lane holds the same id
    __match_all_sync(FULL, g, &one_id);
    if (one_id && g < 0) continue;

    int* dst = hist;            // the cell of (row 0 of the slice, g)
    if (g >= 0) {
      if constexpr (P == CLUSTER) {
        const int owner = g / W;
        dst = cg::this_cluster().map_shared_rank(hist, owner) +
              (g - owner * W);
      } else {
        dst = hist + g;
      }
    }
    for (int k = 0;;) {
#pragma unroll
      for (int j = 0; j < ROWS_IN_FLIGHT; ++j) {
        if (k + j >= kn) break;
        int* cell = dst + (k + j) * W;
        if (one_id) {
          const int s = __reduce_add_sync(FULL, v[j]);
          if (lane == 0 && s != 0) atomicAdd(cell, s);
        } else if (g >= 0 && v[j] != 0) {
          atomicAdd(cell, v[j]);
        }
      }
      k += ROWS_IN_FLIGHT;
      if (k >= kn) break;
#pragma unroll
      for (int j = 0; j < ROWS_IN_FLIGHT; ++j)
        v[j] = in && k + j < kn ? __ldg(ptr[k + j] + i) : 0;
    }
  }

  // every add of the cluster has landed; from here a block reads only its
  // own shared memory, so it may flush and leave without waiting
  sync_all<P>();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int s = hist[c];
    if (s == 0) continue;       // a cell past G + 1 never holds a sum
    const int r = c / W;
    atomicAdd(out + (k0 + r) * G1 + rank * W + (c - r * W), s);
  }
}

constexpr int ERR_SHAPE = -1;

// the per-slice rows R and the columns a block owns W, or ERR_SHAPE
int geometry(long long n, int K, int G1, int C, int slices, int threads,
             int blocks, int* R, int* W, int* smem) {
  if (n < 1 || K < 1 || K > MAX_ROWS || G1 < 1 ||
      static_cast<long long>(K) * G1 >= (1LL << 31) || C < GLOBAL ||
      C > MAX_CLUSTER || slices < 1 || slices > K || threads < 32 ||
      threads > MAX_THREADS || threads % 32 != 0 || blocks < 1 ||
      (C != GLOBAL && (blocks % C != 0 || blocks / C < slices)))
    return ERR_SHAPE;
  if (C == GLOBAL) {
    if (slices != 1) return ERR_SHAPE;
    *R = K;
    *W = G1;
    *smem = 0;
    return 0;
  }
  *R = (K + slices - 1) / slices;
  if ((K + *R - 1) / *R != slices) return ERR_SHAPE;   // a slice left empty
  *W = (G1 + C - 1) / C;
  const long long bytes = static_cast<long long>(*R) * *W * sizeof(int);
  if (bytes > SMEM_BLOCK_MAX) return ERR_SHAPE;
  *smem = static_cast<int>(bytes);
  return 0;
}

// Opts the kernel in to SMEM_BLOCK_MAX bytes of shared memory on the
// current device, once a device: the attribute holds from then on.
template <int P>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < MAX_DEVICES;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(grouped_sums_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BLOCK_MAX);
  if (err == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_release);
  return err;
}

cudaLaunchConfig_t cluster_config(int C, int threads, int blocks, int smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Executes one plan on `stream`: value rows rows[0..K) (K <= MAX_ROWS
// device pointers, each n int32) into out [K, G1], by clusters of C blocks
// of `threads` threads, `blocks` blocks in all, the rows cut into `slices`;
// C = GLOBAL (0): no shared memory, one slice, the adds straight into out.
// Returns 0 when launched, a cudaError_t (> 0) or ERR_SHAPE. The caller
// guarantees contiguous device buffers and `out` zeroed.
int grouped_sums_launch(const void* gid, const void* const* rows, void* out,
                        long long n, int K, int G1, int C, int slices,
                        int threads, int blocks, void* stream) {
  int R = 0, W = 0, smem = 0;
  if (geometry(n, K, G1, C, slices, threads, blocks, &R, &W, &smem))
    return ERR_SHAPE;
  RowPtrs ptrs = {};
  for (int k = 0; k < K; ++k) ptrs.p[k] = static_cast<const int*>(rows[k]);
  const int* g = static_cast<const int*>(gid);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C == GLOBAL) {
    grouped_sums_kernel<IN_OUT><<<blocks, threads, 0, st>>>(
        g, ptrs, o, n, K, G1, R, W, slices);
  } else if (C == 1) {
    err = allow_smem<ONE_BLOCK>();
    if (err != cudaSuccess) return static_cast<int>(err);
    grouped_sums_kernel<ONE_BLOCK><<<blocks, threads, smem, st>>>(
        g, ptrs, o, n, K, G1, R, W, slices);
  } else {
    err = allow_smem<CLUSTER>();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(C, threads, blocks, smem, st, &attr);
    err = cudaLaunchKernelEx(&cfg, grouped_sums_kernel<CLUSTER>, g, ptrs, o,
                             n, K, G1, R, W, slices);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of C blocks (blocks when C is 1 or GLOBAL) of `threads`
// threads and `smem` bytes of shared memory the card holds at once, into
// *count. Returns 0 or a cudaError_t.
int grouped_sums_occupancy(int C, int threads, int smem, int* count) {
  cudaError_t err;
  if (C == 1 || C == GLOBAL) {
    int dev = 0, sms = 0, per_sm = 0;
    err = C == 1 ? allow_smem<ONE_BLOCK>() : cudaSuccess;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = C == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, grouped_sums_kernel<ONE_BLOCK>, threads,
                         smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, grouped_sums_kernel<IN_OUT>, threads, 0);
    *count = sms * per_sm;
    return static_cast<int>(err);
  }
  err = allow_smem<CLUSTER>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(C, threads, C, smem, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      count, grouped_sums_kernel<CLUSTER>, &cfg));
}

const char* grouped_sums_error_string(int err) {
  if (err == ERR_SHAPE) return "shape outside the kernel's contract";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
