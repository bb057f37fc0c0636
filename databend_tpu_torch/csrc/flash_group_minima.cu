// flash_group_minima: fused bf16 distance matmul + lane-group min, for Hopper.
//
// Replaces the Pallas kernel databend_tpu/ops/flash_topk.py:_flash_kernel
// (called through flash_group_minima). Same function:
//   qn [B, D] bf16 = bf16(-c * q), c = 2 (l2, |q|^2 dropped) or 1 (ip / cosine);
//   x [N, D] bf16 (N % tile == 0, tile % 128 == 0, D % 16 == 0); norms [N] f32
//   -> out [N / tile, B, 128] f32,
//   out[t, b, lane] = min over g of  norms[r] + dot(qn[b], x[r]),
//   r = t*tile + g*128 + lane, f32 accumulation. Pad rows are zero vectors
//   with +inf norms: their score is +inf and never wins the min.
//
// Bound. At B = 256, D = 128, N = 1,015,808 the call must move 272 MB (one
// read of the bf16 corpus, norms and q, one write of the minima): 81 us at
// 3.35 TB/s, against 67 us for its 66.6 GFLOP at 989 TFLOP/s: bytes bind. At
// B = 1024 the 266 GFLOP take 269 us and the bytes 91 us: operations bind.
// The two limits meet near B = 256, so the copy and the MMA both stay busy.
//
// Design.
//  * Work items on a persistent grid. An item is (corpus tile, block of 128
//    queries); min(items, SM count) blocks walk the items in steps of the
//    grid size, the query blocks of one tile next to each other, so that they
//    are on the card at the same time and all but the first read of a tile
//    come from L2.
//  * A TMA ring. One producer thread issues cp.async.bulk.tensor loads of
//    [128 rows x 64 columns] boxes of x (16 KB, SWIZZLE_128B) into a ring of
//    shared-memory stages; each stage has a `full` mbarrier (expect_tx /
//    complete_tx) and an `empty` mbarrier on which every consumer warp
//    arrives when its wgmma reads of the stage are done. The 128 norms of a
//    step ride with the step's last box as a 512-byte bulk copy on the same
//    barrier. TMA zero-fills columns past D and query rows past B.
//  * wgmma on the boxes as TMA left them. Two consumer warpgroups own 64
//    queries each: wgmma.mma_async m64n128k16 (bf16 x bf16 -> f32), B = the
//    x box in shared memory (K-major, 128-byte swizzle: x rows need no
//    transpose). One 128-row step of a tile is one [64, 128] accumulator per
//    warpgroup; row s*128 + lane of the tile is in group `lane`, so the step
//    is folded into the running minima elementwise:
//    run = fminf(run, acc + norm[col]), every thread adding the norms of its
//    own columns. While one warpgroup folds, the other's wgmma runs.
//  * q. For D <= 128 each consumer thread holds its part of the item's q
//    block in 32 registers as the wgmma A fragments, loaded from global
//    memory once per item; a stage is one x box (8 stages of 16 KB). For
//    wider D a stage is the (x box, q box) pair of one 64-column slice (6
//    stages of 32 KB, A from shared memory too) and the accumulators stay
//    in registers across the slices of a step: no per-slice block barrier,
//    shared memory independent of D.
//  * The minima go from registers to global memory as float2 stores (each
//    warp store fills whole 32-byte sectors, so staging them through shared
//    memory would save nothing), rows >= B not written.
//  * Registers: 64 accumulator + 64 running minima + 32 q + 32 norms per
//    consumer thread; setmaxnreg gives the consumers 232 and the producer 40
//    (__launch_bounds__(384, 1)). ptxas reports 168 registers, 0 bytes of
//    spill.
//
// A barrier wait that makes no progress for about two seconds traps, so a
// wrong byte count or phase fails the launch instead of hanging the card.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W (CUDA events
// around the Python wrapper, N = 1,015,808, tile 16,384; in brackets the
// wmma kernel this one replaced, same call, same card): l2 B = 256, D = 128
// 0.1345 ms (0.7286), 60% of the bound; B = 1024 0.4653 ms (2.7515), 58%;
// B = 100, D = 400 0.4640 ms (1.6205); B = 256, D = 768 0.6448 ms (4.6883);
// B = 256, D = 1536 1.2099 ms (9.1794). What holds it at D = 128
// (chip_smoke.py --diagnose): device memory delivers a tile stream in about
// 0.095 ms, and per item the fold's FADD + FMNMX add to the wgmma time
// instead of hiding behind it. PERF.md has the table.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int L = 128;                  // lanes = groups per tile = rows per step
constexpr int BQ = 128;                 // queries per work item
constexpr int KB = 64;                  // columns per box: 128 bytes, the swizzle span
constexpr int BOX_BYTES = L * KB * 2;   // one [128 x 64] bf16 box of x or of q
constexpr int NORM_BYTES = L * 4;       // the norms of one step
constexpr int CONSUMER_WARPS = 8;       // two warpgroups of 64 queries
constexpr int THREADS = 384;            // + the producer's warpgroup
constexpr long long WAIT_LIMIT_CLOCKS = 4000000000LL;

// kRegQ (D <= 128): the item's q block lives in registers as the wgmma A
// fragments and a stage is one x box. Otherwise a stage is the (x box, q box)
// pair of one 64-column slice and A comes from shared memory.
template <bool kRegQ>
struct Cfg {
  static constexpr int STAGES = kRegQ ? 8 : 6;
  static constexpr int STAGE_BYTES = kRegQ ? BOX_BYTES : 2 * BOX_BYTES;
  static constexpr int NORMS_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = NORMS_OFF + STAGES * NORM_BYTES;
  // full[STAGES], empty[STAGES]; + slack to align the base to 1024
  static constexpr int SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// waits until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > WAIT_LIMIT_CLOCKS) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared-memory operand descriptor of a K-major [rows x 64] bf16 box in the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO),
// LBO unused in this layout, layout type 1 = SWIZZLE_128B. The k-th 16-column
// slice of the box starts 32 bytes further: descriptor + 2k.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// d[64] (+)= A[64 x 16] * B[16 x 128]; thread (warp w, lane l) of the
// warpgroup holds d[4j + {0, 1}] = row 16w + l/4, columns 8j + 2(l%4) + {0, 1}
// and d[4j + {2, 3}] = the same columns of row + 8.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same with A from registers: a[0..3] hold, as bf16 pairs, columns
// 2(l%4) + {0, 1} of rows 16w + l/4 and + 8, then the same rows 8 columns on.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The ring position shared by the producer's and the consumers' loops.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <bool kRegQ>
__global__ void __launch_bounds__(THREADS, 1)
flash_group_minima_kernel(__grid_constant__ const CUtensorMap xmap,
                          __grid_constant__ const CUtensorMap qmap,
                          const __nv_bfloat16* __restrict__ qn,
                          const float* __restrict__ norms,
                          float* __restrict__ out, int B, int D, int tile,
                          int ntiles) {
  using C = Cfg<kRegQ>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle and the operand descriptors want 1024-byte bases
  unsigned char* smem = smem_raw +
      ((1024 - (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) & 1023)) & 1023);
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t norms_s = ring + C::NORMS_OFF;
  const uint32_t full = ring + C::BAR_OFF;
  const uint32_t empty = full + C::STAGES * 8;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  const int nqb = (B + BQ - 1) / BQ;     // query blocks
  const int items = ntiles * nqb;
  const int steps = tile / L;
  const int nkb = (D + KB - 1) / KB;     // 64-column boxes per row
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == CONSUMER_WARPS * 32) {
      Ring r;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int t = item / nqb, qb = item - t * nqb;
        for (int s = 0; s < steps; ++s) {
          const int row = t * tile + s * L;
          for (int kb = 0; kb < nkb; ++kb) {
            const bool last = kb == nkb - 1;
            const uint32_t bar = full + 8 * r.stage;
            const uint32_t xs = ring + r.stage * C::STAGE_BYTES;
            mbar_wait(empty + 8 * r.stage, r.phase ^ 1);
            mbar_expect_tx(bar, C::STAGE_BYTES + (last ? NORM_BYTES : 0));
            tma_load_2d(xs, &xmap, bar, kb * KB, row);
            if (!kRegQ)
              tma_load_2d(xs + BOX_BYTES, &qmap, bar, kb * KB, qb * BQ);
            if (last)
              bulk_load(norms_s + r.stage * NORM_BYTES, norms + row, NORM_BYTES,
                        bar);
            r.advance(C::STAGES);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns queries [wg*64, wg*64 + 64) of the item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const uint32_t a_off = wg * 64 * (KB * 2);   // the warpgroup's rows of a q box
    constexpr int QSLICES = kRegQ ? 2 * KB / 16 : 1;
    uint32_t qa[QSLICES][4];                      // kRegQ: the A fragments of q
    float acc[64], run[64];
    Ring r;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int t = item / nqb, qb = item - t * nqb;
      const int b0 = qb * BQ + wg * 64 + warp * 16 + lane / 4;   // and b0 + 8
      if constexpr (kRegQ) {
        const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
            qn + static_cast<size_t>(b0) * D + 2 * (lane % 4));
        const uint32_t* q8 = q0 + 4 * D;          // 8 rows of D bf16 further
#pragma unroll
        for (int ks = 0; ks < QSLICES; ++ks) {
          const bool in = ks * 16 < D;
          qa[ks][0] = in && b0 < B ? q0[8 * ks] : 0u;
          qa[ks][1] = in && b0 + 8 < B ? q8[8 * ks] : 0u;
          qa[ks][2] = in && b0 < B ? q0[8 * ks + 4] : 0u;
          qa[ks][3] = in && b0 + 8 < B ? q8[8 * ks + 4] : 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] = INFINITY;

      for (int s = 0; s < steps; ++s) {
        int prev = 0;
        // one 64-column box of the step: wait for it, multiply, free the one before
        auto box = [&](int kb) {
          mbar_wait(full + 8 * r.stage, r.phase);
          const uint32_t xs = ring + r.stage * C::STAGE_BYTES;
          const uint64_t db = operand_desc(xs);
          wgmma_fence();
          // columns past D are zero in both operands
#pragma unroll
          for (int k = 0; k < KB / 16; ++k) {
            if constexpr (kRegQ) {
              wgmma_m64n128k16(acc, qa[4 * kb + k], db + 2 * k, (kb | k) != 0);
            } else {
              const uint64_t da = operand_desc(xs + BOX_BYTES + a_off);
              wgmma_m64n128k16(acc, da + 2 * k, db + 2 * k, (kb | k) != 0);
            }
          }
          wgmma_commit();
          if (kb > 0) {
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(empty + 8 * prev);
          }
          prev = r.stage;
          r.advance(C::STAGES);
        };
        if constexpr (kRegQ) {            // D <= 128: one or two boxes, unrolled
          box(0);
          if (nkb > 1) box(1);
        } else {
          for (int kb = 0; kb < nkb; ++kb) box(kb);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");

        // the step's norms came with its last box; then the stage is free
        const float2* nv = reinterpret_cast<const float2*>(
            smem + C::NORMS_OFF + prev * NORM_BYTES) + (lane % 4);
        float2 nrm[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) nrm[j] = nv[4 * j];
        // The norms are read with ordinary shared-memory loads, and the
        // arrive below lets the producer's next bulk copy overwrite them.
        // Without a fence the arrive can overtake loads that are still
        // queued behind the warpgroups' wgmma operand traffic: with one
        // step per tile (tile = 128) about one launch in 75 read the last
        // 64 bytes of the norms of the stage's next occupant.
        __threadfence_block();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          run[4 * j + 0] = fminf(run[4 * j + 0], acc[4 * j + 0] + nrm[j].x);
          run[4 * j + 1] = fminf(run[4 * j + 1], acc[4 * j + 1] + nrm[j].y);
          run[4 * j + 2] = fminf(run[4 * j + 2], acc[4 * j + 2] + nrm[j].x);
          run[4 * j + 3] = fminf(run[4 * j + 3], acc[4 * j + 3] + nrm[j].y);
        }
      }

      float* o = out + (static_cast<size_t>(t) * B + b0) * L + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (b0 < B)
          *reinterpret_cast<float2*>(o + 8 * j) =
              make_float2(run[4 * j + 0], run[4 * j + 1]);
        if (b0 + 8 < B)
          *reinterpret_cast<float2*>(o + 8 * L + 8 * j) =
              make_float2(run[4 * j + 2], run[4 * j + 3]);
      }
    }
  }
}

// a [rows, cols] bf16 row-major matrix in boxes of [128 rows x 64 columns];
// reads outside the matrix give zeros
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {KB, L};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kRegQ>
int launch(const CUtensorMap& xmap, const CUtensorMap& qmap,
           const __nv_bfloat16* qn, const float* norms, float* out, int B, int N, int D, int tile, int sms,
           cudaStream_t stream) {
  auto kernel = flash_group_minima_kernel<kRegQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<kRegQ>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = N / tile;
  const int items = ntiles * ((B + BQ - 1) / BQ);
  kernel<<<items < sms ? items : sms, THREADS, Cfg<kRegQ>::SMEM_BYTES,
           stream>>>(xmap, qmap, qn, norms, out, B, D, tile, ntiles);
  return static_cast<int>(cudaGetLastError());
}

constexpr int ERR_X_MAP = -1;
constexpr int ERR_Q_MAP = -2;

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 when launched, a cudaError_t (> 0) or one
// of the tensor-map errors (< 0). `qn` is bf16(-c * q). The caller
// guarantees B >= 1, D % 16 == 0, tile % 128 == 0, N % tile == 0, and
// contiguous device buffers whose addresses are multiples of 16.
int flash_group_minima_launch(const void* qn, const void* x, const void* norms,
                              void* out, int B, int N, int D, int tile,
                              void* stream) {
  CUtensorMap xmap, qmap;
  if (!make_map(&xmap, x, N, D)) return ERR_X_MAP;
  if (!make_map(&qmap, qn, B, D)) return ERR_Q_MAP;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(qn);
  const float* nrm = static_cast<const float*>(norms);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 2 * KB
      ? launch<true>(xmap, qmap, qb, nrm, o, B, N, D, tile, sms, st)
      : launch<false>(xmap, qmap, qb, nrm, o, B, N, D, tile, sms, st);
}

const char* flash_group_minima_error_string(int err) {
  switch (err) {
    case ERR_X_MAP: return "cuTensorMapEncodeTiled refused the corpus";
    case ERR_Q_MAP: return "cuTensorMapEncodeTiled refused the queries";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
