// flash_group_minima: fused bf16 distance matmul + lane-group min, for Hopper.
//
// Replaces the Pallas kernel databend_tpu/ops/flash_topk.py:_flash_kernel
// (called through flash_group_minima). Same contract:
//   q [B, D] f32, x [N, D] bf16 (N % tile == 0), norms [N] f32
//   -> out [ntiles, B, L] f32, L = 128, with
//   out[t, b, lane] = min over g of  norms[r] - c * dot(bf16(q[b]), x[r]),
//   r = t*tile + g*L + lane,  c = 2 (l2, |q|^2 dropped) or 1 (ip / cosine).
//
// Design. Grid (ntiles, ceil(B / BQ)); one block owns BQ = 64 queries and one
// corpus tile. It walks the tile in steps of L = 128 consecutive rows: row
// s*L + lane of the tile is in group `lane`, so each step is one [BQ, L]
// score block and a running elementwise min over the steps yields [BQ, L]
// directly. Scores come from tensor cores (nvcuda::wmma bf16 16x16x16, f32
// accumulate). The accumulator of each step starts from the step's norms
// (loaded into the fragment from a 16-row broadcast in shared memory) and the
// A operand is bf16(-c*q), which equals -c*bf16(q) exactly for c in {1, 2};
// so the fragment ends as the score, and the running min is an elementwise
// fminf of two fragments of one type (same element mapping). Pad rows carry
// +inf norms and never win. Eight warps tile the [64, 128] block as 4 x 2
// warps of [16, 64] (four accumulator fragments each).
//
// Shared memory is fixed whatever D is (109,568 bytes, two blocks per SM):
// a step stages x in slices of KS = 128 columns of D, and the accumulators
// stay in registers across the slices. The q block is staged once per block
// when D <= QMAX = 512; a wider q is restaged slice by slice at every step.
//
// Bound. The block reads its tile's bf16 rows once, so the corpus is read
// once per query block: at small B the kernel is bound by that read (2*D
// bytes per row per 64 queries), at large B by the MMA (2*B*N*D flops).
// Loads are plain synchronous 16-byte copies; TMA, wgmma and a multi-stage
// pipeline are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int L = 128;        // lanes = groups per tile = rows per step
constexpr int KS = 128;       // columns of x staged per slice
constexpr int QMAX = 512;     // widest q block staged once per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LD = KS + 8;    // bf16 row stride of x slices (+16 bytes)
constexpr int LDQ = QMAX + 8; // bf16 row stride of the q block

constexpr int QS_BYTES = BQ * LDQ * 2;                     // q block or slice
constexpr int XS_BYTES = (L * LD * 2 > BQ * L * 4)         // x slice, then
                             ? L * LD * 2 : BQ * L * 4;    // the [BQ, L] out
constexpr int NS_BYTES = 16 * L * 4;                       // norms broadcast
constexpr int SMEM_BYTES = QS_BYTES + XS_BYTES + NS_BYTES;

// q rows q0.. of columns [k0, k0 + kw) -> bf16(-c * q); rows past B are zero
// (their output is dropped)
__device__ __forceinline__ void stage_q(__nv_bfloat16* qs, const float* q,
                                        int q0, int B, int D, int k0, int kw,
                                        float neg_c, int tid) {
  const int n4 = kw / 4;
  for (int i = tid; i < BQ * n4; i += THREADS) {
    const int r = i / n4, c4 = i - r * n4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < B)
      v = reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * D + k0)[c4];
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(qs + r * LDQ + c4 * 4);
    dst[0] = __floats2bfloat162_rn(neg_c * v.x, neg_c * v.y);
    dst[1] = __floats2bfloat162_rn(neg_c * v.z, neg_c * v.w);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_group_minima_kernel(const float* __restrict__ q,
                          const __nv_bfloat16* __restrict__ x,
                          const float* __restrict__ norms,
                          float* __restrict__ out,
                          int B, int D, int tile, float neg_c) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);   // [BQ][LDQ]
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + QS_BYTES);         // [L][LD]
  float* ns = reinterpret_cast<float*>(smem + QS_BYTES + XS_BYTES);  // [16][L]

  const int t = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = (warp / 2) * 16;   // the warp's 16 query rows
  const int wc = (warp % 2) * 64;   // the warp's 64 lanes
  const bool q_once = D <= QMAX;    // stage q for the whole tile

  if (q_once) stage_q(qs, q, q0, B, D, 0, D, neg_c, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> run[4], acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(run[j], INFINITY);

  const __nv_bfloat16* xt = x + (size_t)t * tile * D;
  const float* nt = norms + (size_t)t * tile;
  const int steps = tile / L;
  for (int s = 0; s < steps; ++s) {
    const __nv_bfloat16* xstep = xt + (size_t)s * L * D;
    for (int k0 = 0; k0 < D; k0 += KS) {
      const int kw = min(KS, D - k0);
      __syncthreads();              // the last slice's readers are done
      if (!q_once) stage_q(qs, q, q0, B, D, k0, kw, neg_c, tid);
      const int n8 = kw / 8;        // 16-byte chunks per row of the slice
      if (kw == D) {                // one slice: the step's rows are contiguous
        const uint4* src = reinterpret_cast<const uint4*>(xstep);
        for (int i = tid; i < L * n8; i += THREADS) {
          const int r = i / n8, c8 = i - r * n8;
          *reinterpret_cast<uint4*>(xs + r * LD + c8 * 8) = src[i];
        }
      } else {
        for (int i = tid; i < L * n8; i += THREADS) {
          const int r = i / n8, c8 = i - r * n8;
          *reinterpret_cast<uint4*>(xs + r * LD + c8 * 8) =
              *reinterpret_cast<const uint4*>(xstep + (size_t)r * D + k0 + c8 * 8);
        }
      }
      if (k0 == 0) {
        const int c = tid % L;
        const float nv = nt[s * L + c];
        for (int r = tid / L; r < 16; r += THREADS / L) ns[r * L + c] = nv;
      }
      __syncthreads();

      if (k0 == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(acc[j], ns + wc + 16 * j, L,
                                 wmma::mem_row_major);
      }
      for (int k = 0; k < kw; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + wr * LDQ + (q_once ? k0 : 0) + k, LDQ);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // B[k][n] = x row (wc + 16j + n), column k0 + k: column-major B
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> b;
          wmma::load_matrix_sync(b, xs + (wc + 16 * j) * LD + k, LD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < acc[j].num_elements; ++e)
        run[j].x[e] = fminf(run[j].x[e], acc[j].x[e]);
  }

  // [BQ, L] minima through shared memory, then rows < B to global
  __syncthreads();
  float* os = reinterpret_cast<float*>(xs);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(os + wr * L + wc + 16 * j, run[j], L,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BQ * L; i += THREADS) {
    const int r = i / L, c = i - r * L;
    if (q0 + r < B) out[((size_t)t * B + q0 + r) * L + c] = os[i];
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// The caller guarantees D % 16 == 0, tile % 128 == 0, N % tile == 0 and
// contiguous device buffers.
int flash_group_minima_launch(const void* q, const void* x, const void* norms,
                              void* out, int B, int N, int D, int tile,
                              float c, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_group_minima_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / tile, (B + BQ - 1) / BQ);
  flash_group_minima_kernel<<<grid, THREADS, SMEM_BYTES,
                              (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(norms), static_cast<float*>(out), B, D, tile,
      -c);
  return (int)cudaGetLastError();
}

const char* flash_group_minima_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
