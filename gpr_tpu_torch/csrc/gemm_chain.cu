// A chain of f32 matrix products, out = x W^reps, by hand for Hopper (sm_90a).
//
// Replaces the Pallas roofline kernel k_chain of probes/r3_roofline_probe.py:98
// (leg 1: acc = x; repeat reps: acc = acc W, with W resident and one row
// block per grid step), the speed-of-light measurement of the fused
// statistics kernels.  On the TPU each product was _dot3, a 3-pass bf16
// emulation of an f32 product; here it is plain FP32 FMA on the CUDA cores:
// no TF32, no tensor cores, no fast-math, as in csrc/se_iso_stats.cu and
// csrc/se_iso_bwd.cu.
//
// What bounds it on this card.  2 n m^2 reps flops against 4 (2 n m + m^2)
// bytes of device memory: at m = 300..384 about 75..96 flops a byte, far
// above the FP32 balance point (67e12 / 3.35e12 = 20), so the FP32 FMA rate
// bounds it: every issue slot that is not an FFMA, and every cycle a warp
// scheduler waits, is lost to that bound.
//
// What the design does about it: a register-tiled outer product that keeps
// the FMA pipes fed from registers, and every load asynchronous.
//   * A CTA of 8 warps owns a 64-row tile and all 64 G (G = ceil(m / 64) <= 6)
//     of its padded columns, because the next product needs whole rows.  Warp
//     w owns rows 8w..8w+7; lane l owns the columns 128q + 4l .. 128q + 4l + 3
//     for q < G / 2 and, when G is odd, the pair 128 (G / 2) + 2l, +1.  That
//     is 16 G accumulators a thread (96 at m = 384), in registers: the kernel
//     is templated on G.
//   * The products read their left operand k-major, A[k][row] with a row
//     stride of 68 floats.  Per k a thread loads its 8 rows as two broadcast
//     float4 and its W columns as G / 2 float4 (+ a float2), all lanes on
//     consecutive words, then issues 16 G FFMAs: 19 FFMAs a shared load at
//     G = 6, 8 in a row on one W value.  The next k's fragments load while
//     this k's FFMAs issue.
//   * Everything the products read from device memory streams through one
//     ring of 3 stages, filled with cp.async: a stage holds a slice of W (16
//     rows x 64 G columns; 16-byte copies when m % 4 == 0, 4-byte otherwise)
//     and, for a tile's first product, the matching 16 columns of x,
//     transposed into the A layout by 4-byte copies.  The copies zero-fill
//     rows and columns out of range, so the FMA loop has no tail branch.  W is
//     the same in every product, so the ring runs on across product and tile
//     boundaries: the next tile's x and W are in flight while this tile's last
//     product finishes and its result drains.
//   * Between products the accumulators go to A transposed (two float4 a
//     column: 8 consecutive rows), after one barrier; one A buffer suffices
//     because every read of a product precedes that barrier, and the first
//     product reads x from the ring.  The last product goes from registers
//     straight to out.
//   * At m = 384: 104 KB of A + 3 x 28 KB of ring = 187 KB of the 227 KB a
//     block may opt into: one CTA per SM, which strides over the row tiles,
//     so the wrapper launches one CTA per SM.
//   * Rows >= n load as zero and are never written; columns >= m are zero in
//     the ring and so in A, so any n and any 1 <= m <= 384 take the same path.
//   * The loop's pieces (the cp.async copies, load_w, load_frag, column,
//     mma_slice, store_a) live in csrc/fp32_tile.cuh, which
//     csrc/se_iso_stats.cu includes too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp32_tile.cuh"

namespace {

__host__ __device__ inline int n_groups(int m) { return (m + kGroup - 1) / kGroup; }

// Floats of one ring stage: a W slice (kBK x 64 G) and an x slice (kBK x kAStride).
__host__ __device__ inline size_t stage_floats(int m) {
  return (size_t)kBK * (kGroup * n_groups(m) + kAStride);
}

// Shared memory, in floats: A (64 G x kAStride) | kStages stages.
__host__ __device__ inline size_t smem_floats(int m) {
  return (size_t)kGroup * n_groups(m) * kAStride + kStages * stage_floats(m);
}

// Issue the copies of x rows [row0, row0 + 64) x columns [k0, k0 + kBK) into
// the slice Xs transposed, Xs[kk][r] = x[row0 + r][k0 + kk]; zero for rows >=
// n or columns >= m.  Thread t copies column t % 16 of rows t / 16 + 16 i: a
// warp reads 2 rows x 16 columns (64 contiguous bytes a row) a copy.  xt is
// x + (row0 + t / 16) m + t % 16, rows_left = n - row0 - t / 16 clamped to
// [0, 64].
__device__ __forceinline__ void load_x(float* Xs, const float* __restrict__ x, const float* xt,
                                       int rows_left, int m, int k0) {
  const int kk = threadIdx.x % 16, r = threadIdx.x / 16;
  const bool col_ok = k0 + kk < m;
#pragma unroll
  for (int i = 0; i < kRows / 16; ++i) {
    const bool ok = col_ok && 16 * i < rows_left;
    cp_async4(Xs + kk * kAStride + r + 16 * i, ok ? xt + k0 + (size_t)16 * i * m : x, ok);
  }
}

// out[row0 + 8 warp + i][column(j)] = acc[i][j] for rows < n and columns < m;
// vector stores (a lane's 4 or 2 adjacent columns) when m % 4 == 0 and out is
// 16-byte aligned.
template <int G>
__device__ __forceinline__ void store_out(float* __restrict__ out,
                                          const float (&acc)[kWarpRows][2 * G],
                                          long long row0, long long n, int m, bool vec) {
  constexpr int kQuads = G / 2;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const long long row = row0 + warp * kWarpRows + i;
    if (row >= n) break;
    float* o = out + row * m;
    if (vec) {
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const int c = column<G>(4 * q);
        if (c < m)
          *reinterpret_cast<float4*>(o + c) =
              make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
      }
      if (G % 2) {
        const int c = column<G>(4 * kQuads);
        if (c < m)
          *reinterpret_cast<float2*>(o + c) = make_float2(acc[i][4 * kQuads], acc[i][4 * kQuads + 1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2 * G; ++j) {
        const int c = column<G>(j);
        if (c < m) o[c] = acc[i][j];
      }
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads, 1)
gemm_chain_kernel(const float* __restrict__ x, const float* __restrict__ W,
                  float* __restrict__ out, long long n, int m, int reps, long long n_tiles) {
  constexpr int kWidth = kGroup * G;
  constexpr int kStage = kBK * (kWidth + kAStride);  // stage_floats(m), in floats
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);
  float* ring = A + kWidth * kAStride;  // stage s: W slice, then x slice
  const int n_slices = (m + kBK - 1) / kBK;
  const bool vec_w = m % 4 == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  const bool vec_out = m % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  // The ring: one commit group per step (empty past the last step), so
  // wait_group<kStages - 2> at step q means step q's slices have landed.
  // Steps run over (tile, product, slice); the issue side runs kStages - 1
  // steps ahead of the compute side.
  int issue_tile = blockIdx.x;
  int issue_slice = 0, issue_rep = 0, issue_stage = 0;
  auto issue = [&]() {
    if (issue_tile < n_tiles) {
      float* stage = ring + issue_stage * kStage;
      load_w<G>(stage, W, m, issue_slice * kBK, vec_w);
      if (issue_rep == 0) {
        const long long row = (long long)issue_tile * kRows + threadIdx.x / 16;
        load_x(stage + kBK * kWidth, x, x + row * m + threadIdx.x % 16,
               (int)max(0LL, min(n - row, (long long)kRows)), m, issue_slice * kBK);
      }
      if (++issue_slice == n_slices) {
        issue_slice = 0;
        if (++issue_rep == reps) {
          issue_rep = 0;
          issue_tile += gridDim.x;
        }
      }
      issue_stage = issue_stage + 1 == kStages ? 0 : issue_stage + 1;
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue();

  int read_stage = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    for (int r = 0; r < reps; ++r) {
      float acc[kWarpRows][2 * G];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
        for (int j = 0; j < 2 * G; ++j) acc[i][j] = 0.0f;
      for (int s = 0; s < n_slices; ++s) {
        cp_async_wait<kStages - 2>();
        // This step's slices are in for every thread; the stage the next
        // issue overwrites was read by all at the last step; A is written.
        __syncthreads();
        issue();
        const float* stage = ring + read_stage * kStage;
        mma_slice<G>(acc, r == 0 ? stage + kBK * kWidth : A + s * kBK * kAStride, stage);
        read_stage = read_stage + 1 == kStages ? 0 : read_stage + 1;
      }
      if (r + 1 < reps) {
        __syncthreads();  // every read of A by this product is done
        store_a<G>(A, acc);
      } else {
        store_out<G>(out, acc, (long long)t * kRows, n, m, vec_out);
      }
    }
  }
  cp_async_wait<0>();
}

template <int G>
int launch(const float* x, const float* W, float* out, long long n, int m, int reps, int n_ctas,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(m) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_chain_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + kRows - 1) / kRows;
  gemm_chain_kernel<G><<<n_ctas, kThreads, bytes, stream>>>(x, W, out, n, m, reps, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at m, in bytes.
long long gemm_chain_smem_bytes(int m) {
  return (long long)(smem_floats(m) * sizeof(float));
}

// out (n, m) = x (n, m) W^reps, W (m, m), all row-major f32, 1 <= m <= 384,
// reps >= 1; n_ctas CTAs stride over the ceil(n / 64) row tiles.  Returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for m out of range).
int gemm_chain(const float* x, const float* W, float* out, long long n, int m, int reps,
               int n_ctas, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  static_assert(kMaxGroups == 6, "one case per G below");
  switch (n_groups(m)) {
    case 1: return launch<1>(x, W, out, n, m, reps, n_ctas, s);
    case 2: return launch<2>(x, W, out, n, m, reps, n_ctas, s);
    case 3: return launch<3>(x, W, out, n, m, reps, n_ctas, s);
    case 4: return launch<4>(x, W, out, n, m, reps, n_ctas, s);
    case 5: return launch<5>(x, W, out, n, m, reps, n_ctas, s);
    case 6: return launch<6>(x, W, out, n, m, reps, n_ctas, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
