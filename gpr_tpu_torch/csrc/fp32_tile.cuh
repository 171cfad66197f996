// The register-tiled FP32 product loop shared by csrc/gemm_chain.cu,
// csrc/se_iso_stats.cu and csrc/se_iso_bwd.cu, for Hopper (sm_90a): plain
// FP32 FMA on the CUDA cores, no TF32, no tensor cores, no fast-math.
//
// A CTA of 8 warps owns a 64-row tile and all 64 G (G <= 6) of its padded
// columns.  Warp w owns rows 8w..8w+7; lane l owns the columns 128q + 4l ..
// 128q + 4l + 3 for q < G / 2 and, when G is odd, the pair 128 (G / 2) + 2l,
// +1: 16 G accumulators a thread, in registers, so the users template on G.
// The left operand is read k-major, A[k][row] with a row stride of kAStride
// floats; the right operand streams in kBK-row slices (64 G columns, row
// stride 64 G) through a ring of kStages stages filled with cp.async.  Each
// .cu includes this header into its own translation unit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kRows = 64;            // rows per tile
constexpr int kWarpRows = 8;         // rows per warp
constexpr int kGroup = 64;           // columns per group: 2 a lane
constexpr int kMaxGroups = 6;        // 384 padded columns
constexpr int kBK = 16;              // k per slice
constexpr int kStages = 3;           // slices in the ring
constexpr int kAStride = kRows + 4;  // floats per k-row of A

// Asynchronous global -> shared copies, zero-filled when !valid (src-size 0).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of W rows [k0, k0 + kBK) x columns [0, 64 G) into the slice
// Ws (row stride 64 G); rows and columns >= m are zero-filled by the copies.
// Thread t copies row t / 16 of the slice, from column 4 (t % 16) (16-byte
// copies) or t % 16 (4-byte) on in steps of 64 or 16 columns: one base
// address a thread, and a warp reads 2 rows of contiguous bytes.
template <int G>
__device__ __forceinline__ void load_w(float* Ws, const float* __restrict__ W, int m, int k0,
                                       bool vec) {
  constexpr int kWidth = kGroup * G;
  const int kk = threadIdx.x / 16, c = threadIdx.x % 16;
  const bool row_ok = k0 + kk < m;
  const float* src = W + (size_t)(k0 + kk) * m;
  float* dst = Ws + kk * kWidth;
  if (vec) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int j = 4 * c + 64 * i;
      const bool ok = row_ok && j < m;
      cp_async16(dst + j, ok ? src + j : W, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * G; ++i) {
      const int j = c + 16 * i;
      const bool ok = row_ok && j < m;
      cp_async4(dst + j, ok ? src + j : W, ok);
    }
  }
}

// This thread's 8 rows of the k-row Ak and its columns of the W row Wk, for
// the column quads Q0 <= q < Q1; the pair of an odd G counts as quad G / 2.
template <int G, int Q0 = 0, int Q1 = (G + 1) / 2>
__device__ __forceinline__ void load_frag(float (&a)[kWarpRows], float (&b)[2 * G],
                                          const float* Ak, const float* Wk) {
  constexpr int kQuads = G / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4 lo = *reinterpret_cast<const float4*>(Ak + warp * kWarpRows);
  const float4 hi = *reinterpret_cast<const float4*>(Ak + warp * kWarpRows + 4);
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
#pragma unroll
  for (int q = Q0; q < (Q1 < kQuads ? Q1 : kQuads); ++q) {
    const float4 w = *reinterpret_cast<const float4*>(Wk + 128 * q + 4 * lane);
    b[4 * q] = w.x; b[4 * q + 1] = w.y; b[4 * q + 2] = w.z; b[4 * q + 3] = w.w;
  }
  if (G % 2 && Q1 > kQuads) {
    const float2 w = *reinterpret_cast<const float2*>(Wk + 128 * kQuads + 2 * lane);
    b[4 * kQuads] = w.x;
    b[4 * kQuads + 1] = w.y;
  }
}

// Column of the accumulator acc[.][j] of this lane.
template <int G>
__device__ __forceinline__ int column(int j) {
  constexpr int kQuads = G / 2;
  const int lane = threadIdx.x & 31;
  return j < 4 * kQuads ? 128 * (j / 4) + 4 * lane + j % 4 : 128 * kQuads + 2 * lane + j % 2;
}

// acc += As[0 : kBK] (k-major, this warp's rows) x Ws (this lane's columns),
// for the accumulators of the column quads Q0 <= q < Q1, the pair of an odd G
// counting as quad G / 2 (the others keep their values: a triangular Ws is
// zero there).
template <int G, int Q0 = 0, int Q1 = (G + 1) / 2>
__device__ __forceinline__ void mma_slice(float (&acc)[kWarpRows][2 * G], const float* As,
                                          const float* Ws) {
  constexpr int kWidth = kGroup * G;
  constexpr int kEnd = Q1 > G / 2 ? 2 * G : 4 * Q1;  // accumulators [4 Q0, kEnd)
  float a[2][kWarpRows], b[2][2 * G];
  load_frag<G, Q0, Q1>(a[0], b[0], As, Ws);
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    if (kk + 1 < kBK)  // the next k's fragments, while this k's FFMAs issue
      load_frag<G, Q0, Q1>(a[(kk + 1) & 1], b[(kk + 1) & 1], As + (kk + 1) * kAStride,
                           Ws + (kk + 1) * kWidth);
    // Column-major order: 8 FFMAs in a row share the W operand.
#pragma unroll
    for (int j = 4 * Q0; j < kEnd; ++j)
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
  }
}

// A[column(j)][8 warp + i] = acc[i][j]: two float4 stores a column.
template <int G>
__device__ __forceinline__ void store_a(float* A, const float (&acc)[kWarpRows][2 * G]) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) {
    float* col = A + column<G>(j) * kAStride + warp * kWarpRows;
    *reinterpret_cast<float4*>(col) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(col + 4) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

}  // namespace
