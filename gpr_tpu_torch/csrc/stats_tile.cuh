// The pieces the statistics kernels csrc/se_iso_stats.cu (forward) and
// csrc/se_iso_bwd.cu (backward) share, on the register-tiled FP32 loop of
// csrc/fp32_tile.cuh: the compensated sum, the x tile's copies, the products
// against a triangular right operand, the row-major store of a register
// tile, and the update of a CTA's m x m partial by 8 x 8 register blocks.
// Each .cu includes this header into its own translation unit.

#pragma once

#include "fp32_tile.cuh"

namespace {

constexpr int kBlk = 8;                   // register block edge of an m x m partial
constexpr int kVecs = kBlk * kBlk / 4;    // float4s of such a block
constexpr long long kSmemOptin = 232448;  // bytes a block may opt into on sm_90

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ inline void two_sum(float& hi, float& lo, float x) {
  float s = hi + x;
  float bp = s - hi;
  float err = (hi - (s - bp)) + (x - bp);
  hi = s;
  lo = lo + err;
}

inline bool fits(size_t floats) { return (long long)(floats * sizeof(float)) <= kSmemOptin; }

// Ask L2 for the hi and lo float4s of block b of a compensated partial ahead
// of their read-modify-write: no registers, and the HBM reads overlap the
// FFMAs that come first.  The hi/lo partials of 132 CTAs fill the 50 MB L2
// (at m = 300), so they live in HBM; the plain ones take half and stay in
// L2, where the prefetch measured no gain.
template <bool kComp>
__device__ __forceinline__ void prefetch_block(const float* part, int nblk, int b) {
  if (!kComp || b >= nblk) return;
  const float4* p = reinterpret_cast<const float4*>(part) + b;
#pragma unroll
  for (int v = 0; v < 2 * kVecs; ++v)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + (size_t)v * nblk));
}

// The upper 8 x 8 blocks of S'T into the CTA's partial part: S is the kR
// rows (row-major, stride mp) at S0, then, when S1 is not null, those at S1.
// T is S itself (the symmetric S'S) when T0 is null; else the tile at T0 for
// S0, and the one as far from S1 for S1.
// The part holds float4 v of block b (entries v / 2, 4 (v % 2) .. + 3) at
// [v][b], the hi half, then, when kComp, the lo half: a warp's access to one
// v is 512 contiguous bytes (a block's 256 contiguous bytes a thread cost
// the compensated entry 2.2 ms more a pass at m = 300).  Written on the
// CTA's first update, read-modify-write after.  With kBatch > 1 the
// compensated read-modify-write loads kBatch float4s of hi and of lo before
// it stores any (a store to the part keeps the compiler from moving a later
// load of it ahead, and one pair in flight a thread leaves the update bound
// by latency), reads them from L2 (another CTA may have written them) and
// asks for no prefetch.
template <bool kComp, int kBatch = 1, int kR = kRows>
__device__ __forceinline__ void add_gram(const float* S0, const float* S1, int mp,
                                         float* __restrict__ part, bool first,
                                         const float* T0 = nullptr) {
  const long long t_off = T0 ? T0 - S0 : 0;
  const int nb8 = mp / kBlk;
  const int nblk = nb8 * (nb8 + 1) / 2;
  for (int b = threadIdx.x; b < nblk; b += kThreads) {
    int bi = 0, rem = b;
    while (rem >= nb8 - bi) {
      rem -= nb8 - bi;
      ++bi;
    }
    const int bj = bi + rem;
    if (kBatch == 1 && !first) prefetch_block<kComp>(part, nblk, b + kThreads);  // the next round's
    float acc[kBlk][kBlk];
#pragma unroll
    for (int i = 0; i < kBlk; ++i)
#pragma unroll
      for (int j = 0; j < kBlk; ++j) acc[i][j] = 0.0f;
    for (const float* S = S0; S; S = S == S0 ? S1 : nullptr) {
      // 4 rows a trip: the next rows' loads go out under this row's FFMAs
#pragma unroll 4
      for (int r = 0; r < kR; ++r) {
        const float4* ra = reinterpret_cast<const float4*>(&S[r * mp + bi * kBlk]);
        const float4* rb = reinterpret_cast<const float4*>(&S[r * mp + bj * kBlk + t_off]);
        float4 a0 = ra[0], a1 = ra[1], b0 = rb[0], b1 = rb[1];
        float av[kBlk] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[kBlk] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kBlk; ++i)
#pragma unroll
          for (int j = 0; j < kBlk; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    float4* hi4 = reinterpret_cast<float4*>(part) + b;
    float4* lo4 = hi4 + (size_t)kVecs * nblk;
    if constexpr (kComp && kBatch > 1) {
      if (!first) {
#pragma unroll
        for (int v0 = 0; v0 < kVecs; v0 += kBatch) {
          float4 h[kBatch], l[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            h[u] = __ldcg(hi4 + (size_t)(v0 + u) * nblk);
            l[u] = __ldcg(lo4 + (size_t)(v0 + u) * nblk);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int i = (v0 + u) / 2, j = ((v0 + u) % 2) * 4;
            two_sum(h[u].x, l[u].x, acc[i][j]);
            two_sum(h[u].y, l[u].y, acc[i][j + 1]);
            two_sum(h[u].z, l[u].z, acc[i][j + 2]);
            two_sum(h[u].w, l[u].w, acc[i][j + 3]);
            hi4[(size_t)(v0 + u) * nblk] = h[u];
            lo4[(size_t)(v0 + u) * nblk] = l[u];
          }
        }
        continue;
      }
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int i = v / 2, j = (v % 2) * 4;
      const size_t at = (size_t)v * nblk;
      float4 tv = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      if (first) {
        hi4[at] = tv;
        if (kComp) lo4[at] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (kComp) {
        float4 h = hi4[at], l = lo4[at];
        two_sum(h.x, l.x, tv.x);
        two_sum(h.y, l.y, tv.y);
        two_sum(h.z, l.z, tv.z);
        two_sum(h.w, l.w, tv.w);
        hi4[at] = h;
        lo4[at] = l;
      } else {
        float4 h = hi4[at];
        h.x += tv.x;
        h.y += tv.y;
        h.z += tv.z;
        h.w += tv.w;
        hi4[at] = h;
      }
    }
  }
}

// Start the copies of the x tile rows [row0, row0 + kRows) into Xs
// transposed, Xs[k][r] = X[row0 + r][k]; zero for rows >= n.
__device__ __forceinline__ void load_x_tile(float* Xs, const float* __restrict__ X,
                                            long long row0, long long n, int d) {
  const float* base = X + row0 * d;
  const long long left = (n - row0) * d;  // valid elements from base on
  for (int e = threadIdx.x; e < kRows * d; e += kThreads) {
    const bool ok = e < left;
    cp_async4(Xs + (e % d) * kRows + e / d, ok ? base + e : X, ok);
  }
}

// acc += As x Ws for the slice of the upper-triangular U^-1 from row k0 on:
// its columns < k0 are zero, so the column quads (128 columns each) wholly
// below k0 skip their FFMAs.  At m = 300 that is 29 % of V's FFMAs.
template <int G>
__device__ __forceinline__ void mma_upper(float (&acc)[kWarpRows][2 * G], const float* As,
                                          const float* Ws, int k0) {
  if constexpr (G > 4) {
    if (k0 >= 256) return mma_slice<G, 2>(acc, As, Ws);
  }
  if constexpr (G > 2) {
    if (k0 >= 128) return mma_slice<G, 1>(acc, As, Ws);
  }
  mma_slice<G>(acc, As, Ws);
}

// acc += As x Ws for the slice of the lower-triangular U^-T from row k0 on:
// its columns > k0 + kBK - 1 are zero, so the column quads wholly right of
// them skip their FFMAs.  At m = 300 that is 34 % of the product's FFMAs.
template <int G>
__device__ __forceinline__ void mma_lower(float (&acc)[kWarpRows][2 * G], const float* As,
                                          const float* Ws, int k0) {
  if constexpr (G > 2) {
    if (k0 + kBK <= 128) return mma_slice<G, 0, 1>(acc, As, Ws);
  }
  if constexpr (G > 4) {
    if (k0 + kBK <= 256) return mma_slice<G, 0, 2>(acc, As, Ws);
  }
  mma_slice<G>(acc, As, Ws);
}

// A[8 warp + i][column(j)] = acc[i][j] row-major with row stride mp, for the
// columns < mp: one float4 (float2) store a lane per row and column quad
// (pair).
template <int G>
__device__ __forceinline__ void store_rows(float* A, const float (&acc)[kWarpRows][2 * G],
                                           int mp) {
  constexpr int kQuads = G / 2;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    float* row = A + (warp * kWarpRows + i) * mp;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int c = column<G>(4 * q);
      if (c < mp)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
    if (G % 2) {
      const int c = column<G>(4 * kQuads);
      if (c < mp)
        *reinterpret_cast<float2*>(row + c) = make_float2(acc[i][4 * kQuads], acc[i][4 * kQuads + 1]);
    }
  }
}

}  // namespace
