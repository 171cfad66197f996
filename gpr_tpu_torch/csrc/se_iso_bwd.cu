// Backward of the streaming SE-iso FITC statistics, by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas backward tile of gpr_tpu/ops/fused_stats.py:
//   se_iso_bwd_acc <- _se_iso_bwd_kernel_acc (se_iso_stream_bwd_fused)
//
// Given the cotangents (Gb, ub, ldsb, yiyb, isrb) of the forward statistics
// (csrc/se_iso_stats.cu), Gs = Gb + Gb', U^-1 (upper) and U^-T, each row tile
// recomputes and chains:
//   Knm = exp(log_sf2 + q d2),  V = Knm U^-1,  VG = V Gs  (= Knm U^-1 Gs)
//   r = sf2 - rowsq(V),  s = r + sigma2 (1 where masked),  is = mask / s
//   isb = y (V ub) + 1/2 rowdot(VG, V) + yiyb y^2 + isrb r
//   sb  = (ldsb mask - isb is) / s  (0 where masked),  rb = sb + isrb is
//   yb  = is (V ub) + 2 yiyb is y                       (only on request)
//   Vb  = is VG + (is y) ub' - 2 V rb,   Kb = Vb U^-T
//   U^-1 bar += triu(Knm' Vb),   c = Kb * Knm,   caug += c' [X | 1 | xx]
//   [sum rb, sum sb]
// The wrapper turns caug into z_bar and log_ell_bar, and log_sf2_bar =
// sum c + sf2 sum rb (gpr_tpu_torch/kernels/se_iso.py::k_cross_vjp).
//
// What bounds it on this card.  Per row about m d (Knm) + m^2/2 (V) + m^2
// (VG) + m^2/2 (Kb) + m^2/2 (the upper triangle of Knm' Vb) + m (d + 2)
// FMAs, all plain FP32 on the CUDA cores: no TF32, no tensor cores, no
// fast-math.  That is about 2.5 m^2 against the forward's m^2, so the FP32
// FMA rate bounds it; reading X is 32 bytes a row.
//
// Two routes, picked from (m, d) by the host function, never from a failure.
//
// The tiled route (G = ceil(m / 64) <= 5 and its shared memory within the
// 227 KB a block may opt into: m <= 320 at d = 8): se_iso_bwd_kernel<G>, on
// the register-tiled FP32 loop of csrc/fp32_tile.cuh with the pieces of
// csrc/stats_tile.cuh that the forward kernel uses too.  One CTA per SM
// strides over the 64-row tiles; a warp owns 8 whole rows, a lane 2 G columns
// of each, so every elementwise step works on registers.
//   * Two tiles suffice.  VG = Knm (U^-1 Gs) = V Gs: the kernel forms VG
//     from V, so Knm's k-major tile A is free once V is in registers, and
//     the wrapper need not form U^-1 Gs.  A holds in turn Knm, V and Vb
//     (k-major, the left operands of the three products), then Kb, c and
//     Knm row-major; R holds Vb row-major for the triangle update.  Knm is
//     formed three times a tile (d FMAs and an expf an entry, against about
//     2.4 m FMAs an entry for the products): a third tile does not fit at
//     m = 300.
//   * One 2-stage cp.async ring carries the 16-row slices of all three right
//     operands, U^-1, Gs and U^-T, one step ahead across product and tile
//     boundaries.  A tile's x rides with its first slice into one of two x
//     buffers: the last tile's x is still read after its last product.
//   * U^-1 is upper and U^-T lower triangular (the wrapper passes triu and
//     its transpose: the copies read whole rows), so mma_upper and mma_lower
//     skip the column quads a slice has only zeros in.
//   * rowsq(V), V ub and rowdot(VG, V) are register sums and 5 xor shuffles a
//     row; the row chain runs in every lane of the warp that owns the row.
//   * c' [X | 1 | xx] is held (d + 2, mp): a lane takes 4 neighbouring
//     columns of c (one float4 a row) by one column of [X | 1 | xx].
//   * The upper 8 x 8 blocks of Knm' Vb go through the forward kernel's
//     add_gram into a [v][b] hi/lo partial, read and written back on every
//     tile.  One partial a CTA is 50 MB for 132 CTAs at m = 300, the whole
//     L2: the update then waits on device memory for a quarter of the
//     kernel's time.  So `share` neighbouring CTAs take turns on ONE partial
//     (the wrapper picks 1, 2 or 4 so that all partials fit in a quarter of
//     the L2 where they can): a
//     ticket in device memory orders their updates, round by round and by
//     rank within a round, so the sum's order is fixed and the run stays
//     deterministic.  A CTA waits only while a neighbour is inside its own
//     update; a cooperative launch guarantees that the neighbour is running.
//
// The wide route (every other m, up to about m = 2,870 at any d):
// se_iso_bwd_kernel_wide<R>, the first kernel.  A CTA walks a contiguous
// chunk of R-row tiles, R the largest of 32, 24, 16 and 8 whose two tiles
// fit (32 up to about m = 780, 24 up to about 1,030).  Two (R, mp) tiles
// suffice, as on the tiled route: A holds Knm, then VG = V Gs (the tiled
// route's order, so Knm is free once V is formed), then Vb; B holds V, then
// Knm formed again for the triangle update, then c = (Vb U^-T) * Knm, which
// the last product writes over it.  Each product streams 128-column panels
// of its right operand in 16-row chunks through a 3-stage cp.async ring,
// two chunks in flight while one is multiplied, so no m x m operand need fit
// in the SM; a lane accumulates R / 8 rows by 4 columns of a panel.  Knm reads z from device memory (L1 and L2 hold it), so d
// bounds only the x tile.  Each tile reads and writes back its CTA's whole
// partial of the U^-1 cotangent: at m = 1,000 and R = 24 that traffic
// weighs as much as the FFMAs.
//
// Both routes:
//   * The TPU carried z_bar, U^-1 bar and the scalars across an ordered
//     grid.  Here each CTA writes ONE compensated partial; the wrapper folds
//     hi + lo and reduces the partials in f64.  No float atomics, so runs
//     are deterministic.
//   * Only the upper triangle of Knm' Vb is accumulated: the triangular
//     solve that forms U^-1 reads no other part of its cotangent.
//   * The SE-iso pullback needs no d2 tile: c' [X | 1 | xx] (m x (d + 2))
//     holds every reduction it takes (kernels/base.py::
//     sqdist_cotangent_reduce).
//   * Rows >= n are masked in the kernel (no host padding), and columns
//     >= m of every tile are zero.  Every accumulator is a two-sum (hi, lo)
//     pair across the CTA's tiles; two-sum has no products, so FMA
//     contraction cannot break it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stats_tile.cuh"

namespace {

// ---------------------------------------------------------------- tiled route

constexpr int kMaxBwdGroups = 5;  // G = 6 never fits beside R and the ring
constexpr int kRing = 2;          // stages of the right operands' ring
constexpr int kBatch = 8;         // float4 pairs in flight in the triangle's write-back

__host__ __device__ inline int tiled_groups(int m) { return (m + kGroup - 1) / kGroup; }

// Tiled route shared memory, in floats: A (64 G x kAStride) | R (kRows x mp)
// | kRing slices (kBK x 64 G) | two x tiles (d x kRows) | Z^T (d x 64 G) |
// |z|^2, ub (2 x 64 G) | rowsq(V), V ub, |x|^2 (3 kRows) | scalar reduction
// (8 warps x 2).
__host__ __device__ inline size_t tiled_smem_floats(int m, int d) {
  const int width = kGroup * tiled_groups(m);
  return (size_t)width * kAStride + (size_t)kRows * round_up(m, kBlk) +
         (size_t)kRing * kBK * width + 2 * (size_t)d * kRows + (size_t)d * width +
         2 * (size_t)width + 3 * kRows + 2 * (kThreads / 32);
}

// G of the tiled route at (m, d), or 0 for the wide route.
inline int route_groups(int m, int d) {
  if (m < 1 || tiled_groups(m) > kMaxBwdGroups) return 0;
  return fits(tiled_smem_floats(m, d)) ? tiled_groups(m) : 0;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Knm of this thread's 8 rows x 2 G columns (zero for columns >= m) and the
// rows' |x|^2, from the transposed x tile xs: x Z' as a rank-d update, then
// the kernel entry by entry, with the forward kernel's expression and order.
template <int G>
__device__ __forceinline__ void form_knm(float (&acc)[kWarpRows][2 * G], float (&x2)[kWarpRows],
                                         const float* xs, const float* Zt, const float* z2,
                                         int d, int m, float q, float log_sf2) {
  constexpr int kWidth = kGroup * G;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    x2[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * G; ++j) acc[i][j] = 0.0f;
  }
  for (int k = 0; k < d; ++k) {
    float a[kWarpRows], b[2 * G];
    load_frag<G>(a, b, xs + k * kRows, Zt + k * kWidth);
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      x2[i] += a[i] * a[i];
#pragma unroll
      for (int j = 0; j < 2 * G; ++j) acc[i][j] += a[i] * b[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 2 * G; ++j) {
    const int c = column<G>(j);
    const float zc = z2[c];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float d2 = fmaxf(x2[i] - 2.0f * acc[i][j] + zc, 0.0f);
      acc[i][j] = c < m ? expf(log_sf2 + q * d2) : 0.0f;
    }
  }
}

// v[i] = A[column(j)][8 warp + i]: this thread's entries of column j of the
// k-major tile A, as store_a wrote them.
template <int G>
__device__ __forceinline__ void load_a_column(float (&v)[kWarpRows], const float* A, int j) {
  const float* col = A + column<G>(j) * kAStride + (threadIdx.x >> 5) * kWarpRows;
  const float4 lo = *reinterpret_cast<const float4*>(col);
  const float4 hi = *reinterpret_cast<const float4*>(col + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// acc[i][j] *= A[8 warp + i][column(j)] for the columns < mp of the
// row-major tile A (row stride mp): the entries store_rows wrote.
template <int G>
__device__ __forceinline__ void mul_rows(float (&acc)[kWarpRows][2 * G], const float* A, int mp) {
  constexpr int kQuads = G / 2;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const float* row = A + (warp * kWarpRows + i) * mp;
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int c = column<G>(4 * q);
      if (c < mp) {
        const float4 v = *reinterpret_cast<const float4*>(row + c);
        acc[i][4 * q] *= v.x;
        acc[i][4 * q + 1] *= v.y;
        acc[i][4 * q + 2] *= v.z;
        acc[i][4 * q + 3] *= v.w;
      }
    }
    if (G % 2) {
      const int c = column<G>(4 * kQuads);
      if (c < mp) {
        const float2 v = *reinterpret_cast<const float2*>(row + c);
        acc[i][4 * kQuads] *= v.x;
        acc[i][4 * kQuads + 1] *= v.y;
      }
    }
  }
}

template <int G>
__device__ __forceinline__ void zero_acc(float (&acc)[kWarpRows][2 * G]) {
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
    for (int j = 0; j < 2 * G; ++j) acc[i][j] = 0.0f;
}

template <int G>
__global__ void __launch_bounds__(kThreads, 1)
se_iso_bwd_kernel(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ mask, const float* __restrict__ z,
                  const float* __restrict__ u_inv, const float* __restrict__ u_inv_t,
                  const float* __restrict__ gs, const float* __restrict__ ubar, long long n,
                  int d, int m, float q, float log_sf2, float sigma2, float lds_bar,
                  float yiy_bar, float isr_bar, long long n_tiles, int share,
                  int* __restrict__ turn, float* __restrict__ ui_part,
                  float* __restrict__ caug_part, float* __restrict__ sums_part,
                  float* __restrict__ y_bar) {
  constexpr int kWidth = kGroup * G;
  constexpr int kStage = kBK * kWidth;  // floats of one ring stage
  extern __shared__ float4 smem4[];
  const int mp = round_up(m, kBlk);
  const int x_stage = d * kRows;
  float* A = reinterpret_cast<float*>(smem4);
  float* R = A + kWidth * kAStride;
  float* ring = R + kRows * mp;
  float* xbuf = ring + kRing * kStage;
  float* Zt = xbuf + 2 * x_stage;
  float* z2 = Zt + d * kWidth;
  float* ub = z2 + kWidth;
  float* ss_r = ub + kWidth;  // rowsq(V), from product 1 to the row chain
  float* vu_r = ss_r + kRows;
  float* xx = vu_r + kRows;
  float* red = xx + kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_slices = (m + kBK - 1) / kBK;
  const int nb8 = mp / kBlk;
  const int nblk = nb8 * (nb8 + 1) / 2;
  const int naug4 = (d + 2) * (mp / 4);  // float4s of c' [X | 1 | xx], padded to mp
  const float sf2 = expf(log_sf2);
  const bool vec = m % 4 == 0 && ((reinterpret_cast<uintptr_t>(u_inv) |
                                   reinterpret_cast<uintptr_t>(u_inv_t) |
                                   reinterpret_cast<uintptr_t>(gs)) & 15) == 0;

  for (int e = tid; e < d * kWidth; e += kThreads) {
    int k = e / kWidth, j = e % kWidth;
    Zt[e] = j < m ? z[(size_t)j * d + k] : 0.0f;
  }
  for (int j = tid; j < kWidth; j += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < d && j < m; ++k) {
      float v = z[(size_t)j * d + k];
      acc += v * v;
    }
    z2[j] = acc;
    ub[j] = j < m ? ubar[j] : 0.0f;
  }

  // The ring: one commit group per step (empty past the last step), so
  // wait_group<kRing - 2> at step q means step q's copies have landed.
  // Steps run over (tile, product, slice); the copy side runs kRing - 1
  // steps ahead of the compute side.  Product 0 reads U^-1, 1 Gs, 2 U^-T.
  long long fetch_tile = blockIdx.x;
  int fetch_prod = 0, fetch_slice = 0, fetch_stage = 0, fetch_x = 0;
  auto fetch = [&]() {
    if (fetch_tile < n_tiles) {
      const float* W = fetch_prod == 0 ? u_inv : (fetch_prod == 1 ? gs : u_inv_t);
      load_w<G>(ring + fetch_stage * kStage, W, m, fetch_slice * kBK, vec);
      if (fetch_prod == 0 && fetch_slice == 0) {
        load_x_tile(xbuf + fetch_x * x_stage, X, fetch_tile * kRows, n, d);
        fetch_x ^= 1;
      }
      if (++fetch_slice == n_slices) {
        fetch_slice = 0;
        if (++fetch_prod == 3) {
          fetch_prod = 0;
          fetch_tile += gridDim.x;
        }
      }
      fetch_stage = fetch_stage + 1 == kRing ? 0 : fetch_stage + 1;
    }
    cp_async_commit();
  };
  for (int s = 0; s < kRing - 1; ++s) fetch();

  // scalar carries live in thread 0: [sum rb, sum sb] as (hi, lo)
  float s_hi[2] = {0.f, 0.f};
  float s_lo[2] = {0.f, 0.f};
  float4* ca4 = reinterpret_cast<float4*>(caug_part) + (size_t)blockIdx.x * 2 * naug4;
  // CTAs [share p, share p + sharing) take turns on partial p of the U^-1
  // cotangent; this CTA's update of its tile `round` holds ticket
  // round * sharing + rank (a CTA of lower rank has as many tiles or one
  // more, so every rank before it in a round is there).
  const int part_id = blockIdx.x / share, rank = blockIdx.x % share;
  const int sharing = min(share, (int)gridDim.x - part_id * share);
  float* ui = ui_part + (size_t)part_id * 2 * nblk * kBlk * kBlk;
  int ticket = rank;

  int read_stage = 0, read_x = 0;
  bool first = true;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    const float* xs = xbuf + read_x * x_stage;
    read_x ^= 1;
    float acc[kWarpRows][2 * G];

    // 1. Knm into A, k-major (rows j >= m zero), from registers
    cp_async_wait<kRing - 2>();
    __syncthreads();  // this tile's x is in; the last tile is consumed
    {
      float x2[kWarpRows];
      form_knm<G>(acc, x2, xs, Zt, z2, d, m, q, log_sf2);
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) xx[warp * kWarpRows + i] = x2[i];
      }
    }
    store_a<G>(A, acc);

    // 2. V = Knm U^-1 in registers; rowsq(V) and V ub
    zero_acc<G>(acc);
    for (int s = 0; s < n_slices; ++s) {
      cp_async_wait<kRing - 2>();
      // This step's slice is in for every thread; the stage the next fetch
      // overwrites was read by all at the last step; A is written.
      __syncthreads();
      fetch();
      mma_upper<G>(acc, A + s * kBK * kAStride, ring + read_stage * kStage, s * kBK);
      read_stage = read_stage + 1 == kRing ? 0 : read_stage + 1;
    }
    {
      float ss[kWarpRows], vu[kWarpRows];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) ss[i] = vu[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * G; ++j) {
        const float ubj = ub[column<G>(j)];
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) {
          ss[i] += acc[i][j] * acc[i][j];
          vu[i] += acc[i][j] * ubj;
        }
      }
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);
          vu[i] += __shfl_xor_sync(0xffffffffu, vu[i], off);
        }
        if (lane == 0) {
          ss_r[warp * kWarpRows + i] = ss[i];
          vu_r[warp * kWarpRows + i] = vu[i];
        }
      }
    }
    __syncthreads();  // every read of Knm is done
    store_a<G>(A, acc);  // V over Knm

    // 3. VG = V Gs in registers; rowdot(VG, V) and the per-row chain, in
    //    every lane of the warp that owns the row
    zero_acc<G>(acc);
    for (int s = 0; s < n_slices; ++s) {
      cp_async_wait<kRing - 2>();
      __syncthreads();
      fetch();
      mma_slice<G>(acc, A + s * kBK * kAStride, ring + read_stage * kStage);
      read_stage = read_stage + 1 == kRing ? 0 : read_stage + 1;
    }
    float is[kWarpRows], isy[kWarpRows], rb[kWarpRows];
    {
      float vgv[kWarpRows];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) vgv[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * G; ++j) {
        float v[kWarpRows];
        load_a_column<G>(v, A, j);
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) vgv[i] += acc[i][j] * v[i];
      }
      float l_rb = 0.f, l_sb = 0.f;
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          vgv[i] += __shfl_xor_sync(0xffffffffu, vgv[i], off);
        const int r = warp * kWarpRows + i;
        const long long row = row0 + r;
        const float mk_r = row < n ? (mask ? mask[row] : 1.0f) : 0.0f;
        const float yv = row < n ? y[row] : 0.0f;
        const float vu = vu_r[r];
        const bool live = mk_r > 0.0f;
        const float rr = sf2 - ss_r[r];
        const float s = live ? rr + sigma2 : 1.0f;
        is[i] = mk_r / s;
        const float isb = yv * vu + 0.5f * vgv[i] + yiy_bar * yv * yv + isr_bar * rr;
        const float sb = live ? (lds_bar * mk_r - isb * is[i]) / s : 0.0f;
        rb[i] = sb + isr_bar * is[i];
        isy[i] = is[i] * yv;
        if (lane == i && y_bar != nullptr && row < n)
          y_bar[row] = is[i] * vu + 2.0f * yiy_bar * isy[i];
        l_rb += rb[i];
        l_sb += sb;
      }
      if (lane == 0) {
        red[warp * 2 + 0] = l_rb;
        red[warp * 2 + 1] = l_sb;
      }
    }

    // 4. Vb = is VG + (is y) ub' - 2 V rb in registers, then into A in
    //    place (k-major) and into R (row-major)
#pragma unroll
    for (int j = 0; j < 2 * G; ++j) {
      const float ubj = ub[column<G>(j)];
      float v[kWarpRows];
      load_a_column<G>(v, A, j);
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        acc[i][j] = is[i] * acc[i][j] + isy[i] * ubj - 2.0f * v[i] * rb[i];
    }
    __syncthreads();  // every read of V is done
    store_a<G>(A, acc);
    store_rows<G>(R, acc, mp);
    if (tid == 0) {
      for (int c = 0; c < 2; ++c) {
        float tsum = 0.0f;
        for (int w8 = 0; w8 < kThreads / 32; ++w8) tsum += red[w8 * 2 + c];
        two_sum(s_hi[c], s_lo[c], tsum);
      }
    }

    // 5. Kb = Vb U^-T in registers
    zero_acc<G>(acc);
    for (int s = 0; s < n_slices; ++s) {
      cp_async_wait<kRing - 2>();
      __syncthreads();
      fetch();
      mma_lower<G>(acc, A + s * kBK * kAStride, ring + read_stage * kStage, s * kBK);
      read_stage = read_stage + 1 == kRing ? 0 : read_stage + 1;
    }
    __syncthreads();  // every read of Vb in A is done: A is free

    // 6. c = Kb * Knm: Kb to A row-major (a thread reads back only what it
    //    wrote), Knm again in registers, c over Kb; then caug += c' [x | 1 |
    //    xx], each thread its fixed entries (4 columns of c by one column of
    //    [x | 1 | xx]), held (d + 2, mp)
    store_rows<G>(A, acc, mp);
    {
      float x2[kWarpRows];
      form_knm<G>(acc, x2, xs, Zt, z2, d, m, q, log_sf2);
    }
    mul_rows<G>(acc, A, mp);
    store_rows<G>(A, acc, mp);
    __syncthreads();  // c is complete
    for (int e = tid; e < naug4; e += kThreads) {
      const int k = e / (mp / 4), j = 4 * (e % (mp / 4));
      const float* col = k < d ? xs + k * kRows : xx;  // k == d: ones
      const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 h = zero4, l = zero4;  // loaded ahead of the sums they wait for
      if (!first) {
        h = ca4[e];
        l = ca4[naug4 + e];
      }
      float4 sum[2] = {zero4, zero4};  // 2 chains: the FMAs do not wait on one sum
      for (int r = 0; r < kRows; r += 2) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float4 c = *reinterpret_cast<const float4*>(&A[(r + u) * mp + j]);
          const float a = k == d ? 1.0f : col[r + u];
          sum[u].x += c.x * a;
          sum[u].y += c.y * a;
          sum[u].z += c.z * a;
          sum[u].w += c.w * a;
        }
      }
      two_sum(h.x, l.x, sum[0].x + sum[1].x);
      two_sum(h.y, l.y, sum[0].y + sum[1].y);
      two_sum(h.z, l.z, sum[0].z + sum[1].z);
      two_sum(h.w, l.w, sum[0].w + sum[1].w);
      ca4[e] = h;
      ca4[naug4 + e] = l;
    }
    __syncthreads();  // every read of c is done

    // 7. Knm once more, to A row-major; the upper 8 x 8 blocks of Knm' Vb
    //    (A' R) into this CTA's partial
    {
      float x2[kWarpRows];
      form_knm<G>(acc, x2, xs, Zt, z2, d, m, q, log_sf2);
    }
    store_rows<G>(A, acc, mp);
    if (share > 1 && tid == 0) {
      while (load_acquire(turn + part_id) != ticket) __nanosleep(64);
    }
    __syncthreads();
    add_gram<true, kBatch>(A, nullptr, mp, ui, ticket == 0, R);
    if (share > 1) {
      __threadfence();  // this thread's part of the update, before the ticket
      __syncthreads();
      if (tid == 0) store_release(turn + part_id, ticket + 1);
    }
    ticket += sharing;
    first = false;
  }
  cp_async_wait<0>();

  if (tid == 0) {
    float* sp = sums_part + (size_t)blockIdx.x * 4;
    for (int c = 0; c < 2; ++c) {
      sp[c] = s_hi[c];
      sp[2 + c] = s_lo[c];
    }
  }
}

// ----------------------------------------------------------------- wide route

namespace wide {

constexpr int kPanel = 128;   // product panel width: 16 columns a warp, 4 a lane
constexpr int kChunk = 16;    // weight rows of a panel staged at once
constexpr int kWideRing = 3;  // stages of the weight chunk ring
constexpr int kCaug = 4;      // entries of c' [X | 1 | xx] a thread updates at once

enum Tri { kFull, kUpper, kLower };

// Shared memory at R rows a tile, in floats: two (R x mp) tiles | kWideRing
// weight chunks (kChunk x kPanel) | |z|^2, ub (2 mp) | x tile (R x d) |
// |x|^2, is, is*y, rb (4 R) | scalar reduction (8 warps x 2).
__host__ __device__ inline size_t smem_floats(int m, int d, int R) {
  const int mp = round_up(m, kBlk);
  return 2 * (size_t)R * mp + (size_t)kWideRing * kChunk * kPanel + 2 * (size_t)mp +
         (size_t)R * d + 4 * R + 2 * (kThreads / 32);
}

// Rows a tile at (m, d): the largest of 32, 24, 16 and 8 whose shared memory
// fits (8 where none does: the wrapper refuses that).
inline int rows(int m, int d) {
  constexpr int kChoices[] = {32, 24, 16};
  for (int R : kChoices) {
    if (fits(smem_floats(m, d, R))) return R;
  }
  return 8;
}

// The rows [k0, k1) of W that column panel j0 of a product needs.
template <Tri kTri>
__device__ __forceinline__ void panel_rows(int j0, int m, int& k0, int& k1) {
  k0 = kTri == kLower ? j0 : 0;
  k1 = kTri == kUpper ? round_up(min(j0 + kPanel, m), 4) : round_up(m, 4);
}

// out = in W (kMul: out = (in W) * out, entry by entry) for one (R, mp)
// tile; W is (m, m) row-major in device memory, streamed through the ring
// Wp in kPanel-column panels of kChunk rows a step, kWideRing - 1 steps
// (panel, chunk) ahead.  kUpper: W is upper triangular (column j needs rows
// k <= j); kLower: lower (rows k >= j).  Only that triangle of W is read.
// Columns >= m of out are zero.  Warp w owns the panel's columns 16 w ..
// 16 w + 15 for every row; lane l four of them (4 (l % 4) on) for R / 8
// rows (R / 8 * (l / 4) on): each float4 of W in shared memory then serves
// R / 8 rows, and each float4 of in four columns.  in and out are distinct
// tiles; a lane reads back only the out entries it writes (kMul).  Returns
// after a barrier.
template <Tri kTri, int R, bool kMul = false>
__device__ void tile_gemm(const float* __restrict__ in, float* __restrict__ out,
                          const float* __restrict__ W, int m, int mp, float* Wp) {
  constexpr int kLaneRows = R / 8;  // 8 row groups: lane / 4
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (lane >> 2) * kLaneRows;
  const int col = (tid >> 5) * 16 + (lane & 3) * 4;  // in the panel
  const int wcol = (tid >> 5) * 16;                  // the warp's first, in the panel
  int ij0 = 0, ic, ik1, stage_w = 0;  // the next step to issue
  panel_rows<kTri>(0, m, ic, ik1);
  auto issue = [&]() {
    if (ij0 < mp) {
      const int c1 = min(ic + kChunk, ik1);
      float* dst = Wp + stage_w * kChunk * kPanel;
      for (int e = tid; e < (c1 - ic) * kPanel; e += kThreads) {
        const int k = ic + e / kPanel, j = ij0 + e % kPanel;
        const bool nz = k < m && j < m &&
                        (kTri == kFull || (kTri == kUpper ? k <= j : k >= j));
        cp_async4(dst + e, nz ? W + (size_t)k * m + j : W, nz);
      }
      ic = c1;
      if (ic == ik1) {
        ij0 += kPanel;
        panel_rows<kTri>(ij0, m, ic, ik1);
      }
      stage_w = stage_w + 1 == kWideRing ? 0 : stage_w + 1;
    }
    cp_async_commit();
  };
  __syncthreads();  // the input tile is written; the last product left Wp
  for (int s = 0; s < kWideRing - 1; ++s) issue();
  int stage_r = 0;
  for (int j0 = 0; j0 < mp; j0 += kPanel) {  // j0 < m: mp - j0 >= 8
    int k0, k1;
    panel_rows<kTri>(j0, m, k0, k1);
    float acc[kLaneRows][4];
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    for (int c0 = k0; c0 < k1; c0 += kChunk) {
      const int c1 = min(c0 + kChunk, k1);
      cp_async_wait<kWideRing - 2>();
      // This step's chunk is in for every thread; the stage the next issue
      // overwrites was read by all at the last step.
      __syncthreads();
      issue();
      const float* wp = Wp + stage_r * kChunk * kPanel + col;
      stage_r = stage_r + 1 == kWideRing ? 0 : stage_r + 1;
      // A warp whose 16 columns the chunk holds only zeros for (past m, or
      // on the zero side of W's triangle) skips it: the same sums.
      const int wc0 = j0 + wcol;
      if (wc0 >= m || (kTri == kUpper && c0 > wc0 + 15) || (kTri == kLower && c1 <= wc0))
        continue;
      // each chunk sums into its own partial, added to acc after it (as in
      // the forward wide route)
      float part[kLaneRows][4];
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
      for (int k = c0; k < c1; k += 4) {
        float4 a[kLaneRows];
#pragma unroll
        for (int i = 0; i < kLaneRows; ++i)
          a[i] = *reinterpret_cast<const float4*>(&in[(row0 + i) * mp + k]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 w = *reinterpret_cast<const float4*>(wp + (k - c0 + t) * kPanel);
#pragma unroll
          for (int i = 0; i < kLaneRows; ++i) {
            const float av = t == 0 ? a[i].x : t == 1 ? a[i].y : t == 2 ? a[i].z : a[i].w;
            part[i][0] += av * w.x;
            part[i][1] += av * w.y;
            part[i][2] += av * w.z;
            part[i][3] += av * w.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += part[i][c];
    }
    const int j = j0 + col;  // a multiple of 4, and mp of 8: all four or none
    if (j < mp) {
#pragma unroll
      for (int i = 0; i < kLaneRows; ++i) {
        float4* o = reinterpret_cast<float4*>(&out[(row0 + i) * mp + j]);
        float4 v = make_float4(j < m ? acc[i][0] : 0.0f, j + 1 < m ? acc[i][1] : 0.0f,
                               j + 2 < m ? acc[i][2] : 0.0f, j + 3 < m ? acc[i][3] : 0.0f);
        if (kMul) {
          const float4 b = *o;
          v = make_float4(v.x * b.x, v.y * b.y, v.z * b.z, v.w * b.w);
        }
        *o = v;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int R>
__global__ void __launch_bounds__(kThreads)
se_iso_bwd_kernel_wide(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ mask, const float* __restrict__ z,
                  const float* __restrict__ u_inv, const float* __restrict__ u_inv_t,
                  const float* __restrict__ gs, const float* __restrict__ ubar,
                  long long n, int d, int m, float q, float log_sf2, float sigma2,
                  float lds_bar, float yiy_bar, float isr_bar, int tiles_per_cta,
                  long long n_tiles, float* __restrict__ ui_part,
                  float* __restrict__ caug_part, float* __restrict__ sums_part,
                  float* __restrict__ y_bar) {
  constexpr int kWarpRows = R / (kThreads / 32);  // rows per warp
  extern __shared__ float4 smem4[];
  const int mp = round_up(m, kBlk);
  float* A = reinterpret_cast<float*>(smem4);  // Knm, then VG, then Vb
  float* B = A + (size_t)R * mp;               // V, then Knm, then c
  float* Wp = B + (size_t)R * mp;
  float* z2 = Wp + kWideRing * kChunk * kPanel;
  float* ub = z2 + mp;
  float* xs = ub + mp;
  float* xx = xs + R * d;
  float* is_r = xx + R;
  float* isy_r = is_r + R;
  float* rb_r = isy_r + R;
  float* red = rb_r + R;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb8 = mp / kBlk;
  const int nblk = nb8 * (nb8 + 1) / 2;
  const int naug = m * (d + 2);
  const float sf2 = expf(log_sf2);

  for (int j = tid; j < mp; j += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < d && j < m; ++k) {
      float v = z[(size_t)j * d + k];
      acc += v * v;
    }
    z2[j] = acc;
    ub[j] = j < m ? ubar[j] : 0.0f;
  }

  // scalar carries live in thread 0: [sum rb, sum sb] as (hi, lo)
  float s_hi[2] = {0.f, 0.f};
  float s_lo[2] = {0.f, 0.f};

  const long long t0 = (long long)blockIdx.x * tiles_per_cta;
  long long t1 = t0 + tiles_per_cta;
  if (t1 > n_tiles) t1 = n_tiles;
  float* ui = ui_part + (size_t)blockIdx.x * 2 * nblk * kBlk * kBlk;
  float* ca = caug_part + (size_t)blockIdx.x * 2 * naug;

  for (long long t = t0; t < t1; ++t) {
    const long long row0 = t * R;
    const bool first = t == t0;
    __syncthreads();  // previous tile fully consumed; z2/ub written

    // 1. x tile and |x|^2
    for (int e = tid; e < R * d; e += kThreads) {
      long long row = row0 + e / d;
      xs[e] = row < n ? X[row * d + e % d] : 0.0f;
    }
    __syncthreads();
    if (tid < R) {
      float acc = 0.0f;
      for (int k = 0; k < d; ++k) acc += xs[tid * d + k] * xs[tid * d + k];
      xx[tid] = acc;
    }
    __syncthreads();

    // 2. Knm tile into A; columns >= m are zero
    auto form_knm = [&](float* K) {
      for (int e = tid; e < R * mp; e += kThreads) {
        int r = e / mp, j = e % mp;
        float val = 0.0f;
        if (j < m) {
          float xz = 0.0f;
          for (int k = 0; k < d; ++k) xz += xs[r * d + k] * __ldg(z + (size_t)j * d + k);
          float d2 = fmaxf(xx[r] - 2.0f * xz + z2[j], 0.0f);
          val = expf(log_sf2 + q * d2);
        }
        K[e] = val;
      }
    };
    form_knm(A);

    // 3. V = Knm U^-1 into B, then VG = V Gs over Knm
    tile_gemm<kUpper, R>(A, B, u_inv, m, mp, Wp);
    tile_gemm<kFull, R>(B, A, gs, m, mp, Wp);

    // 4. the per-row chain (each warp owns kWarpRows rows)
    float l_rb = 0.f, l_sb = 0.f;
    for (int i = 0; i < kWarpRows; ++i) {
      const int r = warp * kWarpRows + i;
      float ss = 0.f, vu = 0.f, vgv = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float v = B[r * mp + j];
        ss += v * v;
        vu += v * ub[j];
        vgv += A[r * mp + j] * v;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        vu += __shfl_xor_sync(0xffffffffu, vu, off);
        vgv += __shfl_xor_sync(0xffffffffu, vgv, off);
      }
      if (lane == 0) {
        const long long row = row0 + r;
        const float mk_r = row < n ? (mask ? mask[row] : 1.0f) : 0.0f;
        const float yv = row < n ? y[row] : 0.0f;
        const bool live = mk_r > 0.0f;
        const float rr = sf2 - ss;
        const float s = live ? rr + sigma2 : 1.0f;
        const float is = mk_r / s;
        const float isb = yv * vu + 0.5f * vgv + yiy_bar * yv * yv + isr_bar * rr;
        const float sb = live ? (lds_bar * mk_r - isb * is) / s : 0.0f;
        const float rb = sb + isr_bar * is;
        is_r[r] = is;
        isy_r[r] = is * yv;
        rb_r[r] = rb;
        if (y_bar != nullptr && row < n) y_bar[row] = is * vu + 2.0f * yiy_bar * (is * yv);
        l_rb += rb;
        l_sb += sb;
      }
    }
    if (lane == 0) {
      red[warp * 2 + 0] = l_rb;
      red[warp * 2 + 1] = l_sb;
    }
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < 2; ++c) {
        float tsum = 0.0f;
        for (int w8 = 0; w8 < kThreads / 32; ++w8) tsum += red[w8 * 2 + c];
        two_sum(s_hi[c], s_lo[c], tsum);
      }
    }

    // 5. Vb = is VG + (is y) ub' - 2 V rb, in place over VG
    for (int e = tid; e < R * mp; e += kThreads) {
      const int r = e / mp, j = e % mp;
      A[e] = is_r[r] * A[e] + isy_r[r] * ub[j] - 2.0f * B[e] * rb_r[r];
    }
    __syncthreads();  // every read of V is done

    // 6. Knm again, over V
    form_knm(B);
    __syncthreads();

    // 7. upper 8 x 8 blocks of Knm' Vb into this CTA's partial (reads B, A),
    //    kBatch float4 pairs in flight a thread, as on the tiled route
    add_gram<true, kBatch, R>(B, nullptr, mp, ui, first, A);

    // 8. c = (Vb U^-T) * Knm over Knm (tile_gemm starts and ends with a
    //    barrier: the triangle update is done before c goes over Knm)
    tile_gemm<kLower, R, true>(A, B, u_inv_t, m, mp, Wp);

    // 9. caug += c' [x | 1 | xx]; each thread owns fixed entries, kCaug at
    //    a time, their partial's reads in flight together
    for (int e0 = tid; e0 < naug; e0 += kCaug * kThreads) {
      float acc[kCaug], h[kCaug], l[kCaug];
#pragma unroll
      for (int u = 0; u < kCaug; ++u) {
        const int e = e0 + u * kThreads;
        acc[u] = h[u] = l[u] = 0.0f;
        if (e >= naug) continue;
        const int j = e / (d + 2), k = e % (d + 2);
        for (int r = 0; r < R; ++r) {
          const float a = k < d ? xs[r * d + k] : (k == d ? 1.0f : xx[r]);
          acc[u] += B[r * mp + j] * a;
        }
        if (!first) {
          h[u] = __ldcg(ca + e);
          l[u] = __ldcg(ca + naug + e);
        }
      }
#pragma unroll
      for (int u = 0; u < kCaug; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= naug) continue;
        if (!first) two_sum(h[u], l[u], acc[u]);
        ca[e] = first ? acc[u] : h[u];
        ca[naug + e] = l[u];
      }
    }
  }

  if (tid == 0) {
    float* sp = sums_part + (size_t)blockIdx.x * 4;
    for (int c = 0; c < 2; ++c) {
      sp[c] = s_hi[c];
      sp[2 + c] = s_lo[c];
    }
  }
}

}  // namespace wide

inline size_t smem_bytes(int m, int d) {
  return (route_groups(m, d) ? tiled_smem_floats(m, d)
                             : wide::smem_floats(m, d, wide::rows(m, d))) *
         sizeof(float);
}

template <int R>
int launch_wide(const float* X, const float* y, const float* mask, const float* z,
                const float* u_inv, const float* u_inv_t, const float* gs, const float* ubar,
                long long n, int d, int m, float q, float log_sf2, float sigma2, float lds_bar,
                float yiy_bar, float isr_bar, int n_ctas, int tiles_per_cta, float* ui_part,
                float* caug_part, float* sums_part, float* y_bar, cudaStream_t stream) {
  const size_t bytes = wide::smem_floats(m, d, R) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wide::se_iso_bwd_kernel_wide<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + R - 1) / R;
  wide::se_iso_bwd_kernel_wide<R><<<n_ctas, kThreads, bytes, stream>>>(
      X, y, mask, z, u_inv, u_inv_t, gs, ubar, n, d, m, q, log_sf2, sigma2, lds_bar, yiy_bar,
      isr_bar, tiles_per_cta, n_tiles, ui_part, caug_part, sums_part, y_bar);
  return (int)cudaGetLastError();
}

template <int G>
int launch_tiled(const float* X, const float* y, const float* mask, const float* z,
                 const float* u_inv, const float* u_inv_t, const float* gs, const float* ubar,
                 long long n, int d, int m, float q, float log_sf2, float sigma2, float lds_bar,
                 float yiy_bar, float isr_bar, int n_ctas, int share, int* turn, float* ui_part,
                 float* caug_part, float* sums_part, float* y_bar, cudaStream_t stream) {
  if (share < 1 || (share > 1 && turn == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t bytes = tiled_smem_floats(m, d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      se_iso_bwd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  long long n_tiles = (n + kRows - 1) / kRows;
  if (share == 1) {
    se_iso_bwd_kernel<G><<<n_ctas, kThreads, bytes, stream>>>(
        X, y, mask, z, u_inv, u_inv_t, gs, ubar, n, d, m, q, log_sf2, sigma2, lds_bar,
        yiy_bar, isr_bar, n_tiles, share, turn, ui_part, caug_part, sums_part, y_bar);
    return (int)cudaGetLastError();
  }
  // CTAs that wait for one another: all of them must be running
  void* args[] = {&X, &y, &mask, &z, &u_inv, &u_inv_t, &gs, &ubar, &n, &d, &m, &q,
                  &log_sf2, &sigma2, &lds_bar, &yiy_bar, &isr_bar, &n_tiles, &share, &turn,
                  &ui_part, &caug_part, &sums_part, &y_bar};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(se_iso_bwd_kernel<G>), dim3(n_ctas),
                                    dim3(kThreads), args, bytes, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per tile of the tiled route; the wrapper sizes the grid from it.
int se_iso_bwd_rows_per_tile() { return kRows; }

// Rows per tile of the wide route at (m, d): 32, 24, 16 or 8.
int se_iso_bwd_wide_rows(int m, int d) { return wide::rows(m, d); }

// The route at (m, d): G = ceil(m / 64) of the tiled route, or 0 for the wide
// route.
int se_iso_bwd_groups(int m, int d) { return route_groups(m, d); }

// Dynamic shared memory one CTA of the route at (m, d) needs, in bytes.
long long se_iso_bwd_smem_bytes(int m, int d) { return (long long)smem_bytes(m, d); }

// The tiled route's n_ctas CTAs stride over the ceil(n / 64) row tiles
// (n_ctas <= tiles; tiles_per_cta is not read), and each `share` >= 1 of them
// take turns on one partial of the U^-1 cotangent: n_parts = ceil(n_ctas /
// share); for share > 1, turn (n_parts ints) must be zero, and the launch is
// cooperative (every CTA must fit on the device at once).  On the wide route
// CTA c walks tiles [c * tiles_per_cta, (c + 1) * tiles_per_cta) of the
// ceil(n / R) row tiles, R = se_iso_bwd_wide_rows(m, d), every CTA must own at least one tile, n_parts =
// n_ctas, and share and turn are not read.
// u_inv (upper triangular) and u_inv_t = u_inv' are (m, m); g is Gs = Gb +
// Gb' (m, m); ubar is (m,).
// Outputs, hi then lo, over the nblk = nb8 (nb8 + 1) / 2 upper 8 x 8 blocks
// (row-major order) of Knm' Vb padded to mp = 8 nb8 >= m:
//   ui_part   (n_parts, 2, 16, nblk, 4): float4 v (entries v / 2,
//             4 (v % 2) .. + 3) of block b at [v][b];
//   caug_part c' [X | 1 | xx]: tiled (n_ctas, 2, d + 2, mp), zero for columns
//             >= m; wide (n_ctas, 2, m, d + 2);
//   sums_part (n_ctas, 2, 2): [sum rb, sum sb].
// y_bar (n,) is written when not NULL; mask may be NULL (all rows live).
// Returns cudaGetLastError() of the launch.
int se_iso_bwd_acc(const float* X, const float* y, const float* mask, const float* z,
                   const float* u_inv, const float* u_inv_t, const float* g,
                   const float* ubar, long long n, int d, int m, float q, float log_sf2,
                   float sigma2, float lds_bar, float yiy_bar, float isr_bar, int n_ctas,
                   int tiles_per_cta, int share, int* turn, float* ui_part, float* caug_part,
                   float* sums_part, float* y_bar, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  static_assert(kMaxBwdGroups == 5, "one case per G below");
#define TILED(G)                                                                             \
  case G:                                                                                    \
    return launch_tiled<G>(X, y, mask, z, u_inv, u_inv_t, g, ubar, n, d, m, q, log_sf2,      \
                           sigma2, lds_bar, yiy_bar, isr_bar, n_ctas, share, turn, ui_part,  \
                           caug_part, sums_part, y_bar, s)
  switch (route_groups(m, d)) {
    TILED(1);
    TILED(2);
    TILED(3);
    TILED(4);
    TILED(5);
    default: break;
  }
#undef TILED
#define WIDE(R)                                                                              \
  case R:                                                                                    \
    return launch_wide<R>(X, y, mask, z, u_inv, u_inv_t, g, ubar, n, d, m, q, log_sf2,        \
                          sigma2, lds_bar, yiy_bar, isr_bar, n_ctas, tiles_per_cta, ui_part, \
                          caug_part, sums_part, y_bar, s)
  switch (wide::rows(m, d)) {
    WIDE(32);
    WIDE(24);
    WIDE(16);
    WIDE(8);
    default: break;
  }
#undef WIDE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
