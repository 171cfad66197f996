// Forward statistics of the streaming SE-iso FITC evidence, by hand for
// Hopper (sm_90a).
//
// Replaces the two Pallas forward kernels of gpr_tpu/ops/fused_stats.py:
//   se_iso_stats_acc      <- _se_iso_stats_kernel_acc (se_iso_stream_stats_fused_acc)
//   se_iso_stats_partials <- _se_iso_stats_kernel     (se_iso_stream_stats_fused)
//
// For rows x_i (masked by mask_i) and inducing points z_j:
//   Knm = exp(log_sf2 + q * max(|x|^2 - 2 x.z + |z|^2, 0)),  q = -1/(2 ell^2)
//   V   = Knm U^-1,   r = sf2 - rowsq(V),   s = r + sigma2 (1 where masked)
//   is  = mask / s,   w = sqrt(is)
//   G  += (V w)'(V w),  u += V'(is y),
//   [sum mask log s, sum is y^2, sum is r, sum mask]
// Nothing n x m leaves the SM: each Knm / V row tile lives in registers and
// shared memory only, as the Pallas kernel kept it in VMEM.
//
// What bounds it on this card.  Per row, about m (d + m/2) FMAs for Knm and
// V and (m + 1)^2 / 2 for the Gram, all plain FP32 on the CUDA cores: no
// TF32, no tensor cores, no fast-math (the f32 evidence is only as good as
// the Knm/V entries, gpr_tpu/config.py:51-59).  The FP32 FMA rate bounds it
// (~2 n m (d + 2m) flop per pass); reading X is 32 bytes a row.
//
// Two routes, picked from (m, d) by the host function, never from a failure.
//
// The tiled route (m <= 383 and its shared memory within the 227 KB a block
// may opt into): se_iso_stats_kernel<G, kComp>, G = ceil((m + 1) / 64), on
// the register-tiled FP32 loop of csrc/fp32_tile.cuh (the GEMM chain's).
//   * One CTA per SM strides over the 64-row tiles.  U^-1 is the same for
//     every tile, so it streams in 16-row slices through one 2-stage
//     cp.async ring that runs on across tiles; a tile's x rides in its first
//     slice's stage, transposed by 4-byte copies.  The next tile's first
//     slice is in flight while this tile's row sums and Gram run.  (A third
//     stage is 3 % faster without the fold below, whose B needs its 22 KB.)
//   * Knm is formed in registers, in the product loop's layout (x Z' over d
//     from the x tile and Z^T, then the kernel entry by entry with the same
//     expression and operation order as the wide route), and goes to A
//     k-major (A[j][r], zero for j >= m) by store_a.  Formed element by
//     element from shared memory instead, it cost 1.7 ms more a pass at
//     m = 300 (ops/stats_variants.py measures each such choice).
//   * V = Knm U^-1 is mma_slice<G>: a warp owns 8 whole rows, a lane 2 G
//     columns of each, in registers.  U^-1 must be upper triangular (the
//     copies read whole rows; the wrapper passes triu(u_inv)): a slice from
//     row k0 on is zero left of column k0, so the lane column quads wholly
//     left of it skip their FFMAs (mma_upper).
//   * rowsq(V) is a register sum and 5 xor shuffles a row; then r, s, is, w.
//   * A' = [V w | w y | 0] goes from registers to the A buffer, row-major
//     with row stride mp = round_up(m + 1, 8), after one barrier: the Gram's
//     per-thread 8 x 8 blocks read rows.
//   * The fold: where a second A' tile, B, fits in shared memory too (G <= 5
//     at d = 8), every other tile's A' goes to B and waits, and the Gram
//     update runs over both tiles' 128 rows.  That halves the partial's
//     read-modify-write traffic (below), which cost a third of the kernel's
//     time at m = 300 when every tile paid it.
//
// The wide route (every other m, up to about m = 5,980 at any d):
// se_iso_stats_kernel_wide<R, kComp>, the first kernel.  A CTA walks a
// contiguous chunk of tiles_per_cta tiles of R rows, R the largest of 64,
// 48, 32, 24, 16 and 8 whose (R, mp) tile fits in shared memory (64 up to
// about m = 810, 48 up to about 1,080).  V is formed in place over the Knm
// tile, panel by panel from the right, against 32-column panels of U^-1
// (half the flops of a full product; only the upper triangle of u_inv is
// read) that stream in 64-row chunks through a 2-stage cp.async ring, the
// next chunk in flight while this one is multiplied, so no m x m operand
// need fit in the SM.  Each chunk sums into its own partial of V, so the
// rounding grows with m / 64 + 64 terms, not m.  Knm reads z from device
// memory (L1 and L2 hold it), so d bounds only the x tile.  Each Gram
// update reads and writes the whole m x m partial for R rows: at m = 1,000
// and R = 48 that traffic, not the FFMAs, bounds it.
//
// Both routes:
//   * The TPU ran its grid in order and carried sums in VMEM.  Here each CTA
//     writes ONE partial; the wrapper reduces the partials in f64 (no float
//     atomics: they are neither deterministic nor compensable).
//   * The m x m Gram does not fit in one SM (360 KB at m = 300).  A CTA adds
//     A'A block by block (8 x 8 register blocks, upper triangle only, u as
//     column m) into its partial in device memory, read-modify-write per
//     update: 190 KB (380 KB as hi/lo) a CTA at m = 300, 50 MB for 132 CTAs
//     as hi/lo, the whole L2.
//   * Rows >= n are masked in the kernel (no host padding), and columns >= m
//     of the tile are zero.
//   * se_iso_stats_acc accumulates each Gram entry, u and the four scalars
//     as two-sum (hi, lo) pairs across its tiles; se_iso_stats_partials adds
//     the Gram plainly (the wrapper sums its partials in f64).  Both
//     compensate the scalars.  Two-sum has no products, so FMA contraction
//     cannot break it; its adds are written in the order they must run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stats_tile.cuh"

namespace {

constexpr int kPanel = 32;  // wide route: V panel width (one column per lane)
constexpr int kChunk = 64;  // wide route: U^-1 rows of a panel staged at once
constexpr int kWideRing = 2;  // wide route: stages of the U^-1 chunk ring
// wide route: float4 pairs in flight in the compensated Gram write-back (the
// tiled route prefetches instead; at m = 1,000 this was 19 % faster)
constexpr int kWideBatch = 8;
constexpr int kMaxTiledM = kGroup * kMaxGroups - 1;  // column m (u) in the last group
constexpr int kRing = 2;    // tiled route: stages of the U^-1 ring

// Wide route shared memory at R rows a tile, in floats: tile (R x mp) |
// kWideRing U^-1 chunks (kChunk x kPanel) | |z|^2 (mp) | x tile (R x d) |
// w, w*y (2 R) | scalar reduction (8 warps x 4).
__host__ __device__ inline size_t wide_smem_floats(int m, int d, int R) {
  int mp = round_up(m + 1, kBlk);
  return (size_t)R * mp + (size_t)kWideRing * kChunk * kPanel + mp + (size_t)R * d + 2 * R +
         32;
}

// Rows a tile of the wide route at (m, d): the largest of 64, 48, 32, 24, 16
// and 8 whose shared memory fits (8 where none does: the wrapper refuses
// that).
inline int wide_rows(int m, int d) {
  constexpr int kChoices[] = {64, 48, 32, 24, 16};
  for (int R : kChoices) {
    if (fits(wide_smem_floats(m, d, R))) return R;
  }
  return 8;
}

__host__ __device__ inline int tiled_groups(int m) { return (m + kGroup) / kGroup; }

// Floats of one tiled ring stage: a U^-1 slice (kBK x 64 G) and an x tile
// (d x kRows, transposed).
__host__ __device__ inline size_t tiled_stage_floats(int G, int d) {
  return (size_t)kBK * kGroup * G + (size_t)d * kRows;
}

// Tiled route shared memory, in floats: A (64 G x kAStride) | kRing stages |
// Z^T (d x 64 G) | |z|^2 (64 G) | scalar reduction (8 warps x 4) | when
// fold, B (kRows x mp): the held A' of every other tile.
__host__ __device__ inline size_t tiled_smem_floats(int m, int d, bool fold) {
  const int G = tiled_groups(m), width = kGroup * G;
  return (size_t)width * kAStride + kRing * tiled_stage_floats(G, d) + (size_t)d * width +
         width + 32 + (fold ? (size_t)kRows * round_up(m + 1, kBlk) : 0);
}

// G of the tiled route at (m, d), or 0 for the wide route.
inline int route_groups(int m, int d) {
  if (m < 1 || m > kMaxTiledM) return 0;
  return fits(tiled_smem_floats(m, d, false)) ? tiled_groups(m) : 0;
}

// Whether the tiled route at (m, d) folds two tiles into each Gram update.
inline bool route_fold(int m, int d) {
  return route_groups(m, d) && fits(tiled_smem_floats(m, d, true));
}

inline size_t smem_bytes(int m, int d) {
  return (route_groups(m, d) ? tiled_smem_floats(m, d, route_fold(m, d))
                             : wide_smem_floats(m, d, wide_rows(m, d))) *
         sizeof(float);
}

// r, s, is and w of one row from ss = rowsq(V): returns w, sets wy = w y and,
// when acc, adds the row's terms to l = [lds, yiy, isr, cnt].
__device__ __forceinline__ float row_weight(float ss, long long row, long long n,
                                            const float* __restrict__ y,
                                            const float* __restrict__ mask, float sf2,
                                            float sigma2, float& wy, float (&l)[4], bool acc) {
  const float mk_r = row < n ? (mask ? mask[row] : 1.0f) : 0.0f;
  const float yv = row < n ? y[row] : 0.0f;
  const bool live = mk_r > 0.0f;
  const float rr = sf2 - ss;
  const float s = live ? rr + sigma2 : 1.0f;
  const float is = mk_r / s;
  const float w = live ? sqrtf(is) : 0.0f;
  wy = w * yv;
  if (acc) {
    l[0] += mk_r * logf(s);
    l[1] += is * yv * yv;
    l[2] += is * rr;
    l[3] += mk_r;
  }
  return w;
}

// Thread 0 folds the 8 warps' scalar sums in red into its (hi, lo) carries.
__device__ __forceinline__ void fold_scalars(const float* red, float (&s_hi)[4],
                                             float (&s_lo)[4]) {
  for (int c = 0; c < 4; ++c) {
    float tsum = 0.0f;
    for (int w8 = 0; w8 < kThreads / 32; ++w8) tsum += red[w8 * 4 + c];
    two_sum(s_hi[c], s_lo[c], tsum);
  }
}

__device__ __forceinline__ void write_scalars(float* __restrict__ sums_part,
                                              const float (&s_hi)[4], const float (&s_lo)[4]) {
  float* sp = sums_part + (size_t)blockIdx.x * 8;
  for (int c = 0; c < 4; ++c) {
    sp[c] = s_hi[c];
    sp[4 + c] = s_lo[c];
  }
}

// ---------------------------------------------------------------- tiled route

template <int G, bool kComp>
__global__ void __launch_bounds__(kThreads, 1)
se_iso_stats_kernel(const float* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ mask, const float* __restrict__ z,
                    const float* __restrict__ u_inv, long long n, int d, int m, float q,
                    float log_sf2, float sigma2, long long n_tiles, bool fold,
                    float* __restrict__ gram_part, float* __restrict__ sums_part) {
  constexpr int kWidth = kGroup * G;
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);
  float* ring = A + kWidth * kAStride;
  const int stage = (int)tiled_stage_floats(G, d);
  float* Zt = ring + kRing * stage;
  float* z2 = Zt + d * kWidth;
  float* red = z2 + kWidth;
  float* B = red + 32;  // when fold

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mp = round_up(m + 1, kBlk);
  const int n_slices = (m + kBK - 1) / kBK;
  const float sf2 = expf(log_sf2);
  const bool vec_u = m % 4 == 0 && (reinterpret_cast<uintptr_t>(u_inv) & 15) == 0;

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
  }

  // The ring: one commit group per step (empty past the last step), so
  // wait_group<kRing - 2> at step q means step q's copies have landed.
  // Steps run over (tile, slice); the issue side runs kRing - 1 steps ahead
  // of the compute side.
  long long issue_tile = blockIdx.x;
  int issue_slice = 0, issue_stage = 0;
  auto issue = [&]() {
    if (issue_tile < n_tiles) {
      float* st = ring + issue_stage * stage;
      load_w<G>(st, u_inv, m, issue_slice * kBK, vec_u);
      if (issue_slice == 0) load_x_tile(st + kBK * kWidth, X, issue_tile * kRows, n, d);
      if (++issue_slice == n_slices) {
        issue_slice = 0;
        issue_tile += gridDim.x;
      }
      issue_stage = issue_stage + 1 == kRing ? 0 : issue_stage + 1;
    }
    cp_async_commit();
  };
  for (int s = 0; s < kRing - 1; ++s) issue();

  // scalar carries live in thread 0: [lds, yiy, isr, cnt] as (hi, lo)
  float s_hi[4] = {0.f, 0.f, 0.f, 0.f};
  float s_lo[4] = {0.f, 0.f, 0.f, 0.f};
  const int nblk = (mp / kBlk) * (mp / kBlk + 1) / 2;
  float* part = gram_part + (size_t)blockIdx.x * (kComp ? 2 : 1) * nblk * kBlk * kBlk;

  int read_stage = 0;
  bool held = false, first = true;  // B holds the last tile's A'; no update yet
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kRows;

    // 1. Knm into A, k-major (rows j >= m zero), from registers: x Z' in
    //    the product loop's layout (8 rows x 2 G columns a thread, over d),
    //    then the kernel entry by entry.
    cp_async_wait<kRing - 2>();
    __syncthreads();  // this tile's x is in; the last tile's A' is consumed
    if (!first && (!fold || held || t + gridDim.x >= n_tiles))
      prefetch_block<kComp>(part, nblk, tid);  // this tile updates: its first round
    {
      const float* xs = ring + read_stage * stage + kBK * kWidth;
      float acc[kWarpRows][2 * G], x2[kWarpRows];
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
      store_a<G>(A, acc);
    }

    // 2. V = Knm U^-1 in registers, U^-1 through the ring
    float acc[kWarpRows][2 * G];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
      for (int j = 0; j < 2 * G; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < n_slices; ++s) {
      cp_async_wait<kRing - 2>();
      // This step's slice is in for every thread; the stage the next issue
      // overwrites was read by all at the last step; Knm is written.
      __syncthreads();
      issue();
      mma_upper<G>(acc, A + s * kBK * kAStride, ring + read_stage * stage, s * kBK);
      read_stage = read_stage + 1 == kRing ? 0 : read_stage + 1;
    }

    // 3. per-row r, s, is, w from rowsq(V) (columns >= m of V are zero);
    //    lane 0 of each warp sums its 8 rows' scalar terms
    float w[kWarpRows], wy[kWarpRows];
    float l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < 2 * G; ++j) ss += acc[i][j] * acc[i][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      w[i] = row_weight(ss, row0 + warp * kWarpRows + i, n, y, mask, sf2, sigma2, wy[i], l,
                        lane == 0);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp * 4 + c] = l[c];
    }

    // 4. A' = [V w | w y | 0], over the Knm tile or, to be held for the
    //    next tile's update, into B
#pragma unroll
    for (int j = 0; j < 2 * G; ++j) {
      const bool u_col = column<G>(j) == m;
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) acc[i][j] = u_col ? wy[i] : acc[i][j] * w[i];
    }
    const bool hold = fold && !held && t + gridDim.x < n_tiles;
    __syncthreads();  // every read of Knm is done
    store_rows<G>(hold ? B : A, acc, mp);
    __syncthreads();
    if (tid == 0) fold_scalars(red, s_hi, s_lo);
    if (hold) {
      held = true;
      continue;
    }

    // 5. upper 8 x 8 blocks of A'A (of the held tile's rows too) into this
    //    CTA's partial
    add_gram<kComp>(held ? B : A, held ? A : nullptr, mp, part, first);
    held = first = false;
  }
  cp_async_wait<0>();
  if (tid == 0) write_scalars(sums_part, s_hi, s_lo);
}

// ----------------------------------------------------------------- wide route

template <int R, bool kComp>
__global__ void __launch_bounds__(kThreads, 1)  // the grid is one CTA an SM
se_iso_stats_kernel_wide(const float* __restrict__ X, const float* __restrict__ y,
                         const float* __restrict__ mask, const float* __restrict__ z,
                         const float* __restrict__ u_inv, long long n, int d, int m, float q,
                         float log_sf2, float sigma2, int tiles_per_cta, long long n_tiles,
                         float* __restrict__ gram_part, float* __restrict__ sums_part) {
  constexpr int kWR = R / (kThreads / 32);  // rows a warp
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int mp = round_up(m + 1, kBlk);
  float* Up = S + (size_t)R * mp;
  float* z2 = Up + kWideRing * kChunk * kPanel;
  float* xs = z2 + mp;
  float* wrow = xs + R * d;
  float* wyrow = wrow + R;
  float* red = wyrow + R;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb8 = mp / kBlk;
  const int nblk = nb8 * (nb8 + 1) / 2;
  const float sf2 = expf(log_sf2);

  for (int j = tid; j < mp; j += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < d && j < m; ++k) {
      float v = z[(size_t)j * d + k];
      acc += v * v;
    }
    z2[j] = acc;
  }

  // scalar carries live in thread 0: [lds, yiy, isr, cnt] as (hi, lo)
  float s_hi[4] = {0.f, 0.f, 0.f, 0.f};
  float s_lo[4] = {0.f, 0.f, 0.f, 0.f};

  const long long t0 = (long long)blockIdx.x * tiles_per_cta;
  long long t1 = t0 + tiles_per_cta;
  if (t1 > n_tiles) t1 = n_tiles;
  float* part = gram_part + (size_t)blockIdx.x * (kComp ? 2 : 1) * nblk * kBlk * kBlk;

  for (long long t = t0; t < t1; ++t) {
    const long long row0 = t * R;
    __syncthreads();  // previous tile fully consumed; z2 written

    // 1. x tile and |x|^2
    for (int e = tid; e < R * d; e += kThreads) {
      long long row = row0 + e / d;
      xs[e] = row < n ? X[row * d + e % d] : 0.0f;
    }
    __syncthreads();
    if (tid < R) {
      float acc = 0.0f;
      for (int k = 0; k < d; ++k) acc += xs[tid * d + k] * xs[tid * d + k];
      wyrow[tid] = acc;  // |x|^2, until step 4 overwrites it
    }
    __syncthreads();

    // 2. Knm tile; columns >= m are zero
    for (int e = tid; e < R * mp; e += kThreads) {
      int r = e / mp, j = e % mp;
      float val = 0.0f;
      if (j < m) {
        float xz = 0.0f;
        for (int k = 0; k < d; ++k) xz += xs[r * d + k] * __ldg(z + (size_t)j * d + k);
        float d2 = fmaxf(wyrow[r] - 2.0f * xz + z2[j], 0.0f);
        val = expf(log_sf2 + q * d2);
      }
      S[e] = val;
    }

    // 3. V = Knm U^-1 in place, panels right to left; each panel's U^-1
    //    rows [0, kk) stream in kChunk-row chunks through the ring, one
    //    step (panel, chunk) ahead.  A warp reads and writes only its own
    //    rows (warp + 8 i), so its V goes over its Knm columns after a warp
    //    barrier.
    const int npan = (m + kPanel - 1) / kPanel;
    int ip = npan - 1, ic = 0, stage_w = 0;  // the next step to issue
    auto issue = [&]() {
      if (ip >= 0) {
        const int j0 = ip * kPanel;
        const int kk = round_up(min(j0 + kPanel, m), 4);
        const int c1 = min(ic + kChunk, kk);
        float* dst = Up + stage_w * kChunk * kPanel;
        for (int e = tid; e < (c1 - ic) * kPanel; e += kThreads) {
          const int k = ic + e / kPanel, j = j0 + e % kPanel;
          const bool ok = j < m && k <= j;
          cp_async4(dst + e, ok ? u_inv + (size_t)k * m + j : u_inv, ok);
        }
        ic = c1;
        if (ic == kk) {
          ic = 0;
          --ip;
        }
        stage_w = stage_w + 1 == kWideRing ? 0 : stage_w + 1;
      }
      cp_async_commit();
    };
    for (int s = 0; s < kWideRing - 1; ++s) issue();
    int stage_r = 0;
    for (int p = npan - 1; p >= 0; --p) {
      const int j0 = p * kPanel;
      const int j1 = min(j0 + kPanel, m);
      const int kk = round_up(j1, 4);
      float acc[kWR];
#pragma unroll
      for (int i = 0; i < kWR; ++i) acc[i] = 0.0f;
      for (int c0 = 0; c0 < kk; c0 += kChunk) {
        const int c1 = min(c0 + kChunk, kk);
        cp_async_wait<kWideRing - 2>();
        // This step's chunk is in for every thread; the stage the next
        // issue overwrites was read by all at the last step; Knm is written.
        __syncthreads();
        issue();
        const float* up = Up + stage_r * kChunk * kPanel;
        stage_r = stage_r + 1 == kWideRing ? 0 : stage_r + 1;
        // each chunk sums into its own partial, added to acc after it: the
        // rounding of V then grows with m / kChunk + kChunk terms, not m
        float part[kWR];
#pragma unroll
        for (int i = 0; i < kWR; ++i) part[i] = 0.0f;
        for (int k = c0; k < c1; k += 4) {
          const float* uc = up + (k - c0) * kPanel;
          float u0 = uc[0 * kPanel + lane];
          float u1 = uc[1 * kPanel + lane];
          float u2 = uc[2 * kPanel + lane];
          float u3 = uc[3 * kPanel + lane];
#pragma unroll
          for (int i = 0; i < kWR; ++i) {
            float4 s4 = *reinterpret_cast<const float4*>(&S[(warp + 8 * i) * mp + k]);
            part[i] += s4.x * u0;
            part[i] += s4.y * u1;
            part[i] += s4.z * u2;
            part[i] += s4.w * u3;
          }
        }
#pragma unroll
        for (int i = 0; i < kWR; ++i) acc[i] += part[i];
      }
      __syncwarp();  // every read of this warp's rows' Knm columns is done
      if (j0 + lane < m) {
#pragma unroll
        for (int i = 0; i < kWR; ++i) S[(warp + 8 * i) * mp + j0 + lane] = acc[i];
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // 4. per-row r, s, is, w; scalar sums (each warp owns kWR rows)
    float l[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < kWR; ++i) {
      const int r = warp * kWR + i;
      float ss = 0.0f;
      for (int j = lane; j < m; j += 32) ss += S[r * mp + j] * S[r * mp + j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (lane == 0) wrow[r] = row_weight(ss, row0 + r, n, y, mask, sf2, sigma2, wyrow[r], l, true);
    }
    if (lane == 0) {
      for (int c = 0; c < 4; ++c) red[warp * 4 + c] = l[c];
    }
    __syncthreads();
    if (tid == 0) fold_scalars(red, s_hi, s_lo);

    // 5. A = [V w | w y | 0]
    for (int e = tid; e < R * mp; e += kThreads) {
      int r = e / mp, j = e % mp;
      if (j < m) S[e] *= wrow[r];
      else if (j == m) S[e] = wyrow[r];
    }
    __syncthreads();

    // 6. upper 8 x 8 blocks of A'A into this CTA's partial
    add_gram<kComp, kWideBatch, R>(S, nullptr, mp, part, t == t0);
  }

  if (tid == 0) write_scalars(sums_part, s_hi, s_lo);
}

template <int G, bool kComp>
int launch_tiled(const float* X, const float* y, const float* mask, const float* z,
                 const float* u_inv, long long n, int d, int m, float q, float log_sf2,
                 float sigma2, int n_ctas, float* gram_part, float* sums_part,
                 cudaStream_t stream) {
  const bool fold = route_fold(m, d);
  const size_t bytes = tiled_smem_floats(m, d, fold) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(se_iso_stats_kernel<G, kComp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + kRows - 1) / kRows;
  se_iso_stats_kernel<G, kComp><<<n_ctas, kThreads, bytes, stream>>>(
      X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, n_tiles, fold, gram_part, sums_part);
  return (int)cudaGetLastError();
}

template <int R, bool kComp>
int launch_wide(const float* X, const float* y, const float* mask, const float* z,
                const float* u_inv, long long n, int d, int m, float q, float log_sf2,
                float sigma2, int n_ctas, int tiles_per_cta, float* gram_part,
                float* sums_part, cudaStream_t stream) {
  const size_t bytes = wide_smem_floats(m, d, R) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      se_iso_stats_kernel_wide<R, kComp>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + R - 1) / R;
  se_iso_stats_kernel_wide<R, kComp><<<n_ctas, kThreads, bytes, stream>>>(
      X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, tiles_per_cta, n_tiles,
      gram_part, sums_part);
  return (int)cudaGetLastError();
}

template <bool kComp>
int launch(const float* X, const float* y, const float* mask, const float* z,
           const float* u_inv, long long n, int d, int m, float q, float log_sf2,
           float sigma2, int n_ctas, int tiles_per_cta, float* gram_part,
           float* sums_part, cudaStream_t stream) {
  static_assert(kMaxGroups == 6, "one case per G below");
#define TILED(G)                                                                            \
  case G:                                                                                   \
    return launch_tiled<G, kComp>(X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, n_ctas, \
                                  gram_part, sums_part, stream)
  switch (route_groups(m, d)) {
    TILED(1);
    TILED(2);
    TILED(3);
    TILED(4);
    TILED(5);
    TILED(6);
    default: break;
  }
#define WIDE(R)                                                                             \
  case R:                                                                                   \
    return launch_wide<R, kComp>(X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, n_ctas,  \
                                 tiles_per_cta, gram_part, sums_part, stream)
  switch (wide_rows(m, d)) {
    WIDE(64);
    WIDE(48);
    WIDE(32);
    WIDE(24);
    WIDE(16);
    WIDE(8);
    default: break;
  }
#undef WIDE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Rows per tile of the tiled route; the wrapper sizes the grid from it.
int se_iso_stats_rows_per_tile() { return kRows; }

// Rows per tile of the wide route at (m, d): 64, 48, 32, 24, 16 or 8.
int se_iso_stats_wide_rows(int m, int d) { return wide_rows(m, d); }

// The route at (m, d): G = ceil((m + 1) / 64) of the tiled route, or 0 for
// the wide route.
int se_iso_stats_groups(int m, int d) { return route_groups(m, d); }

// Dynamic shared memory one CTA of the route at (m, d) needs, in bytes.
long long se_iso_stats_smem_bytes(int m, int d) { return (long long)smem_bytes(m, d); }

const char* se_iso_stats_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The tiled route's n_ctas CTAs stride over the ceil(n / 64) row tiles
// (n_ctas <= tiles; tiles_per_cta is not read); on the wide route CTA c
// reduces tiles [c * tiles_per_cta, (c + 1) * tiles_per_cta) of the
// ceil(n / R) tiles of R = se_iso_stats_wide_rows(m, d) rows, and every CTA
// must own at least one tile.
// gram_part: (n_ctas, 2, 16, nblk, 4) f32, hi then lo: float4 v (entries
// v / 2, 4 (v % 2) .. + 3) of each of the nblk = nb8 (nb8 + 1) / 2 upper 8 x 8
// blocks of the (mp, mp) Gram of [V w | w y], mp = 8 nb8 >= m + 1, the blocks
// in row-major order; sums_part: (n_ctas, 2, 4), hi then lo, of
// [sum mask log s, sum is y^2, sum is r, sum mask].  mask may be NULL (all
// rows live).  u_inv must be upper triangular.  Returns cudaGetLastError() of
// the launch.
int se_iso_stats_acc(const float* X, const float* y, const float* mask,
                     const float* z, const float* u_inv, long long n, int d,
                     int m, float q, float log_sf2, float sigma2, int n_ctas,
                     int tiles_per_cta, float* gram_part, float* sums_part,
                     void* stream) {
  return launch<true>(X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, n_ctas,
                      tiles_per_cta, gram_part, sums_part, (cudaStream_t)stream);
}

// gram_part: (n_ctas, 1, 16, nblk, 4) f32, plain sums; sums_part as above.
int se_iso_stats_partials(const float* X, const float* y, const float* mask,
                          const float* z, const float* u_inv, long long n, int d,
                          int m, float q, float log_sf2, float sigma2, int n_ctas,
                          int tiles_per_cta, float* gram_part, float* sums_part,
                          void* stream) {
  return launch<false>(X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, n_ctas,
                       tiles_per_cta, gram_part, sums_part, (cudaStream_t)stream);
}

}  // extern "C"
