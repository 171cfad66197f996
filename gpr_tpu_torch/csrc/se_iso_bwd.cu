// Backward of the streaming SE-iso FITC statistics, by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas backward tile of gpr_tpu/ops/fused_stats.py:
//   se_iso_bwd_acc <- _se_iso_bwd_kernel_acc (se_iso_stream_bwd_fused)
//
// Given the cotangents (Gb, ub, ldsb, yiyb, isrb) of the forward statistics
// (csrc/se_iso_stats.cu), UG = U^-1 (Gb + Gb') and U^-T (both formed once by
// the wrapper), each row tile recomputes and chains:
//   Knm = exp(log_sf2 + q d2),  V = Knm U^-1,  VG = Knm UG
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
// What the design does about it.
//   * The TPU carried z_bar, U^-1 bar and the scalars across an ordered
//     grid.  Here each CTA walks a contiguous chunk of 32-row tiles (the
//     wrapper's block_size rows) and writes ONE compensated partial; the
//     wrapper folds hi + lo and reduces the partials in f64.  No float
//     atomics, so runs are deterministic.
//   * Three (32, mp) f32 tiles stay live in shared memory: Knm; V, reused
//     for Kb and then for c; VG, overwritten in place by Vb.  At m = 300
//     that is 116,736 bytes, plus a (300, 64) panel of the weight matrix
//     being multiplied (76,800 bytes), Z' (9,728) and the small vectors:
//     207,296 bytes of the 232,448 a block may opt into.  64-row tiles
//     would need 233,472 bytes for the three tiles alone.
//   * U^-1 is upper triangular: V reads only its upper triangle and Kb
//     only the lower triangle of U^-T (half the flops of a full product
//     each).  Only the upper triangle of Knm' Vb is accumulated (8 x 8
//     register blocks, upper ones only): the triangular solve that forms
//     U^-1 reads no other part of its cotangent.
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

namespace {

constexpr int kThreads = 256;                        // 8 warps
constexpr int kRows = 32;                            // rows per tile
constexpr int kWarpRows = kRows / (kThreads / 32);   // rows per warp
constexpr int kPanel = 64;                           // product panel width
constexpr int kBlk = 8;                              // U^-1 bar block edge

enum Tri { kFull, kUpper, kLower };

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ inline void two_sum(float& hi, float& lo, float x) {
  float s = hi + x;
  float bp = s - hi;
  float err = (hi - (s - bp)) + (x - bp);
  hi = s;
  lo = lo + err;
}

// Shared memory, in floats: three (kRows x mp) tiles | weight panel
// (mk x kPanel) | Z^T (d x mp) | |z|^2, ub (2 mp) | x tile (kRows x d) |
// |x|^2, is, is*y, rb (4 kRows) | scalar reduction (8 warps x 2).
__host__ __device__ inline size_t smem_floats(int m, int d) {
  const int mp = round_up(m, kBlk);
  const int mk = round_up(m, 4);
  return 3 * (size_t)kRows * mp + (size_t)mk * kPanel + (size_t)d * mp +
         2 * (size_t)mp + (size_t)kRows * d + 4 * kRows + 2 * (kThreads / 32);
}

// out = in W for one (kRows, mp) tile; W is (m, m) row-major in device
// memory, streamed through shared memory (Wp) in kPanel-column panels.
// kUpper: W is upper triangular (column j needs rows k <= j); kLower: lower
// (rows k >= j).  Only that triangle of W is read.  Columns >= m of out are
// zero.  in and out are distinct tiles; returns after a barrier.
template <Tri kTri>
__device__ void tile_gemm(const float* __restrict__ in, float* __restrict__ out,
                          const float* __restrict__ W, int m, int mp, float* Wp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mk = round_up(m, 4);
  for (int j0 = 0; j0 < mp; j0 += kPanel) {  // j0 < m: mp - j0 >= 8
    const int k0 = kTri == kLower ? j0 : 0;
    const int k1 = kTri == kUpper ? round_up(min(j0 + kPanel, m), 4) : mk;
    __syncthreads();  // the input tile is written; the last panel is consumed
    for (int e = tid; e < (k1 - k0) * kPanel; e += kThreads) {
      const int k = k0 + e / kPanel, j = j0 + e % kPanel;
      const bool nz = k < m && j < m &&
                      (kTri == kFull || (kTri == kUpper ? k <= j : k >= j));
      Wp[e] = nz ? W[(size_t)k * m + j] : 0.0f;
    }
    __syncthreads();
    float acc[kWarpRows][2];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) acc[i][0] = acc[i][1] = 0.0f;
    for (int k = k0; k < k1; k += 4) {
      const float* w = Wp + (size_t)(k - k0) * kPanel;
      float w0[4], w1[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        w0[t] = w[t * kPanel + lane];
        w1[t] = w[t * kPanel + 32 + lane];
      }
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(&in[(warp * kWarpRows + i) * mp + k]);
        acc[i][0] += a.x * w0[0];
        acc[i][0] += a.y * w0[1];
        acc[i][0] += a.z * w0[2];
        acc[i][0] += a.w * w0[3];
        acc[i][1] += a.x * w1[0];
        acc[i][1] += a.y * w1[1];
        acc[i][1] += a.z * w1[2];
        acc[i][1] += a.w * w1[3];
      }
    }
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const int row = warp * kWarpRows + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + 32 * h + lane;
        if (j < mp) out[row * mp + j] = j < m ? acc[i][h] : 0.0f;
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
se_iso_bwd_kernel(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ mask, const float* __restrict__ z,
                  const float* __restrict__ u_inv, const float* __restrict__ u_inv_t,
                  const float* __restrict__ ug, const float* __restrict__ ubar,
                  long long n, int d, int m, float q, float log_sf2, float sigma2,
                  float lds_bar, float yiy_bar, float isr_bar, int tiles_per_cta,
                  long long n_tiles, float* __restrict__ ui_part,
                  float* __restrict__ caug_part, float* __restrict__ sums_part,
                  float* __restrict__ y_bar) {
  extern __shared__ float4 smem4[];
  const int mp = round_up(m, kBlk);
  const int mk = round_up(m, 4);
  float* A = reinterpret_cast<float*>(smem4);  // Knm
  float* B = A + (size_t)kRows * mp;           // V, then Kb, then c
  float* C = B + (size_t)kRows * mp;           // VG, then Vb
  float* Wp = C + (size_t)kRows * mp;
  float* Zt = Wp + (size_t)mk * kPanel;
  float* z2 = Zt + (size_t)d * mp;
  float* ub = z2 + mp;
  float* xs = ub + mp;
  float* xx = xs + kRows * d;
  float* is_r = xx + kRows;
  float* isy_r = is_r + kRows;
  float* rb_r = isy_r + kRows;
  float* red = rb_r + kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb8 = mp / kBlk;
  const int nblk = nb8 * (nb8 + 1) / 2;
  const int naug = m * (d + 2);
  const float sf2 = expf(log_sf2);

  for (int e = tid; e < d * mp; e += kThreads) {
    int k = e / mp, j = e % mp;
    Zt[e] = j < m ? z[(size_t)j * d + k] : 0.0f;
  }
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
    const long long row0 = t * kRows;
    const bool first = t == t0;
    __syncthreads();  // previous tile fully consumed; Zt/z2/ub written

    // 1. x tile and |x|^2
    for (int e = tid; e < kRows * d; e += kThreads) {
      long long row = row0 + e / d;
      xs[e] = row < n ? X[row * d + e % d] : 0.0f;
    }
    __syncthreads();
    if (tid < kRows) {
      float acc = 0.0f;
      for (int k = 0; k < d; ++k) acc += xs[tid * d + k] * xs[tid * d + k];
      xx[tid] = acc;
    }
    __syncthreads();

    // 2. Knm tile; columns >= m are zero
    for (int e = tid; e < kRows * mp; e += kThreads) {
      int r = e / mp, j = e % mp;
      float val = 0.0f;
      if (j < m) {
        float xz = 0.0f;
        for (int k = 0; k < d; ++k) xz += xs[r * d + k] * Zt[k * mp + j];
        float d2 = fmaxf(xx[r] - 2.0f * xz + z2[j], 0.0f);
        val = expf(log_sf2 + q * d2);
      }
      A[e] = val;
    }

    // 3. V = Knm U^-1 and VG = Knm UG
    tile_gemm<kUpper>(A, B, u_inv, m, mp, Wp);
    tile_gemm<kFull>(A, C, ug, m, mp, Wp);

    // 4. the per-row chain (each warp owns kWarpRows rows)
    float l_rb = 0.f, l_sb = 0.f;
    for (int i = 0; i < kWarpRows; ++i) {
      const int r = warp * kWarpRows + i;
      float ss = 0.f, vu = 0.f, vgv = 0.f;
      for (int j = lane; j < m; j += 32) {
        const float v = B[r * mp + j];
        ss += v * v;
        vu += v * ub[j];
        vgv += C[r * mp + j] * v;
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
    for (int e = tid; e < kRows * mp; e += kThreads) {
      const int r = e / mp, j = e % mp;
      C[e] = is_r[r] * C[e] + isy_r[r] * ub[j] - 2.0f * B[e] * rb_r[r];
    }

    // 6. Kb = Vb U^-T over V
    tile_gemm<kLower>(C, B, u_inv_t, m, mp, Wp);

    // 7. c = Kb * Knm over Kb
    for (int e = tid; e < kRows * mp; e += kThreads) B[e] *= A[e];

    // 8. upper 8 x 8 blocks of Knm' Vb into this CTA's partial (reads A, C)
    for (int b = tid; b < nblk; b += kThreads) {
      int bi = 0, rem = b;
      while (rem >= nb8 - bi) {
        rem -= nb8 - bi;
        ++bi;
      }
      const int bj = bi + rem;
      float acc[kBlk][kBlk];
#pragma unroll
      for (int i = 0; i < kBlk; ++i)
#pragma unroll
        for (int j = 0; j < kBlk; ++j) acc[i][j] = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        const float4* ra = reinterpret_cast<const float4*>(&A[r * mp + bi * kBlk]);
        const float4* rc = reinterpret_cast<const float4*>(&C[r * mp + bj * kBlk]);
        float4 a0 = ra[0], a1 = ra[1], c0 = rc[0], c1 = rc[1];
        float av[kBlk] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float cv[kBlk] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < kBlk; ++i)
#pragma unroll
          for (int j = 0; j < kBlk; ++j) acc[i][j] += av[i] * cv[j];
      }
      float4* hi4 = reinterpret_cast<float4*>(ui + (size_t)b * kBlk * kBlk);
      float4* lo4 = reinterpret_cast<float4*>(ui + ((size_t)nblk + b) * kBlk * kBlk);
#pragma unroll
      for (int v = 0; v < kBlk * kBlk / 4; ++v) {
        const int i = v / 2, j = (v % 2) * 4;
        float4 tv = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
        if (first) {
          hi4[v] = tv;
          lo4[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          float4 h = hi4[v], l = lo4[v];
          two_sum(h.x, l.x, tv.x);
          two_sum(h.y, l.y, tv.y);
          two_sum(h.z, l.z, tv.z);
          two_sum(h.w, l.w, tv.w);
          hi4[v] = h;
          lo4[v] = l;
        }
      }
    }
    __syncthreads();  // c is complete

    // 9. caug += c' [x | 1 | xx]; each thread owns fixed entries
    for (int e = tid; e < naug; e += kThreads) {
      const int j = e / (d + 2), k = e % (d + 2);
      float acc = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        const float a = k < d ? xs[r * d + k] : (k == d ? 1.0f : xx[r]);
        acc += B[r * mp + j] * a;
      }
      if (first) {
        ca[e] = acc;
        ca[naug + e] = 0.0f;
      } else {
        float h = ca[e], l = ca[naug + e];
        two_sum(h, l, acc);
        ca[e] = h;
        ca[naug + e] = l;
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

}  // namespace

extern "C" {

// Rows per tile; the wrapper sizes the grid from it.
int se_iso_bwd_rows_per_tile() { return kRows; }

// Dynamic shared memory one CTA needs at (m, d), in bytes.
long long se_iso_bwd_smem_bytes(int m, int d) {
  return (long long)(smem_floats(m, d) * sizeof(float));
}

// CTA c walks tiles [c * tiles_per_cta, (c + 1) * tiles_per_cta) of the
// ceil(n / 32) row tiles; every CTA must own at least one tile.
// u_inv (upper) and u_inv_t = u_inv' are (m, m); ug = U^-1 (Gb + Gb') is
// (m, m); ubar is (m,).  Outputs, hi then lo:
//   ui_part   (n_ctas, 2, nblk, 8, 8): upper 8 x 8 blocks of Knm' Vb over
//             mp = round_up(m, 8), row-major, nblk = nb8 (nb8 + 1) / 2;
//   caug_part (n_ctas, 2, m, d + 2): c' [X | 1 | xx];
//   sums_part (n_ctas, 2, 2): [sum rb, sum sb].
// y_bar (n,) is written when not NULL; mask may be NULL (all rows live).
// Returns cudaGetLastError() of the launch.
int se_iso_bwd_acc(const float* X, const float* y, const float* mask, const float* z,
                   const float* u_inv, const float* u_inv_t, const float* ug,
                   const float* ubar, long long n, int d, int m, float q, float log_sf2,
                   float sigma2, float lds_bar, float yiy_bar, float isr_bar, int n_ctas,
                   int tiles_per_cta, float* ui_part, float* caug_part, float* sums_part,
                   float* y_bar, void* stream) {
  const size_t bytes = smem_floats(m, d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      se_iso_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + kRows - 1) / kRows;
  se_iso_bwd_kernel<<<n_ctas, kThreads, bytes, (cudaStream_t)stream>>>(
      X, y, mask, z, u_inv, u_inv_t, ug, ubar, n, d, m, q, log_sf2, sigma2, lds_bar,
      yiy_bar, isr_bar, tiles_per_cta, n_tiles, ui_part, caug_part, sums_part, y_bar);
  return (int)cudaGetLastError();
}

}  // extern "C"
