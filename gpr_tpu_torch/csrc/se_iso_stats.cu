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
// Nothing n x m leaves the SM: each Knm / V row tile lives in shared memory
// only, as the Pallas kernel kept it in VMEM.
//
// What bounds it on this card.  Per row, about m (d + m/2) FMAs for Knm and
// V and (m + 1)^2 / 2 for the Gram, all plain FP32 on the CUDA cores: no
// TF32, no tensor cores, no fast-math (the f32 evidence is only as good as
// the Knm/V entries, gpr_tpu/config.py:51-59).  The FP32 FMA rate bounds it
// (~2 n m (d + 2m) flop per pass); reading X is 32 bytes a row.
//
// What the design does about it.
//   * The TPU ran its grid in order and carried sums in VMEM.  Here each CTA
//     walks a contiguous chunk of 64-row tiles (the wrapper's block_size
//     rows) and writes ONE partial; the wrapper reduces the partials in f64
//     (no float atomics: they are neither deterministic nor compensable).
//   * The m x m Gram does not fit in one SM (360 KB at m = 300).  A CTA
//     keeps the (64, mp) tile A = [V w | w y | 0] in shared memory and adds
//     A'A block by block (8 x 8 register blocks, upper triangle only, u as
//     column m) into its partial in device memory, read-modify-write per
//     tile: 190 KB (380 KB as hi/lo) a CTA at m = 300, which the 50 MB L2
//     holds for about one wave of CTAs.
//   * U^-1 is upper triangular, so column j of V needs Knm columns <= j.
//     V is formed IN PLACE over Knm, panel by panel from the right, with
//     the U^-1 panel streamed through shared memory: half the flops of a
//     full GEMM and no second (64, m) buffer.  Only the upper triangle of
//     u_inv is read.
//   * Rows >= n are masked in the kernel (no host padding), and columns
//     >= m of the tile are zero.
//   * se_iso_stats_acc accumulates each Gram entry, u and the four scalars
//     as two-sum (hi, lo) pairs across its tiles; se_iso_stats_partials
//     adds the Gram plainly (the wrapper sums its partials in f64).  Both
//     compensate the scalars.  Two-sum has no products, so FMA contraction
//     cannot break it; its adds are written in the order they must run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // rows per tile
constexpr int kPanel = 32;     // V panel width (one column per lane)
constexpr int kBlk = 8;        // Gram register block edge

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ inline void two_sum(float& hi, float& lo, float x) {
  float s = hi + x;
  float bp = s - hi;
  float err = (hi - (s - bp)) + (x - bp);
  hi = s;
  lo = lo + err;
}

// Shared memory, in floats: tile (kRows x mp) | U^-1 panel (mk x kPanel) |
// Z^T (d x mp) | |z|^2 (mp) | x tile (kRows x d) | w, w*y (2 kRows) |
// scalar reduction (8 warps x 4).
__host__ __device__ inline size_t smem_floats(int m, int d) {
  int mp = round_up(m + 1, kBlk);
  int mk = round_up(m, 4);
  return (size_t)kRows * mp + (size_t)mk * kPanel + (size_t)d * mp + mp +
         (size_t)kRows * d + 2 * kRows + 32;
}

template <bool kComp>
__global__ void __launch_bounds__(kThreads)
se_iso_stats_kernel(const float* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ mask, const float* __restrict__ z,
                    const float* __restrict__ u_inv, long long n, int d, int m,
                    float q, float log_sf2, float sigma2, int tiles_per_cta,
                    long long n_tiles, float* __restrict__ gram_part,
                    float* __restrict__ sums_part) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);
  const int mp = round_up(m + 1, kBlk);
  const int mk = round_up(m, 4);
  float* Up = S + (size_t)kRows * mp;
  float* Zt = Up + (size_t)mk * kPanel;
  float* z2 = Zt + (size_t)d * mp;
  float* xs = z2 + mp;
  float* wrow = xs + kRows * d;
  float* wyrow = wrow + kRows;
  float* red = wyrow + kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nb8 = mp / kBlk;
  const int nblk = nb8 * (nb8 + 1) / 2;
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
  }

  // scalar carries live in thread 0: [lds, yiy, isr, cnt] as (hi, lo)
  float s_hi[4] = {0.f, 0.f, 0.f, 0.f};
  float s_lo[4] = {0.f, 0.f, 0.f, 0.f};

  const long long t0 = (long long)blockIdx.x * tiles_per_cta;
  long long t1 = t0 + tiles_per_cta;
  if (t1 > n_tiles) t1 = n_tiles;
  float* part = gram_part + (size_t)blockIdx.x * (kComp ? 2 : 1) * nblk * kBlk * kBlk;

  for (long long t = t0; t < t1; ++t) {
    const long long row0 = t * kRows;
    __syncthreads();  // previous tile fully consumed; Zt/z2 written

    // 1. x tile and |x|^2
    for (int e = tid; e < kRows * d; e += kThreads) {
      long long row = row0 + e / d;
      xs[e] = row < n ? X[row * d + e % d] : 0.0f;
    }
    __syncthreads();
    if (tid < kRows) {
      float acc = 0.0f;
      for (int k = 0; k < d; ++k) acc += xs[tid * d + k] * xs[tid * d + k];
      wyrow[tid] = acc;  // |x|^2, until step 4 overwrites it
    }
    __syncthreads();

    // 2. Knm tile; columns >= m are zero
    for (int e = tid; e < kRows * mp; e += kThreads) {
      int r = e / mp, j = e % mp;
      float val = 0.0f;
      if (j < m) {
        float xz = 0.0f;
        for (int k = 0; k < d; ++k) xz += xs[r * d + k] * Zt[k * mp + j];
        float d2 = fmaxf(wyrow[r] - 2.0f * xz + z2[j], 0.0f);
        val = expf(log_sf2 + q * d2);
      }
      S[e] = val;
    }

    // 3. V = Knm U^-1 in place, panels right to left
    const int npan = (m + kPanel - 1) / kPanel;
    for (int p = npan - 1; p >= 0; --p) {
      const int j0 = p * kPanel;
      const int j1 = min(j0 + kPanel, m);
      const int kk = round_up(j1, 4);
      __syncthreads();  // Knm written / previous panel stored
      for (int e = tid; e < kk * kPanel; e += kThreads) {
        int k = e / kPanel, j = j0 + e % kPanel;
        Up[e] = (j < m && k <= j) ? u_inv[(size_t)k * m + j] : 0.0f;
      }
      __syncthreads();
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      for (int k = 0; k < kk; k += 4) {
        float u0 = Up[(k + 0) * kPanel + lane];
        float u1 = Up[(k + 1) * kPanel + lane];
        float u2 = Up[(k + 2) * kPanel + lane];
        float u3 = Up[(k + 3) * kPanel + lane];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float4 s4 = *reinterpret_cast<const float4*>(&S[(warp + 8 * i) * mp + k]);
          acc[i] += s4.x * u0;
          acc[i] += s4.y * u1;
          acc[i] += s4.z * u2;
          acc[i] += s4.w * u3;
        }
      }
      __syncthreads();  // every read of this panel's Knm columns is done
      if (j0 + lane < m) {
#pragma unroll
        for (int i = 0; i < 8; ++i) S[(warp + 8 * i) * mp + j0 + lane] = acc[i];
      }
    }
    __syncthreads();

    // 4. per-row r, s, is, w; scalar sums (each warp owns 8 rows)
    float l_lds = 0.f, l_yiy = 0.f, l_isr = 0.f, l_cnt = 0.f;
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
      float ss = 0.0f;
      for (int j = lane; j < m; j += 32) ss += S[r * mp + j] * S[r * mp + j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (lane == 0) {
        const long long row = row0 + r;
        const float mk_r = row < n ? (mask ? mask[row] : 1.0f) : 0.0f;
        const float yv = row < n ? y[row] : 0.0f;
        const bool live = mk_r > 0.0f;
        const float rr = sf2 - ss;
        const float s = live ? rr + sigma2 : 1.0f;
        const float is = mk_r / s;
        const float w = live ? sqrtf(is) : 0.0f;
        wrow[r] = w;
        wyrow[r] = w * yv;
        l_lds += mk_r * logf(s);
        l_yiy += is * yv * yv;
        l_isr += is * rr;
        l_cnt += mk_r;
      }
    }
    if (lane == 0) {
      red[warp * 4 + 0] = l_lds;
      red[warp * 4 + 1] = l_yiy;
      red[warp * 4 + 2] = l_isr;
      red[warp * 4 + 3] = l_cnt;
    }
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < 4; ++c) {
        float tsum = 0.0f;
        for (int w8 = 0; w8 < kThreads / 32; ++w8) tsum += red[w8 * 4 + c];
        two_sum(s_hi[c], s_lo[c], tsum);
      }
    }

    // 5. A = [V w | w y | 0]
    for (int e = tid; e < kRows * mp; e += kThreads) {
      int r = e / mp, j = e % mp;
      if (j < m) S[e] *= wrow[r];
      else if (j == m) S[e] = wyrow[r];
    }
    __syncthreads();

    // 6. upper 8 x 8 blocks of A'A into this CTA's partial
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
        const float4* ra = reinterpret_cast<const float4*>(&S[r * mp + bi * kBlk]);
        const float4* rb = reinterpret_cast<const float4*>(&S[r * mp + bj * kBlk]);
        float4 a0 = ra[0], a1 = ra[1], b0 = rb[0], b1 = rb[1];
        float av[kBlk] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[kBlk] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kBlk; ++i)
#pragma unroll
          for (int j = 0; j < kBlk; ++j) acc[i][j] += av[i] * bv[j];
      }
      float4* hi4 = reinterpret_cast<float4*>(part + (size_t)b * kBlk * kBlk);
      float4* lo4 = reinterpret_cast<float4*>(part + ((size_t)nblk + b) * kBlk * kBlk);
#pragma unroll
      for (int v = 0; v < kBlk * kBlk / 4; ++v) {
        const int i = v / 2, j = (v % 2) * 4;
        float4 tv = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
        if (t == t0) {
          hi4[v] = tv;
          if (kComp) lo4[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else if (kComp) {
          float4 h = hi4[v], l = lo4[v];
          two_sum(h.x, l.x, tv.x);
          two_sum(h.y, l.y, tv.y);
          two_sum(h.z, l.z, tv.z);
          two_sum(h.w, l.w, tv.w);
          hi4[v] = h;
          lo4[v] = l;
        } else {
          float4 h = hi4[v];
          h.x += tv.x;
          h.y += tv.y;
          h.z += tv.z;
          h.w += tv.w;
          hi4[v] = h;
        }
      }
    }
  }

  if (tid == 0) {
    float* sp = sums_part + (size_t)blockIdx.x * 8;
    for (int c = 0; c < 4; ++c) {
      sp[c] = s_hi[c];
      sp[4 + c] = s_lo[c];
    }
  }
}

template <bool kComp>
int launch(const float* X, const float* y, const float* mask, const float* z,
           const float* u_inv, long long n, int d, int m, float q, float log_sf2,
           float sigma2, int n_ctas, int tiles_per_cta, float* gram_part,
           float* sums_part, cudaStream_t stream) {
  const size_t bytes = smem_floats(m, d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      se_iso_stats_kernel<kComp>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + kRows - 1) / kRows;
  se_iso_stats_kernel<kComp><<<n_ctas, kThreads, bytes, stream>>>(
      X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, tiles_per_cta, n_tiles,
      gram_part, sums_part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile; the wrapper sizes the grid and the partials from it.
int se_iso_stats_rows_per_tile() { return kRows; }

// Dynamic shared memory one CTA needs at (m, d), in bytes.
long long se_iso_stats_smem_bytes(int m, int d) {
  return (long long)(smem_floats(m, d) * sizeof(float));
}

const char* se_iso_stats_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// CTA c reduces tiles [c * tiles_per_cta, (c + 1) * tiles_per_cta) of the
// ceil(n / 64) row tiles; every CTA must own at least one tile.
// gram_part: (n_ctas, 2, nblk, 8, 8) f32, hi then lo, nblk = nb8 (nb8 + 1) / 2
// upper 8 x 8 blocks of the (mp, mp) Gram of [V w | w y], mp = 8 nb8 >= m + 1,
// in row-major order; sums_part: (n_ctas, 2, 4), hi then lo, of
// [sum mask log s, sum is y^2, sum is r, sum mask].  mask may be NULL (all
// rows live).  Returns cudaGetLastError() of the launch.
int se_iso_stats_acc(const float* X, const float* y, const float* mask,
                     const float* z, const float* u_inv, long long n, int d,
                     int m, float q, float log_sf2, float sigma2, int n_ctas,
                     int tiles_per_cta, float* gram_part, float* sums_part,
                     void* stream) {
  return launch<true>(X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, n_ctas,
                      tiles_per_cta, gram_part, sums_part, (cudaStream_t)stream);
}

// gram_part: (n_ctas, 1, nblk, 8, 8) f32, plain sums; sums_part as above.
int se_iso_stats_partials(const float* X, const float* y, const float* mask,
                          const float* z, const float* u_inv, long long n, int d,
                          int m, float q, float log_sf2, float sigma2, int n_ctas,
                          int tiles_per_cta, float* gram_part, float* sums_part,
                          void* stream) {
  return launch<false>(X, y, mask, z, u_inv, n, d, m, q, log_sf2, sigma2, n_ctas,
                       tiles_per_cta, gram_part, sums_part, (cudaStream_t)stream);
}

}  // extern "C"
