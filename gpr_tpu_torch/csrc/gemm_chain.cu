// A chain of f32 matrix products, out = x W^reps, by hand for Hopper (sm_90a).
//
// Replaces the Pallas roofline kernel k_chain of probes/r3_roofline_probe.py
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
// bounds it.
//
// What the design does about it: nothing beyond the backward kernel's
// product loop, on purpose.  The loop below is csrc/se_iso_bwd.cu's
// tile_gemm<kFull> with the same tile shapes -- a 32-row tile of acc in
// shared memory, 8 warps of 4 rows each, every lane owning 2 columns of a
// 64-column panel of W streamed from L2 through shared memory -- and none of
// the GP algebra around it.  Its rate is therefore the ceiling of that loop
// design: the gap between it and the backward kernel's rate is what the GP
// epilogue and the per-tile partials cost.
//   * Two (32, mp) tiles ping-pong between reps, so the intermediate never
//     leaves the SM; the barrier at the end of each product separates
//     writing one buffer from reading it as the next input.
//   * A W panel is staged row by row (64 consecutive floats of a row of the
//     row-major W per warp-pair: coalesced), so the strided column panel is
//     never read from device memory column-wise.
//   * A warp reads one acc row as float4 at a time: all 32 lanes read the same
//     address (a broadcast, no bank conflict); W panel reads are one float per
//     lane on consecutive words (conflict-free).
//   * At m = 384: 2 x 48 KB of tiles + 96 KB of panel = 192 KB of the 227 KB a
//     block may opt into: one CTA per SM.  CTAs loop over row tiles, so the
//     wrapper launches one CTA per SM, a whole wave.
//   * Columns >= m of both tiles are zero and rows >= n are zero on input and
//     never written, so any n and any m <= 384 (m = 300 needs a panel tail)
//     take the same path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                        // 8 warps
constexpr int kRows = 32;                            // rows per tile
constexpr int kWarpRows = kRows / (kThreads / 32);   // rows per warp
constexpr int kPanel = 64;                           // W panel width
constexpr int kPad = 8;                              // tile column padding

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Shared memory, in floats: two (kRows x mp) tiles | W panel (mk x kPanel).
__host__ __device__ inline size_t smem_floats(int m) {
  const int mp = round_up(m, kPad);
  const int mk = round_up(m, 4);
  return 2 * (size_t)kRows * mp + (size_t)mk * kPanel;
}

// out = in W for one (kRows, mp) tile; W is (m, m) row-major in device
// memory, streamed through shared memory (Wp) in kPanel-column panels.
// Columns >= m of out are zero.  in and out are distinct tiles; returns
// after a barrier.
__device__ void tile_gemm(const float* __restrict__ in, float* __restrict__ out,
                          const float* __restrict__ W, int m, int mp, float* Wp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mk = round_up(m, 4);
  for (int j0 = 0; j0 < mp; j0 += kPanel) {
    __syncthreads();  // the input tile is written; the last panel is consumed
    for (int e = tid; e < mk * kPanel; e += kThreads) {
      const int k = e / kPanel, j = j0 + e % kPanel;
      Wp[e] = k < m && j < m ? W[(size_t)k * m + j] : 0.0f;
    }
    __syncthreads();
    float acc[kWarpRows][2];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) acc[i][0] = acc[i][1] = 0.0f;
    for (int k = 0; k < mk; k += 4) {
      const float* w = Wp + (size_t)k * kPanel;
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
gemm_chain_kernel(const float* __restrict__ x, const float* __restrict__ W,
                  float* __restrict__ out, long long n, int m, int reps,
                  long long n_tiles) {
  extern __shared__ float4 smem4[];
  const int mp = round_up(m, kPad);
  float* A = reinterpret_cast<float*>(smem4);
  float* B = A + (size_t)kRows * mp;
  float* Wp = B + (size_t)kRows * mp;
  const int tid = threadIdx.x;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    __syncthreads();  // the previous tile's result is written out
    for (int e = tid; e < kRows * mp; e += kThreads) {
      const long long row = row0 + e / mp;
      const int j = e % mp;
      A[e] = row < n && j < m ? x[row * m + j] : 0.0f;
    }
    float* cur = A;
    float* nxt = B;
    for (int r = 0; r < reps; ++r) {
      tile_gemm(cur, nxt, W, m, mp, Wp);  // ends with a barrier
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    for (int e = tid; e < kRows * m; e += kThreads) {
      const long long row = row0 + e / m;
      if (row < n) out[row * m + e % m] = cur[(e / m) * mp + e % m];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs at m, in bytes.
long long gemm_chain_smem_bytes(int m) {
  return (long long)(smem_floats(m) * sizeof(float));
}

// out (n, m) = x (n, m) W^reps, W (m, m), all row-major f32, reps >= 1;
// n_ctas CTAs stride over the ceil(n / 32) row tiles.  Returns
// cudaGetLastError() of the launch.
int gemm_chain(const float* x, const float* W, float* out, long long n, int m, int reps,
               int n_ctas, void* stream) {
  const size_t bytes = smem_floats(m) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (n + kRows - 1) / kRows;
  gemm_chain_kernel<<<n_ctas, kThreads, bytes, (cudaStream_t)stream>>>(x, W, out, n, m, reps,
                                                                      n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
