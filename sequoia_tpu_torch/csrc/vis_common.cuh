// Pieces shared by the two K1 kernels, vis_blocks.cu (f32, CUDA cores) and
// vis_wgmma.cu (bf16, tensor cores): the GEMM epilogue kinds and the three
// small kernels between the GEMMs.  Each small kernel waits on the launch
// before it and lets the next one start (griddepcontrol, hopper.cuh); both
// are no-ops unless the kernel is launched with programmatic stream
// serialization, as vis_wgmma.cu launches it.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace sq {
namespace vis {

enum Epi { E_LOCAL = 0, E_STORE_F32 = 1, E_COMBINE = 2, E_PROJ = 3, E_FF1 = 4, E_FF2 = 5 };

constexpr float LN_EPS = 1e-5f;

// xs = round(x + pos), both f32 (pallas_vis.py:186)
template <class T>
__global__ void vis_init(const float* __restrict__ x, const float* __restrict__ pos,
                         T* __restrict__ xs, int n) {
  hopper::griddep_wait();
  hopper::griddep_launch();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) xs[i] = from_f<T>(x[i] + pos[i]);
}

// One block per 64 summary columns (whole heads): token mean of s over all M
// tokens, per-head LN + GELU, round, then the block-diagonal Wc_sum product
// for these columns.
template <class T>
__global__ void __launch_bounds__(64)
vis_summary(const float* __restrict__ s, int M, int P, int hw,
            const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
            const T* __restrict__ wcs, float* __restrict__ sc) {
  __shared__ float v[64];
  __shared__ float stat[64][2];
  hopper::griddep_wait();
  hopper::griddep_launch();
  const int c = threadIdx.x, n = blockIdx.x * 64 + c;
  float sum = 0.f;
  for (int m = 0; m < M; ++m) sum += s[(size_t)m * P + n];
  v[c] = sum / M;
  __syncthreads();
  if (c < 64 / hw) {
    const int c0 = c * hw;
    float mean = 0.f;
    for (int i = 0; i < hw; ++i) mean += v[c0 + i];
    mean /= hw;
    float var = 0.f;
    for (int i = 0; i < hw; ++i) {
      const float d = v[c0 + i] - mean;
      var = fmaf(d, d, var);
    }
    stat[c][0] = mean;
    stat[c][1] = 1.f / sqrtf(var / hw + LN_EPS);
  }
  __syncthreads();
  const int h = c / hw;
  const float u = (v[c] - stat[h][0]) * stat[h][1] * ln_scale[n] + ln_bias[n];
  __syncthreads();
  v[c] = round_to<T>(gelu_erf(u));
  __syncthreads();
  const int k0 = blockIdx.x * 64;
  float acc = 0.f;
  for (int k = 0; k < 64; ++k) acc = fmaf(v[k], to_f(wcs[(size_t)(k0 + k) * P + n]), acc);
  sc[n] = acc;
}

// y = round(LN(xf)) over the D = 2P columns of one token row (two-pass variance)
template <class T>
__global__ void __launch_bounds__(256)
vis_ln(const float* __restrict__ xf, int D, const float* __restrict__ scale,
       const float* __restrict__ bias, T* __restrict__ y) {
  __shared__ float red[32];
  hopper::griddep_wait();
  hopper::griddep_launch();
  const float* row = xf + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) s += row[i];
  const float mean = block_sum(s, red) / D;
  float q = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = row[i] - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = 1.f / sqrtf(block_sum(q, red) / D + LN_EPS);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    y[(size_t)blockIdx.x * D + i] = from_f<T>((row[i] - mean) * rstd * scale[i] + bias[i]);
}

}  // namespace vis
}  // namespace sq
