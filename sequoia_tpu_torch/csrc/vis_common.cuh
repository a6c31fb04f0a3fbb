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

// The head widths the K1 kernels take: divisors of 64 (a 64-feature tile
// holds whole heads) and multiples of 64 up to 1024 (a head spans hw / 64
// tiles)
__host__ __device__ inline bool head_width_ok(int hw) {
  return hw > 0 && (64 % hw == 0 || (hw % 64 == 0 && hw <= 1024));
}

// Columns of the summary product a block takes (whole heads), and rows of
// the block-diagonal combine that features [n0, n0 + 64) meet: from
// n0 / group * group
__host__ __device__ inline int head_group(int hw) { return hw > 64 ? hw : 64; }

// One block per head_group(hw) summary columns (whole heads), a thread a
// column: token mean of s over all M tokens, per-head LN + GELU, round, then
// the block-diagonal Wc_sum product for these columns.
template <class T>
__global__ void __launch_bounds__(1024)
vis_summary(const float* __restrict__ s, int M, int P, int hw,
            const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
            const T* __restrict__ wcs, float* __restrict__ sc) {
  __shared__ float v[1024];
  __shared__ float stat[64][2];
  hopper::griddep_wait();
  hopper::griddep_launch();
  const int G = blockDim.x, c = threadIdx.x, n = blockIdx.x * G + c;
  float sum = 0.f;
  for (int m = 0; m < M; ++m) sum += s[(size_t)m * P + n];
  v[c] = sum / M;
  __syncthreads();
  if (c < G / hw) {
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
  const int k0 = blockIdx.x * G;
  float acc = 0.f;
  for (int k = 0; k < G; ++k) acc = fmaf(v[k], to_f(wcs[(size_t)(k0 + k) * P + n]), acc);
  sc[n] = acc;
}

// local = round(GELU(headLN(v))) for head widths past 64, where the f GEMM's
// 64-feature tiles hold part of a head and store v = xs.Wf + bf in f32: a
// warp per (token, head), two-pass variance
template <class T>
__global__ void __launch_bounds__(256)
vis_head_ln(const float* __restrict__ v, int M, int P, int hw,
            const float* __restrict__ scale, const float* __restrict__ bias,
            T* __restrict__ out) {
  hopper::griddep_wait();
  hopper::griddep_launch();
  const int lane = threadIdx.x & 31, heads = P / hw;
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= M * heads) return;
  const size_t row = (size_t)(w / heads) * P;
  const int c0 = (w % heads) * hw;
  float s = 0.f;
  for (int i = lane; i < hw; i += 32) s += v[row + c0 + i];
  const float mean = warp_sum(s) / hw;
  float q = 0.f;
  for (int i = lane; i < hw; i += 32) {
    const float d = v[row + c0 + i] - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = 1.f / sqrtf(warp_sum(q) / hw + LN_EPS);
  for (int i = lane; i < hw; i += 32) {
    const int n = c0 + i;
    out[row + n] = from_f<T>(gelu_erf((v[row + n] - mean) * rstd * scale[n] + bias[n]));
  }
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
