// Pieces shared by K1's two routes in vis_wgmma.cu (bf16 and 3xTF32 f32
// GEMMs on the tensor cores): the GEMM epilogue kinds, the head-width rules
// and the small kernels between the GEMMs.  Each small kernel waits on the
// launch before it and lets the next one start (griddepcontrol, hopper.cuh);
// both are no-ops unless the kernel is launched with programmatic stream
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

// The K1 kernels take every head width hw that divides P (P % 64 == 0).  Where
// hw divides 64 a 64-feature tile holds whole heads and the f GEMM runs the
// per-head LN in its epilogue (two features a lane: bf16 also needs an even
// hw, f32 takes hw = 1 as a head per feature); for every other width the f
// GEMM stores f32 and vis_head_ln normalises whole heads, one launch more
// per block.
__host__ __device__ inline bool ln_in_epilogue(int hw, bool bf16) {
  return 64 % hw == 0 && (!bf16 || hw % 2 == 0);
}

// Rows [first, last) of the block-diagonal combine that features [n0, n0 +
// 64) meet: from the first row of the head of feature n0 to the last row of
// the head of feature n0 + 63, widened to whole 64-row slabs (rows outside
// these heads are zero, so the product is exact).  n0's own 64 rows where hw
// divides 64, the head's hw rows where 64 divides hw.
__host__ __device__ inline int diag_first(int n0, int hw) { return n0 / hw * hw / 64 * 64; }
__host__ __device__ inline int diag_last(int n0, int hw) {
  return (((n0 + 63) / hw + 1) * hw + 63) / 64 * 64;
}

// Summary columns a vis_summary block takes: whole heads, 64 where hw
// divides 64, else one head; its threads and dynamic shared memory
__host__ __device__ inline int head_group(int hw) { return 64 % hw == 0 ? 64 : hw; }
__host__ __device__ inline int summary_threads(int hw) {
  const int g = (head_group(hw) + 31) / 32 * 32;
  return g < 256 ? g : 256;
}
__host__ __device__ inline int summary_smem(int hw) { return head_group(hw) * 4; }

// One block per head_group(hw) summary columns (whole heads), threads
// striding over the columns: token mean of s over all M tokens, per-head LN
// (a warp per head) + GELU, round, then the block-diagonal Wc_sum product
// for these columns.
template <class T>
__global__ void __launch_bounds__(256)
vis_summary(const float* __restrict__ s, int M, int P, int hw,
            const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
            const T* __restrict__ wcs, float* __restrict__ sc) {
  extern __shared__ float v[];  // head_group(hw) floats
  __shared__ float stat[64][2];
  hopper::griddep_wait();
  hopper::griddep_launch();
  const int G = head_group(hw), k0 = blockIdx.x * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < G; c += blockDim.x) {
    float sum = 0.f;
    for (int m = 0; m < M; ++m) sum += s[(size_t)m * P + k0 + c];
    v[c] = sum / M;
  }
  __syncthreads();
  for (int h = warp; h < G / hw; h += nwarps) {
    const float* vh = v + h * hw;
    float a = 0.f;
    for (int i = lane; i < hw; i += 32) a += vh[i];
    const float mean = warp_sum(a) / hw;
    float q = 0.f;
    for (int i = lane; i < hw; i += 32) {
      const float d = vh[i] - mean;
      q = fmaf(d, d, q);
    }
    const float rstd = 1.f / sqrtf(warp_sum(q) / hw + LN_EPS);
    if (lane == 0) {
      stat[h][0] = mean;
      stat[h][1] = rstd;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < G; c += blockDim.x) {
    const int h = c / hw, n = k0 + c;
    v[c] = round_to<T>(gelu_erf((v[c] - stat[h][0]) * stat[h][1] * ln_scale[n] + ln_bias[n]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < G; c += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < G; ++k) acc = fmaf(v[k], to_f(wcs[(size_t)(k0 + k) * P + k0 + c]), acc);
    sc[k0 + c] = acc;
  }
}

// Sets vis_summary<T>'s dynamic shared memory limit where its head group
// needs more than the default 48 KB (heads wider than 12,288 features)
template <class T>
inline cudaError_t summary_attr(int hw) {
  const int bytes = summary_smem(hw);
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(vis_summary<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// local = round(GELU(headLN(v))) where the f GEMM's 64-feature tiles do not
// hold whole heads (or, in bf16, odd widths) and the GEMM stores v = xs.Wf +
// bf in f32: a warp per (token, head), two-pass variance
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
