// Shared pieces of the port's Hopper kernels: type conversion, exact-erf
// GELU, block reductions and one tiled GEMM core.
//
// The core is deliberately simple (first slice: right before fast): each
// block stages a BK-deep slab of A (BM x BK) and B (BK x BN) in shared memory
// as f32, and every thread accumulates a TM x TN register tile with plain
// f32 FMAs.  bf16 operands are widened on load, so a bf16 GEMM is "bf16
// operands, f32 accumulation" exactly as the JAX kernels' preferred_element_type
// f32 dots, and an f32 GEMM is full f32 (no TF32).  Operands are read through
// loader functors, so a kernel can feed the core a shifted, edge-masked view of
// an activation (the tap-gather loaders of the ResNet kernels) instead of an
// im2col buffer in device memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace sq {

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the value v takes after a store in T (round to nearest even for bf16)
template <class T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// exact-erf GELU (torch.nn.GELU() default, jax.nn.gelu(approximate=False))
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the block (blockDim.x a multiple of 32, <= 1024); every thread
// gets the total.  `red` holds 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  return warp_sum(t);
}

// C[m0:m0+BM, n0:n0+BN] += A[m0:, k0:k1] . B[k0:k1, n0:]
//
// la(m, k) and lb(k, n) return the operand as f32 and 0 outside it.  A_KFAST /
// B_KFAST pick which index neighbouring threads walk while staging a slab, so
// that the global reads coalesce for the operand's layout: k-fast for a
// row-major (M, K) A or a (N, K) B^T, m/n-fast for a (K, N) B.
// Thread t owns rows m0 + (t / (BN/TN))*TM + i and cols n0 + (t % (BN/TN))*TN + j.
template <int BM, int BN, int BK, int TM, int TN, bool A_KFAST, bool B_KFAST,
          class LA, class LB>
__device__ __forceinline__ void gemm_tile(float (&acc)[TM][TN], int m0, int n0,
                                          int k0, int k1, const LA& la, const LB& lb,
                                          float* As, float* Bs) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int LDA = BM + 4;  // padded: the k-fast stores hit fewer banks
  constexpr int LDB = BN + 4;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  for (int kt = k0; kt < k1; kt += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int kk = A_KFAST ? i % BK : i / BM;
      const int mm = A_KFAST ? i / BK : i % BM;
      const int k = kt + kk;
      As[kk * LDA + mm] = k < k1 ? la(m0 + mm, k) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = B_KFAST ? i % BK : i / BN;
      const int nn = B_KFAST ? i / BK : i % BN;
      const int k = kt + kk;
      Bs[kk * LDB + nn] = k < k1 ? lb(k, n0 + nn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk * LDA + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * LDB + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// the shared-memory floats gemm_tile needs for one A and one B slab
template <int BM, int BN, int BK> struct TileSmem {
  static constexpr int A = BK * (BM + 4);
  static constexpr int B = BK * (BN + 4);
};

}  // namespace sq
