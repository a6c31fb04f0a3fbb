// K2 stem16 and K3 bottleneck_chain_cp in f32: convolutions as GEMMs in the
// (C, P) layout (channels x pixels, one image per grid z).
//
// Replaces sequoia_tpu/ops/pallas_resnet.py:stem16 (_stem16_kernel) and
// :bottleneck_chain_cp (_chain_cp_kernel) in f32 only: bf16 runs the
// tensor-core kernels of stem_wgmma.cu (K2) and conv_wgmma.cu (K3), and the
// C entry here refuses it.  (K4, the (P, C) chain, runs conv_wgmma.cu in
// both types.)
//
// conv_gemm_kernel:
// Every launch computes out[b] = epilogue(A . Bop(X[b])) with A the folded
// (M, K) weights and Bop one of four views of the activations:
//   PLAIN   X[b] itself, (K, P)                          (1x1 conv)
//   TAPS3   the 9 taps of a 3x3/s1/pad1 conv, row k = (tap, cin), each tap a
//           shifted copy of X[b] masked to zero outside the image (TAPS order
//           of pallas_resnet.py: (dy, dx) lexicographic in {-1, 0, 1}^2)
//   STEM    the 16 taps of the 4x4 s2d stem, row k = (ky*4 + kx)*16 + c, tap
//           (ky, dx = kx - 2) reads input row ky*W2 + q + dx of the row-padded
//           (16, (H2+3)*W2) input, masked where the column leaves [0, W2)
//   CONCAT  [X[b]; X2[b]] stacked on K: conv3 and the projection shortcut as
//           one GEMM ([W3|Wd], pallas_resnet.py:342)
// and the epilogue adds the per-row (output channel) bias, optionally the
// residual R[b], applies ReLU and rounds to the compute type.
//
// What bounds it on the H100: at the extractor batch these are large GEMMs
// (layer1: 1.75 GFLOP per image), so arithmetic.  This first kernel runs them
// on the CUDA cores in f32 FMA (a 3xTF32 tensor-core route, as K4's in
// conv_wgmma.cu, is later work); its design point is that no tap stack is
// ever written to device memory: the tap-gather loader builds each K-slab of
// the (9*width, P) or (256, P) stack in shared memory from the activation
// itself.  y1/y2 between the three GEMMs of a block do go through device
// memory.
#include "common.cuh"

using namespace sq;

namespace {

enum BMode { B_PLAIN = 0, B_TAPS3 = 1, B_STEM = 2, B_CONCAT = 3 };

struct ConvArgs {
  const void* A;      // (M, K) weights, compute type
  const float* bias;  // (M,) f32
  const void* X;      // operand activations, image stride xs, channel stride xc
  const void* X2;     // CONCAT: rows K1.. of the stack, (K - K1, N), stride x2s
  const void* R;      // residual (M, N) per image, stride rs, or null
  void* out;          // (M, N) per image, stride os
  int M, K, K1, N, W;
  long long xc, xs, x2s, rs, os;
  int relu;
};

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int NTHREADS = (BM / TM) * (BN / TN);

template <class T, int MODE>
__global__ void __launch_bounds__(NTHREADS) conv_gemm_kernel(ConvArgs a) {
  __shared__ float As[TileSmem<BM, BN, BK>::A];
  __shared__ float Bs[TileSmem<BM, BN, BK>::B];
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* A = static_cast<const T*>(a.A);
  const T* X = static_cast<const T*>(a.X) + b * a.xs;
  const T* X2 = static_cast<const T*>(a.X2) + (a.X2 ? b * a.x2s : 0);
  const int M = a.M, K = a.K, N = a.N, W = a.W;

  auto la = [&](int m, int k) -> float {
    return m < M ? to_f(A[(size_t)m * K + k]) : 0.f;
  };
  auto lb = [&](int k, int n) -> float {
    if (n >= N) return 0.f;
    if constexpr (MODE == B_PLAIN) {
      return to_f(X[(size_t)k * a.xc + n]);
    } else if constexpr (MODE == B_CONCAT) {
      return k < a.K1 ? to_f(X[(size_t)k * a.xc + n])
                      : to_f(X2[(size_t)(k - a.K1) * N + n]);
    } else if constexpr (MODE == B_TAPS3) {
      const int C = K / 9;
      const int t = k / C, c = k - t * C;
      const int dy = t / 3 - 1, dx = t % 3 - 1;
      const int col = n % W + dx;
      const int s = n + dy * W + dx;
      if (col < 0 || col >= W || s < 0 || s >= N) return 0.f;
      return to_f(X[(size_t)c * a.xc + s]);
    } else {  // B_STEM
      const int t = k >> 4, c = k & 15;
      const int ky = t >> 2, dx = (t & 3) - 2;
      const int col = n % W + dx;
      if (col < 0 || col >= W) return 0.f;
      return to_f(X[(size_t)c * a.xc + ky * W + n + dx]);
    }
  };

  float acc[TM][TN] = {};
  gemm_tile<BM, BN, BK, TM, TN, true, false>(acc, m0, n0, 0, K, la, lb, As, Bs);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  T* out = static_cast<T*>(a.out) + b * a.os;
  const T* R = a.R ? static_cast<const T*>(a.R) + b * a.rs : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const float bias = a.bias[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      float v = acc[i][j] + bias;
      if (R) v += to_f(R[(size_t)m * N + n]);
      if (a.relu) v = fmaxf(v, 0.f);
      out[(size_t)m * N + n] = from_f<T>(v);
    }
  }
}

template <class T>
void launch(int mode, const ConvArgs& a, int B, cudaStream_t s) {
  dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, B);
  switch (mode) {
    case B_PLAIN: conv_gemm_kernel<T, B_PLAIN><<<grid, NTHREADS, 0, s>>>(a); break;
    case B_TAPS3: conv_gemm_kernel<T, B_TAPS3><<<grid, NTHREADS, 0, s>>>(a); break;
    case B_STEM: conv_gemm_kernel<T, B_STEM><<<grid, NTHREADS, 0, s>>>(a); break;
    case B_CONCAT: conv_gemm_kernel<T, B_CONCAT><<<grid, NTHREADS, 0, s>>>(a); break;
  }
}

}  // namespace

extern "C" int sq_conv_gemm(int dtype, int mode, const void* A, const float* bias,
                            const void* X, const void* X2, const void* R, void* out,
                            int B, int M, int K, int K1, int N, int W,
                            long long xc, long long xs, long long x2s,
                            long long rs, long long os, int relu, void* stream) {
  if (dtype != F32 || mode < B_PLAIN || mode > B_CONCAT) return (int)cudaErrorInvalidValue;
  ConvArgs a{A, bias, X, X2, R, out, M, K, K1, N, W, xc, xs, x2s, rs, os, relu};
  launch<float>(mode, a, B, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
