// K5 lloyd_stats: one Lloyd accumulation pass of k-means.
//
// Replaces sequoia_tpu/ops/pallas_kmeans.py:lloyd_stats (_lloyd_kernel).
//
//   d2     = max(|x|^2 + |c|^2 - 2 x.c^T, 0)      (N, Kc), never stored
//   label  = argmin_c d2 (first index on ties), -1 on masked rows
//   best   = min_c d2 on valid rows, 0 on masked rows
//   counts = members per center (exact: integer count, one block per center)
//   sums   = sum of member rows per center
//   inertia= sum of best
//
// Two launches.  lloyd_assign: a (32 points x 128 centers) distance tile per
// block through the shared GEMM core, with the row argmin fused into its
// epilogue, so the (N, Kc) distances never reach device memory.  lloyd_sums:
// one block per (center, 256-wide column slab) walks the labels in point order
// and adds its members' rows, so the sums and counts come out in a fixed order
// (deterministic, no float atomics); one extra block reduces the inertia.
// The kernel masks its own ragged edge, so any N is accepted (the JAX
// _pallas_tile_n restriction is a TPU tiling rule).  Sentinel centers padded
// at 1e8 (ops/kmeans.py) simply never win the argmin.
//
// What bounds it on the H100: the distance GEMM, 2*N*D*Kc f32 operations
// (2.1 GFLOP at N=4096, D=2048, Kc=128); x is read once by each pass.  This
// first kernel runs it on the CUDA cores in f32 FMA, the precision the
// reference path uses for k-means.
#include "common.cuh"

using namespace sq;

namespace {

constexpr int BM = 32, BN = 128, BK = 16, TM = 4, TN = 4;
constexpr int NTHREADS = (BM / TM) * (BN / TN);  // 256
constexpr int SUM_COLS = 256;
constexpr int LABEL_CHUNK = 1024;

__global__ void __launch_bounds__(NTHREADS)
lloyd_assign(const float* __restrict__ x, const uint8_t* __restrict__ mask,
             const float* __restrict__ c, const float* __restrict__ c2, int N, int D,
             int Kc, int* __restrict__ labels, float* __restrict__ best) {
  __shared__ float As[TileSmem<BM, BN, BK>::A];
  __shared__ float Bs[TileSmem<BM, BN, BK>::B];
  __shared__ float x2s[BM];
  __shared__ float d2s[BM][BN + 1];
  const int m0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // |x|^2 of this block's rows: 8 warps x 4 rows
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    const int m = m0 + r;
    float s = 0.f;
    if (m < N)
      for (int d = lane; d < D; d += 32) {
        const float v = x[(size_t)m * D + d];
        s = fmaf(v, v, s);
      }
    s = warp_sum(s);
    if (lane == 0) x2s[r] = s;
  }

  auto la = [&](int m, int k) -> float { return m < N ? x[(size_t)m * D + k] : 0.f; };
  auto lb = [&](int k, int n) -> float { return n < Kc ? c[(size_t)n * D + k] : 0.f; };
  float acc[TM][TN] = {};
  gemm_tile<BM, BN, BK, TM, TN, true, true>(acc, m0, 0, 0, D, la, lb, As, Bs);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx * TN + j;
      d2s[r][n] = n < Kc ? fmaxf(x2s[r] + c2[n] - 2.f * acc[i][j], 0.f) : INFINITY;
    }
  }
  __syncthreads();

  // row argmin: 8 warps x 4 rows, each lane scans centers lane, lane+32, ...
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    const int m = m0 + r;
    float bv = INFINITY;
    int bi = 0x7fffffff;
    for (int n = lane; n < BN; n += 32) {
      const float v = d2s[r][n];
      if (v < bv) { bv = v; bi = n; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0 && m < N) {
      const bool ok = mask[m] != 0;
      labels[m] = ok ? bi : -1;
      best[m] = ok ? bv : 0.f;
    }
  }
}

__global__ void __launch_bounds__(SUM_COLS)
lloyd_sums(const float* __restrict__ x, const int* __restrict__ labels,
           const float* __restrict__ best, int N, int D, int Kc,
           float* __restrict__ sums, float* __restrict__ counts,
           float* __restrict__ inertia) {
  __shared__ int lab[LABEL_CHUNK];
  __shared__ float red[32];
  const int k = blockIdx.x;
  if (k == Kc) {  // the inertia block
    if (blockIdx.y != 0) return;
    float s = 0.f;
    for (int i = threadIdx.x; i < N; i += blockDim.x) s += best[i];
    s = block_sum(s, red);
    if (threadIdx.x == 0) *inertia = s;
    return;
  }
  const int d = blockIdx.y * SUM_COLS + threadIdx.x;
  float acc = 0.f;
  int cnt = 0;
  for (int base = 0; base < N; base += LABEL_CHUNK) {
    const int len = min(LABEL_CHUNK, N - base);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) lab[i] = labels[base + i];
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      if (lab[i] == k) {
        ++cnt;
        if (d < D) acc += x[(size_t)(base + i) * D + d];
      }
    }
  }
  if (d < D) sums[(size_t)k * D + d] = acc;
  if (blockIdx.y == 0 && threadIdx.x == 0) counts[k] = (float)cnt;
}

}  // namespace

extern "C" int sq_lloyd_stats(const float* x, const uint8_t* mask, const float* c,
                              const float* c2, int N, int D, int Kc, int* labels,
                              float* best, float* sums, float* counts,
                              float* inertia, void* stream) {
  if (Kc > BN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lloyd_assign<<<(N + BM - 1) / BM, NTHREADS, 0, s>>>(x, mask, c, c2, N, D, Kc,
                                                      labels, best);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Kc + 1, (D + SUM_COLS - 1) / SUM_COLS);
  lloyd_sums<<<grid, SUM_COLS, 0, s>>>(x, labels, best, N, D, Kc, sums, counts,
                                       inertia);
  return (int)cudaGetLastError();
}
