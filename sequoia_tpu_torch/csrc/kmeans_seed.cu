// kmeans_seed on Hopper: the kmeans++ seeding of k-means (D^2 sampling, one
// draw a center) in one cooperative launch.
//
// Replaces no TPU kernel: the JAX package seeds inside its jitted fit, a
// ``fori_loop`` in one XLA program (sequoia_tpu/ops/kmeans.py:40,
// ``_plusplus_init``).  Eager PyTorch issued them one by one: about fifteen
// launches a pick, some 1,500 a slide, with the device idle between them.
// This kernel does the same mathematics in one launch, the k picks inside it.
//
// The recipe (ops/cuda_kmeans.kmeans_seed_plain is its plain mirror):
//   u (k,) f64 uniforms, drawn by the caller from its generator, one a pick;
//   the weights: pick 0 the valid rows (1, masked rows 0); pick i >= 1 d2_r
//     where the row is valid and d2_r > 0, else 0, d2_r = min(d2_r, sum_d
//     ((double)x_rd - (double)c_d)^2) to the center picked last; where every
//     weight is 0 (fewer distinct valid rows than centers), the valid rows';
//   the pick: an exponential race.  Row r draws e_r = -log(h_r), h_r in
//     (0, 1) from splitmix64 of u_i's bits and r; among the rows with
//     weight, the least e_r / w_r wins (the first row on a tie).  With e_r
//     independent Exp(1) draws, row r wins with probability w_r / T.  A
//     change in one row's weight moves the pick only where it changes the
//     winner, so the rounding of the features (a bf16 batch position, a
//     decode path) seldom changes the seeding; an inverse CDF over the
//     cumulative weights moves every later boundary with any earlier row;
//   centers[i] = x[pick], idx[i] = pick.
//
// What bounds it on the H100 (N = 4096, D = 2048, k = 100): the k - 1
// distance passes over x, 99 x 33.5 MB, the first from HBM and the rest from
// the 50 MB L2 that holds x, against k picks at the latency of one: a grid
// barrier and the dependent reads around it.  The latency is the larger.
//
// Design:
//   - one block of 512 threads a slice of R = ceil(N / G) consecutive rows,
//     G = min(SMs, ceil(N / 32)): a biopsy of 500 patches runs on 16 SMs;
//   - a block keeps its rows' d2 in shared memory and, each pick, takes them
//     against the last center (staged in shared memory as f64): a warp a row,
//     16-byte loads of x, f64 products, a shuffle sum;
//   - lane 0 of each warp races its rows; the block's best (score, row),
//     under the D^2 weights and under the valid rows, goes to device memory;
//   - one grid barrier a pick (cooperative launch); the bests live in two
//     buffers by the pick's parity, so the next pick's writes never meet a
//     slower block's reads of this one (which end before the next barrier);
//   - after the barrier every block reduces the G bests itself, with one
//     warp and the same order: the least score, then the least row;
//   - block i % G copies the row into centers[i]; block 0 writes idx[i].
// Cross-block data is read with __ldcg and written with __stcg (L2, never a
// stale L1 line).  No atomics: the result does not depend on timing.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;        // threads a block
constexpr int NW = NT / 32;    // warps a block: a row each at a time
constexpr int MIN_ROWS = 32;   // rows a block at least: the grid follows N
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ROW = 0x7fffffff;

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// (s, r) <- the least of (s, r) and (t, q): score first, then row
__device__ __forceinline__ void take_least(double& s, int& r, double t, int q) {
  if (t < s || (t == s && q < r)) {
    s = t;
    r = q;
  }
}

// every lane gets the warp's least (s, r)
__device__ __forceinline__ void warp_least(double& s, int& r) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double t = __shfl_xor_sync(FULL, s, o);
    const int q = __shfl_xor_sync(FULL, r, o);
    take_least(s, r, t, q);
  }
}

// row r's Exp(1) draw of the pick keyed by `key` (its uniform's bits):
// -log of ((z >> 11) + 1/2) 2^-53, z splitmix64 of key + (r + 1) golden
__device__ __forceinline__ double race_exp(unsigned long long key, int r) {
  unsigned long long z = key + (unsigned long long)(r + 1) * 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z ^= z >> 31;
  return -log(((double)(z >> 11) + 0.5) * 0x1p-53);
}

// ws (doubles): BW[2][G], BWR[2][G] the blocks' best score and row under the
// D^2 weights, BV[2][G], BVR[2][G] under the valid rows, by pick parity.
// Dynamic shared memory: c64[D], d2[R].
__global__ void __launch_bounds__(NT, 1)
kmeans_seed_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                   const double* __restrict__ u, int N, int D, int K, int R,
                   float* __restrict__ centers, long long* __restrict__ idx, double* ws) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = b * R, rows = max(0, min(R, N - row0));
  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  double* BW = ws;
  double* BWR = BW + 2 * G;
  double* BV = BWR + 2 * G;
  double* BVR = BV + 2 * G;

  extern __shared__ __align__(16) unsigned char smem[];
  double* c64 = reinterpret_cast<double*>(smem);
  double* d2 = c64 + D;
  __shared__ double s_w[NW], s_v[NW];
  __shared__ int s_wr[NW], s_vr[NW];
  __shared__ int s_pick;

  for (int j = tid; j < rows; j += NT) d2[j] = INF;

  int prev = 0;
  for (int i = 0; i < K; ++i) {
    const int p = i & 1;
    const unsigned long long key = (unsigned long long)__double_as_longlong(u[i]);
    if (i > 0) {
      const float* c = x + (size_t)prev * D;
      for (int d = tid * 4; d < D; d += NT * 4) {
        const float4 v = *reinterpret_cast<const float4*>(c + d);
        *reinterpret_cast<double2*>(c64 + d) = make_double2(v.x, v.y);
        *reinterpret_cast<double2*>(c64 + d + 2) = make_double2(v.z, v.w);
      }
      __syncthreads();
    }
    // this warp's rows: d2 against the center picked last, then the race
    double bw = INF, bv = INF;
    int bwr = NO_ROW, bvr = NO_ROW;
    for (int j = warp; j < rows; j += NW) {
      const int r = row0 + j;
      double w = 0.0;
      if (i > 0) {
        const float* xr = x + (size_t)r * D;
        double acc = 0.0;
#pragma unroll 4
        for (int d = lane * 4; d < D; d += 128) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xr + d));
          const double2 c01 = *reinterpret_cast<const double2*>(c64 + d);
          const double2 c23 = *reinterpret_cast<const double2*>(c64 + d + 2);
          double e = (double)v.x - c01.x;
          acc = fma(e, e, acc);
          e = (double)v.y - c01.y;
          acc = fma(e, e, acc);
          e = (double)v.z - c23.x;
          acc = fma(e, e, acc);
          e = (double)v.w - c23.y;
          acc = fma(e, e, acc);
        }
        acc = warp_sum_f64(acc);
        if (lane == 0) {
          const double m = fmin(d2[j], acc);
          d2[j] = m;
          w = (mask[r] && m > 0.0) ? m : 0.0;
        }
      }
      if (lane == 0) {
        const double e = race_exp(key, r);
        if (w > 0.0) take_least(bw, bwr, e / w, r);
        if (mask[r]) take_least(bv, bvr, e, r);
      }
    }
    if (lane == 0) {
      s_w[warp] = bw;
      s_wr[warp] = bwr;
      s_v[warp] = bv;
      s_vr[warp] = bvr;
    }
    __syncthreads();
    if (warp == 0) {
      bw = lane < NW ? s_w[lane] : INF;
      bwr = lane < NW ? s_wr[lane] : NO_ROW;
      bv = lane < NW ? s_v[lane] : INF;
      bvr = lane < NW ? s_vr[lane] : NO_ROW;
      warp_least(bw, bwr);
      warp_least(bv, bvr);
      if (lane == 0) {
        __stcg(BW + p * G + b, bw);
        __stcg(BWR + p * G + b, (double)bwr);
        __stcg(BV + p * G + b, bv);
        __stcg(BVR + p * G + b, (double)bvr);
      }
    }
    grid.sync();
    // pick i, reduced by warp 0 of every block alike: the D^2 race, or where
    // no row has weight the valid rows' race, or row 0 where no row is valid
    if (warp == 0) {
      bw = INF, bv = INF;
      bwr = NO_ROW, bvr = NO_ROW;
      for (int g = lane; g < G; g += 32) {
        take_least(bw, bwr, __ldcg(BW + p * G + g), (int)__ldcg(BWR + p * G + g));
        take_least(bv, bvr, __ldcg(BV + p * G + g), (int)__ldcg(BVR + p * G + g));
      }
      warp_least(bw, bwr);
      warp_least(bv, bvr);
      if (lane == 0) s_pick = bw < INF ? bwr : (bv < INF ? bvr : 0);
    }
    __syncthreads();
    prev = s_pick;
    if (b == i % G) {
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)prev * D);
      float4* dst = reinterpret_cast<float4*>(centers + (size_t)i * D);
      for (int d = tid; d < D / 4; d += NT) dst[d] = src[d];
    }
    if (b == 0 && tid == 0) idx[i] = prev;
  }
}

}  // namespace

// One launch.  D % 4 == 0, x 16-byte aligned; mask (N,) bytes; u (K,) f64;
// centers (K, D) f32 and idx (K,) int64 the outputs; ws the scratch, 8 N
// doubles (the grid never exceeds N blocks).
extern "C" int sq_kmeans_seed(const float* x, const uint8_t* mask, const double* u, int N,
                              int D, int K, float* centers, long long* idx, double* ws,
                              void* stream) {
  if (N <= 0 || D <= 0 || D % 4 || K <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // a block an SM at most, and at least MIN_ROWS rows a block
  const int G0 = (N + MIN_ROWS - 1) / MIN_ROWS;
  const int G = G0 < sms ? G0 : sms;
  const int R = (N + G - 1) / G;
  const size_t smem = (size_t)(D + R) * sizeof(double);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kmeans_seed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a cooperative launch needs every block resident at once
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kmeans_seed_kernel, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&x, (void*)&mask, (void*)&u, (void*)&N, (void*)&D, (void*)&K,
                  (void*)&R, (void*)&centers, (void*)&idx, (void*)&ws};
  e = cudaLaunchCooperativeKernel((const void*)kmeans_seed_kernel, dim3(G), dim3(NT), args,
                                  smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
