// K4 bottleneck_chain and K3 bottleneck_chain_cp in bf16: the (P, C)
// convolution GEMMs of a stride-1 bottleneck chain on Hopper's tensor cores.
//
// Replaces sequoia_tpu/ops/pallas_resnet.py:bottleneck_chain (_chain_kernel)
// and :bottleneck_chain_cp (_chain_cp_kernel) for bf16; f32 keeps the
// CUDA-core kernels of conv_gemm.cu (f32 has no tensor-core route without
// TF32, which the port keeps off).
//
// Function, per launch, over the B images of P pixels stacked as M = B*P rows:
//   out (M, N) = relu(Aop(X) (M, K) . B (K, N) + bias [+ R]),
// bf16 operands, f32 accumulation, the residual added in f32, one rounding
// to bf16 (the rounding points of pallas_resnet.py:117,137,143).  Aop is
//   A_PLAIN   X itself, (M, K)                                  (1x1 conv)
//   A_TAPS3   row m of the (M, 9*C) tap stack: column k = (tap, c) reads
//             X[m + dy*W + dx, c], zero where the tap leaves m's image
//             (TAPS order of pallas_resnet.py: (dy, dx) lexicographic)
//   A_CONCAT  [X | X2]: columns < K1 from y2, the rest from the block input
//             (conv3 and the projection shortcut as one GEMM)
// and B is the folded weights, stored (K, N) (K4's orientation, read as an
// MN-major operand) or (N, K) (K3's, read K-major): neither is re-laid.
//
// What bounds it on the H100.  The stage tails are operations: 219, 365 and
// 146 GFLOP per batch of 128 images against a few hundred MB of activations
// (layer2-4), far above the card's 295 FLOP per byte.  Layer1 is near the
// memory line: y1, y2 and x cross device memory in three launches per block
// (about 1 GB per identity block of a batch, 0.3 ms at 3.35 TB/s, against
// 74 GFLOP, 0.08 ms at 989 TFLOP/s).
//
// What the design does about it.  Each CTA computes a 128 x BN output tile
// (128 rows in two warpgroups of 64; BN = 64, 128 or 256 output channels)
// with wgmma m64nBNk16 from shared memory, so the products run on the tensor
// cores.  Rows are the images' pixels stacked, so a tile may hold the end of
// one image and the start of the next, and layer4's 64-pixel images fill
// whole tiles.  K is walked in slabs of 64 (one 128-byte swizzle row of
// bf16) through a ring of three or four stages: every thread issues its
// 16-byte cp.async copies one or two slabs ahead of the slab being
// multiplied, and one wgmma group stays in flight while the next copies are
// issued, so copies and math overlap.  The A loader gathers each 8-channel
// chunk of the tap stack straight from the activation (zero-filled where the
// tap leaves its row's image, or past M or K), so no tap stack reaches device
// memory.  The epilogue stages the f32 tile in shared memory and writes bias
// + residual + ReLU in 16-byte coalesced rows, or, for the last launch of
// K3's chain, straight into K3's (C, P) layout.  y1 and y2 still go through
// device memory between the three launches of a block (a halo-fused block is
// later work).  The copies are issued by the threads that multiply and the
// ring is ordered by cp.async groups and one block barrier per slab; a TMA
// producer warp with mbarriers (warp specialisation) is later work.
#include "hopper.cuh"

using namespace sq::hopper;

namespace {

using bf16 = __nv_bfloat16;

// the (P, C) operand modes, numbered as conv_gemm.cu's
enum AMode { A_PLAIN = 4, A_TAPS3 = 5, A_CONCAT = 6 };

struct WgArgs {
  const bf16* X;      // (M, K) (TAPS3: (M, C); CONCAT: (M, K1))
  const bf16* X2;     // CONCAT: columns K1.. of the stack, (M, K - K1)
  const bf16* Wt;     // (K, N), or (N, K) for a K-major B
  const float* bias;  // (N,)
  const bf16* R;      // residual (M, N), or null
  bf16* out;          // (M, N), or (images, N, P) when out_cp
  int mode, M, P, K, K1, N, W, C;  // M = images * P rows, P pixels an image
  int out_cp;         // write the output in K3's (C, P) layout
};

constexpr int BM = 128;     // rows per CTA: two warpgroups of 64
constexpr int NT = 2 * BM;  // threads per CTA
constexpr int BK = 64;      // K per slab: one 128-byte swizzle row of bf16

// per tile width: the ring depth (copies run STAGES - 2 slabs ahead) and the
// CTAs an SM should hold.  A 128 x 256 tile keeps its 128 accumulators a
// thread and a 4-deep ring on one CTA per SM; a 128 x 128 tile fits two CTAs
// an SM in registers (128 a thread) and shared memory (3 x 32 KB), so one
// CTA's epilogue overlaps the other's main loop.
template <int BN> struct Cfg;
template <> struct Cfg<256> { static constexpr int STAGES = 4, MIN_CTAS = 1; };
template <> struct Cfg<128> { static constexpr int STAGES = 3, MIN_CTAS = 2; };
template <> struct Cfg<64> { static constexpr int STAGES = 4, MIN_CTAS = 2; };

template <int BN> struct Smem {
  static constexpr int A = BM * BK * 2;  // bytes of one A slab
  static constexpr int B = BN * BK * 2;  // bytes of one B slab
  static constexpr int STAGE = A + B;
  static constexpr int RING = Cfg<BN>::STAGES * STAGE;
  static constexpr int LDS = BN + 8;     // floats per row of the epilogue tile
  static constexpr int EPI = BM * LDS * 4;
  static constexpr int BYTES = (RING > EPI ? RING : EPI) + 1024;  // + 1 KB to align
};

// The (M, N) output, in two passes.  stage_pc: the f32 accumulators from the
// wgmma fragment (see Wgmma in hopper.cuh) into the tile in shared memory
// (st, padded rows).  store_pc: a thread takes 8 columns (chunk c) of EPT
// tile rows: + bias, + residual, ReLU, bf16, 16-byte stores; the residual
// loads go out four at a time before their first use.
template <int BN>
__device__ __forceinline__ void stage_pc(const float (&acc)[BN / 2], float* st) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid / 128) * 64 + ((tid & 127) >> 5) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float* row = st + r0 * Smem<BN>::LDS + j * 8 + (lane & 3) * 2;
    *reinterpret_cast<float2*>(row) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(row + 8 * Smem<BN>::LDS) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

template <int BN>
__device__ __forceinline__ void store_pc(const WgArgs& a, const float* st, int m0, int n0) {
  constexpr int CPR = BN / 8;         // 8-column chunks per tile row
  constexpr int EPT = BM * CPR / NT;  // chunks per thread
  constexpr int G = EPT < 4 ? EPT : 4;
  static_assert(NT % CPR == 0, "a thread's chunks share their columns");
  const int tid = threadIdx.x, c = tid % CPR, n = n0 + c * 8;
  if (n >= a.N) return;
  const float4 blo = __ldg(reinterpret_cast<const float4*>(a.bias + n));
  const float4 bhi = __ldg(reinterpret_cast<const float4*>(a.bias + n + 4));
#pragma unroll
  for (int e0 = 0; e0 < EPT; e0 += G) {
    uint4 res[G];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int m = m0 + (tid + (e0 + e) * NT) / CPR;
      res[e] = make_uint4(0, 0, 0, 0);  // zeros without a residual
      if (a.R && m < a.M)
        res[e] = __ldg(reinterpret_cast<const uint4*>(a.R + (size_t)m * a.N + n));
    }
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int r = (tid + (e0 + e) * NT) / CPR, m = m0 + r;
      if (m >= a.M) continue;
      const float* row = st + r * Smem<BN>::LDS + c * 8;
      const float4 lo = *reinterpret_cast<const float4*>(row);
      const float4 hi = *reinterpret_cast<const float4*>(row + 4);
      const float v[8] = {lo.x + blo.x, lo.y + blo.y, lo.z + blo.z, lo.w + blo.w,
                          hi.x + bhi.x, hi.y + bhi.y, hi.z + bhi.z, hi.w + bhi.w};
      const bf16* rb = reinterpret_cast<const bf16*>(&res[e]);
      uint4 o;
      bf16* ob = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        ob[k] = __float2bfloat16_rn(fmaxf(v[k] + __bfloat162float(rb[k]), 0.f));
      *reinterpret_cast<uint4*>(a.out + (size_t)m * a.N + n) = o;
    }
  }
}

// the (images, N, P) output (K3's layout, so its chain needs no transpose
// out), in two passes.  stage_cp: relu(acc + bias + residual) from the wgmma
// fragment, rounded to bf16, into the tile transposed in shared memory (sT,
// one row of BM pixels per output channel).  copy_cp: 16-byte chunks of 8
// pixels, a half warp per 256-byte channel row; 8 rows from a multiple of 8
// lie in one image where P % 8 == 0, else each pixel is stored alone.
constexpr int LDT = BM + 8;  // bf16 per row of sT (padded)

template <int BN>
__device__ __forceinline__ void stage_cp(const WgArgs& a, const float (&acc)[BN / 2],
                                         bf16* sT, int m0, int n0) {
  static_assert(BN * LDT * 2 <= Smem<BN>::EPI, "sT fits where the f32 tile goes");
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = (tid / 128) * 64 + ((tid & 127) >> 5) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2, n = n0 + col;
    if (n >= a.N) continue;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + n));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, m = m0 + r;
      float v0 = acc[4 * j + 2 * h] + bb.x, v1 = acc[4 * j + 2 * h + 1] + bb.y;
      if (a.R && m < a.M) {
        const __nv_bfloat162 rr =
            __ldg(reinterpret_cast<const __nv_bfloat162*>(a.R + (size_t)m * a.N + n));
        v0 += __low2float(rr);
        v1 += __high2float(rr);
      }
      sT[col * LDT + r] = __float2bfloat16_rn(fmaxf(v0, 0.f));
      sT[(col + 1) * LDT + r] = __float2bfloat16_rn(fmaxf(v1, 0.f));
    }
  }
}

template <int BN>
__device__ __forceinline__ void copy_cp(const WgArgs& a, const bf16* sT, int m0, int n0) {
  constexpr int CH = BM / 8;  // 16-byte chunks per channel row
  const bool vec = a.P % 8 == 0;
#pragma unroll
  for (int i = threadIdx.x; i < BN * CH; i += NT) {
    const int nl = i / CH, m = m0 + (i % CH) * 8, n = n0 + nl;
    if (n >= a.N || m >= a.M) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(sT + nl * LDT + (i % CH) * 8);
    if (vec) {
      const int b = m / a.P, p = m - b * a.P;
      *reinterpret_cast<uint4*>(a.out + ((size_t)b * a.N + n) * a.P + p) = v;
    } else {
      const bf16* vb = reinterpret_cast<const bf16*>(&v);
      for (int k = 0; k < 8 && m + k < a.M; ++k) {
        const int b = (m + k) / a.P, p = m + k - b * a.P;
        a.out[((size_t)b * a.N + n) * a.P + p] = vb[k];
      }
    }
  }
}

template <int BN, bool B_KMAJOR>
__global__ void __launch_bounds__(NT, Cfg<BN>::MIN_CTAS) pc_wgmma_kernel(const WgArgs a) {
  constexpr int STAGES = Cfg<BN>::STAGES;
  constexpr int ROWS = NT / 8;        // A rows one pass of the threads copies
  constexpr int A_PER = BM / ROWS;    // A chunks a thread copies per slab
  constexpr int B_PER = BN * 8 / NT;  // B chunks a thread copies per slab
  using S = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_addr(smem);

  // N tiles fastest, so neighbouring CTAs share their A rows in L2
  const int ntiles = (a.N + BN - 1) / BN;
  const int tid = threadIdx.x;
  const int m0 = (blockIdx.x / ntiles) * BM, n0 = (blockIdx.x % ntiles) * BN;
  const int M = a.M, P = a.P, K = a.K, N = a.N, W = a.W, C = a.C, K1 = a.K1;
  const bf16* X = a.X;
  const bf16* X2 = a.X2 ? a.X2 : a.X;
  const int nk = (K + BK - 1) / BK;

  // this thread's A chunks: column chunk ac of tile rows arow[j], which are
  // stack rows am[j], pixel ap[j] of their image, in image column acol[j]
  const int ac = tid & 7;
  int arow[A_PER], am[A_PER], ap[A_PER], acol[A_PER];
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    arow[j] = tid / 8 + j * ROWS;
    am[j] = m0 + arow[j];
    ap[j] = am[j] % P;
    acol[j] = ap[j] % W;
  }

  auto load = [&](int kt, int slot) {
    const uint32_t sa = sbase + slot * S::STAGE, sb = sa + S::A;
    const int k = kt * BK + ac * 8;  // the 8 stack columns of this thread's A chunks
    const bool kin = k < K;
    if (a.mode == A_TAPS3) {
      const int t = k / C, c = k - t * C;
      const int dy = t / 3 - 1, dx = t % 3 - 1;
#pragma unroll
      for (int j = 0; j < A_PER; ++j) {
        const int s = ap[j] + dy * W + dx, col = acol[j] + dx;
        const bool ok = kin && am[j] < M && col >= 0 && col < W && s >= 0 && s < P;
        cp_async_16(sa + sw128_offset(arow[j], ac),
                    ok ? X + ((size_t)am[j] + dy * W + dx) * C + c : X, ok);
      }
    } else {
      const bool second = a.mode == A_CONCAT && k >= K1;
      const bf16* src = second ? X2 + (k - K1) : X + k;
      const int ld = a.mode == A_CONCAT ? (second ? K - K1 : K1) : K;
#pragma unroll
      for (int j = 0; j < A_PER; ++j) {
        const bool ok = kin && am[j] < M;
        cp_async_16(sa + sw128_offset(arow[j], ac), ok ? src + (size_t)am[j] * ld : X, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
      const int i = tid + j * NT;
      if constexpr (B_KMAJOR) {  // row n of the slab: 64 K values of output channel n0 + n
        const int n = i / 8, c = i % 8;
        const int kk = kt * BK + c * 8, nn = n0 + n;
        const bool ok = kk < K && nn < N;
        cp_async_16(sb + sw128_offset(n, c), ok ? a.Wt + (size_t)nn * K + kk : a.Wt, ok);
      } else {  // row kr of 64-wide N block jb: 64 output channels of stack row kt*BK + kr
        const int cn = i % (BN / 8), kr = i / (BN / 8);
        const int kk = kt * BK + kr, nn = n0 + cn * 8;
        const bool ok = kk < K && nn < N;
        cp_async_16(sb + (cn / 8) * (BK * 128) + sw128_offset(kr, cn % 8),
                    ok ? a.Wt + (size_t)kk * N + nn : a.Wt, ok);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  const int wg = tid / 128;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % STAGES;
    cp_async_wait<STAGES - 3>();  // this thread's copies of slab kt have landed
    fence_proxy_async();
    // every thread's copies of slab kt are visible, and every warpgroup has
    // finished the wgmma of slab kt - 2, whose slot is refilled below
    __syncthreads();
    const uint32_t sa = sbase + slot * S::STAGE + wg * (64 * 128);
    const uint32_t sb = sbase + slot * S::STAGE + S::A;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = sw128_desc(sa + ks * 32, 16, 1024);
      const uint64_t db = B_KMAJOR ? sw128_desc(sb + ks * 32, 16, 1024)
                                   : sw128_desc(sb + ks * 16 * 128, BK * 128, 1024);
      Wgmma<BN, B_KMAJOR ? 0 : 1>::mma(acc, da, db);
    }
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // the wgmma of slab kt - 1 is done
    fence_regs(acc);
    const int next = kt + STAGES - 2;
    if (next < nk) load(next, next % STAGES);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();  // the ring is free: reuse it for the output tile
  if (a.out_cp) {
    stage_cp<BN>(a, acc, reinterpret_cast<bf16*>(smem), m0, n0);
    __syncthreads();
    copy_cp<BN>(a, reinterpret_cast<const bf16*>(smem), m0, n0);
  } else {
    stage_pc<BN>(acc, reinterpret_cast<float*>(smem));
    __syncthreads();
    store_pc<BN>(a, reinterpret_cast<const float*>(smem), m0, n0);
  }
}

template <int BN, bool B_KMAJOR>
int launch(const WgArgs& a, cudaStream_t s) {
  constexpr int bytes = Smem<BN>::BYTES;
  auto kernel = pc_wgmma_kernel<BN, B_KMAJOR>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((a.N + BN - 1) / BN) * ((a.M + BM - 1) / BM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)tiles, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// the widest tile that divides N; 256 only where K >= N: an expansion GEMM
// (short K, wide N) spends its time in the epilogue and runs faster as
// 128-wide tiles two to an SM
template <bool B_KMAJOR> int launch_bn(const WgArgs& a, cudaStream_t s) {
  if (a.N % 256 == 0 && a.K >= a.N) return launch<256, B_KMAJOR>(a, s);
  if (a.N % 128 == 0) return launch<128, B_KMAJOR>(a, s);
  return launch<64, B_KMAJOR>(a, s);
}

}  // namespace

// bf16 only, every operand contiguous.  K, N, C, K1 multiples of 8 (16-byte
// chunks); every pointer 16-byte aligned; b_kmajor = 1 when Wt is stored
// (N, K); out_cp = 1 writes out as (images, N, P).  M = images * P rows.
extern "C" int sq_pc_wgmma(int mode, int b_kmajor, const void* X, const void* X2,
                           const void* Wt, const float* bias, const void* R, void* out,
                           int M, int P, int K, int K1, int N, int W, int C,
                           int out_cp, void* stream) {
  if (mode < A_PLAIN || mode > A_CONCAT || K % 8 || N % 8 || W <= 0 || P <= 0 || M % P)
    return (int)cudaErrorInvalidValue;
  if (mode == A_TAPS3 && (C <= 0 || C % 8 || K != 9 * C)) return (int)cudaErrorInvalidValue;
  if (mode == A_CONCAT && (K1 <= 0 || K1 >= K || K1 % 8)) return (int)cudaErrorInvalidValue;
  WgArgs a{static_cast<const bf16*>(X), static_cast<const bf16*>(X2),
           static_cast<const bf16*>(Wt), bias, static_cast<const bf16*>(R),
           static_cast<bf16*>(out), mode, M, P, K, K1, N, W, C, out_cp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b_kmajor ? launch_bn<true>(a, s) : launch_bn<false>(a, s);
}
