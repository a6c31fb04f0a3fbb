// K4 bottleneck_chain and K3 bottleneck_chain_cp, in bf16 and f32: the (P, C)
// convolution GEMMs of a stride-1 bottleneck chain on Hopper's tensor cores.
//
// Replaces sequoia_tpu/ops/pallas_resnet.py:bottleneck_chain (_chain_kernel)
// and :bottleneck_chain_cp (_chain_cp_kernel) in both types.  K3 runs K4's
// GEMMs after one transpose of its input to (P, C): its (C_out, K) weights
// are read as a K-major B and its last launch writes the (C, P) layout.
//
// Function, per launch, over the B images of P pixels stacked as M = B*P rows:
//   out (M, N) = relu(Aop(X) (M, K) . B (K, N) + bias [+ R]),
// f32 accumulation, the residual added in f32, one rounding to the compute
// type (the rounding points of pallas_resnet.py:117,137,143).  Aop is
//   A_PLAIN   X itself, (M, K)                                  (1x1 conv)
//   A_TAPS3   row m of the (M, 9*C) tap stack: column k = (tap, c) reads
//             X[m + dy*W + dx, c], zero where the tap leaves m's image
//             (TAPS order of pallas_resnet.py: (dy, dx) lexicographic)
//   A_CONCAT  [X | X2]: columns < K1 from y2, the rest from the block input
//             (conv3 and the projection shortcut as one GEMM)
// and B is the folded weights, stored (K, N) (K4's orientation) or (N, K)
// (K3's): neither is re-laid in device memory.
//
// What bounds it on the H100.  The stage tails are operations: 219, 365 and
// 146 GFLOP per batch of 128 images against a few hundred MB of activations
// (layer2-4), far above the card's 295 FLOP per byte.  Layer1 is near the
// memory line in bf16: y1, y2 and x cross device memory in three launches per
// block (about 1 GB per identity block of a batch, 0.3 ms at 3.35 TB/s,
// against 74 GFLOP, 0.08 ms at 989 TFLOP/s).  In f32 the three TF32 products
// (3 x 223 GFLOP at layer1, 1.35 ms at 495 TFLOP/s) outweigh the doubled
// bytes: every shape is bound by operations.
//
// bf16, pc_wgmma_kernel.  Each CTA computes a 128 x BN output tile (128 rows
// in two warpgroups of 64; BN = 64, 128 or 256 output channels) with wgmma
// m64nBNk16 from shared memory, so the products run on the tensor cores.
// Rows are the images' pixels stacked, so a tile may hold the end of one
// image and the start of the next, and layer4's 64-pixel images fill whole
// tiles.  K is walked in slabs of 64 (one 128-byte swizzle row of bf16)
// through a ring of three or four stages: every thread issues its 16-byte
// cp.async copies one or two slabs ahead of the slab being multiplied, and
// one wgmma group stays in flight while the next copies are issued, so
// copies and math overlap.  The A loader gathers each 8-channel chunk of the
// tap stack straight from the activation (zero-filled where the tap leaves
// its row's image, or past M or K), so no tap stack reaches device memory.
// B is read as it is stored: K-major (N, K) or, through the transpose bit,
// MN-major (K, N).  The epilogue stages the f32 tile in shared memory and
// writes bias + residual + ReLU in 16-byte coalesced rows, or, for the last
// launch of K3's chain, straight into K3's (C, P) layout.  y1 and y2 still go
// through device memory between the three launches of a block (a halo-fused
// block is later work).  The copies are issued by the threads that multiply
// and the ring is ordered by cp.async groups and one block barrier per slab;
// a TMA producer warp with mbarriers (warp specialisation) is later work.
//
// f32, pc_tf32_kernel: the same tiles, A gather and epilogue on f32, with
// every product taken as 3xTF32 (as K5, lloyd_wgmma.cu): each operand v is
// split into TF32 hi = rna(v) and lo = rna(v - hi), and hi.hi + hi.lo + lo.hi
// (wgmma m64nBNk8 .tf32, three products per k8 step) keeps about 22 of f32's
// 24 bits per product, at 3 x FLOP / 495 TFLOP/s: 2.5x less than f32 FMA's
// FLOP / 67 TFLOP/s on the CUDA cores.  The tensor cores truncate as they
// accumulate, which over K = 2,304 and five blocks costs up to ~7e-5 of the
// output; so each slab's 12 products go to an accumulator of their own and
// are added to the running f32 sum with a rounded add (promotion), which
// bounds a truncation by one slab's partial sum.  TF32 wgmma takes K-major
// operands only, with no transpose bit, so both operands go through
// registers: every thread loads its chunks of slab kt + 2 while the tensor
// cores multiply slab kt, then, while they multiply slab kt + 1, splits them
// and stores hi and lo to the swizzled tiles of a two-slot ring (32 K values,
// one 128-byte row of f32, per slab).  The activations are K-major as stored,
// and so are K3's (C_out, K) weights, which load as A does; K4's (K, C_out)
// weights are transposed on the way (krows_item in hopper.cuh).  Neither lo
// nor a transposed weight reaches device memory; the weights are split by
// every CTA that reads them (from L2), which costs the SM a few instructions
// a value and no bytes.  BN = 128, or 64 where N is not a multiple of 128
// (two CTAs an SM).  Each output row is one K reduction in a fixed order
// (slab by slab, k8 step by step, hi.hi then hi.lo then lo.hi), whatever its
// M tile: no split K, so a row's value does not depend on its place in the
// batch.  The epilogue is the bf16 kernel's, on f32: (M, N) rows or, for
// the last launch of K3's chain, the (images, N, P) layout.
#include "hopper.cuh"

using namespace sq::hopper;

namespace {

using bf16 = __nv_bfloat16;

// the (P, C) operand modes, numbered as ops/cuda_resnet.py's _PC_* modes
enum AMode { A_PLAIN = 4, A_TAPS3 = 5, A_CONCAT = 6 };

template <class T> struct WgArgs {
  const T* X;         // (M, K) (TAPS3: (M, C); CONCAT: (M, K1))
  const T* X2;        // CONCAT: columns K1.. of the stack, (M, K - K1)
  const T* Wt;        // (K, N), or (N, K) for a K-major B
  const float* bias;  // (N,)
  const T* R;         // residual (M, N), or null
  T* out;             // (M, N), or (images, N, P) when out_cp
  int mode, M, P, K, K1, N, W, C;  // M = images * P rows, P pixels an image
  int out_cp;         // write the output in K3's (C, P) layout
};

// The A operand's source: the chunk of stack columns [k, k + chunk) of
// stack row m (pixel p of its image, in image column col), or, with ok
// false, a valid address to zero-fill from (past M or K, or a tap that
// leaves the image)
template <class T>
__device__ __forceinline__ const T* a_src(const WgArgs<T>& a, int k, int m, int p, int col,
                                          bool& ok) {
  ok = k < a.K && m < a.M;
  if (a.mode == A_TAPS3) {
    const int t = k / a.C, c = k - t * a.C;
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    const int s = p + dy * a.W + dx, cc = col + dx;
    ok = ok && cc >= 0 && cc < a.W && s >= 0 && s < a.P;
    return ok ? a.X + ((size_t)m + dy * a.W + dx) * a.C + c : a.X;
  }
  const bool second = a.mode == A_CONCAT && k >= a.K1;
  const int ld = a.mode == A_CONCAT ? (second ? a.K - a.K1 : a.K1) : a.K;
  const T* src = second ? (a.X2 ? a.X2 : a.X) + (k - a.K1) : a.X + k;
  return ok ? src + (size_t)m * ld : a.X;
}

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

// T = bf16: 8 columns are one 16-byte chunk; T = float: two
template <int BN, class T>
__device__ __forceinline__ void store_pc(const WgArgs<T>& a, const float* st, int m0, int n0) {
  constexpr int CPR = BN / 8;         // 8-column chunks per tile row
  constexpr int EPT = BM * CPR / NT;  // chunks per thread
  constexpr int G = EPT < 4 ? EPT : 4;
  constexpr bool F32 = sizeof(T) == 4;
  static_assert(NT % CPR == 0, "a thread's chunks share their columns");
  const int tid = threadIdx.x, c = tid % CPR, n = n0 + c * 8;
  if (n >= a.N) return;
  const float4 blo = __ldg(reinterpret_cast<const float4*>(a.bias + n));
  const float4 bhi = __ldg(reinterpret_cast<const float4*>(a.bias + n + 4));
#pragma unroll
  for (int e0 = 0; e0 < EPT; e0 += G) {
    uint4 res[G][F32 ? 2 : 1];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int m = m0 + (tid + (e0 + e) * NT) / CPR;
#pragma unroll
      for (int h = 0; h < (F32 ? 2 : 1); ++h) {
        res[e][h] = make_uint4(0, 0, 0, 0);  // zeros without a residual
        if (a.R && m < a.M)
          res[e][h] = __ldg(reinterpret_cast<const uint4*>(a.R + (size_t)m * a.N + n) + h);
      }
    }
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int r = (tid + (e0 + e) * NT) / CPR, m = m0 + r;
      if (m >= a.M) continue;
      const float* row = st + r * Smem<BN>::LDS + c * 8;
      const float4 lo = *reinterpret_cast<const float4*>(row);
      const float4 hi = *reinterpret_cast<const float4*>(row + 4);
      float v[8] = {lo.x + blo.x, lo.y + blo.y, lo.z + blo.z, lo.w + blo.w,
                    hi.x + bhi.x, hi.y + bhi.y, hi.z + bhi.z, hi.w + bhi.w};
      if constexpr (F32) {
        const float* rf = reinterpret_cast<const float*>(&res[e][0]);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k] + rf[k], 0.f);
        float4* o = reinterpret_cast<float4*>(a.out + (size_t)m * a.N + n);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        const bf16* rb = reinterpret_cast<const bf16*>(&res[e][0]);
        uint4 o;
        bf16* ob = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          ob[k] = __float2bfloat16_rn(fmaxf(v[k] + __bfloat162float(rb[k]), 0.f));
        *reinterpret_cast<uint4*>(a.out + (size_t)m * a.N + n) = o;
      }
    }
  }
}

// the (images, N, P) output (K3's layout, so its chain needs no transpose
// out), in two passes.  stage_cp: relu(acc + bias + residual) from the wgmma
// fragment, rounded to T, into the tile transposed in shared memory (sT, one
// padded row of BM pixels per output channel; the 16-byte pad puts the
// fragment's 32 stores of a warp in 32 banks in f32).  copy_cp: 16-byte
// chunks of VEC pixels (8 bf16, 4 f32) along a channel row; VEC rows from a
// multiple of VEC lie in one image where P % VEC == 0, else each pixel is
// stored alone.
template <class T> struct Cp {
  static constexpr int VEC = 16 / sizeof(T);  // pixels per 16-byte chunk
  static constexpr int LDT = BM + VEC;        // T per row of sT (padded)
};

template <int BN, class T>
__device__ __forceinline__ void stage_cp(const WgArgs<T>& a, const float (&acc)[BN / 2],
                                         T* sT, int m0, int n0) {
  constexpr int LDT = Cp<T>::LDT;
  static_assert(BN * LDT * sizeof(T) <= Smem<BN>::EPI, "sT fits where the f32 tile goes");
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
        if constexpr (sizeof(T) == 4) {
          const float2 rr = __ldg(reinterpret_cast<const float2*>(a.R + (size_t)m * a.N + n));
          v0 += rr.x;
          v1 += rr.y;
        } else {
          const __nv_bfloat162 rr =
              __ldg(reinterpret_cast<const __nv_bfloat162*>(a.R + (size_t)m * a.N + n));
          v0 += __low2float(rr);
          v1 += __high2float(rr);
        }
      }
      if constexpr (sizeof(T) == 4) {
        sT[col * LDT + r] = fmaxf(v0, 0.f);
        sT[(col + 1) * LDT + r] = fmaxf(v1, 0.f);
      } else {
        sT[col * LDT + r] = __float2bfloat16_rn(fmaxf(v0, 0.f));
        sT[(col + 1) * LDT + r] = __float2bfloat16_rn(fmaxf(v1, 0.f));
      }
    }
  }
}

template <int BN, class T>
__device__ __forceinline__ void copy_cp(const WgArgs<T>& a, const T* sT, int m0, int n0) {
  constexpr int VEC = Cp<T>::VEC, LDT = Cp<T>::LDT;
  constexpr int CH = BM / VEC;  // 16-byte chunks per channel row
  const bool vec = a.P % VEC == 0;
#pragma unroll
  for (int i = threadIdx.x; i < BN * CH; i += NT) {
    const int nl = i / CH, m = m0 + (i % CH) * VEC, n = n0 + nl;
    if (n >= a.N || m >= a.M) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(sT + nl * LDT + (i % CH) * VEC);
    if (vec) {
      const int b = m / a.P, p = m - b * a.P;
      *reinterpret_cast<uint4*>(a.out + ((size_t)b * a.N + n) * a.P + p) = v;
    } else {
      const T* vt = reinterpret_cast<const T*>(&v);
      for (int k = 0; k < VEC && m + k < a.M; ++k) {
        const int b = (m + k) / a.P, p = m + k - b * a.P;
        a.out[((size_t)b * a.N + n) * a.P + p] = vt[k];
      }
    }
  }
}

template <int BN, bool B_KMAJOR>
__global__ void __launch_bounds__(NT, Cfg<BN>::MIN_CTAS) pc_wgmma_kernel(const WgArgs<bf16> a) {
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
  const int P = a.P, K = a.K, N = a.N, W = a.W;
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
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      bool ok;
      const bf16* src = a_src(a, k, am[j], ap[j], acol[j], ok);
      cp_async_16(sa + sw128_offset(arow[j], ac), src, ok);
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
    stage_cp<BN, bf16>(a, acc, reinterpret_cast<bf16*>(smem), m0, n0);
    __syncthreads();
    copy_cp<BN, bf16>(a, reinterpret_cast<const bf16*>(smem), m0, n0);
  } else {
    stage_pc<BN>(acc, reinterpret_cast<float*>(smem));
    __syncthreads();
    store_pc<BN>(a, reinterpret_cast<const float*>(smem), m0, n0);
  }
}

template <int BN, bool B_KMAJOR>
int launch(const WgArgs<bf16>& a, cudaStream_t s) {
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
template <bool B_KMAJOR> int launch_bn(const WgArgs<bf16>& a, cudaStream_t s) {
  if (a.N % 256 == 0 && a.K >= a.N) return launch<256, B_KMAJOR>(a, s);
  if (a.N % 128 == 0) return launch<128, B_KMAJOR>(a, s);
  return launch<64, B_KMAJOR>(a, s);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32
// ---------------------------------------------------------------------------

constexpr int BK32 = 32;  // K per f32 slab: one 128-byte swizzle row of f32

// BN = 128 keeps its 64 accumulators and two slabs of registers a thread at
// one CTA an SM; BN = 64 fits two
template <int BN> struct Tf32Cfg;
template <> struct Tf32Cfg<128> { static constexpr int MIN_CTAS = 1; };
template <> struct Tf32Cfg<64> { static constexpr int MIN_CTAS = 2; };

template <int BN> struct Tf32Smem {
  static constexpr int A = BM * 128;   // one of A's hi and lo tiles
  static constexpr int B = BN * 128;   // one of B's hi and lo tiles
  static constexpr int STAGE = 2 * A + 2 * B;
  static constexpr int RING = 2 * STAGE;
  static constexpr int BYTES = (RING > Smem<BN>::EPI ? RING : Smem<BN>::EPI) + 1024;
  static_assert(A % 1024 == 0 && B % 1024 == 0, "every tile starts on a swizzle atom");
};

template <int BN, bool B_KMAJOR>
__global__ void __launch_bounds__(NT, Tf32Cfg<BN>::MIN_CTAS) pc_tf32_kernel(const WgArgs<float> a) {
  constexpr int ROWS = NT / 8;               // A rows one pass of the threads loads
  constexpr int A_PER = BM / ROWS;           // A float4 chunks a thread loads per slab
  constexpr int B_PER = BK32 * BN / 4 / NT;  // B float4 items a thread loads per slab
  using S = Tf32Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_addr(smem);

  // N tiles fastest, so neighbouring CTAs share their A rows in L2
  const int ntiles = (a.N + BN - 1) / BN;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = (blockIdx.x / ntiles) * BM, n0 = (blockIdx.x % ntiles) * BN;
  const int P = a.P, K = a.K, N = a.N, W = a.W;
  const int nk = (K + BK32 - 1) / BK32;

  // this thread's A chunks: column chunk ac (4 values) of tile rows
  // tid / 8 + 32 j, which are stack rows am[j], pixel ap[j] of their image,
  // in image column acol[j]
  const int ac = tid & 7;
  int am[A_PER], ap[A_PER], acol[A_PER];
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    am[j] = m0 + tid / 8 + j * ROWS;
    ap[j] = am[j] % P;
    acol[j] = ap[j] % W;
  }

  struct Regs {
    float4 a[A_PER];  // A chunks
    float4 b[B_PER];  // B items: 4 K values of one output channel (K-major, chunk
                      // i % 8 of slab row i / 8), or 4 output channels of one
                      // stack row (krows_item)
  };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // slab kt of both operands into registers
  auto load = [&](int kt, Regs& r) {
    const int k = kt * BK32 + ac * 4;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      bool ok;
      const float* src = a_src(a, k, am[j], ap[j], acol[j], ok);
      r.a[j] = ok ? __ldg(reinterpret_cast<const float4*>(src)) : zero;
    }
#pragma unroll
    for (int u = 0; u < B_PER; ++u) {
      if constexpr (B_KMAJOR) {
        const int i = tid + u * NT, kk = kt * BK32 + (i % 8) * 4, n = n0 + i / 8;
        r.b[u] = kk < K && n < N
                     ? __ldg(reinterpret_cast<const float4*>(a.Wt + (size_t)n * K + kk))
                     : zero;
      } else {
        int kk, grp;
        krows_item(tid + u * NT, kk, grp);
        const int kr = kt * BK32 + kk, n = n0 + 4 * grp;
        r.b[u] = kr < K && n < N
                     ? __ldg(reinterpret_cast<const float4*>(a.Wt + (size_t)kr * N + n))
                     : zero;
      }
    }
  };
  // ... split into hi and lo, stored to ring slot `slot`: A hi, A lo, B hi, B lo
  auto store = [&](int slot, const Regs& r) {
    const uint32_t sa = sbase + slot * S::STAGE, sb = sa + 2 * S::A;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
      const uint32_t off = sw128_offset(tid / 8 + j * ROWS, ac);
      st_split_v4(sa + off, sa + S::A + off, r.a[j]);
    }
#pragma unroll
    for (int u = 0; u < B_PER; ++u) {
      if constexpr (B_KMAJOR) {
        const int i = tid + u * NT;
        const uint32_t off = sw128_offset(i / 8, i % 8);
        st_split_v4(sb + off, sb + S::B + off, r.b[u]);
      } else {
        int kk, grp;
        krows_item(tid + u * NT, kk, grp);
        st_split_krows(sb, sb + S::B, kk, grp, r.b[u]);
      }
    }
  };

  // acc: the running sum; part: one slab's products, added to acc with a
  // rounded f32 add once the slab is done.  The tensor cores truncate as they
  // accumulate, so each of part's 12 accumulations a slab loses up to an ulp
  // of one slab's partial sum instead of the whole running sum's
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;

  // r holds slab kt + 1 while the tensor cores multiply slab kt; slab kt + 2
  // is loaded into it once it is stored
  Regs r;
  if (nk > 0) {
    load(0, r);
    store(0, r);
  }
  if (nk > 1) load(1, r);
  for (int kt = 0; kt < nk; ++kt) {
    fence_proxy_async();  // this thread's stores of slab kt are visible to wgmma
    wgmma_wait<0>();      // this warpgroup's products of slab kt - 1 are done
    fence_regs(part);
    if (kt > 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
    // both warpgroups are past slab kt - 1, whose slot slab kt + 1 refills,
    // and every thread's share of slab kt is in place
    __syncthreads();
    const uint32_t st = sbase + (kt & 1) * S::STAGE;
    const uint32_t sa = st + wg * (64 * 128), sb = st + 2 * S::A;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK32 / 8; ++ks) {
      const uint64_t ah = sw128_desc(sa + ks * 32, 16, 1024);
      const uint64_t al = sw128_desc(sa + S::A + ks * 32, 16, 1024);
      const uint64_t bh = sw128_desc(sb + ks * 32, 16, 1024);
      const uint64_t bl = sw128_desc(sb + S::B + ks * 32, 16, 1024);
      WgmmaTf32<BN>::mma(part, ah, bh, ks > 0);  // the slab's first product starts part
      WgmmaTf32<BN>::mma(part, ah, bl);
      WgmmaTf32<BN>::mma(part, al, bh);
    }
    wgmma_commit();
    fence_regs(part);
    if (kt + 1 < nk) store((kt + 1) & 1, r);  // the slot of slab kt - 1
    if (kt + 2 < nk) load(kt + 2, r);
  }
  wgmma_wait<0>();
  fence_regs(part);
  if (nk > 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }
  __syncthreads();  // the ring is free: reuse it for the output tile
  if (a.out_cp) {
    stage_cp<BN, float>(a, acc, reinterpret_cast<float*>(smem), m0, n0);
    __syncthreads();
    copy_cp<BN, float>(a, reinterpret_cast<const float*>(smem), m0, n0);
  } else {
    stage_pc<BN>(acc, reinterpret_cast<float*>(smem));
    __syncthreads();
    store_pc<BN>(a, reinterpret_cast<const float*>(smem), m0, n0);
  }
}

template <int BN, bool B_KMAJOR>
int launch_tf32(const WgArgs<float>& a, cudaStream_t s) {
  constexpr int bytes = Tf32Smem<BN>::BYTES;
  auto kernel = pc_tf32_kernel<BN, B_KMAJOR>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((a.N + BN - 1) / BN) * ((a.M + BM - 1) / BM);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)tiles, NT, bytes, s>>>(a);
  return (int)cudaGetLastError();
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
  WgArgs<bf16> a{static_cast<const bf16*>(X), static_cast<const bf16*>(X2),
           static_cast<const bf16*>(Wt), bias, static_cast<const bf16*>(R),
           static_cast<bf16*>(out), mode, M, P, K, K1, N, W, C, out_cp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b_kmajor ? launch_bn<true>(a, s) : launch_bn<false>(a, s);
}

// f32, every operand contiguous: the 3xTF32 kernel.  K, C, K1 multiples of 4
// and N of 8 (16-byte chunks, 32-byte epilogue rows); every pointer 16-byte
// aligned; b_kmajor = 1 when Wt is stored (N, K), else (K, N); out_cp = 1
// writes out as (images, N, P).  M = images * P rows.
extern "C" int sq_pc_tf32(int mode, int b_kmajor, const float* X, const float* X2,
                          const float* Wt, const float* bias, const float* R, float* out,
                          int M, int P, int K, int K1, int N, int W, int C, int out_cp,
                          void* stream) {
  if (mode < A_PLAIN || mode > A_CONCAT || K % 4 || N % 8 || W <= 0 || P <= 0 || M % P)
    return (int)cudaErrorInvalidValue;
  if (mode == A_TAPS3 && (C <= 0 || C % 4 || K != 9 * C)) return (int)cudaErrorInvalidValue;
  if (mode == A_CONCAT && (K1 <= 0 || K1 >= K || K1 % 4)) return (int)cudaErrorInvalidValue;
  WgArgs<float> a{X, X2, Wt, bias, R, out, mode, M, P, K, K1, N, W, C, out_cp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 128 == 0)
    return b_kmajor ? launch_tf32<128, true>(a, s) : launch_tf32<128, false>(a, s);
  return b_kmajor ? launch_tf32<64, true>(a, s) : launch_tf32<64, false>(a, s);
}
