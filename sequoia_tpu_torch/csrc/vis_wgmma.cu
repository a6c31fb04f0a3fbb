// K1 vis_blocks_fused: the positional-embedding add and all `depth` ViS
// SummaryMixing blocks of one slide (B = 1 serving) on Hopper's tensor
// cores, in bf16 and in f32.
//
// Replaces sequoia_tpu/ops/pallas_vis.py:vis_blocks_fused (_kernel).  Same
// operands (pack_vis_blocks: per block a (16P, P) chunk of row-stacked
// weight slabs in the compute type and an (8, 3P) f32 smalls block, P =
// H*hw, D = 2P), and per block eight launches with the Pallas kernel's
// epilogues and rounding points (pallas_vis.py:186, :210, :244-250), where
// round() is the store in the compute type:
//   f     local = round(GELU(headLN(xs.Wf + bf)))
//   s     s     = xs.Ws + bs                             (N, P) f32
//   summ  sc    = round(GELU(headLN(mean_tok(s)))).Wc_sum   all N tokens
//   c     c     = round(GELU(local.Wc_loc + sc + bc))    block-diagonal
//   proj  xf    = xs + c.Wproj + bproj                   f32
//   ln    y     = round(LN(xf))
//   ff1   h     = round(GELU(y.W1 + b1))
//   ff2   xs    = round(xf + h.W2 + b2)   (the last block writes f32)
// The summary mean runs over all N tokens (:219).  The packed dense (P, P)
// combine slabs are block diagonal; only the diagonal head blocks are
// multiplied (the Pallas kernel multiplies the zero blocks too).
//
// What bounds it on the H100: weight bytes.  Every weight element meets the
// N = 100 tokens only (about 100 FLOP per byte in bf16, against the card's
// ridge of about 295), so the floor is reading the ~14.1 P^2 weights of each
// block once: ~169 MB in bf16 at depth 6, 0.05 ms at 3.35 TB/s.  In f32 the
// weights are 355 MB (0.106 ms), level with the three TF32 products (3 x
// 17.8 GFLOP, 0.108 ms at 495 TFLOP/s).
//
// What the design does about it:
//   - Swapped GEMMs: out^T = W^T . act^T.  A CTA takes 64 output features
//     (wgmma's M; whole heads where hw | 64 and hw is even, so the per-head
//     LN of `f` stays in the CTA; for every other width a separate launch
//     normalises each head) and a tile of 104 tokens (wgmma's N; rows past N
//     are zero filled).
//   - bf16 (vis_wgmma_gemm): the weight slab is an MN-major A read in place
//     from the packed chunk (the transpose bit), the tokens a K-major B;
//     both go through a 5-stage ring of 128-byte-swizzled 16-byte cp.async
//     copies, 4 slabs of 64 K ahead of the multiply.
//   - f32 (vis_tf32_gemm): 3xTF32, as K5 (lloyd_wgmma.cu): each operand v is
//     split into TF32 hi = rna(v) and lo = rna(v - hi), and hi.hi + hi.lo +
//     lo.hi go to an f32 accumulator per slab (wgmma m64n104k8 .tf32),
//     added to the running sum with a rounded add, as K4's.  TF32 wgmma
//     takes K-major operands only, so both operands go through registers,
//     loaded two slabs of 32 K ahead: the weight slab is transposed on the way
//     (krows_item in hopper.cuh), the tokens are K-major as stored; each
//     thread splits its values and stores hi and lo to a two-slot ring.  The
//     chunk keeps its f32 layout and no lo reaches device memory, so the
//     weight bytes stay 355 MB (the floor above); each CTA splits the
//     weights it reads, a few instructions a value.
//   - Split K inside a thread-block cluster, so every GEMM puts 128 CTAs
//     on the card's 132 SMs at 2 CTAs an SM: f and s 16 tiles x 8, proj,
//     ff1 and ff2 32 tiles x 4 (each CTA streams 32-64 KB of bf16 weights).
//     Each CTA leaves its f32 partial tile in its shared memory; after a
//     cluster barrier CTA r sums every CTA's partial for its share of the
//     tokens through distributed shared memory, in rank order (no float
//     atomics), and runs the epilogue for them, a warp per token.  The
//     combine GEMM is block diagonal (K = the 64-row slabs that hold the
//     heads of the tile's features: its own 64 rows where hw | 64, its
//     head's rows where 64 | hw, the straddled heads' rows otherwise) and
//     runs unsplit.
//   - Programmatic dependent launch: every launch may start while the one
//     before it finishes.  A GEMM issues its first weight loads (which no
//     launch writes) before griddepcontrol.wait, and its token loads after
//     it; it lets the next launch start once its main loop is done.
#include "vis_common.cuh"

using namespace sq;
using namespace sq::hopper;
using namespace sq::vis;

namespace {

using bf16 = __nv_bfloat16;

constexpr int MT = 64;       // output features per CTA: wgmma's M
constexpr int NTOK = 104;    // tokens per CTA: wgmma's N
constexpr int BK = 64;       // K per slab: one 128-byte swizzle row of bf16
constexpr int NT = 128;      // one warpgroup
constexpr int STAGES = 5;    // ring depth: slabs kt+1..kt+4 in flight while kt multiplies
constexpr int A_BYTES = BK * 128;    // weight slab: 64 K rows of 64 features
constexpr int B_BYTES = NTOK * 128;  // token slab: 104 rows of 64 K values
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int LDT = MT + 4;          // floats per token row of the partial tile
constexpr int PART = NTOK * LDT * 4;
constexpr int SMEM = (STAGES * STAGE > PART ? STAGES * STAGE : PART) + 1024;  // + 1 KB to align
constexpr int SPLIT_F = 8, SPLIT_FF = 4;  // cluster sizes: (f, s) and (proj, ff1, ff2)
static_assert(STAGE % 1024 == 0, "every slab starts on a swizzle atom");

template <class T> struct Gemm {
  const T* act;       // (M, K) tokens, row stride K
  const T* W;         // this block's (16P, P) chunk
  int P, base_lo, base_hi;  // feature n reads chunk row (n < P ? base_lo : base_hi) + k
  int M, N, K, hw;
  const float* bias;      // (N,)
  const float* vec;       // E_COMBINE: the summary contribution sc (N,)
  const float* ln_scale;  // E_LOCAL: per-feature LN affine (N,)
  const float* ln_bias;
  const void* res;    // E_PROJ: xs (M, N) compute type; E_FF2: xf (M, N) f32
  void* out;          // (M, N)
  int last;           // E_FF2: write f32 (the stack's output) instead of xs
};

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// the epilogue of features n, n + 1 of token m, from the summed products
// a0, a1; the lanes of a warp hold the 64 features of one token in order
template <int EPI, class T>
__device__ __forceinline__ void epilogue(const Gemm<T>& g, int m, int n, float a0, float a1) {
  const size_t o = (size_t)m * g.N + n;
  const float b0 = g.bias[n], b1 = g.bias[n + 1];
  if constexpr (EPI == E_LOCAL) {
    // per-(token, head) LayerNorm over hw features = hw / 2 neighbouring
    // lanes, or, where hw = 1 (f32 only), over each feature alone
    const float v0 = a0 + b0, v1 = a1 + b1;
    float d0, d1, rstd;
    if (g.hw == 1) {
      d0 = v0 - v0;
      d1 = v1 - v1;
      rstd = 1.f / sqrtf(LN_EPS);
    } else {
      float s = v0 + v1;
      for (int k = g.hw >> 2; k > 0; k >>= 1) s += __shfl_xor_sync(0xffffffffu, s, k);
      const float mean = s / g.hw;
      d0 = v0 - mean;
      d1 = v1 - mean;
      float q = fmaf(d0, d0, d1 * d1);
      for (int k = g.hw >> 2; k > 0; k >>= 1) q += __shfl_xor_sync(0xffffffffu, q, k);
      rstd = 1.f / sqrtf(q / g.hw + LN_EPS);
    }
    store2(static_cast<T*>(g.out) + o,
           gelu_erf(d0 * rstd * g.ln_scale[n] + g.ln_bias[n]),
           gelu_erf(d1 * rstd * g.ln_scale[n + 1] + g.ln_bias[n + 1]));
  } else if constexpr (EPI == E_STORE_F32) {
    store2(static_cast<float*>(g.out) + o, a0 + b0, a1 + b1);
  } else if constexpr (EPI == E_COMBINE) {
    store2(static_cast<T*>(g.out) + o, gelu_erf(a0 + g.vec[n] + b0),
           gelu_erf(a1 + g.vec[n + 1] + b1));
  } else if constexpr (EPI == E_PROJ) {
    const float2 x = load2(static_cast<const T*>(g.res) + o);
    store2(static_cast<float*>(g.out) + o, x.x + a0 + b0, x.y + a1 + b1);
  } else if constexpr (EPI == E_FF1) {
    store2(static_cast<T*>(g.out) + o, gelu_erf(a0 + b0), gelu_erf(a1 + b1));
  } else {  // E_FF2
    const float2 x = load2(static_cast<const float*>(g.res) + o);
    const float v0 = x.x + a0 + b0, v1 = x.y + a1 + b1;
    if (g.last) store2(static_cast<float*>(g.out) + o, v0, v1);
    else store2(static_cast<T*>(g.out) + o, v0, v1);
  }
}

// After the main loop, with the ring free: the f32 partial tile into shared
// memory, token-major (part[t * LDT + f], see Wgmma in hopper.cuh); after a
// cluster barrier CTA `rank` sums the cluster's partials for its share of
// the tokens in rank order through distributed shared memory and runs their
// epilogue, a warp per token, two features a lane
template <int EPI, class T>
__device__ __forceinline__ void finish(const Gemm<T>& g, const float (&acc)[52], float* part,
                                       int n0, int m0, int cs, int rank) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int f0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < NTOK / 8; ++j) {
    const int t = j * 8 + (lane & 3) * 2;
    part[t * LDT + f0] = acc[4 * j];
    part[(t + 1) * LDT + f0] = acc[4 * j + 1];
    part[t * LDT + f0 + 8] = acc[4 * j + 2];
    part[(t + 1) * LDT + f0 + 8] = acc[4 * j + 3];
  }
  cluster_sync();  // every CTA's partial is written

  const int ntok = min(NTOK, g.M - m0);
  const int t1 = (rank + 1) * ntok / cs;
  const uint32_t pbase = smem_addr(part);
  for (int t = rank * ntok / cs + warp; t < t1; t += NT / 32) {
    const uint32_t off = pbase + (uint32_t)(t * LDT + 2 * lane) * 4;
    float a0 = 0.f, a1 = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float2 p = ld_cluster_f2(map_rank(off, r));
      a0 += p.x;
      a1 += p.y;
    }
    epilogue<EPI>(g, m0 + t, n0 + 2 * lane, a0, a1);
  }
  cluster_sync();  // no CTA leaves while another reads its partial
}

// grid (N / 64 * cluster, ceil(M / 104)), clusters of `cluster` CTAs along x
// that split one tile's K slabs between them
template <int EPI>
__global__ void __launch_bounds__(NT, 2) vis_wgmma_gemm(const Gemm<bf16> g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x;
  const int cs = cluster_size(), rank = cluster_rank();
  const int n0 = (blockIdx.x / cs) * MT, m0 = blockIdx.y * NTOK;
  const int P = g.P, M = g.M, K = g.K;
  const bool lo = n0 < P;
  const bf16* Wt = g.W + (size_t)(lo ? g.base_lo : g.base_hi) * P + (lo ? n0 : n0 - P);
  // the combine slab is block diagonal with hw x hw blocks: features [n0,
  // n0 + 64) only meet the rows of their heads (vis_common.cuh, diag_first)
  const int kbase = EPI == E_COMBINE ? diag_first(n0, g.hw) : 0;
  const int nk_all = (EPI == E_COMBINE ? diag_last(n0, g.hw) - kbase : K) / BK;
  const int s0 = rank * nk_all / cs, nk = (rank + 1) * nk_all / cs - s0;

  auto load_w = [&](int s, int slot) {  // row kr of the slab: 64 features of K row k0 + kr
    const uint32_t sa = sbase + slot * STAGE;
    const int k0 = kbase + (s0 + s) * BK;
#pragma unroll
    for (int u = 0; u < BK * 8 / NT; ++u) {
      const int i = tid + u * NT, kr = i >> 3, c = i & 7;
      cp_async_16(sa + sw128_offset(kr, c), Wt + (size_t)(k0 + kr) * P + c * 8, true);
    }
  };
  auto load_x = [&](int s, int slot) {  // row t of the slab: 64 K values of token m0 + t
    const uint32_t sb = sbase + slot * STAGE + A_BYTES;
    const int k0 = kbase + (s0 + s) * BK;
    for (int i = tid; i < NTOK * 8; i += NT) {
      const int t = i >> 3, c = i & 7, m = m0 + t;
      const bool ok = m < M;
      cp_async_16(sb + sw128_offset(t, c), ok ? g.act + (size_t)m * K + k0 + c * 8 : g.act, ok);
    }
  };

  // the weights no launch writes: their copies go out before the wait on
  // the previous launch; the tokens after it.  Group 0 holds every weight
  // copy of the prologue, group s the tokens of slab s.
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < nk) load_w(s, s);
  griddep_wait();
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_x(s, s);
    cp_async_commit();
  }

  float acc[52];
#pragma unroll
  for (int i = 0; i < 52; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slab kt have landed
    fence_proxy_async();
    // every thread's copies of slab kt are visible, and the wgmma of slab
    // kt - 1, whose slot is refilled below, is done
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < nk) {
      load_w(next, next % STAGES);
      load_x(next, next % STAGES);
    }
    cp_async_commit();
    const uint32_t sa = sbase + (kt % STAGES) * STAGE, sb = sa + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      Wgmma104<1, 0>::mma(acc, sw128_desc(sa + ks * 16 * 128, A_BYTES, 1024),
                          sw128_desc(sb + ks * 32, 16, 1024));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  griddep_launch();
  __syncthreads();  // the ring is free: it takes the partial tile

  finish<EPI>(g, acc, reinterpret_cast<float*>(smem), n0, m0, cs, rank);
}

// f32, 3xTF32: slabs of 32 K (one 128-byte row of f32) through registers
// into a two-slot ring of weight hi, weight lo, token hi, token lo tiles
constexpr int BK32 = 32;
constexpr int TA = MT * 128;          // one of the weight slab's hi and lo tiles
constexpr int TB = NTOK * 128;        // one of the token slab's hi and lo tiles
constexpr int STAGE32 = 2 * TA + 2 * TB;
constexpr int SMEM32 = (2 * STAGE32 > PART ? 2 * STAGE32 : PART) + 1024;
constexpr int W_PER = BK32 * MT / 4 / NT;          // weight float4 items a thread
constexpr int X_PER = (NTOK * 8 + NT - 1) / NT;    // token float4 chunks a thread
static_assert(TA % 1024 == 0 && TB % 1024 == 0, "every tile starts on a swizzle atom");

// grid and clusters as vis_wgmma_gemm
template <int EPI>
__global__ void __launch_bounds__(NT, 2) vis_tf32_gemm(const Gemm<float> g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x;
  const int cs = cluster_size(), rank = cluster_rank();
  const int n0 = (blockIdx.x / cs) * MT, m0 = blockIdx.y * NTOK;
  const int P = g.P, M = g.M, K = g.K;
  const bool lo = n0 < P;
  const float* Wt = g.W + (size_t)(lo ? g.base_lo : g.base_hi) * P + (lo ? n0 : n0 - P);
  const int kbase = EPI == E_COMBINE ? diag_first(n0, g.hw) : 0;
  const int nk_all = (EPI == E_COMBINE ? diag_last(n0, g.hw) - kbase : K) / BK32;
  const int s0 = rank * nk_all / cs, nk = (rank + 1) * nk_all / cs - s0;

  struct Regs {
    float4 w[W_PER];  // weight items: 4 features of one K row (krows_item)
    float4 x[X_PER];  // token chunks: 4 K values of one token
  };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_w = [&](int s, Regs& r) {
    const int k0 = kbase + (s0 + s) * BK32;
#pragma unroll
    for (int u = 0; u < W_PER; ++u) {
      int kk, grp;
      krows_item(tid + u * NT, kk, grp);
      r.w[u] = __ldg(reinterpret_cast<const float4*>(Wt + (size_t)(k0 + kk) * P + 4 * grp));
    }
  };
  auto load_x = [&](int s, Regs& r) {
    const int k0 = kbase + (s0 + s) * BK32;
#pragma unroll
    for (int u = 0; u < X_PER; ++u) {
      const int i = tid + u * NT, m = m0 + (i >> 3);
      r.x[u] = i < NTOK * 8 && m < M
                   ? __ldg(reinterpret_cast<const float4*>(g.act + (size_t)m * K + k0 +
                                                           (i & 7) * 4))
                   : zero;
    }
  };
  auto store = [&](int slot, const Regs& r) {
    const uint32_t sa = sbase + slot * STAGE32, sb = sa + 2 * TA;
#pragma unroll
    for (int u = 0; u < W_PER; ++u) {
      int kk, grp;
      krows_item(tid + u * NT, kk, grp);
      st_split_krows(sa, sa + TA, kk, grp, r.w[u]);
    }
#pragma unroll
    for (int u = 0; u < X_PER; ++u) {
      const int i = tid + u * NT;
      if (i < NTOK * 8) {
        const uint32_t off = sw128_offset(i >> 3, i & 7);
        st_split_v4(sb + off, sb + TB + off, r.x[u]);
      }
    }
  };

  // acc: the running sum; part: one slab's products, added to acc with a
  // rounded f32 add once the slab is done (the tensor cores truncate as they
  // accumulate: a truncation loses up to an ulp of one slab's partial sum)
  float acc[52], part[52];
#pragma unroll
  for (int i = 0; i < 52; ++i) acc[i] = part[i] = 0.f;

  // r holds slab kt + 1 while the tensor cores multiply slab kt; slab kt + 2
  // is loaded into it once it is stored.  The weights no launch writes:
  // their first loads go out before the wait on the previous launch; the
  // tokens after it.
  Regs r;
  if (nk > 0) load_w(0, r);
  griddep_wait();
  if (nk > 0) {
    load_x(0, r);
    store(0, r);
  }
  if (nk > 1) {
    load_w(1, r);
    load_x(1, r);
  }
  for (int kt = 0; kt < nk; ++kt) {
    fence_proxy_async();  // this thread's stores of slab kt are visible to wgmma
    wgmma_wait<0>();      // the products of slab kt - 1 are done
    fence_regs(part);
    if (kt > 0) {
#pragma unroll
      for (int i = 0; i < 52; ++i) acc[i] += part[i];
    }
    __syncthreads();      // ... and every thread's share of slab kt is in place
    const uint32_t sa = sbase + (kt & 1) * STAGE32, sb = sa + 2 * TA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK32 / 8; ++ks) {
      const uint64_t ah = sw128_desc(sa + ks * 32, 16, 1024);
      const uint64_t al = sw128_desc(sa + TA + ks * 32, 16, 1024);
      const uint64_t bh = sw128_desc(sb + ks * 32, 16, 1024);
      const uint64_t bl = sw128_desc(sb + TB + ks * 32, 16, 1024);
      WgmmaTf32<NTOK>::mma(part, ah, bh, ks > 0);  // the slab's first product starts part
      WgmmaTf32<NTOK>::mma(part, ah, bl);
      WgmmaTf32<NTOK>::mma(part, al, bh);
    }
    wgmma_commit();
    fence_regs(part);
    if (kt + 1 < nk) store((kt + 1) & 1, r);  // the slot of slab kt - 1
    if (kt + 2 < nk) {
      load_w(kt + 2, r);
      load_x(kt + 2, r);
    }
  }
  wgmma_wait<0>();
  fence_regs(part);
  if (nk > 0) {
#pragma unroll
    for (int i = 0; i < 52; ++i) acc[i] += part[i];
  }
  griddep_launch();
  __syncthreads();  // the ring is free: it takes the partial tile

  finish<EPI>(g, acc, reinterpret_cast<float*>(smem), n0, m0, cs, rank);
}

// every launch allows programmatic stream serialization; cluster > 0 also
// sets the cluster's size along x
template <class... Params, class... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, int smem, int cluster,
           cudaStream_t st, Args... args) {
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = cluster > 0 ? cluster : 1;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster > 0 ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int EPI>
int gemm(const Gemm<bf16>& g, int cluster, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(vis_wgmma_gemm<EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.N / MT * cluster, (g.M + NTOK - 1) / NTOK);
  return launch(vis_wgmma_gemm<EPI>, grid, NT, SMEM, cluster, st, g);
}

template <int EPI>
int gemm(const Gemm<float>& g, int cluster, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(vis_tf32_gemm<EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM32);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(g.N / MT * cluster, (g.M + NTOK - 1) / NTOK);
  return launch(vis_tf32_gemm<EPI>, grid, NT, SMEM32, cluster, st, g);
}

// Launches: 1 + 8 * depth (1 + 9 * depth where !ln_in_epilogue(hw): the f
// GEMM stores f32 and vis_head_ln normalises whole heads), each with
// programmatic stream serialization, the GEMMs in clusters of 8 (f, s), 1 (c)
// and 4 (proj, ff1, ff2) CTAs with 108.5 KB (bf16) or 85 KB (f32) of dynamic
// shared memory each.
template <class T>
int run(const float* x, const float* pos, const T* chunks, const float* smalls, int M,
        int P, int depth, int hw, T* xs_, T* local_, float* s, float* sc, T* c_, float* xf,
        T* y_, T* h_, float* out, cudaStream_t st) {
  if (M <= 0 || P <= 0 || P % 64 || hw <= 0 || P % hw || depth <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr bool BF = sizeof(T) == 2;
  const int D = 2 * P;
  int rc = (int)summary_attr<T>(hw);
  if (rc == 0)
    rc = launch(vis_init<T>, dim3((M * D + 255) / 256), 256, 0, 0, st, x, pos, xs_, M * D);
  for (int d = 0; d < depth && rc == 0; ++d) {
    const T* W = chunks + (size_t)d * 16 * P * P;
    const float* sm = smalls + (size_t)d * 8 * 3 * P;
    auto seg = [&](int r, int k) { return sm + (size_t)r * 3 * P + (size_t)k * P; };
    const bool last = d == depth - 1;
    Gemm<T> g{};
    g.W = W; g.P = P; g.M = M; g.hw = hw;
    // f: local branch; where a 64-feature tile does not hold whole heads
    // (or, in bf16, hw is odd) the GEMM stores f32 (into s, free until the s
    // GEMM) and vis_head_ln normalises each head
    g.act = xs_; g.base_lo = 0; g.base_hi = 0; g.N = P; g.K = D;
    g.bias = seg(0, 0); g.ln_scale = seg(0, 1); g.ln_bias = seg(0, 2); g.out = local_;
    if (ln_in_epilogue(hw, BF)) {
      rc = gemm<E_LOCAL>(g, SPLIT_F, st);
    } else {
      g.out = s;
      rc = gemm<E_STORE_F32>(g, SPLIT_F, st);
      if (rc == 0)
        rc = launch(vis_head_ln<T>, dim3((M * (P / hw) + 7) / 8), 256, 0, 0, st,
                    (const float*)s, M, P, hw, seg(0, 1), seg(0, 2), local_);
    }
    // s: summary projection (f32, mean taken next)
    g.base_lo = 2 * P; g.base_hi = 2 * P; g.bias = seg(1, 0); g.out = s;
    if (rc == 0) rc = gemm<E_STORE_F32>(g, SPLIT_F, st);
    if (rc == 0)
      rc = launch(vis_summary<T>, dim3(P / head_group(hw)), summary_threads(hw),
                  summary_smem(hw), 0, st, (const float*)s, M, P, hw, seg(1, 1), seg(1, 2),
                  W + (size_t)5 * P * P, sc);
    // c: per-head combine of the local branch + the summary contribution
    g.act = local_; g.base_lo = 4 * P; g.base_hi = 4 * P; g.K = P; g.N = P;
    g.vec = sc; g.bias = seg(2, 0); g.out = c_;
    if (rc == 0) rc = gemm<E_COMBINE>(g, 1, st);
    // proj + residual, f32
    g.act = c_; g.base_lo = 6 * P; g.base_hi = 7 * P; g.K = P; g.N = D;
    g.bias = seg(3, 0); g.res = xs_; g.out = xf;
    if (rc == 0) rc = gemm<E_PROJ>(g, SPLIT_FF, st);
    // FeedForward
    if (rc == 0)
      rc = launch(vis_ln<T>, dim3(M), 256, 0, 0, st, (const float*)xf, D, seg(6, 0),
                  seg(7, 0), y_);
    g.act = y_; g.base_lo = 8 * P; g.base_hi = 10 * P; g.K = D; g.N = D;
    g.bias = seg(4, 0); g.out = h_;
    if (rc == 0) rc = gemm<E_FF1>(g, SPLIT_FF, st);
    g.act = h_; g.base_lo = 12 * P; g.base_hi = 14 * P;
    g.bias = seg(5, 0); g.res = xf; g.last = last;
    g.out = last ? static_cast<void*>(out) : static_cast<void*>(xs_);
    if (rc == 0) rc = gemm<E_FF2>(g, SPLIT_FF, st);
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace

// bf16: the tensor-core kernel.  P % 64 == 0 and P % hw == 0; every pointer
// 16-byte aligned.
extern "C" int sq_vis_wgmma(const float* x, const float* pos, const void* chunks,
                            const float* smalls, int M, int P, int depth, int hw,
                            void* xs, void* local, float* s, float* sc, void* c,
                            float* xf, void* y, void* h, float* out, void* stream) {
  return run<bf16>(x, pos, static_cast<const bf16*>(chunks), smalls, M, P, depth, hw,
                   static_cast<bf16*>(xs), static_cast<bf16*>(local), s, sc,
                   static_cast<bf16*>(c), xf, static_cast<bf16*>(y), static_cast<bf16*>(h),
                   out, static_cast<cudaStream_t>(stream));
}

// f32 (dtype 0): the 3xTF32 kernel, on the same operands and constraints.
extern "C" int sq_vis_blocks(int dtype, const float* x, const float* pos,
                             const void* chunks, const float* smalls, int M, int P,
                             int depth, int hw, void* xs, void* local, float* s,
                             float* sc, void* c, float* xf, void* y, void* h,
                             float* out, void* stream) {
  if (dtype != F32) return (int)cudaErrorInvalidValue;
  return run<float>(x, pos, static_cast<const float*>(chunks), smalls, M, P, depth, hw,
                    static_cast<float*>(xs), static_cast<float*>(local), s, sc,
                    static_cast<float*>(c), xf, static_cast<float*>(y),
                    static_cast<float*>(h), out, static_cast<cudaStream_t>(stream));
}
