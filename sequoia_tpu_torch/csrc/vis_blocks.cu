// K1 vis_blocks_fused: the positional-embedding add and all `depth` ViS
// SummaryMixing blocks of one slide (B = 1 serving).
//
// Replaces sequoia_tpu/ops/pallas_vis.py:vis_blocks_fused (_kernel) in f32
// (bf16 runs the tensor-core kernel of vis_wgmma.cu; the C entry here
// refuses it).  It reads
// the same packed operands (pack_vis_blocks): per block a (16P, P) chunk of
// row-stacked weight slabs in the compute type and an (8, 3P) f32 "smalls"
// block of biases and LayerNorm affines, with P = H*hw and D = 2P.
//
// Per block, eight launches through the shared GEMM core (A = token rows,
// B = a weight slab read in place from the chunk):
//   f     local = round(GELU(headLN(xs.Wf + bf)))      per-head LN in the epilogue
//                                                        where hw | 64, else vis_head_ln
//   s     s     = xs.Ws + bs                           (N, P) f32
//   summ  sc    = round(GELU(headLN(mean_tok(s)))).Wc_sum   one block per head group
//   c     c     = round(GELU(local.Wc_loc + sc + bc))  block-diagonal: K = the tile's heads' rows
//   proj  xf    = xs + c.Wproj + bproj                 f32
//   ln    y     = round(LN(xf))
//   ff1   h     = round(GELU(y.W1 + b1))
//   ff2   xs    = round(xf + h.W2 + b2)   (the last block writes f32, unrounded)
// where round() is the store in the compute type, at the points the Pallas
// kernel rounds (pallas_vis.py:186, :210, :244-250).  The summary mean runs
// over all N tokens, zero-filled ones included (:219).  The packed dense
// (P, P) combine slabs are block diagonal; this kernel multiplies only the
// diagonal head blocks (the Pallas kernel multiplies the zero blocks too).
//
// What bounds it on the H100: weight bytes.  With N = 100 tokens every weight
// is used for 100 rows only (2 FLOP per weight element per token, ~100 FLOP
// per byte in bf16, far below the card's ~295 FLOP/byte ridge), so the floor
// is reading ~14.1 P^2 weights per block once (~169 MB in bf16 at depth 6).
// This kernel streams each slab once per 64-token tile from L2 and computes
// on the CUDA cores in f32 FMA (full f32: the parity path).
#include "vis_common.cuh"

using namespace sq;
using namespace sq::vis;

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int NTHREADS = (BM / TM) * (BN / TN);

struct VisGemm {
  const void* A;      // (M, K) activations in the compute type, row stride K
  const void* W;      // this block's (16P, P) chunk
  int P, base_lo, base_hi;  // output col n reads chunk row (n < P ? base_lo : base_hi) + k
  int M, N, K, hw;
  const float* bias;  // (N,) f32
  const float* vec;   // E_COMBINE: the summary contribution sc (N,) f32
  const float* ln_scale;  // E_LOCAL: per-column LN affine (N,) f32
  const float* ln_bias;
  const void* res;    // E_PROJ: xs (M, N) compute type; E_FF2: xf (M, N) f32
  void* out;
  int last;           // E_FF2: write f32 (the stack's output) instead of xs
};

template <class T, int EPI>
__global__ void __launch_bounds__(NTHREADS) vis_gemm(VisGemm g) {
  __shared__ float As[TileSmem<BM, BN, BK>::A];
  __shared__ float Bs[TileSmem<BM, BN, BK>::B];
  __shared__ float Cs[BM][BN + 1];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* A = static_cast<const T*>(g.A);
  const T* W = static_cast<const T*>(g.W);
  const int M = g.M, N = g.N, K = g.K, P = g.P;

  auto la = [&](int m, int k) -> float { return m < M ? to_f(A[(size_t)m * K + k]) : 0.f; };
  auto lb = [&](int k, int n) -> float {
    if (n >= N) return 0.f;
    const bool lo = n < P;
    return to_f(W[(size_t)((lo ? g.base_lo : g.base_hi) + k) * P + (lo ? n : n - P)]);
  };
  float acc[TM][TN] = {};
  // the combine slab is block diagonal with hw x hw blocks: output cols
  // [n0, n0+BN) only meet the rows of their heads (BN = 64; diag_first)
  const int k0 = EPI == E_COMBINE ? diag_first(n0, g.hw) : 0;
  const int k1 = EPI == E_COMBINE ? diag_last(n0, g.hw) : K;
  gemm_tile<BM, BN, BK, TM, TN, true, false>(acc, m0, n0, k0, k1, la, lb, As, Bs);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  if constexpr (EPI == E_LOCAL) {
    // bias into the tile, then per-(row, head) LayerNorm + GELU in shared memory
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        Cs[ty * TM + i][tx * TN + j] = acc[i][j] + (n < N ? g.bias[n] : 0.f);
      }
    __syncthreads();
    const int hw = g.hw, heads = BN / hw;
    for (int w = threadIdx.x; w < BM * heads; w += NTHREADS) {
      const int r = w / heads, c0 = (w % heads) * hw;
      float mean = 0.f;
      for (int c = 0; c < hw; ++c) mean += Cs[r][c0 + c];
      mean /= hw;
      float var = 0.f;
      for (int c = 0; c < hw; ++c) {
        const float d = Cs[r][c0 + c] - mean;
        var = fmaf(d, d, var);
      }
      var /= hw;
      const float rstd = 1.f / sqrtf(var + LN_EPS);
      for (int c = 0; c < hw; ++c) {
        const int n = n0 + c0 + c;
        const float v = (Cs[r][c0 + c] - mean) * rstd * g.ln_scale[n] + g.ln_bias[n];
        Cs[r][c0 + c] = gelu_erf(v);
      }
    }
    __syncthreads();
    T* out = static_cast<T*>(g.out);
    for (int w = threadIdx.x; w < BM * BN; w += NTHREADS) {
      const int r = w / BN, c = w % BN;
      const int m = m0 + r, n = n0 + c;
      if (m < M && n < N) out[(size_t)m * N + n] = from_f<T>(Cs[r][c]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (n >= N) continue;
        const size_t o = (size_t)m * N + n;
        const float a = acc[i][j];
        if constexpr (EPI == E_STORE_F32) {
          static_cast<float*>(g.out)[o] = a + g.bias[n];
        } else if constexpr (EPI == E_COMBINE) {
          static_cast<T*>(g.out)[o] = from_f<T>(gelu_erf(a + g.vec[n] + g.bias[n]));
        } else if constexpr (EPI == E_PROJ) {
          const float x = to_f(static_cast<const T*>(g.res)[o]);
          static_cast<float*>(g.out)[o] = x + a + g.bias[n];
        } else if constexpr (EPI == E_FF1) {
          static_cast<T*>(g.out)[o] = from_f<T>(gelu_erf(a + g.bias[n]));
        } else {  // E_FF2
          const float v = static_cast<const float*>(g.res)[o] + a + g.bias[n];
          if (g.last) static_cast<float*>(g.out)[o] = v;
          else static_cast<T*>(g.out)[o] = from_f<T>(v);
        }
      }
    }
  }
}

template <class T, int EPI>
void gemm(const VisGemm& g, cudaStream_t s) {
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  vis_gemm<T, EPI><<<grid, NTHREADS, 0, s>>>(g);
}

template <class T>
int run(const float* x, const float* pos, const T* chunks, const float* smalls, int M,
        int P, int depth, int hw, T* xs, T* local, float* sbuf, float* sc, T* cbuf,
        float* xf, T* y, T* h, float* out, cudaStream_t st) {
  const int D = 2 * P;
  const cudaError_t attr = summary_attr<T>(hw);
  if (attr != cudaSuccess) return (int)attr;
  vis_init<T><<<(M * D + 255) / 256, 256, 0, st>>>(x, pos, xs, M * D);
  for (int d = 0; d < depth; ++d) {
    const T* W = chunks + (size_t)d * 16 * P * P;
    const float* sm = smalls + (size_t)d * 8 * 3 * P;
    auto seg = [&](int r, int k) { return sm + (size_t)r * 3 * P + (size_t)k * P; };
    const bool last = d == depth - 1;
    VisGemm g{};
    g.W = W; g.P = P; g.M = M; g.hw = hw;
    // f: local branch (where a tile does not hold whole heads: f32 into
    // sbuf, then vis_head_ln)
    g.A = xs; g.base_lo = 0; g.base_hi = 0; g.N = P; g.K = D;
    g.bias = seg(0, 0); g.ln_scale = seg(0, 1); g.ln_bias = seg(0, 2); g.out = local;
    if (ln_in_epilogue(hw, false)) {
      gemm<T, E_LOCAL>(g, st);
    } else {
      g.out = sbuf;
      gemm<T, E_STORE_F32>(g, st);
      vis_head_ln<T><<<(M * (P / hw) + 7) / 8, 256, 0, st>>>(sbuf, M, P, hw, seg(0, 1),
                                                             seg(0, 2), local);
    }
    // s: summary projection (f32, mean taken next)
    g.base_lo = 2 * P; g.base_hi = 2 * P; g.bias = seg(1, 0); g.out = sbuf;
    gemm<T, E_STORE_F32>(g, st);
    vis_summary<T><<<P / head_group(hw), summary_threads(hw), summary_smem(hw), st>>>(
        sbuf, M, P, hw, seg(1, 1), seg(1, 2), W + (size_t)5 * P * P, sc);
    // c: per-head combine of the local branch + the summary contribution
    g.A = local; g.base_lo = 4 * P; g.base_hi = 4 * P; g.K = P; g.N = P;
    g.vec = sc; g.bias = seg(2, 0); g.out = cbuf;
    gemm<T, E_COMBINE>(g, st);
    // proj + residual, f32
    g.A = cbuf; g.base_lo = 6 * P; g.base_hi = 7 * P; g.K = P; g.N = D;
    g.bias = seg(3, 0); g.res = xs; g.out = xf;
    gemm<T, E_PROJ>(g, st);
    // FeedForward
    vis_ln<T><<<M, 256, 0, st>>>(xf, D, seg(6, 0), seg(7, 0), y);
    g.A = y; g.base_lo = 8 * P; g.base_hi = 10 * P; g.K = D; g.N = D;
    g.bias = seg(4, 0); g.out = h;
    gemm<T, E_FF1>(g, st);
    g.A = h; g.base_lo = 12 * P; g.base_hi = 14 * P;
    g.bias = seg(5, 0); g.res = xf; g.last = last;
    g.out = last ? static_cast<void*>(out) : static_cast<void*>(xs);
    gemm<T, E_FF2>(g, st);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// f32 only; P % 64 == 0 and P % hw == 0.  Launches: 1 + 8 * depth (1 + 9 *
// depth where hw does not divide 64)
extern "C" int sq_vis_blocks(int dtype, const float* x, const float* pos,
                             const void* chunks, const float* smalls, int M, int P,
                             int depth, int hw, void* xs, void* local, float* s,
                             float* sc, void* c, float* xf, void* y, void* h,
                             float* out, void* stream) {
  if (dtype != F32 || P % 64 != 0 || hw <= 0 || P % hw) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return run<float>(x, pos, static_cast<const float*>(chunks), smalls, M, P, depth,
                    hw, static_cast<float*>(xs), static_cast<float*>(local), s, sc,
                    static_cast<float*>(c), xf, static_cast<float*>(y),
                    static_cast<float*>(h), out, st);
}
