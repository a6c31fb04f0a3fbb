// vit_glue on Hopper: the ViT block's memory-bound passes between its GEMMs
// (models/uni_vit.py _block), for UNI (D 1024, GELU MLP) and Virchow2 (D
// 1280, packed SwiGLU MLP of 6832 -> 3416), in bf16:
//   vit_swiglu       the packed gate, fc1's (M, 2H) output -> (M, H):
//                    bf16(bf16(silu(a)) * b) of its halves a = h[:, :H] and
//                    b = h[:, H:];
//   vit_residual_ln  the LayerScale residual x' = bf16(x + out * gamma) and
//                    the LayerNorm after it, y = LN(x'), both written.
//
// Replace no TPU kernel: the JAX package leaves the residual and the
// LayerNorm to XLA (sequoia_tpu/models/uni_vit.py), which fuses them into the
// neighbouring ops, and has no Virchow2, so no gate.  Eager PyTorch ran each
// as passes of its own through device memory: F.silu over the strided first
// half of fc1's output, its product with the strided second half (both
// PyTorch's non-vectorised elementwise kernel, for strided operands),
// torch.addcmul with a broadcast gamma, then F.layer_norm reading x' again.
//
// Operands: contiguous bf16, 16-byte aligned, widths (H, D) multiples of 8,
// so that every row and both halves of a gate row start on 16 bytes and each
// thread moves 16 bytes (8 values) a load.  The mathematics and rounding
// points are those of ops/cuda_vit_glue.swiglu_plain and residual_ln_plain:
//   gate:     s = a / (1 + exp(-a)) in f32 (PyTorch's silu), rounded to bf16;
//             s * b in f32, rounded to bf16;
//   residual: x + out * gamma with torch.addcmul's f32 op-math: the product
//             rounded in f32, then the sum (no fused multiply-add), rounded
//             to bf16: the same bits as addcmul;
//   LN:       the mean and biased variance of the bf16 x' in f32 (the
//             variance from the row's deviations from its mean, two passes
//             over registers), rstd = rsqrt(var + eps), y = w * (rstd * (x' -
//             mean)) + b in f32, rounded to bf16: F.layer_norm's formula; its
//             Welford statistics sum in another order, so y can round one
//             bf16 ulp apart.
//
// What bounds them on the H100: bytes.  The gate reads 2 M H and writes M H
// values: 684.7 MB at Virchow2's (33,408 x 6832), 0.204 ms at 3.35 TB/s.  The
// residual reads x and out and writes x' and y: 4 M D values, 342 MB at
// Virchow2's (33,408 x 1280), 0.102 ms, and 206.6 MB at UNI's (25,216 x
// 1024), 0.062 ms; gamma and the LayerNorm affine (3 D values) stay in L1/L2.
//
// Design:
//   - gate: one thread a 16-byte chunk of the output; it loads the chunk of
//     a and of b in place from fc1's row (no copies of the halves), both as
//     streaming loads, and stores one 16-byte chunk;
//   - residual: one warp a row, a lane holding ceil(D / 256) chunks of x' in
//     registers as packed bf16 (K = 5 at D 1280, 4 at D 1024: 20 and 16
//     registers), so the statistics and y need no second read of device
//     memory; the row's sums by warp shuffles, four rows a 128-thread block.
// On the H100 (chip_smoke.py's rows): the gate 0.234 ms at Virchow2's shape,
// 87% of its byte bound, against 0.648 for F.silu and the product; the
// residual 0.076 ms at UNI's and 0.122 at Virchow2's, 81% and 83%, against
// 0.145 and 0.224 for addcmul and F.layer_norm.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int LN_WARPS = 4;    // rows a block of vit_residual_ln
constexpr int MAX_LN_K = 8;    // 16-byte chunks a lane: D <= 2048
constexpr int GATE_THREADS = 256;

// the two bf16 of a 32-bit word, in memory order (element 2i in the low half)
__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack(float l, float h) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(l, h);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// bf16(bf16(silu(a)) * b) for the two values of a word
__device__ __forceinline__ float gate1(float a, float b) {
  const float s = __bfloat162float(__float2bfloat16_rn(a / (1.0f + expf(-a))));
  return s * b;
}
__device__ __forceinline__ uint32_t gate2(uint32_t a, uint32_t b) {
  return pack(gate1(lo(a), lo(b)), gate1(hi(a), hi(b)));
}

// bf16(x + out * gamma), the product and the sum rounded apart (addcmul)
__device__ __forceinline__ float res1(float x, float o, float g) {
  return __fadd_rn(x, __fmul_rn(o, g));
}
__device__ __forceinline__ uint32_t res2(uint32_t x, uint32_t o, uint32_t g) {
  return pack(res1(lo(x), lo(o), lo(g)), res1(hi(x), hi(o), hi(g)));
}

__global__ void __launch_bounds__(GATE_THREADS)
vit_swiglu_kernel(const uint4* __restrict__ h, uint4* __restrict__ out, unsigned chunks,
                  unsigned C) {
  const unsigned i = blockIdx.x * GATE_THREADS + threadIdx.x;
  if (i >= chunks) return;
  const unsigned row = i / C, c = i - row * C;
  const uint4* a = h + (size_t)row * 2 * C + c;
  const uint4 va = __ldcs(a), vb = __ldcs(a + C);
  uint4 o;
  o.x = gate2(va.x, vb.x);
  o.y = gate2(va.y, vb.y);
  o.z = gate2(va.z, vb.z);
  o.w = gate2(va.w, vb.w);
  out[i] = o;
}

// One warp a row of D = 8 C values, K = ceil(C / 32) chunks a lane.
template <int K>
__global__ void __launch_bounds__(32 * LN_WARPS)
vit_residual_ln_kernel(const uint4* __restrict__ x, const uint4* __restrict__ o,
                       const uint4* __restrict__ g, const uint4* __restrict__ w,
                       const uint4* __restrict__ b, uint4* __restrict__ xs,
                       uint4* __restrict__ y, int M, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = (size_t)row * C;
  uint4 r[K];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      const uint4 xv = __ldcs(x + base + c), ov = __ldcs(o + base + c), gv = __ldg(g + c);
      r[k] = make_uint4(res2(xv.x, ov.x, gv.x), res2(xv.y, ov.y, gv.y),
                        res2(xv.z, ov.z, gv.z), res2(xv.w, ov.w, gv.w));
      xs[base + c] = r[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) s += lo(word(r[k], i)) + hi(word(r[k], i));
    }
  }
  const float D = 8.f * C;
  const float mean = sq::warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + 32 * k < C) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d0 = lo(word(r[k], i)) - mean, d1 = hi(word(r[k], i)) - mean;
        q += d0 * d0 + d1 * d1;
      }
    }
  }
  const float rstd = rsqrtf(sq::warp_sum(q) / D + eps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      const uint4 wv = __ldg(w + c), bv = __ldg(b + c);
      uint4 out;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t v = word(r[k], i), wi = word(wv, i), bi = word(bv, i);
        ow[i] = pack(lo(wi) * (rstd * (lo(v) - mean)) + lo(bi),
                     hi(wi) * (rstd * (hi(v) - mean)) + hi(bi));
      }
      y[base + c] = out;
    }
  }
}

template <int K>
cudaError_t launch_ln(const uint4* x, const uint4* o, const uint4* g, const uint4* w,
                      const uint4* b, uint4* xs, uint4* y, int M, int C, float eps,
                      cudaStream_t st) {
  const unsigned blocks = (unsigned)((M + LN_WARPS - 1) / LN_WARPS);
  vit_residual_ln_kernel<K><<<blocks, 32 * LN_WARPS, 0, st>>>(x, o, g, w, b, xs, y, M, C, eps);
  return cudaGetLastError();
}

}  // namespace

// One launch.  h (M, 2 H) bf16, contiguous, 16-byte aligned, H % 8 == 0;
// out (M, H) bf16.
extern "C" int sq_vit_swiglu(const void* h, void* out, int M, int H, void* stream) {
  if (M <= 0 || H <= 0 || H % 8) return (int)cudaErrorInvalidValue;
  const long long chunks = (long long)M * (H / 8);
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((chunks + GATE_THREADS - 1) / GATE_THREADS);
  vit_swiglu_kernel<<<blocks, GATE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(h), static_cast<uint4*>(out), (unsigned)chunks,
      (unsigned)(H / 8));
  return (int)cudaGetLastError();
}

// One launch.  x, out (M, D) bf16; gamma, w, b (D,) bf16; writes xs = x +
// out * gamma and y = LayerNorm(xs; w, b, eps), (M, D) bf16.  All contiguous
// and 16-byte aligned, D % 8 == 0, D <= 2048.
extern "C" int sq_vit_residual_ln(const void* x, const void* out, const void* gamma,
                                  const void* w, const void* b, void* xs, void* y, int M,
                                  int D, float eps, void* stream) {
  if (M <= 0 || D <= 0 || D % 8 || D > 256 * MAX_LN_K) return (int)cudaErrorInvalidValue;
  const int C = D / 8;
  const auto* px = static_cast<const uint4*>(x);
  const auto* po = static_cast<const uint4*>(out);
  const auto* pg = static_cast<const uint4*>(gamma);
  const auto* pw = static_cast<const uint4*>(w);
  const auto* pb = static_cast<const uint4*>(b);
  auto* pxs = static_cast<uint4*>(xs);
  auto* py = static_cast<uint4*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((C + 31) / 32) {
    case 1: return (int)launch_ln<1>(px, po, pg, pw, pb, pxs, py, M, C, eps, st);
    case 2: return (int)launch_ln<2>(px, po, pg, pw, pb, pxs, py, M, C, eps, st);
    case 3: return (int)launch_ln<3>(px, po, pg, pw, pb, pxs, py, M, C, eps, st);
    case 4: return (int)launch_ln<4>(px, po, pg, pw, pb, pxs, py, M, C, eps, st);
    case 5: return (int)launch_ln<5>(px, po, pg, pw, pb, pxs, py, M, C, eps, st);
    case 6: return (int)launch_ln<6>(px, po, pg, pw, pb, pxs, py, M, C, eps, st);
    case 7: return (int)launch_ln<7>(px, po, pg, pw, pb, pxs, py, M, C, eps, st);
    default: return (int)launch_ln<8>(px, po, pg, pw, pb, pxs, py, M, C, eps, st);
  }
}
