// vit_attention on Hopper: the ViTs' multi-head attention between the qkv
// GEMM and the proj GEMM (models/uni_vit.py _block), for UNI (16 heads of
// 64, 197 tokens) and Virchow2 (16 heads of 80, 261 tokens), in bf16.
//
// Replaces no TPU kernel: the JAX package computes this attention with XLA
// einsums (sequoia_tpu/models/uni_vit.py:68-70).  Eager PyTorch ran it as
// separate passes, each through device memory: copies of q, k and v into the
// head-major layout, the (B, H, N, N) f32 scores, their scale, the softmax,
// the probabilities' cast to bf16, P.V and the copy back into (token, head)
// order.  This kernel does all of it in one launch, from the qkv GEMM's
// output as it lies to the tensor proj takes.
//
// Operands: qkv (B*N, 3*D) bf16, columns in (3, heads, dh) order; out
// (B*N, D) bf16, columns in (heads, dh) order.  Its mathematics and rounding
// points are those of ops/cuda_vit.vit_attention_plain (the module's
// docstring):
//   s = (q . k^T) * scale, bf16 products summed in f32, the scale an f32
//       multiply of the f32 sum;
//   p = exp(s - max_row s) / sum_row exp(s - max_row s), the whole row in f32
//       (no online softmax: each row's max and sum are taken over all its keys
//       before any p is formed), then p rounded to bf16;
//   out = p . v, bf16 products summed in f32, rounded once to bf16.
// The division is exact (correctly rounded): r = 1 / l once a row, then q =
// e r and q + (e - q l) r with fused multiply-adds, which for a correctly
// rounded r gives the correctly rounded e / l (Markstein), without a
// division a value.
//
// What bounds it on the H100: the bytes of qkv and out, 0.34 GB a Virchow2
// block at batch 128 (0.102 ms at 3.35 TB/s), against 44.6 GFLOP (0.045 ms
// at 989 TFLOP/s); UNI's 0.21 GB, 0.062 ms.  Padding adds to the work and
// not to the bytes: 64-query tiles (261 tokens take 320 rows) and keys in
// whole 16-key steps.  In practice the softmax's instruction stream (about
// 20 instructions a score, one of them an exp on the MUFU unit) and its
// latency decide, with at most two warpgroups an SM (each holds a row's
// scores in registers).
//
// Design:
//   - one CTA an (image, head): K and V of its N tokens are staged once in
//     shared memory (cp.async, 16-byte chunks read in place from qkv with
//     the row stride 3 D; rows past N zero-filled; V's wait deferred to the
//     first P.V), then the CTA walks its ceil(N / 64) query tiles;
//   - up to 272 keys (SPLIT = 1) one warpgroup holds a 64-query x 272-key
//     tile of scores in registers (136 floats a thread), so a row is there
//     whole for the exact softmax; two such CTAs share an SM.  Up to 512 keys
//     (SPLIT = 2) two warpgroups split the keys, 256 each, and combine each
//     row's max and sum, and their two halves of P.V, through shared memory
//     in a fixed order;
//   - the key width is a template parameter (128, 208, 272; 2 x 256), the
//     least that holds N, with the keys below the width's least N never
//     masked; dh (64 or 80) is one too;
//   - q is read from device memory straight into wgmma's A fragment (no
//     shared memory), the next tile's while this one's softmax and P.V run;
//     the scores' accumulator, normalised and rounded in pairs, is P.V's A
//     fragment in the same registers (hopper.cuh WgmmaRA);
//   - K and V lie in 32-byte-swizzled tiles of 16 values a row: dh = 80 is
//     five of them, so it needs neither a 64 + 16 split of QK^T's depth nor
//     padding to 96, and V needs no transposed copy.  K is QK^T's K-major B
//     (one tile a k16 step, two wgmma of half the keys each), V P.V's
//     MN-major B (n = dh).  The 128-byte swizzle, tried first, pads dh = 80
//     to 128 in shared memory: 147 KB, one CTA an SM, 0.53 ms a Virchow2
//     block against 0.39 at 32 bytes;
//   - the output is rounded and stored straight into (token, head, dh)
//     order, rows past N left out; warps whose 16 rows all lie past N skip
//     the softmax.
// Shared memory: 2 * KW * dh * 2 bytes of K and V (87 KB at Virchow2's 272
// keys) plus 1 KB of alignment, and with SPLIT = 2 the exchange (11 KB).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace sq::hopper;
using bf16 = __nv_bfloat16;

constexpr int QT = 64;   // queries a tile: wgmma's M
constexpr int MAX_N = 512;

// K and V of one (image, head) in shared memory: SPLIT * KH rows (keys)
// each, in DH / 16 tiles of 32-byte rows (16 values of dh), swizzled
// (hopper.cuh); with SPLIT = 2 also the two warpgroups' exchange
template <int DH, int KH, int SPLIT> struct Geo {
  static constexpr int KW = SPLIT * KH;           // keys staged
  static constexpr int TILE = KW * 32;            // bytes of 16 values of dh
  static constexpr int KV = DH / 16 * TILE;       // bytes of K, and of V
  static constexpr int XCH = SPLIT == 2 ? QT * (DH / 2) * 4 : 0;  // half an output tile
  static constexpr int RED = SPLIT == 2 ? 2 * 2 * QT * 4 : 0;     // row max and sum
  static constexpr int SMEM = 1024 + 2 * KV + XCH + RED;

  // byte offset of 16-byte chunk cc (values 8 cc .. 8 cc + 7) of row j
  __device__ static __forceinline__ uint32_t off(int j, int cc) {
    return (cc >> 1) * TILE + sw32_offset(j, cc & 1);
  }
  // QK^T's B for k16 step ks over dh: K-major, keys from key0
  __device__ static __forceinline__ uint64_t k_desc(uint32_t sk, int key0, int ks) {
    return sw32_desc(sk + ks * TILE + key0 * 32, 16, 256);
  }
  // P.V's B for the 16 keys from key0: MN-major, n = dh over the tiles
  __device__ static __forceinline__ uint64_t v_desc(uint32_t sv, int key0) {
    return sw32_desc(sv + key0 * 32, TILE, 256);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// e / l, correctly rounded, from r = 1 / l (correctly rounded)
__device__ __forceinline__ float div_rn(float e, float l, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, l, e), r, q);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// the max, then the sum, of a row over the four threads of a quad
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One CTA an (image, head), SPLIT warpgroups.  SPLIT = 1: the warpgroup
// holds all KH keys and walks the query tiles alone.  SPLIT = 2: the two
// share each tile, KH keys each, and exchange row max, row sum and half the
// output through shared memory.  N >= NMIN: the keys below NMIN need no mask.
template <int DH, int KH, int SPLIT, int NMIN>
__global__ void __launch_bounds__(128 * SPLIT, 1)
vit_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H,
                     float scale) {
  using G = Geo<DH, KH, SPLIT>;
  constexpr int NT = 128 * SPLIT;
  constexpr int KS = DH / 16;  // QK^T's k16 steps
  constexpr int CN = KH / 2;   // keys of one QK^T wgmma: two a k16 step
  constexpr int KK = KH / 16;  // P.V's k16 steps a warpgroup
  constexpr int NS = KH / 2;   // score accumulators a thread
  constexpr int NO = DH / 2;   // output accumulators a thread
  constexpr int CH = DH / 8;   // 16-byte chunks of a row of K or V
  // the 8-key blocks below NMIN in every warpgroup: never masked
  constexpr int JSAFE = (NMIN > (SPLIT - 1) * KH ? NMIN - (SPLIT - 1) * KH : 0) / 8;
  const float NEG_INF = __int_as_float(static_cast<int>(0xff800000u));

  const int h = blockIdx.x, b = blockIdx.y;
  const int D = H * DH;
  const size_t ld = 3 * (size_t)D;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, g = (tid & 31) >> 2, tq = tid & 3;
  const int row0 = 16 * warp + g, row1 = row0 + 8;  // this thread's rows of a tile
  const int key0 = SPLIT == 2 ? wg * KH : 0;         // the warpgroup's first key
  const int nvalid = N - key0;                       // of its keys, those < N

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sk = smem_addr(smem), sv = sk + G::KV;
  float* red = reinterpret_cast<float*>(smem + 2 * G::KV + G::XCH);  // SPLIT = 2

  // K (commit group 0), then V (group 1): rows past N zero-filled
  const bf16* q_in = qkv + (size_t)b * N * ld + h * DH;  // row 0's q of this head
#pragma unroll 1
  for (int part = 0; part < 2; ++part) {
    for (int i = tid; i < G::KW * CH; i += NT) {
      const int j = i / CH, cc = i % CH;
      const bool full = j < N;
      cp_async_16(sk + part * G::KV + G::off(j, cc),
                  q_in + (full ? j * ld : 0) + (1 + part) * D + cc * 8, full);
    }
    cp_async_commit();
  }

  // q of a tile's rows, straight into QK^T's A fragments (0 past N)
  uint32_t qf[KS][4];
  auto load_q = [&](int q0) {
    const int r0 = q0 + row0, r1 = q0 + row1;
    const bf16* p0 = q_in + (size_t)r0 * ld + 2 * tq;
    const bf16* p1 = q_in + (size_t)r1 * ld + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = r0 < N ? ld_u32(p0 + 16 * ks) : 0u;
      qf[ks][1] = r1 < N ? ld_u32(p1 + 16 * ks) : 0u;
      qf[ks][2] = r0 < N ? ld_u32(p0 + 16 * ks + 8) : 0u;
      qf[ks][3] = r1 < N ? ld_u32(p1 + 16 * ks + 8) : 0u;
    }
  };

  load_q(0);
  cp_async_wait<1>();  // this thread's K
  fence_proxy_async();
  __syncthreads();

  const int tiles = (N + QT - 1) / QT;
#pragma unroll 1
  for (int qt = 0; qt < tiles; ++qt) {
    const int q0 = qt * QT;
    // whether this warp's 16 rows hold a query < N: the softmax of the rest
    // is skipped (their p are 0 and they are not stored)
    const bool live = q0 + 16 * warp < N;

    // s = q . k^T over the warpgroup's keys, in two wgmma of CN keys
    float s[NS];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        WgmmaRA<CN, 0>::mma(*reinterpret_cast<float(*)[CN / 2]>(s + c * (CN / 2)), qf[ks],
                            G::k_desc(sk, key0 + c * CN, ks), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(qf);
    if (qt + 1 < tiles) load_q(q0 + QT);  // the next tile's, through the softmax

    // scale, keys past N to -inf (only the 8-key blocks that may reach N
    // look), the row max
    float m0 = NEG_INF, m1 = NEG_INF;
    if (live) {
#pragma unroll
      for (int j = 0; j < KH / 8; ++j) {
        float* v = s + 4 * j;
        if (j < JSAFE) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] *= scale;
        } else {
          const int key = 8 * j + 2 * tq;
          v[0] = key < nvalid ? v[0] * scale : NEG_INF;
          v[1] = key + 1 < nvalid ? v[1] * scale : NEG_INF;
          v[2] = key < nvalid ? v[2] * scale : NEG_INF;
          v[3] = key + 1 < nvalid ? v[3] * scale : NEG_INF;
        }
        m0 = fmaxf(m0, fmaxf(v[0], v[1]));
        m1 = fmaxf(m1, fmaxf(v[2], v[3]));
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
    }
    if (SPLIT == 2) {  // over both warpgroups
      if (live && tq == 0) {
        red[wg * QT + row0] = m0;
        red[wg * QT + row1] = m1;
      }
      __syncthreads();
      if (live) {
        m0 = fmaxf(red[row0], red[QT + row0]);
        m1 = fmaxf(red[row1], red[QT + row1]);
      }
    }

    // exp(s - max) and the row sum: the thread's keys in order, its quad,
    // (with SPLIT = 2) the first warpgroup's plus the second's
    float l0 = 0.f, l1 = 0.f;
    if (live) {
#pragma unroll
      for (int j = 0; j < KH / 8; ++j) {
        float* v = s + 4 * j;
        v[0] = expf(v[0] - m0);
        v[1] = expf(v[1] - m0);
        v[2] = expf(v[2] - m1);
        v[3] = expf(v[3] - m1);
        l0 += v[0];
        l0 += v[1];
        l1 += v[2];
        l1 += v[3];
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
    }
    if (SPLIT == 2) {
      if (live && tq == 0) {
        red[2 * QT + wg * QT + row0] = l0;
        red[2 * QT + wg * QT + row1] = l1;
      }
      __syncthreads();
      if (live) {
        l0 = red[2 * QT + row0] + red[3 * QT + row0];
        l1 = red[2 * QT + row1] + red[3 * QT + row1];
      }
    }

    // p = e / l in bf16: P.V's A fragments
    uint32_t pf[KK][4];
    if (live) {
      const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        const float* e = s + 8 * k;
        pf[k][0] = pack_bf16(div_rn(e[0], l0, r0), div_rn(e[1], l0, r0));
        pf[k][1] = pack_bf16(div_rn(e[2], l1, r1), div_rn(e[3], l1, r1));
        pf[k][2] = pack_bf16(div_rn(e[4], l0, r0), div_rn(e[5], l0, r0));
        pf[k][3] = pack_bf16(div_rn(e[6], l1, r1), div_rn(e[7], l1, r1));
      }
    } else {
#pragma unroll
      for (int k = 0; k < KK; ++k) pf[k][0] = pf[k][1] = pf[k][2] = pf[k][3] = 0u;
    }

    if (qt == 0) {  // V, first needed here
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }

    // o = p . v over the warpgroup's keys
    float o[NO];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KK; ++k)
      WgmmaRA<DH, 1>::mma(o, pf[k], G::v_desc(sv, key0 + 16 * k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);

    // rounded to bf16 and stored in (token, head, dh) order, rows past N
    // left out; with SPLIT = 2 the two parts are first added in f32 (the
    // first warpgroup's plus the second's), each warpgroup finishing half
    // the columns
    bf16* o0 = out + ((size_t)b * N + q0 + row0) * D + h * DH + 2 * tq;
    bf16* o1 = o0 + 8 * (size_t)D;
    const bool in0 = q0 + row0 < N, in1 = q0 + row1 < N;
    if (SPLIT == 1) {
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        if (in0) *reinterpret_cast<uint32_t*>(o0 + 8 * j) = pack_bf16(o[4 * j], o[4 * j + 1]);
        if (in1) *reinterpret_cast<uint32_t*>(o1 + 8 * j) = pack_bf16(o[4 * j + 2], o[4 * j + 3]);
      }
    } else {
      constexpr int HALF = NO / 2;  // the accumulators of the first dh / 2 columns
      float* x = reinterpret_cast<float*>(smem + 2 * G::KV) + (tid & 127);
      if (wg == 0) {
#pragma unroll
        for (int i = HALF; i < NO; ++i) x[(i - HALF) * 128] = o[i];
      }
      __syncthreads();
      if (wg == 1) {
#pragma unroll
        for (int j = HALF / 4; j < NO / 4; ++j) {
          const float* y = x + (4 * j - HALF) * 128;
          if (in0) *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
              pack_bf16(y[0] + o[4 * j], y[128] + o[4 * j + 1]);
          if (in1) *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
              pack_bf16(y[256] + o[4 * j + 2], y[384] + o[4 * j + 3]);
        }
#pragma unroll
        for (int i = 0; i < HALF; ++i) x[i * 128] = o[i];
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < HALF / 4; ++j) {
          const float* y = x + 4 * j * 128;
          if (in0) *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
              pack_bf16(o[4 * j] + y[0], o[4 * j + 1] + y[128]);
          if (in1) *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
              pack_bf16(o[4 * j + 2] + y[256], o[4 * j + 3] + y[384]);
        }
      }
    }
  }
}

template <int DH, int KH, int SPLIT, int NMIN>
cudaError_t launch(const bf16* qkv, bf16* out, int B, int N, int H, float scale,
                   cudaStream_t stream) {
  using G = Geo<DH, KH, SPLIT>;
  const cudaError_t e = cudaFuncSetAttribute(vit_attention_kernel<DH, KH, SPLIT, NMIN>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             G::SMEM);
  if (e != cudaSuccess) return e;
  vit_attention_kernel<DH, KH, SPLIT, NMIN><<<dim3(H, B), 128 * SPLIT, G::SMEM, stream>>>(
      qkv, out, N, H, scale);
  return cudaGetLastError();
}

// the least key width that holds the N keys: one warpgroup's up to 272 (its
// scores in registers), two warpgroups' beyond
template <int DH>
cudaError_t by_keys(const bf16* qkv, bf16* out, int B, int N, int H, float scale,
                    cudaStream_t st) {
  if (N <= 128) return launch<DH, 128, 1, 1>(qkv, out, B, N, H, scale, st);
  if (N <= 208) return launch<DH, 208, 1, 129>(qkv, out, B, N, H, scale, st);
  if (N <= 272) return launch<DH, 272, 1, 209>(qkv, out, B, N, H, scale, st);
  return launch<DH, 256, 2, 273>(qkv, out, B, N, H, scale, st);
}

}  // namespace

// One launch.  qkv (B*N, 3*H*DH) bf16, contiguous, 16-byte aligned; out
// (B*N, H*DH) bf16; 1 <= N <= 512; DH 64 or 80; scale the f32 the scores
// are multiplied by.
extern "C" int sq_vit_attention(const void* qkv, void* out, int B, int N, int H, int DH,
                                float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || N > MAX_N || H <= 0 || (DH != 64 && DH != 80))
    return (int)cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(DH == 64 ? by_keys<64>(q, o, B, N, H, scale, st)
                        : by_keys<80>(q, o, B, N, H, scale, st));
}
