// K2 stem16 in bf16 and f32: the space-to-depth ResNet stem (7x7/s2 conv +
// folded BN + ReLU as a 4x4 conv over 16 channels) on Hopper's tensor cores.
//
// Replaces sequoia_tpu/ops/pallas_resnet.py:stem16 (_stem16_kernel) in both
// types: bf16 stem_wgmma_kernel, f32 stem_tf32_kernel (3xTF32).
//
// Function, per image b: out[b] (64, P) = relu(A (64, 256) . S_b (256, P) +
// bias), P = H2*W2 pixels, one rounding to the compute type.  S_b is the tap
// stack of the row-padded input x16[b] (16, (H2+3)*W2): row k = (ky*4 +
// kx)*16 + c holds x16[b, c, ky*W2 + q + dx] at pixel q, dx = kx - 2, zero
// where the column q % W2 + dx leaves [0, W2) (pallas_resnet.py's tap
// order).
//
// bf16.  What bounds it on the H100: bytes.  A batch of 128 images at 256 px
// reads 69 MB and writes 268 MB (0.10 ms at 3.35 TB/s) for 69 GFLOP (0.07 ms
// at 989 TFLOP/s).
//
// What the design does about it.  Persistent CTAs (two an SM, 256 threads:
// two warpgroups) walk tiles of 128 pixels of one image.  The folded
// weights are a K-major A, 32 KB, copied into shared memory once per CTA.
// Per tile every thread loads four (ky, channel, 8-pixel chunk) items from
// x16: the 16-byte chunk itself, 4 bytes before it and 2 after it (the
// chunk offsets ky*W2 + q0 are 16-byte aligned when W2 % 8 == 0), with the
// neighbours zeroed where they leave the image row.  From these 11 values
// it writes the four dx-shifted chunks (rows kx = 0..3; funnel shifts by
// 0 or 2 bytes) into the 128-byte-swizzled MN-major B tile (transpose bit),
// so the stack never reaches device memory.  Each warpgroup multiplies its
// 64 pixels with wgmma m64n64k16 over K = 256.  The next tile's loads go
// out into registers before the multiply, so they are in flight during it
// and the epilogue.  The epilogue (bias, ReLU, one rounding) stages each
// warpgroup's 64 x 64 tile in its own part of the B tile and stores whole
// 128-byte channel rows of the (64, P) output with 16-byte stores.
//
// f32, stem_tf32_kernel.  What bounds it: operations.  Each product is
// 3xTF32, as K4's (conv_wgmma.cu): every operand v split into TF32 hi =
// rna(v) and lo = rna(v - hi), hi.hi + hi.lo + lo.hi per k8 step, so the
// batch's 69 GFLOP are 206 GFLOP on the tensor cores (0.416 ms at 495
// TFLOP/s) against 137 MB read and 537 MB written (0.201 ms at 3.35 TB/s).
// TF32 wgmma has no transpose bit, so both operands must be K-major in
// shared memory and the bf16 kernel's MN-major stack does not carry over.
// The layout: the folded weights are the wgmma A (64 output channels, K-major
// as stored) and the tap stack the B, one 128-byte row of 32 K values per
// pixel.  Pixels as N put the output's channel rows in the accumulator
// fragment (pixel pairs along a row), so the epilogue writes (64, P) with
// 8-byte stores that fill whole 32-byte sectors and needs no transpose;
// pixels as M would have needed one through shared memory.
//
// Persistent CTAs, one an SM (256 threads: two warpgroups), walk tiles of
// 128 pixels of one image.  A's hi and lo (2 x 64 KB, 8 slabs of 32 K
// values) are split once per CTA and stay resident.  The stack goes through
// a two-slot ring of 32-deep slabs (128 pixels x 128 bytes, hi + lo: 2 x 32
// KB): slab s holds taps (ky, kx) = (s / 2, 2 (s % 2) + h), h = 0, 1, of the
// 16 channels.  Thread t owns pixel t % 128 and the tap h = t / 128 of every
// slab: it reads its 16 channels' values along x16's rows (a warp's 32 lanes
// read 32 neighbouring pixels, 128 contiguous bytes; the four dx shifts of a
// row hit L1/L2), zeroed where the tap leaves the image row, splits them and
// stores four 16-byte chunks into its pixel's swizzled row (8 lanes, 8 rows:
// 8 different chunk slots, no bank conflict).  x16 is read from HBM about
// once; no stack reaches device memory.  As in K4, every thread loads slab
// g + 2 into registers while the tensor cores multiply slab g and stores it
// while they multiply slab g + 1, the slabs running on across tiles; each
// warpgroup multiplies its 64 pixels with wgmma m64n64k8, 12 products a slab
// into an accumulator of their own that is added to the running sum with a
// rounded add (promotion), and a tile's epilogue (bias, ReLU) runs while the
// tensor cores multiply the next tile's first slab.  Each output is one K
// reduction in a fixed order, whatever its tile.
#include "hopper.cuh"

using namespace sq::hopper;

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;            // threads: two warpgroups
constexpr int TP = 128;            // pixels per tile, 64 per warpgroup
constexpr int KS = 256;            // tap-stack rows: 16 taps x 16 channels
constexpr int A_BYTES = 64 * KS * 2;  // 4 K-major slabs of 64 rows x 64 K
constexpr int BLK = KS * 128;         // one 64-pixel MN-major block of the stack
constexpr int SMEM = A_BYTES + 2 * BLK + 1024;  // + 1 KB to align
constexpr int ITEMS = 4 * 16 * (TP / 8) / NT;   // (ky, c, chunk) items a thread gathers
constexpr int LDO = 64 + 8;        // bf16 per channel row of the staged output

struct Raw {
  uint4 cur;      // x[q0 .. q0 + 7]
  uint32_t prev;  // x[q0 - 2], x[q0 - 1]; 0 at the row's left edge
  uint32_t next;  // x[q0 + 8] in the low half; 0 at the row's right edge
};

__global__ void __launch_bounds__(NT, 2)
stem_wgmma_kernel(const bf16* __restrict__ x16, const bf16* __restrict__ A,
                  const float* __restrict__ bias, bf16* __restrict__ out, int H2, int W2,
                  int tiles_per_img, long long ntiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sA = smem_addr(smem), sB = sA + A_BYTES;
  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = wtid >> 5, lane = tid & 31;
  const int P = H2 * W2, Pin = (H2 + 3) * W2;

  // the folded weights, once: row r, K chunk q (8 values) -> slab q / 8
  for (int i = tid; i < 64 * (KS / 8); i += NT) {
    const int r = i / (KS / 8), q = i % (KS / 8);
    cp_async_16(sA + (q >> 3) * (64 * 128) + sw128_offset(r, q & 7), A + r * KS + q * 8, true);
  }
  cp_async_commit();

  // item u of this thread: stack rows (ky, c) = row >> 4, row & 15 and the
  // tile's 8-pixel chunk i; neighbouring threads take neighbouring chunks
  Raw raw[ITEMS];
  auto gather = [&](long long tile) {
    const int b = (int)(tile / tiles_per_img), p0 = (int)(tile % tiles_per_img) * TP;
    const bf16* xb = x16 + (size_t)b * 16 * Pin;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int item = tid + u * NT, i = item & 15, row = item >> 4;
      const int ky = row >> 4, c = row & 15, q0 = p0 + i * 8;
      Raw r = {make_uint4(0, 0, 0, 0), 0u, 0u};
      if (q0 < P) {
        const int c0 = q0 % W2;
        const bf16* src = xb + (size_t)c * Pin + ky * W2 + q0;
        r.cur = __ldg(reinterpret_cast<const uint4*>(src));
        if (c0 > 0) r.prev = __ldg(reinterpret_cast<const unsigned int*>(src - 2));
        if (c0 + 8 < W2) r.next = __ldg(reinterpret_cast<const unsigned short*>(src + 8));
      }
      raw[u] = r;
    }
  };
  // the four dx-shifted copies of each item into the B tile: 16-bit word j
  // of row kx is word j + kx of [prev | cur | next]
  auto build = [&]() {
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int item = tid + u * NT, i = item & 15, row = item >> 4;
      const int ky = row >> 4, c = row & 15;
      const uint32_t w0 = raw[u].prev, w1 = raw[u].cur.x, w2 = raw[u].cur.y,
                     w3 = raw[u].cur.z, w4 = raw[u].cur.w, w5 = raw[u].next;
      const uint32_t blk = sB + (i >> 3) * BLK;
      const int ch = i & 7, k = ky * 64 + c;
      st_shared_v4(blk + sw128_offset(k, ch), make_uint4(w0, w1, w2, w3));  // dx = -2
      st_shared_v4(blk + sw128_offset(k + 16, ch),                           // dx = -1
                   make_uint4(__funnelshift_r(w0, w1, 16), __funnelshift_r(w1, w2, 16),
                              __funnelshift_r(w2, w3, 16), __funnelshift_r(w3, w4, 16)));
      st_shared_v4(blk + sw128_offset(k + 32, ch), make_uint4(w1, w2, w3, w4));  // dx = 0
      st_shared_v4(blk + sw128_offset(k + 48, ch),                               // dx = 1
                   make_uint4(__funnelshift_r(w1, w2, 16), __funnelshift_r(w2, w3, 16),
                              __funnelshift_r(w3, w4, 16), __funnelshift_r(w4, w5, 16)));
    }
  };

  long long tile = blockIdx.x;
  if (tile < ntiles) gather(tile);
  cp_async_wait<0>();
  bf16* st = reinterpret_cast<bf16*>(smem + A_BYTES + wg * BLK);  // this warpgroup's staging
  const int r0 = warp * 16 + (lane >> 2);  // the fragment's channel rows r0, r0 + 8
  const float bias0 = bias[r0], bias1 = bias[r0 + 8];
  for (; tile < ntiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's staged output has been read
    build();
    fence_proxy_async();
    __syncthreads();  // the B tile (and, on the first pass, A) is complete
    const int b = (int)(tile / tiles_per_img);
    const int px0 = (int)(tile % tiles_per_img) * TP + wg * 64;
    if (tile + gridDim.x < ntiles) gather(tile + gridDim.x);

    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks)
      Wgmma<64, 1>::mma(acc, sw128_desc(sA + (ks >> 2) * (64 * 128) + (ks & 3) * 32, 16, 1024),
                        sw128_desc(sB + wg * BLK + ks * 16 * 128, BLK, 1024));
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<0>();
    fence_regs(acc);

    // bias, ReLU, one rounding; staged channel-major in this warpgroup's
    // block of B (its wgmma is done), then whole channel rows out
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<__nv_bfloat162*>(st + r0 * LDO + col) = __floats2bfloat162_rn(
          fmaxf(acc[4 * j] + bias0, 0.f), fmaxf(acc[4 * j + 1] + bias0, 0.f));
      *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8) * LDO + col) = __floats2bfloat162_rn(
          fmaxf(acc[4 * j + 2] + bias1, 0.f), fmaxf(acc[4 * j + 3] + bias1, 0.f));
    }
    warpgroup_sync(wg);
#pragma unroll
    for (int u = 0; u < 64 * 8 / 128; ++u) {
      const int idx = wtid + u * 128, ch = idx >> 3, h = idx & 7, p = px0 + h * 8;
      if (p < P)
        *reinterpret_cast<uint4*>(out + ((size_t)b * 64 + ch) * P + p) =
            *reinterpret_cast<const uint4*>(st + ch * LDO + h * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32
// ---------------------------------------------------------------------------

constexpr int TF_SLABS = KS / 32;       // K slabs of 32: (ky, kx pair) x 16 channels
constexpr int TF_A = 64 * 128;          // one A slab: 64 rows of 32 f32
constexpr int TF_AH = TF_SLABS * TF_A;  // all of A's hi (or lo): 64 KB
constexpr int TF_B = TP * 128;          // one stack slab: 128 pixel rows of 32 f32
constexpr int TF_STAGE = 2 * TF_B;      // a ring slot: the slab's hi and lo
constexpr int TF_SMEM = 2 * TF_AH + 2 * TF_STAGE + 1024;  // + 1 KB to align

__global__ void __launch_bounds__(NT, 1)
stem_tf32_kernel(const float* __restrict__ x16, const float* __restrict__ A,
                 const float* __restrict__ bias, float* __restrict__ out, int H2, int W2,
                 int tiles_per_img, long long ntiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sAh = smem_addr(smem), sAl = sAh + TF_AH, sB = sAl + TF_AH;
  const int tid = threadIdx.x, wg = tid >> 7, px = tid & 127;
  const int warp = px >> 5, lane = tid & 31;
  const int P = H2 * W2, Pin = (H2 + 3) * W2;

  // A's hi and lo, once: float4 q of row r (K values 4q .. 4q + 3) goes to
  // chunk q % 8 of row r of slab q / 8
  for (int i = tid; i < 64 * (KS / 4); i += NT) {
    const int r = i / (KS / 4), q = i % (KS / 4);
    const uint32_t off = (q >> 3) * TF_A + sw128_offset(r, q & 7);
    st_split_v4(sAh + off, sAl + off, __ldg(reinterpret_cast<const float4*>(A + r * KS + q * 4)));
  }

  // the CTA's slabs g = 0 .. nslab - 1: slab g & 7 of its tile g >> 3, the
  // tiles blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long mine = blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long nslab = mine * TF_SLABS;
  // a tile's image b and index i in it, walked to the CTA's next tile with
  // one 32-bit division (load and epilogue each take their tiles in order)
  struct Pos { int b, i; };
  auto advance = [&](Pos& t) {
    t.i += gridDim.x;
    t.b += t.i / tiles_per_img;
    t.i %= tiles_per_img;
  };
  const Pos first = {(int)(blockIdx.x / tiles_per_img), (int)(blockIdx.x % tiles_per_img)};

  // this thread's 16 values of slab g: channels 0..15 of tap (ky, kx) =
  // (s / 2, 2 (s % 2) + wg) at its pixel q, zero where the tap leaves the row
  float v[16];
  Pos lt = first;
  int q = lt.i * TP + px, col0 = q % W2;
  auto load = [&](long long g) {
    const int s = (int)(g & 7);
    if (s == 0 && g > 0) {
      advance(lt);
      q = lt.i * TP + px;
      col0 = q % W2;
    }
    const int dx = 2 * (s & 1) + wg - 2, col = col0 + dx;
    const bool ok = q < P && col >= 0 && col < W2;
    const float* src = x16 + (size_t)lt.b * 16 * Pin + (s >> 1) * W2 + q + dx;
#pragma unroll
    for (int c = 0; c < 16; ++c) v[c] = ok ? __ldg(src + (size_t)c * Pin) : 0.f;
  };
  // ... split and stored as chunks 4 wg .. 4 wg + 3 of the pixel's row
  auto store = [&](int slot) {
    const uint32_t hi = sB + slot * TF_STAGE;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t off = sw128_offset(px, 4 * wg + j);
      st_split_v4(hi + off, hi + TF_B + off,
                  make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]));
    }
  };

  // the fragment: output channels r0 and r0 + 8, pixels 8j + 2 (lane % 4)
  // (+1) of the warpgroup's 64
  const int r0 = warp * 16 + (lane >> 2);
  const float bias0 = bias[r0], bias1 = bias[r0 + 8];
  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.f;
  // bias, ReLU and the (64, P) stores of the CTA's next tile, from acc
  Pos et = first;
  auto epilogue = [&]() {
    const int p0 = et.i * TP + wg * 64 + 2 * (lane & 3);
    float* o0 = out + ((size_t)et.b * 64 + r0) * P;
    float* o1 = o0 + 8 * (size_t)P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = p0 + 8 * j;  // even, and P is a multiple of 8
      if (p < P) {
        *reinterpret_cast<float2*>(o0 + p) =
            make_float2(fmaxf(acc[4 * j] + bias0, 0.f), fmaxf(acc[4 * j + 1] + bias0, 0.f));
        *reinterpret_cast<float2*>(o1 + p) =
            make_float2(fmaxf(acc[4 * j + 2] + bias1, 0.f), fmaxf(acc[4 * j + 3] + bias1, 0.f));
      }
    }
    advance(et);
  };
  // part holds slab g - 1's products: the first slab of a tile starts acc
  auto promote = [&](long long g) {
    const bool starts = ((g - 1) & 7) == 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = starts ? part[i] : acc[i] + part[i];
  };

  if (nslab > 0) {
    load(0);
    store(0);
  }
  if (nslab > 1) load(1);
  for (long long g = 0; g < nslab; ++g) {
    fence_proxy_async();  // this thread's stores of slab g (and of A) are visible to wgmma
    wgmma_wait<0>();      // this warpgroup's products of slab g - 1 are done
    fence_regs(part);
    if (g > 0) promote(g);
    // both warpgroups are past slab g - 1, whose slot slab g + 1 refills,
    // and every thread's share of slab g is in place
    __syncthreads();
    const uint32_t sa = sAh + (int)(g & 7) * TF_A;
    const uint32_t sb = sB + (int)(g & 1) * TF_STAGE + wg * (64 * 128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t ah = sw128_desc(sa + ks * 32, 16, 1024);
      const uint64_t al = sw128_desc(sa + TF_AH + ks * 32, 16, 1024);
      const uint64_t bh = sw128_desc(sb + ks * 32, 16, 1024);
      const uint64_t bl = sw128_desc(sb + TF_B + ks * 32, 16, 1024);
      WgmmaTf32<64>::mma(part, ah, bh, ks > 0);  // the slab's first product starts part
      WgmmaTf32<64>::mma(part, ah, bl);
      WgmmaTf32<64>::mma(part, al, bh);
    }
    wgmma_commit();
    fence_regs(part);
    if (g > 0 && ((g - 1) & 7) == 7) epilogue();  // acc holds a whole tile
    if (g + 1 < nslab) store((int)((g + 1) & 1));  // the slot of slab g - 1
    if (g + 2 < nslab) load(g + 2);
  }
  wgmma_wait<0>();
  fence_regs(part);
  if (nslab > 0) {
    promote(nslab);
    epilogue();
  }
}

}  // namespace

// bf16 only: x16 (B, 16, (H2+3)*W2), A (64, 256), bias (64,) f32, out (B,
// 64, H2*W2), all contiguous and 16-byte aligned; W2 % 8 == 0.  One launch
// of min(tiles, 2 * SMs) persistent CTAs of 256 threads with 97 KB of
// dynamic shared memory each.
extern "C" int sq_stem_wgmma(const void* x16, const void* A, const float* bias, void* out,
                             int B, int H2, int W2, void* stream) {
  if (B <= 0 || H2 <= 0 || W2 <= 0 || W2 % 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(stem_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int tiles_per_img = (H2 * W2 + TP - 1) / TP;
  const long long ntiles = (long long)B * tiles_per_img;
  const long long grid = ntiles < 2LL * sms ? ntiles : 2LL * sms;
  stem_wgmma_kernel<<<(unsigned)grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x16), static_cast<const bf16*>(A), bias,
      static_cast<bf16*>(out), H2, W2, tiles_per_img, ntiles);
  return (int)cudaGetLastError();
}

// f32 only: the 3xTF32 stem.  x16 (B, 16, (H2+3)*W2), A (64, 256), bias
// (64,), out (B, 64, H2*W2), all contiguous and 16-byte aligned; W2 % 8 ==
// 0.  One launch of min(tiles, SMs) persistent CTAs of 256 threads with
// 193 KB of dynamic shared memory each.
extern "C" int sq_stem_tf32(const float* x16, const float* A, const float* bias, float* out,
                            int B, int H2, int W2, void* stream) {
  if (B <= 0 || H2 <= 0 || W2 <= 0 || W2 % 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(stem_tf32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TF_SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int tiles_per_img = (H2 * W2 + TP - 1) / TP;
  const long long ntiles = (long long)B * tiles_per_img;
  const long long grid = ntiles < sms ? ntiles : sms;
  stem_tf32_kernel<<<(unsigned)grid, NT, TF_SMEM, static_cast<cudaStream_t>(stream)>>>(
      x16, A, bias, out, H2, W2, tiles_per_img, ntiles);
  return (int)cudaGetLastError();
}
