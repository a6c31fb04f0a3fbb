// K2 stem16 in bf16: the space-to-depth ResNet stem (7x7/s2 conv + folded
// BN + ReLU as a 4x4 conv over 16 channels) on Hopper's tensor cores.
//
// Replaces sequoia_tpu/ops/pallas_resnet.py:stem16 (_stem16_kernel) for
// bf16; f32 keeps the CUDA-core kernel of conv_gemm.cu (B_STEM).
//
// Function, per image b: out[b] (64, P) = relu(A (64, 256) . S_b (256, P) +
// bias), P = H2*W2 pixels, one rounding to bf16.  S_b is the tap stack of
// the row-padded input x16[b] (16, (H2+3)*W2): row k = (ky*4 + kx)*16 + c
// holds x16[b, c, ky*W2 + q + dx] at pixel q, dx = kx - 2, zero where the
// column q % W2 + dx leaves [0, W2) (pallas_resnet.py's tap order).
//
// What bounds it on the H100: bytes.  A batch of 128 images at 256 px reads
// 69 MB and writes 268 MB (0.10 ms at 3.35 TB/s) for 69 GFLOP (0.07 ms at
// 989 TFLOP/s).
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
