// K5 lloyd_stats on Hopper: one Lloyd accumulation pass of k-means, with the
// distance GEMM on the tensor cores as a centered 3xTF32 product.
//
// Replaces sequoia_tpu/ops/pallas_kmeans.py:81 lloyd_stats (_lloyd_kernel,
// :39).  Per fit (sq_lloyd_prepare, two launches; x is fixed across the
// fit's Lloyd steps):
//   mu = mean of the valid rows of x, xc = x - mu (0 on masked rows),
//   x2 = |xc|^2 per row.
// Per Lloyd step (sq_lloyd_wgmma, three launches):
//   lloyd_centers  cc = c - mu split into TF32 hi = rna(cc), lo = rna(cc - hi);
//                  c2 = |cc|^2
//   lloyd_assign   d2 = max(x2 + c2 - 2 (xh.ch + xh.cl + xl.ch), 0), never
//                  stored; label = the first-index argmin over the Kc real
//                  centers (-1 on masked rows); best = |xc - cc|^2 to that
//                  center in f32 on the CUDA cores (0 on masked rows)
//   lloyd_sums     counts and sums of the raw member rows in point order,
//                  inertia = the sum of best
//
// Why it centers.  d2 does not change under translation; its rounding does.
// ResNet features of near-equal patches lie close together far from the
// origin (|x|^2 ~ 500 against a squared spread of ~0.05).  There the JAX
// kernel's |x|^2 + |c|^2 - 2 x.c in f32 (pallas_kmeans.py:56-58) cancels
// most of its digits, the argmin follows the rounding, and the Lloyd loop
// can run to its step cap where a float64 fit converges.  sklearn's KMeans
// subtracts the mean first for the same reason.  Centered, the three terms
// are the size of the spread and f32 keeps the argmin.
//
// Why 3xTF32.  A TF32 product keeps 11 bits of each operand; hi.hi + hi.lo +
// lo.hi keeps about 22 (lo.lo, ~2^-22 of the product, is dropped): f32's
// accuracy for the product at the tensor cores' rate.  The tensor cores
// accumulate by truncation, though, which pulls every x.c toward zero: on
// clustered points (d2 ~ 20 beside |xc|^2 ~ 2000) by ~1e-3 of the nearest
// d2, the same sign on every point.  That moves no argmin that f32 would
// keep, but it would bias the inertia; so best, which feeds the inertia,
// the relocation of empty clusters and the donor repair, is taken directly
// as the sum of (xc - cc)^2 over D for the chosen center (no cancellation).
//
// What bounds it on the H100 (N = 4096, D = 2048, Kc = 100-128): the three
// products, 3 * 2 N D Kc TF32 operations (5.0-6.4 GFLOP: 0.010-0.013 ms at
// 495 TFLOP/s), about level with reading x once (33.5 MB: 0.010 ms at
// 3.35 TB/s).  On the CUDA cores in f32 the product alone needs 0.025-0.032
// ms at 67 TFLOP/s.
//
// lloyd_assign:
//   - a tile is 128 points x 128 centers; D is split four ways over a
//     thread-block cluster of 4 CTAs, so N = 4096 gives 32 x 4 = 128 CTAs,
//     one an SM;
//   - each CTA streams its quarter of xc and of the centers' hi and lo in
//     32-wide K slabs (one 128-byte row of f32) through a 3-stage ring in
//     the 128-byte swizzle: the centers by cp.async, two slabs ahead; xc
//     through registers, two slabs ahead, where each thread splits its chunks
//     into hi and lo and stores both while the tensor cores multiply the
//     slab before (no xc lo reaches device memory);
//   - two warpgroups, 64 points each, issue wgmma m64n128k8 .tf32 from
//     shared memory (TF32 operands are K-major only; xc (N, D) and the
//     centers (Kc, D) are K-major as stored), three products per k8 step into
//     one f32 accumulator;
//   - the f32 partials go to shared memory; after a cluster barrier CTA r
//     sums the four partials of its quarter of the points in rank order
//     through distributed shared memory and takes the tile's argmin, a warp
//     per point;
//   - any Kc: the centers go in tiles of 128, in increasing order, each
//     streaming the CTA's xc range again (from L2); a warp keeps each of its
//     points' running (d2, index) in registers and replaces it only on a
//     strict <, so the result is the first-index argmin over all Kc centers;
//   - after the last tile, best from the point's xc row and the center's
//     row.  Fixed summation orders, no float atomics.
// lloyd_sums: a block per (center, 256 columns) lists its center's members in
// point order with warp ballots, then adds their rows in that order: the
// sums and counts of a scan over all labels, bit for bit, for the same
// labels, without each block walking every label serially.
#include "common.cuh"
#include "hopper.cuh"

using namespace sq;
using namespace sq::hopper;

namespace {

constexpr int BM = 128;          // points per tile: two warpgroups of 64
constexpr int BN = 128;          // centers per tile: wgmma's N
constexpr int BK = 32;           // K per slab: one 128-byte row of f32
constexpr int CLUSTER = 4;       // CTAs that split one tile's K
constexpr int NT = 256;
constexpr int STAGES = 3;
constexpr int TILE = 128 * 128;  // bytes of a 128-row tile of 128-byte rows
constexpr int STAGE = 4 * TILE;  // xc hi, xc lo, centers hi, centers lo
constexpr int CHUNKS = BM * 8 / NT;  // 16-byte chunks of a tile a thread copies
constexpr int LDP = BN + 8;      // floats per point row of the partial tile
constexpr int PART = BM * LDP * 4;
constexpr int SMEM = (STAGES * STAGE > PART ? STAGES * STAGE : PART) + 1024;  // + 1 KB to align
static_assert(TILE % 1024 == 0 && STAGE % 1024 == 0, "every tile starts on a swizzle atom");

constexpr int SUM_COLS = 256;                 // columns of the sums a block adds, one a thread
constexpr int SEG = 512;                      // labels a warp lists per chunk
constexpr int CHUNK = SUM_COLS / 32 * SEG;    // labels a block lists per chunk

// mu over the valid rows: a block per 32 columns, lane = column, its 32 warps
// take every 32nd row; the warps' partials are added in warp order
__global__ void __launch_bounds__(1024)
lloyd_mean(const float* __restrict__ x, const uint8_t* __restrict__ mask, int N, int D,
           float* __restrict__ mu) {
  __shared__ float part[32][33];
  __shared__ int valid[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  float s = 0.f;
  int n = 0;
  for (int m = warp; m < N; m += 32) {
    if (mask[m]) {
      ++n;
      if (d < D) s += x[(size_t)m * D + d];
    }
  }
  part[warp][lane] = s;
  if (lane == 0) valid[warp] = n;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    int nv = 0;
    for (int w = 0; w < 32; ++w) {
      t += part[w][lane];
      nv += valid[w];
    }
    if (d < D) mu[d] = nv > 0 ? t / (float)nv : 0.f;
  }
}

// xc = x - mu on valid rows and 0 on masked ones, x2 = |xc|^2: a warp a row,
// four columns a lane (D % 4 == 0, 16-byte aligned rows)
__global__ void __launch_bounds__(256)
lloyd_center(const float* __restrict__ x, const uint8_t* __restrict__ mask,
             const float* __restrict__ mu, int N, int D, float* __restrict__ xc,
             float* __restrict__ x2) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (m >= N) return;
  const bool ok = mask[m] != 0;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)m * D);
  const float4* mr = reinterpret_cast<const float4*>(mu);
  float4* yr = reinterpret_cast<float4*>(xc + (size_t)m * D);
  float s = 0.f;
  for (int j = lane; j < D / 4; j += 32) {
    const float4 v = xr[j], u = mr[j];
    const float4 o = ok ? make_float4(v.x - u.x, v.y - u.y, v.z - u.z, v.w - u.w)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    yr[j] = o;
    s = fmaf(o.x, o.x, s);
    s = fmaf(o.y, o.y, s);
    s = fmaf(o.z, o.z, s);
    s = fmaf(o.w, o.w, s);
  }
  s = warp_sum(s);
  if (lane == 0) x2[m] = s;
}

// a block per center: cc = c - mu, its TF32 hi and lo, and |cc|^2
__global__ void __launch_bounds__(256)
lloyd_centers(const float* __restrict__ c, const float* __restrict__ mu, int D,
              float* __restrict__ chi, float* __restrict__ clo, float* __restrict__ c2) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = c[row + d] - mu[d];
    const float h = tf32_rna(v);
    chi[row + d] = h;
    clo[row + d] = tf32_rna(v - h);
    s = fmaf(v, v, s);
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) c2[blockIdx.x] = s;
}

// grid (ceil(N / 128) * 4), clusters of 4 CTAs along x, 256 threads, SMEM
// bytes of dynamic shared memory
__global__ void __launch_bounds__(NT, 1)
lloyd_assign(const float* __restrict__ xc, const float* __restrict__ x2,
             const uint8_t* __restrict__ mask, const float* __restrict__ chi,
             const float* __restrict__ clo, const float* __restrict__ c2,
             const float* __restrict__ c, const float* __restrict__ mu, int N, int D,
             int Kc, int* __restrict__ labels, float* __restrict__ best) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  const int rank = cluster_rank();
  const int m0 = (blockIdx.x / CLUSTER) * BM;
  const int nk_all = (D + BK - 1) / BK;
  const int s0 = rank * nk_all / CLUSTER, nk = (rank + 1) * nk_all / CLUSTER - s0;
  int n0 = 0;  // the first center of the tile being multiplied

  // the centers' hi and lo of slab s of this CTA's K range into ring slot
  // `slot` (center n0 + r; rows past Kc and columns past D are zero-filled)
  auto load_c = [&](int s, int slot) {
    const uint32_t st = sbase + slot * STAGE + 2 * TILE;
    const int k0 = (s0 + s) * BK;
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int i = tid + u * NT, r = i >> 3, c = i & 7, k = k0 + c * 4;
      const bool ok = n0 + r < Kc && k < D;
      const size_t o = ok ? (size_t)(n0 + r) * D + k : 0;
      cp_async_16(st + sw128_offset(r, c), chi + o, ok);
      cp_async_16(st + TILE + sw128_offset(r, c), clo + o, ok);
    }
  };
  // this thread's xc chunks of slab s (row r: point m0 + r) into registers
  auto load_x = [&](int s, float4 (&xr)[CHUNKS]) {
    const int k0 = (s0 + s) * BK;
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int i = tid + u * NT, m = m0 + (i >> 3), k = k0 + (i & 7) * 4;
      xr[u] = m < N && k < D ? __ldg(reinterpret_cast<const float4*>(xc + (size_t)m * D + k))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // ... split into TF32 hi and lo, stored to ring slot `slot`
  auto store_x = [&](int slot, const float4 (&xr)[CHUNKS]) {
    const uint32_t st = sbase + slot * STAGE;
#pragma unroll
    for (int u = 0; u < CHUNKS; ++u) {
      const int i = tid + u * NT;
      const uint32_t off = sw128_offset(i >> 3, i & 7);
      const float4 v = xr[u];
      const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      st_shared_v4(st + off, make_uint4(__float_as_uint(h.x), __float_as_uint(h.y),
                                        __float_as_uint(h.z), __float_as_uint(h.w)));
      st_shared_v4(st + TILE + off,
                   make_uint4(__float_as_uint(tf32_rna(v.x - h.x)),
                              __float_as_uint(tf32_rna(v.y - h.y)),
                              __float_as_uint(tf32_rna(v.z - h.z)),
                              __float_as_uint(tf32_rna(v.w - h.w))));
    }
  };

  float acc[64];

  // one slab: `nxt` holds slab kt + 1's xc (loaded a step ago), `after`
  // receives slab kt + 2's
  auto step = [&](int kt, float4 (&nxt)[CHUNKS], float4 (&after)[CHUNKS]) {
    const int slot = kt % STAGES;
    if (kt + 2 < nk) load_x(kt + 2, after);  // in flight for two slabs
    cp_async_wait<STAGES - 2>();  // this thread's center copies of slab kt have landed
    fence_proxy_async();          // they and the xc stores are visible to wgmma
    wgmma_wait<0>();              // this warpgroup's products of slab kt - 1 are done
    fence_regs(acc);
    // both warpgroups are past slab kt - 1, whose slot the centers of slab
    // kt + 2 refill, and every thread's share of slab kt is in place
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_c(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint32_t st = sbase + slot * STAGE, a = st + wg * 64 * 128;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const uint64_t ah = sw128_desc(a + ks * 32, 16, 1024);
      const uint64_t al = sw128_desc(a + TILE + ks * 32, 16, 1024);
      const uint64_t bh = sw128_desc(st + 2 * TILE + ks * 32, 16, 1024);
      const uint64_t bl = sw128_desc(st + 3 * TILE + ks * 32, 16, 1024);
      WgmmaTf32<BN>::mma(acc, ah, bh);
      WgmmaTf32<BN>::mma(acc, ah, bl);
      WgmmaTf32<BN>::mma(acc, al, bh);
    }
    wgmma_commit();
    fence_regs(acc);
    // slab kt + 1's xc goes to the slot slab kt - 2 used, free since the
    // barrier of step kt - 1
    if (kt + 1 < nk) store_x((kt + 1) % STAGES, nxt);
  };

  // CTA `rank` takes the argmin of a quarter of the tile's points, a warp a
  // point: ROWS / 8 points a warp, each with the running (d2, index) of the
  // tiles so far, the same in every lane
  constexpr int ROWS = BM / CLUSTER, PER_WARP = ROWS / (NT / 32);
  float run_v[PER_WARP];
  int run_i[PER_WARP];
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    run_v[i] = INFINITY;
    run_i[i] = 0;
  }
  float* part = reinterpret_cast<float*>(smem);
  const uint32_t pbase = smem_addr(part);
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);

  // the centers in tiles of 128, in increasing order; each tile streams this
  // CTA's K range of xc again (from L2)
  for (n0 = 0; n0 < Kc; n0 += BN) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // the centers run STAGES - 1 slabs ahead through cp.async groups, xc two
    // slabs ahead through two register buffers that take turns
    float4 xa[CHUNKS], xb[CHUNKS];
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk) load_c(s, s);
      cp_async_commit();
    }
    if (nk > 0) load_x(0, xa);
    if (nk > 1) load_x(1, xb);
    if (nk > 0) store_x(0, xa);
    for (int kt = 0; kt < nk; kt += 2) {
      step(kt, xb, xa);
      if (kt + 1 < nk) step(kt + 1, xa, xb);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it takes the partial tile

    // the f32 partial, point-major: part[r * LDP + n] (see Wgmma in hopper.cuh)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(part + r0 * LDP + n) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (r0 + 8) * LDP + n) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_sync();  // every CTA's partial is written

    // sum the cluster's partials in rank order, lane l holding the centers
    // n0 + 2l, n0 + 2l + 1, n0 + 64 + 2l, n0 + 65 + 2l, and take the tile's
    // first-index argmin; it replaces the running one only if strictly
    // smaller, so the first index wins a tie across tiles too
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
      const int r = rank * ROWS + warp + i * (NT / 32), m = m0 + r;
      if (m >= N) break;
      const uint32_t off = pbase + (uint32_t)(r * LDP + 2 * lane) * 4;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) {
        const float2 lo = ld_cluster_f2(map_rank(off, q));
        const float2 hi = ld_cluster_f2(map_rank(off + 64 * 4, q));
        dot[0] += lo.x;
        dot[1] += lo.y;
        dot[2] += hi.x;
        dot[3] += hi.y;
      }
      const float xm = x2[m];
      float bv = INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // increasing center index: the first wins a tie
        const int n = n0 + (j >> 1) * 64 + 2 * lane + (j & 1);
        const float v = n < Kc ? fmaxf(xm + c2[n] - 2.f * dot[j], 0.f) : INFINITY;
        if (v < bv) {
          bv = v;
          bi = n;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov < bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (bv < run_v[i]) {
        run_v[i] = bv;
        run_i[i] = bi;
      }
    }
    cluster_sync();  // no CTA refills its ring while another reads its partial
  }

#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    const int m = m0 + rank * ROWS + warp + i * (NT / 32);
    if (m >= N) break;
    const int bi = run_i[i];
    // best = |xc - (c - mu)|^2 to center bi, in f32 (bv would carry the
    // product's truncation); 16-byte rows as D % 4 == 0
    const bool ok = mask[m] != 0;
    float b = 0.f;
    if (ok) {
      const float4* xr = reinterpret_cast<const float4*>(xc + (size_t)m * D);
      const float4* cr = reinterpret_cast<const float4*>(c + (size_t)bi * D);
      const float4* mr = reinterpret_cast<const float4*>(mu);
#pragma unroll 8
      for (int j = lane; j < D / 4; j += 32) {  // unrolled: the row's loads in flight together
        const float4 xv = xr[j], cv = cr[j], mv = mr[j];
        const float e0 = xv.x - (cv.x - mv.x), e1 = xv.y - (cv.y - mv.y);
        const float e2 = xv.z - (cv.z - mv.z), e3 = xv.w - (cv.w - mv.w);
        b = fmaf(e0, e0, b);
        b = fmaf(e1, e1, b);
        b = fmaf(e2, e2, b);
        b = fmaf(e3, e3, b);
      }
      b = warp_sum(b);
    }
    if (lane == 0) {
      labels[m] = ok ? bi : -1;
      best[m] = b;
    }
  }
}

// grid (Kc + 1, ceil(D / 256)): block (k, y) adds the rows of center k's
// members for columns [256 y, 256 y + 256); block (Kc, 0) sums the inertia
__global__ void __launch_bounds__(SUM_COLS)
lloyd_sums(const float* __restrict__ x, const int* __restrict__ labels,
           const float* __restrict__ best, int N, int D, int Kc,
           float* __restrict__ sums, float* __restrict__ counts,
           float* __restrict__ inertia) {
  __shared__ int members[CHUNK];
  __shared__ int found[SUM_COLS / 32];
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = blockIdx.y * SUM_COLS + threadIdx.x;
  float acc = 0.f;
  int cnt = 0;
  for (int base = 0; base < N; base += CHUNK) {
    // warp w lists, in point order, center k's members among the labels
    // [base + w SEG, base + (w + 1) SEG)
    int* list = members + warp * SEG;
    int n = 0;
    for (int j = base + warp * SEG + lane; j < base + (warp + 1) * SEG; j += 32) {
      const bool hit = j < N && labels[j] == k;
      const unsigned b = __ballot_sync(0xffffffffu, hit);
      if (hit) list[n + __popc(b & ((1u << lane) - 1u))] = j;
      n += __popc(b);
    }
    if (lane == 0) found[warp] = n;
    __syncthreads();
    for (int w = 0; w < SUM_COLS / 32; ++w) {  // the warps' lists in order: point order
      const int nw = found[w];
      const int* lw = members + w * SEG;
      cnt += nw;
      if (d < D) {
#pragma unroll 4
        for (int i = 0; i < nw; ++i) acc += x[(size_t)lw[i] * D + d];
      }
    }
    __syncthreads();
  }
  if (d < D) sums[(size_t)k * D + d] = acc;
  if (blockIdx.y == 0 && threadIdx.x == 0) counts[k] = (float)cnt;
}

}  // namespace

// Per fit.  D % 4 == 0 and x 16-byte aligned; mu (D,), xc (N, D), x2 (N,).
extern "C" int sq_lloyd_prepare(const float* x, const uint8_t* mask, int N, int D, float* mu,
                                float* xc, float* x2, void* stream) {
  if (N <= 0 || D <= 0 || D % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lloyd_mean<<<(D + 31) / 32, 1024, 0, s>>>(x, mask, N, D, mu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lloyd_center<<<(N + 7) / 8, 256, 0, s>>>(x, mask, mu, N, D, xc, x2);
  return (int)cudaGetLastError();
}

// Per Lloyd step, three launches.  Kc >= 1; c 16-byte aligned; x, xc,
// x2, mask and mu from sq_lloyd_prepare; chi, clo (Kc, D) and c2 (Kc,) are scratch; labels,
// best (N,), sums (Kc, D), counts (Kc,), inertia () the outputs.  lloyd_assign
// runs in clusters of 4 CTAs with SMEM (193 KB) of dynamic shared memory.
extern "C" int sq_lloyd_wgmma(const float* x, const float* xc, const float* x2,
                              const uint8_t* mask, const float* mu, const float* c, int N,
                              int D, int Kc, float* chi, float* clo, float* c2, int* labels,
                              float* best, float* sums, float* counts, float* inertia,
                              void* stream) {
  if (N <= 0 || D <= 0 || D % 4 || Kc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lloyd_centers<<<Kc, 256, 0, s>>>(c, mu, D, chi, clo, c2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(lloyd_assign, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BM - 1) / BM * CLUSTER);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, lloyd_assign, xc, x2, mask, (const float*)chi,
                         (const float*)clo, (const float*)c2, c, mu, N, D, Kc, labels, best);
  if (e != cudaSuccess) return (int)e;
  lloyd_sums<<<dim3(Kc + 1, (D + SUM_COLS - 1) / SUM_COLS), SUM_COLS, 0, s>>>(
      x, labels, best, N, D, Kc, sums, counts, inertia);
  return (int)cudaGetLastError();
}
