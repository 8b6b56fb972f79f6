// Kernel E: bilateral-weighted ZNCC over static patch offsets against the
// centre-warped source images.
//
// Replaces the Pallas kernel hcmvs_tpu/ops/pallas_zncc.py
// zncc_warped_pallas -> _kernel.  For each view v and pixel p, starting
// from the exactly warped corner sums acc[v, :, p] = (num, s1, sq1, sw),
// and for each offset (dy, dx) of the list:
//   v_d = ref_pad[p + (dy, dx)],  w_d = warped_pad[v, p + (dy, dx)],
//   ok = valid_pad[v, p + (dy, dx)],
//   wt = exp((v_d - v_c)^2 * (-1 / (2 * 0.2^2)) + (dy^2 + dx^2) * inv_2hw2)
//        * (max(|dy|, |dx|) <= hw) * ok,   inv_2hw2 = -0.5 / hw^2,
//   num += wt * (v_d - tm) * w_d,  s1 += wt * w_d,  sq1 += wt * w_d * w_d,
//   sw += wt;
// then var1 = sq1 - s1^2 / max(sw, 1e-12) and
// score = 1 - clip(num / sqrt(max(nsq0 * var1, 1e-16)), -1, 1).
// Padded arrays are (H + 2 pad, W + 2 pad) with every |dy|, |dx| <= pad.
// The Pallas row tiles with their halo copies, the (8, 128) alignment
// padding and the pltpu.roll shifts are Mosaic plumbing.
//
// What bounds it on the H100: bytes.  Phase 0 of the hybrid path (V = 3 at
// 960 x 1280, pad 5, 8 offsets) reads ref_pad (5 MB), warped_pad and
// valid_pad (30 MB), tm, nsq0, hw (15 MB) and acc (59 MB) and writes
// score and var1 (29.5 MB): about 138 MB, 41 us at 3.35 TB/s; its 9.8 M
// exps are far below the special-function units' rate.
//
// The first design ran one thread per (view, pixel) and read every tap from
// global memory: the reference's taps and the bilateral weight, which do
// not depend on the view, were loaded and computed V times, each texel was
// fetched once per offset per view, and two 64-bit divisions split the
// flat index.  This one runs a 2D grid of 32 x 16 pixel tiles, 256 threads
// a block, each thread two pixels of a column (rows y and y + 8), each for
// all V views (V a template parameter, 1..kMaxViews).  The block stages
// its haloed tile of ref_pad and of every view's warped_pad and valid_pad
// in shared memory ((16 + 2 pad) x (32 + 2 pad) floats each, 30.6 KB at
// V = 3, pad 5), so each texel leaves L2 once per block.  The staging uses
// cp.async: a thread's ~30 copies are all in flight at once instead of
// one load-store round trip after another.  Per offset the thread
// computes the reference's terms once (v_d, the colour and spatial
// weights, the window mask, e = exp(..) * in_win) and each view adds
// wt = e * ok to its own four sums, in the offsets' order.  The offsets
// come as a device buffer of (dy, dx) pairs, any count within the pad
// (the Pallas kernel reads them from SMEM): the block turns them into
// shared-memory displacements with dy^2 + dx^2 and max(|dy|, |dx|)
// beside them, staged after the tiles (12 B an offset), which every
// thread then reads as a broadcast.  (Until the offsets moved there they
// rode by value in the kernel's parameters, which capped them at 128:
// n-adapthalfwin 11 at patch step 2 gives 140.)  All indices are
// 32-bit (the launcher checks the sizes), with no division.  The
// accumulation order and every rounding step follow the plain version
// (built with --fmad=false; expf, not __expf): (exp(..) * in_win) * ok is
// the plain version's product, so the outputs stay equal to it.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), with kernel
// time taken from launches queued behind a spin kernel: the first design
// 0.111 ms, this one 0.063 ms at the phase-0 shapes above (65% of the byte
// bound).
//
// A stack of K candidates scored against the same reference (the JAX
// package's vmap of the cost, which gives the Pallas call one more grid
// axis) runs on the grid's z axis: block z reads candidate z's warped
// images, validity and corner sums and writes its outputs, at offsets of
// whole candidates from the bases; everything within a candidate is as
// for one hypothesis, so one launch serves the stack.
#include "common.cuh"

namespace {

constexpr int kMaxViews = 10;
constexpr int kTileX = 32;             // a block's pixel tile
constexpr int kTileY = 16;
constexpr int kThreadsY = 8;           // 32 x 8 threads, two rows each
constexpr int kMaxSmemBytes = 232448;  // a block's limit on the H100

// asynchronous 4-byte copy from global to shared memory (sm_80 and later)
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

template <int NV>
__global__ void __launch_bounds__(kTileX * kThreadsY)
    zncc_warped_kernel(const float* __restrict__ ref_pad,
                       const float* __restrict__ tm,
                       const float* __restrict__ nsq0,
                       const float* __restrict__ warped_pad,
                       const float* __restrict__ valid_pad,
                       const float* __restrict__ hw,
                       const float* __restrict__ acc,
                       float* __restrict__ score, float* __restrict__ var_out,
                       const int* __restrict__ offsets, int n_offsets, int h,
                       int w, int pad) {
  extern __shared__ float tile[];
  {
    // candidate blockIdx.z's planes
    const long long cand = blockIdx.z;
    const long long padded = (long long)(h + 2 * pad) * (w + 2 * pad);
    warped_pad += cand * NV * padded;
    valid_pad += cand * NV * padded;
    acc += cand * NV * 4 * (long long)h * w;
    score += cand * NV * (long long)h * w;
    var_out += cand * NV * (long long)h * w;
  }
  const int tw = kTileX + 2 * pad;
  const int th = kTileY + 2 * pad;
  const int tsz = tw * th;
  const int wp = w + 2 * pad;
  const int hp = h + 2 * pad;
  const int plane = hp * wp;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  // the offset table after the 1 + 2 NV tile planes: displacement in the
  // shared tile, dy^2 + dx^2, max(|dy|, |dx|)
  int* o_disp = reinterpret_cast<int*>(tile + (1 + 2 * NV) * tsz);
  float* o_d2 = reinterpret_cast<float*>(o_disp + n_offsets);
  float* o_cheb = o_d2 + n_offsets;
  for (int k = threadIdx.y * kTileX + threadIdx.x; k < n_offsets;
       k += kTileX * kThreadsY) {
    const int dy = offsets[2 * k], dx = offsets[2 * k + 1];
    o_disp[k] = dy * tw + dx;
    o_d2[k] = (float)(dy * dy + dx * dx);
    const int ay = dy < 0 ? -dy : dy, ax = dx < 0 ? -dx : dx;
    o_cheb[k] = (float)(ay > ax ? ay : ax);
  }

  // tile planes: 0 the reference, 1..NV the warped views, NV+1..2NV their
  // validity.  Tile row r, column c is padded row y0 + r, column x0 + c.
  for (int r = threadIdx.y; r < th; r += kThreadsY) {
    const int gy = y0 + r;
    for (int c = threadIdx.x; c < tw; c += kTileX) {
      const int gx = x0 + c;
      if (gy < hp && gx < wp) {
        const int g = gy * wp + gx;
        const int s = r * tw + c;
        copy_async(tile + s, ref_pad + g);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          copy_async(tile + (1 + v) * tsz + s, warped_pad + v * plane + g);
          copy_async(tile + (1 + NV + v) * tsz + s,
                     valid_pad + v * plane + g);
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int hw_n = h * w;
  const float* t_ref = tile;
  const float* t_warp = tile + tsz;
  const float* t_valid = tile + (1 + NV) * tsz;
  const float inv_2sc2 = -12.5f;        // -1 / (2 * 0.2^2)
#pragma unroll 1
  for (int sub = 0; sub < kTileY / kThreadsY; ++sub) {
    const int ty = threadIdx.y + kThreadsY * sub;
    const int x = x0 + threadIdx.x;
    const int y = y0 + ty;
    if (x >= w || y >= h) return;
    const int pix = y * w + x;
    float num[NV], s1[NV], sq1[NV], sw[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float* acc_v = acc + v * 4 * hw_n + pix;
      num[v] = acc_v[0];
      s1[v] = acc_v[hw_n];
      sq1[v] = acc_v[2 * hw_n];
      sw[v] = acc_v[3 * hw_n];
    }
    const float tm_p = tm[pix];
    const float hw_p = hw[pix];
    const int centre = (ty + pad) * tw + threadIdx.x + pad;
    const float v_c = t_ref[centre];
    const float inv_2hw2 = -0.5f * (1.0f / (hw_p * hw_p));

#pragma unroll 4
    for (int k = 0; k < n_offsets; ++k) {
      const int q = centre + o_disp[k];
      const float v_d = t_ref[q];
      const float dc = v_d - v_c;
      const float w_color = (dc * dc) * inv_2sc2;
      const float w_sp = o_d2[k] * inv_2hw2;
      const float in_win = o_cheb[k] <= hw_p ? 1.0f : 0.0f;
      const float e = expf(w_color + w_sp) * in_win;
      const float dt = v_d - tm_p;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float w_d = t_warp[v * tsz + q];
        const float wt = e * t_valid[v * tsz + q];
        num[v] = num[v] + (wt * dt) * w_d;
        const float t = wt * w_d;
        s1[v] = s1[v] + t;
        sq1[v] = sq1[v] + t * w_d;
        sw[v] = sw[v] + wt;
      }
    }
    const float nsq0_p = nsq0[pix];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float var1 = sq1[v] - (s1[v] * s1[v]) / fmaxf(sw[v], 1e-12f);
      const float denom = sqrtf(fmaxf(nsq0_p * var1, 1e-16f));
      const float ncc = hcmvs::clampf(num[v] / denom, -1.0f, 1.0f);
      score[v * hw_n + pix] = 1.0f - ncc;
      var_out[v * hw_n + pix] = var1;
    }
  }
}

template <int NV>
int launch(const float* ref_pad, const float* tm, const float* nsq0,
           const float* warped_pad, const float* valid_pad, const float* hw,
           const float* acc, float* score, float* var_out,
           const int* offsets, int n_offsets, int n_cand, int h, int w,
           int pad, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        zncc_warped_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY,
                  n_cand);
  zncc_warped_kernel<NV><<<grid, dim3(kTileX, kThreadsY), smem, stream>>>(
      ref_pad, tm, nsq0, warped_pad, valid_pad, hw, acc, score, var_out,
      offsets, n_offsets, h, w, pad);
  return (int)cudaGetLastError();
}

}  // namespace

// ref_pad (h + 2 pad, w + 2 pad); tm, nsq0, hw (h, w); warped_pad,
// valid_pad (n_cand, v, h + 2 pad, w + 2 pad); acc (n_cand, v, 4, h, w);
// score, var_out (n_cand, v, h, w); all f32, contiguous.  offsets: device
// array of n (dy, dx) int pairs, every |dy|, |dx| <= pad (checked by the
// Python launcher); 1 <= v <= 10; 1 <= n_cand <= 65535; a candidate's
// element count of every array below 2^31; the (1 + 2 v) haloed tiles and
// the 12 n bytes of the offset table within a block's shared memory.
HCMVS_API int hcmvs_zncc_warped(const void* ref_pad, const void* tm,
                                const void* nsq0, const void* warped_pad,
                                const void* valid_pad, const void* hw,
                                const void* acc, void* score, void* var_out,
                                const int* offsets, int n_offsets, int n_cand,
                                int v, int h, int w, int pad, void* stream) {
  const long long tile = (long long)(kTileX + 2 * pad) * (kTileY + 2 * pad);
  const long long smem = (1 + 2LL * v) * tile * (long long)sizeof(float) +
                         12LL * n_offsets;
  const long long padded = (long long)(h + 2 * pad) * (w + 2 * pad);
  if (n_offsets < 0 || v < 1 || v > kMaxViews || n_cand < 1 ||
      n_cand > 65535 ||
      pad < 0 || smem > kMaxSmemBytes || (long long)v * padded >= (1LL << 31) ||
      4LL * v * h * w >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  const float* a[7] = {(const float*)ref_pad,    (const float*)tm,
                       (const float*)nsq0,       (const float*)warped_pad,
                       (const float*)valid_pad,  (const float*)hw,
                       (const float*)acc};
  float* s = (float*)score;
  float* o = (float*)var_out;
  const int sm = (int)smem;
  cudaStream_t st = (cudaStream_t)stream;
  switch (v) {
#define HCMVS_ZNCC_CASE(NV)                                                \
  case NV:                                                                 \
    return launch<NV>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], s, o,     \
                      offsets, n_offsets, n_cand, h, w, pad, sm, st);
    HCMVS_ZNCC_CASE(1)
    HCMVS_ZNCC_CASE(2)
    HCMVS_ZNCC_CASE(3)
    HCMVS_ZNCC_CASE(4)
    HCMVS_ZNCC_CASE(5)
    HCMVS_ZNCC_CASE(6)
    HCMVS_ZNCC_CASE(7)
    HCMVS_ZNCC_CASE(8)
    HCMVS_ZNCC_CASE(9)
    HCMVS_ZNCC_CASE(10)
#undef HCMVS_ZNCC_CASE
  }
  return (int)cudaErrorInvalidValue;
}
