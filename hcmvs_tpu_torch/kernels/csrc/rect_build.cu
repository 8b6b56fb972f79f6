// Kernel A: the rect-frame sigma-table build.
//
// Replaces the Pallas kernel hcmvs_tpu/ops/volume.py
// build_volume_tables_rect -> _rect_build_kernel, with the semantics of
// its XLA replica _rect_build_xla.  For every (pair v, pixel p, plane j):
//   row  = floor(rowf[p]) (band-relative), fr its fraction; rows outside
//          the tile's 11 x 8-row band read 0 (the Mosaic banding is part
//          of the reference semantics, so it is reproduced exactly);
//   col  = clip(floor(c0w[p] + kp[p] * j), 0, 1022) + 512 * cb[tile],
//          clamped to the frame, fc its clipped fraction;
//   tab[v, p, j] = u16(round(clip(bilerp(rect_src[v], row, col), 0, 1)
//                              * 65535)).
// Pixel p runs in the rect build's tile-major order (volume.to_volume_order):
// p = tile * 1024 + column_in_tile * 8 + row_in_tile.  Rows p >= 1024 * T
// are the table's alignment padding and are written 0.  The u16 encoding
// (_encode_tab) is fused, so the f32 table never reaches device memory.
//
// What bounds it on the H100: bytes written.  The output is 256 B per
// pixel and pair (0.94 GB per reference view at 1280x960 x 3 pairs,
// 0.31 ms at 3.35 TB/s); the four taps per entry come from one pair's
// 20 MB rect image, which stays in the 50 MB L2 (the grid runs the pairs
// one after the other).
//
// The first design ran one thread per (v, p, j) and was bound by
// instruction issue and latency: every thread split its flat index with
// 64-bit division and modulo by the runtime row count, all 128 threads of
// a pixel repeated its field loads and its row, band and mask work, and
// each thread waited on a chain of dependent loads (fields, tile bases,
// taps) for one output.  In this design a half-warp owns a pixel and lane
// l makes its planes l, l + 16, ..., l + 112.  The grid is (pixel blocks,
// pair); a 64-bit base is formed once per (pair, pixel), the rest of the
// index work is 32-bit.  A warp's eight pixels have their per-pixel work
// (row, fraction, band masks, window bases, row offsets) done up front by
// eight lanes, all loads in flight together, and handed to the half-warps
// by shuffles.  The two half-warps of a step take pixels p and p + 8: the
// same row of neighbouring tile columns, whose rect rows and columns
// nearly coincide, so one gather instruction's two halves share cache
// lines.  A pixel whose two rows lie in the band and whose window cannot
// reach the frame's last column (nearly all of them) skips the masks'
// multiplications by 1 and the column clamps that cannot bind; the rest
// take the general formula; both give the same bits.  Stores stay 2 bytes
// a lane (32 contiguous bytes a half-warp): a lane that owned adjacent
// planes, to store them as one wider word, would spread every gather
// instruction over twice the columns (kp is 1.6-3.1 columns per plane in
// the bench scene).  The arithmetic is the first design's, op by op
// (--fmad=false), so the table stays bit-equal to the plain version.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), with kernel
// time taken from launches queued behind a spin kernel: the first design
// 2.82 ms, this one 0.74 ms for the build above (42% of the byte bound).
#include "common.cuh"

namespace {

constexpr int kPlanes = 128;
constexpr int kLanes = 16;                      // a half-warp per pixel
constexpr int kLanePlanes = kPlanes / kLanes;   // planes l + 16 q
constexpr int kWarps = 8;
constexpr int kSteps = 4;                       // pixel pairs per warp
constexpr int kPixelsPerWarp = 2 * kSteps;
constexpr int kPixelsPerBlock = kWarps * kPixelsPerWarp;
constexpr int kBandRows = 11 * 8;   // _RG_ROW_HALVES x 8
constexpr int kWinColsLast = 1022;  // 1024-column window, lerp needs +1
constexpr int kColBase = 512;
// per-pixel flags
constexpr int kIn0 = 1;      // row 0 in the band
constexpr int kIn1 = 2;      // row 1 in the band
constexpr int kInside = 4;   // both rows in the band, no column clamp binds
constexpr int kUsed = 8;     // p < n_tiles * 1024 (else a padding row)

// One pixel's planes lane + 16 q.  kFast: both rows in the band and the
// window's columns within the frame, so ok0 = ok1 = 1 and the column
// clamps cannot bind.
template <bool kFast>
__device__ __forceinline__ void pixel_planes(
    const float* __restrict__ row0, const float* __restrict__ row1,
    float ok0, float ok1, float fr, float c0, float kk, int col_lo, int w_r,
    int lane, uint16_t* __restrict__ out) {
  const float gr = 1.0f - fr;
#pragma unroll
  for (int q = 0; q < kLanePlanes; ++q) {
    const float base = c0 + kk * (float)(lane + kLanes * q);
    const float i0 = hcmvs::clampf(floorf(base), 0.0f, (float)kWinColsLast);
    const float fc = hcmvs::clampf(base - i0, 0.0f, 1.0f);
    const int ci = (int)i0 + col_lo;
    float v00, v01, v10, v11;
    if (kFast) {
      v00 = row0[ci];
      v01 = row0[ci + 1];
      v10 = row1[ci];
      v11 = row1[ci + 1];
    } else {
      const int ci0 = hcmvs::clampi(ci, 0, w_r - 1);
      const int ci1 = hcmvs::clampi(ci + 1, 0, w_r - 1);
      v00 = row0[ci0] * ok0;
      v01 = row0[ci1] * ok0;
      v10 = row1[ci0] * ok1;
      v11 = row1[ci1] * ok1;
    }
    const float gc = 1.0f - fc;
    const float top = v00 * gc + v01 * fc;
    const float bot = v10 * gc + v11 * fc;
    const float val = top * gr + bot * fr;
    out[kLanes * q] =
        (uint16_t)rintf(hcmvs::clampf(val, 0.0f, 1.0f) * 65535.0f);
  }
}

// Pixel of slot s (0 .. kPixelsPerWarp - 1) of a warp: step s >> 1, half
// s & 1.
__device__ __forceinline__ int slot_pixel(int block_p0, int warp, int s) {
  return block_p0 + 2 * kWarps * (s >> 1) + warp + kWarps * (s & 1);
}

__global__ void __launch_bounds__(kWarps * 32)
    rect_build_kernel(const float* __restrict__ rect_src,
                      const int* __restrict__ rb, const int* __restrict__ cb,
                      const float* __restrict__ rowf,
                      const float* __restrict__ c0w,
                      const float* __restrict__ kp,
                      uint16_t* __restrict__ tab, int h_r, int w_r,
                      int n_tiles, int p_pad) {
  const int v = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p_used = n_tiles * 1024;
  const int block_p0 = blockIdx.x * kPixelsPerBlock;
  const float* src = rect_src + (long long)v * h_r * w_r;

  // lane s < kPixelsPerWarp: the per-pixel work of the warp's slot s
  int f_flags = 0, f_row0 = 0, f_row1 = 0, f_col = 0;
  float f_fr = 0.0f, f_c0 = 0.0f, f_kk = 0.0f;
  if (lane < kPixelsPerWarp) {
    const int p = slot_pixel(block_p0, warp, lane);
    if (p < p_used) {
      const long long fi = (long long)v * p_used + p;
      const float rf = rowf[fi];
      f_c0 = c0w[fi];
      f_kk = kp[fi];
      const int tile = p >> 10;
      const int band_lo = rb[v * n_tiles + tile] * 8;
      f_col = cb[v * n_tiles + tile] * kColBase;
      const float r0 = floorf(rf);
      f_fr = rf - r0;
      const int r0b = (int)r0;
      const bool in0 = r0b >= 0 && r0b < kBandRows;
      const bool in1 = r0b + 1 >= 0 && r0b + 1 < kBandRows;
      f_row0 = hcmvs::clampi(r0b + band_lo, 0, h_r - 1) * w_r;
      f_row1 = hcmvs::clampi(r0b + 1 + band_lo, 0, h_r - 1) * w_r;
      const bool fast = in0 && in1 && f_col >= 0 &&
                        f_col + kWinColsLast + 1 < w_r;
      f_flags = kUsed | (in0 ? kIn0 : 0) | (in1 ? kIn1 : 0) |
                (fast ? kInside : 0);
    }
  }

  const int half = lane >> 4;
  const int l = lane & (kLanes - 1);
#pragma unroll 1
  for (int i = 0; i < kSteps; ++i) {
    const int s = 2 * i + half;
    const unsigned all = 0xffffffffu;
    const int flags = __shfl_sync(all, f_flags, s);
    const int row0 = __shfl_sync(all, f_row0, s);
    const int row1 = __shfl_sync(all, f_row1, s);
    const int col_lo = __shfl_sync(all, f_col, s);
    const float fr = __shfl_sync(all, f_fr, s);
    const float c0 = __shfl_sync(all, f_c0, s);
    const float kk = __shfl_sync(all, f_kk, s);
    const int p = slot_pixel(block_p0, warp, s);
    if (p >= p_pad) continue;
    uint16_t* out = tab + ((long long)v * p_pad + p) * kPlanes + l;
    if (!(flags & kUsed)) {
#pragma unroll
      for (int q = 0; q < kLanePlanes; ++q) out[kLanes * q] = 0;
    } else if (flags & kInside) {
      pixel_planes<true>(src + row0, src + row1, 1.0f, 1.0f, fr, c0, kk,
                         col_lo, w_r, l, out);
    } else {
      pixel_planes<false>(src + row0, src + row1,
                          (flags & kIn0) ? 1.0f : 0.0f,
                          (flags & kIn1) ? 1.0f : 0.0f, fr, c0, kk, col_lo,
                          w_r, l, out);
    }
  }
}

}  // namespace

// rect_src (v, h_r, w_r) f32; rb, cb (v, n_tiles) i32; rowf, c0w, kp
// (v, n_tiles * 1024) f32 in tile-major pixel order; tab (v, p_pad, 128)
// u16 with p_pad >= n_tiles * 1024.  All contiguous; h_r * w_r and p_pad
// below 2^31.
HCMVS_API int hcmvs_rect_build(const void* rect_src, const void* rb,
                               const void* cb, const void* rowf,
                               const void* c0w, const void* kp, void* tab,
                               int v, int h_r, int w_r, int n_tiles,
                               long long p_pad, void* stream) {
  if ((long long)h_r * w_r >= (1LL << 31) || p_pad >= (1LL << 31) ||
      p_pad < (long long)n_tiles * 1024 || v > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (v <= 0 || p_pad <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((p_pad + kPixelsPerBlock - 1) / kPixelsPerBlock),
                  (unsigned)v);
  rect_build_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)rect_src, (const int*)rb, (const int*)cb,
      (const float*)rowf, (const float*)c0w, (const float*)kp,
      (uint16_t*)tab, h_r, w_r, n_tiles, (int)p_pad);
  return (int)cudaGetLastError();
}
