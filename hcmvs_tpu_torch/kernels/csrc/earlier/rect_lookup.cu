// Kernel C: per-candidate lookup of the neighbour maps in the rect frames.
//
// The earlier design (one 1024-thread block per view and tile, views on
// grid z, a shared-memory atomicMin and three barriers per candidate),
// replaced by ../rect_lookup.cu and kept only to be timed against it
// (chip_smoke.py phase 3); it is built into a library of its own, and no
// path calls it.
//
// Replaces the Pallas kernel hcmvs_tpu/ops/rect_gather.py rect_lookup ->
// _lookup_kernel, with the semantics of its XLA replica rect_lookup_xla.
// For each view v and pixel p:
//   icol = round(clip(c0[p] + k[p] * sigma[p], -2^21, 2^21))
//   cb   = clip(min over the pixel's (8, 128) tile of its in-frame icols
//              / 256, 0, W_r / 256 - 2)                 (_col_bases)
//   out[v, :, p] = maps[v, :, row_int[p], icol] when the read lies inside
//   the tile's 40-row band (rb) and 512-column window (cb) and inside the
//   frame, else 0 ("neighbour invalid").
// The band and window are a Mosaic constraint of the TPU kernel, but
// their misses are part of the reference semantics and are kept exactly.
// A stack of K candidates' sigma fields (K, H, W) is read into (K, V, C,
// H, W) in the same one launch (the JAX package's vmap of the lookup
// gives the Pallas call one more grid axis): each candidate has its own
// column base per tile, over the same maps and fields.
//
// What bounds it on the H100: bytes.  Per pixel and view it reads 16 B of
// fields and C words of map, and writes C words: ~0.1 GB per call at
// 1280x960 x 3 views.  The map reads are scattered along one rect row
// per pixel, and a tile's reads fall in one 40 x 512 window that L2
// holds.  The simple design is one 1024-thread block per (view, tile):
// a shared-memory atomicMin gives the tile's column base, then each
// thread tests its own read and copies its C words bit for bit (the
// words carry bit-packed bf16 normals, so no float arithmetic touches
// them).  For a candidate stack the block loads its pixels' fields once
// and loops over the candidates (a column base and a read each), so the
// fields are read once for all K and the map window stays in L2.
#include "../common.cuh"

namespace {

constexpr int kInvalid = 1 << 20;
constexpr int kRowsHalf = 8;
constexpr int kBandRows = 5 * kRowsHalf;
constexpr int kColsHalf = 256;
constexpr int kWinCols = 2 * kColsHalf;
constexpr int kTileRows = 8;
constexpr int kTileCols = 128;

__global__ void rect_lookup_kernel(const float* __restrict__ maps,
                                   const int* __restrict__ row_int,
                                   const float* __restrict__ c0,
                                   const float* __restrict__ k,
                                   const int* __restrict__ rb,
                                   const float* __restrict__ sigma,
                                   float* __restrict__ out, int n_cand, int c,
                                   int h, int w, int h_r, int w_r) {
  const int n_bw = gridDim.x, n_bh = gridDim.y, nv = gridDim.z;
  const int bw = blockIdx.x, bh = blockIdx.y, v = blockIdx.z;
  const int x = bw * kTileCols + (threadIdx.x % kTileCols);
  const int y = bh * kTileRows + (threadIdx.x / kTileCols);
  const bool inside = y < h && x < w;
  const long long hw = (long long)h * w;

  __shared__ int s_min;
  int row = kInvalid;
  float c0_p = 0.0f, k_p = 0.0f;
  if (inside) {
    const long long pix = (long long)v * hw + (long long)y * w + x;
    c0_p = c0[pix];
    k_p = k[pix];
    row = row_int[pix];
  }
  const int roff = row - rb[((long long)v * n_bh + bh) * n_bw + bw] *
                             kRowsHalf;
  for (int cand = 0; cand < n_cand; ++cand) {
    if (threadIdx.x == 0) s_min = kInvalid;
    __syncthreads();
    int icol = -kInvalid;
    if (inside) {
      const float col = c0_p + k_p * sigma[cand * hw + (long long)y * w + x];
      icol = (int)rintf(hcmvs::clampf(col, -2.0f * kInvalid,
                                      2.0f * kInvalid));
    }
    atomicMin(&s_min, (icol < 0 || icol > w_r - 1) ? kInvalid : icol);
    __syncthreads();
    if (inside) {
      const int cb = hcmvs::clampi(s_min / kColsHalf, 0,
                                   w_r / kColsHalf - 2);
      const int iwin = icol - cb * kColsHalf;
      const bool ok = roff >= 0 && roff < kBandRows && iwin >= 0 &&
                      iwin < kWinCols && icol >= 0 && icol <= w_r - 1 &&
                      row <= h_r - 1;
      for (int ch = 0; ch < c; ++ch) {
        const long long plane = (long long)v * c + ch;
        const long long out_plane = (long long)cand * nv * c + plane;
        out[out_plane * hw + (long long)y * w + x] =
            ok ? maps[(plane * h_r + row) * w_r + icol] : 0.0f;
      }
    }
    __syncthreads();   // every read of s_min before the next reset
  }
}

}  // namespace

// maps (v, c, h_r, w_r) f32; row_int (v, h, w) i32; c0, k (v, h, w) f32;
// rb (v, ceil(h / 8), ceil(w / 128)) i32; sigma (n_cand, h, w) f32;
// out (n_cand, v, c, h, w) f32.  All contiguous; v <= 65535.
HCMVS_API int hcmvs_rect_lookup(const void* maps, const void* row_int,
                                const void* c0, const void* k, const void* rb,
                                const void* sigma, void* out, int n_cand,
                                int v, int c, int h, int w, int h_r, int w_r,
                                void* stream) {
  if (n_cand < 0 || v < 0 || v > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((w + kTileCols - 1) / kTileCols, (h + kTileRows - 1) / kTileRows,
            v);
  if (n_cand > 0 && v > 0 && h > 0 && w > 0) {
    rect_lookup_kernel<<<grid, kTileRows * kTileCols, 0,
                         (cudaStream_t)stream>>>(
        (const float*)maps, (const int*)row_int, (const float*)c0,
        (const float*)k, (const int*)rb, (const float*)sigma, (float*)out,
        n_cand, c, h, w, h_r, w_r);
  }
  return (int)cudaGetLastError();
}
