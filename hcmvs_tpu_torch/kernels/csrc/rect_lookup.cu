// Kernel C: per-candidate lookup of the neighbour maps in the rect frames.
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
// column base per tile, over the same maps and fields.  A tile with no
// in-frame read keeps the sentinel 2^20 as its minimum, so its base is
// the last window.  Map words are copied as 32-bit words, never through
// float arithmetic: word 1 carries bit-packed bf16 normals.
//
// What bounds it on the H100, and what the design does about it: bytes.
// Per pixel it reads sigma once for each candidate and c0, k and row_int
// once for each view, and writes C words for each (candidate, view): at
// 1280x960, V = 3 and K = 8 about 0.38 GB (0.11 ms at 3.35 TB/s), most of
// it the 236 MB of output.
//   - A block owns one (8, 128) tile and up to 8 candidates, and loops
//     over the V views inside: it loads its pixels' K sigmas once and
//     keeps them in registers for every view (with the views on the
//     grid, the stack's sigma was read once per view).  More candidates
//     are further groups of 8 on grid z, so any K takes one launch.
//   - 256 threads, a warp a tile row, 4 neighbouring pixels a thread:
//     c0, k, row_int and sigma arrive as 16-byte loads and each output
//     plane's 4 words leave as one 16-byte store (a scalar path covers a
//     thread past W, W % 4 != 0 or an unaligned argument).
//   - Column bases without atomics: for each (view, candidate) a thread
//     takes the min over its 4 pixels, then __reduce_min_sync over the
//     warp; each warp's minimum goes to a [candidate][warp] array in
//     shared memory, read by every thread after one __syncthreads() a
//     view.  The array is double-buffered across views, so the next
//     view's writes need no second barrier.
//   - Then, a candidate at a time, a thread issues its 2 channels x 4
//     pixels of gathers (read-only loads) and their two 16-byte stores.
//     Issuing more candidates' gathers before their stores (all 8: 64
//     loads in flight a thread) needs more registers than two blocks an
//     SM leave, and measured slower on the stack of 8 (kGather below,
//     kernel_c_variants.py).
//   - No staging of the window in shared memory and no TMA: a tile's
//     40 x 512 x C window is 160 KB at C = 2 and serves 1,024 x C reads,
//     so staging it would move ~20x the bytes it gives; TMA copies tiles
//     and this is a gather.  The rect maps (59 MB at 1280x960, V = 3) are
//     read where the tiles' reads fall, one window a tile, out of L2.
#include "common.cuh"

namespace {

constexpr int kInvalid = 1 << 20;
constexpr int kRowsHalf = 8;
constexpr int kBandRows = 5 * kRowsHalf;
constexpr int kColsHalf = 256;
constexpr int kWinCols = 2 * kColsHalf;
constexpr int kTileRows = 8;
constexpr int kTileCols = 128;
constexpr int kPix = 4;                      // neighbouring pixels a thread
constexpr int kWarps = kTileRows;            // a warp a tile row
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;                 // candidates a block
constexpr int kChanStep = 2;                 // channels gathered per store
constexpr int kGather = 1;                   // candidates gathered per store
template <int G>
constexpr int kGatherOf = G < kGather ? G : kGather;

// The thread's 4 words of a (.., H, W) plane at p: one 16-byte load when
// ``vec`` (all 4 pixels inside, 16-byte aligned), else a load for each of
// the first n_in pixels and ``fill`` past them.
__device__ __forceinline__ void load4(const unsigned* __restrict__ p,
                                      bool vec, int n_in, unsigned fill,
                                      unsigned (&v)[kPix]) {
  if (vec) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) v[j] = j < n_in ? __ldg(p + j) : fill;
  }
}

__device__ __forceinline__ void store4(unsigned* __restrict__ p, bool vec,
                                       int n_in, const unsigned (&v)[kPix]) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (j < n_in) p[j] = v[j];
    }
  }
}

// G: candidates a block (1, 2, 4 or 8); the last group may hold fewer.
template <int G>
__global__ void __launch_bounds__(kThreads)
rect_lookup_kernel(const unsigned* __restrict__ maps,
                   const unsigned* __restrict__ row_int,
                   const unsigned* __restrict__ c0,
                   const unsigned* __restrict__ k,
                   const int* __restrict__ rb,
                   const unsigned* __restrict__ sigma,
                   unsigned* __restrict__ out, int n_cand, int nv, int c,
                   int h, int w, int h_r, int w_r, bool vec_ok) {
  __shared__ __align__(16) int s_min[2][G][kWarps];
  const int n_bw = gridDim.x, n_bh = gridDim.y;
  const int bw = blockIdx.x, bh = blockIdx.y;
  const int g0 = blockIdx.z * G;
  const int n_g = min(G, n_cand - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int y = bh * kTileRows + warp;
  const int x = bw * kTileCols + lane * kPix;
  // this thread's pixels inside the frame (0 to 4)
  const int n_in = y < h ? hcmvs::clampi(w - x, 0, kPix) : 0;
  const bool vec = vec_ok && n_in == kPix;
  const long long hw = (long long)h * w;
  const long long pix = (long long)y * w + x;
  const long long plane_r = (long long)h_r * w_r;

  // the group's sigmas, read once for every view
  float sig[G][kPix];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unsigned s[kPix] = {0u, 0u, 0u, 0u};
    if (g < n_g) load4(sigma + (g0 + g) * hw + pix, vec, n_in, 0u, s);
#pragma unroll
    for (int j = 0; j < kPix; ++j) sig[g][j] = __uint_as_float(s[j]);
  }

  for (int v = 0; v < nv; ++v) {
    const int buf = v & 1;
    const long long at = v * hw + pix;
    unsigned c0v[kPix], kv[kPix], rowv[kPix];
    load4(c0 + at, vec, n_in, 0u, c0v);
    load4(k + at, vec, n_in, 0u, kv);
    load4(row_int + at, vec, n_in, (unsigned)kInvalid, rowv);

    // each candidate's icols and this warp's least in-frame one
    int icol[G][kPix];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int m = kInvalid;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        int ic = -kInvalid;
        if (j < n_in) {
          // a separate multiply and add (built with --fmad=false)
          const float col = __uint_as_float(c0v[j]) +
                            __uint_as_float(kv[j]) * sig[g][j];
          ic = (int)rintf(hcmvs::clampf(col, -2.0f * kInvalid,
                                        2.0f * kInvalid));
        }
        icol[g][j] = ic;
        m = min(m, (ic < 0 || ic > w_r - 1) ? kInvalid : ic);
      }
      m = __reduce_min_sync(0xffffffffu, m);
      if (lane == 0) s_min[buf][g][warp] = m;
    }
    __syncthreads();     // s_min[buf] complete; s_min[buf ^ 1] free again

    // each read's word offset in its view's planes, or -1 for a miss
    const int roff0 = rb[((long long)v * n_bh + bh) * n_bw + bw] *
                      kRowsHalf;
    int off[G][kPix];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int4 lo = *reinterpret_cast<const int4*>(&s_min[buf][g][0]);
      const int4 hi = *reinterpret_cast<const int4*>(&s_min[buf][g][4]);
      const int m = min(min(min(lo.x, lo.y), min(lo.z, lo.w)),
                        min(min(hi.x, hi.y), min(hi.z, hi.w)));
      const int cb = hcmvs::clampi(m / kColsHalf, 0, w_r / kColsHalf - 2);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const int row = (int)rowv[j];
        const int ic = icol[g][j];
        const int iwin = ic - cb * kColsHalf;
        const int roff = row - roff0;
        const bool ok = j < n_in && roff >= 0 && roff < kBandRows &&
                        iwin >= 0 && iwin < kWinCols && ic >= 0 &&
                        ic <= w_r - 1 && row <= h_r - 1;
        off[g][j] = ok ? max(row, 0) * w_r + ic : -1;
      }
    }

    // the gathers of kGather candidates, then their stores
    const unsigned* maps_v = maps + (long long)v * c * plane_r;
    for (int ch0 = 0; ch0 < c; ch0 += kChanStep) {
#pragma unroll
      for (int gb = 0; gb < G; gb += kGatherOf<G>) {
        unsigned val[kGatherOf<G>][kChanStep][kPix];
#pragma unroll
        for (int gi = 0; gi < kGatherOf<G>; ++gi) {
#pragma unroll
          for (int s = 0; s < kChanStep; ++s) {
            const unsigned* mp = maps_v + (ch0 + s) * plane_r;
            const bool live = gb + gi < n_g && ch0 + s < c;
#pragma unroll
            for (int j = 0; j < kPix; ++j) {
              const int o = off[gb + gi][j];
              val[gi][s][j] = live && o >= 0 ? __ldg(mp + o) : 0u;
            }
          }
        }
#pragma unroll
        for (int gi = 0; gi < kGatherOf<G>; ++gi) {
#pragma unroll
          for (int s = 0; s < kChanStep; ++s) {
            if (gb + gi < n_g && ch0 + s < c) {
              store4(out + (((long long)(g0 + gb + gi) * nv + v) * c + ch0 +
                            s) * hw + pix, vec, n_in, val[gi][s]);
            }
          }
        }
      }
    }
  }
}

template <int G>
cudaError_t launch(dim3 grid, cudaStream_t stream, const void* maps,
                   const void* row_int, const void* c0, const void* k,
                   const void* rb, const void* sigma, void* out, int n_cand,
                   int v, int c, int h, int w, int h_r, int w_r,
                   bool vec_ok) {
  rect_lookup_kernel<G><<<grid, kThreads, 0, stream>>>(
      (const unsigned*)maps, (const unsigned*)row_int, (const unsigned*)c0,
      (const unsigned*)k, (const int*)rb, (const unsigned*)sigma,
      (unsigned*)out, n_cand, v, c, h, w, h_r, w_r, vec_ok);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

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
  if (n_cand == 0 || v == 0 || h == 0 || w == 0) {
    return (int)cudaGetLastError();
  }
  // the smallest group of 1, 2, 4 or 8 that holds the candidates, or 8
  const int g = n_cand > 4 ? kMaxGroup : n_cand > 2 ? 4 : n_cand;
  const int n_groups = (n_cand + g - 1) / g;
  if (n_groups > 65535) return (int)cudaErrorInvalidValue;
  const bool vec_ok = w % kPix == 0 && aligned16(row_int) &&
                      aligned16(c0) && aligned16(k) && aligned16(sigma) &&
                      aligned16(out);
  const dim3 grid((w + kTileCols - 1) / kTileCols,
                  (h + kTileRows - 1) / kTileRows, n_groups);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc;
  switch (g) {
    case 1:
      rc = launch<1>(grid, s, maps, row_int, c0, k, rb, sigma, out, n_cand,
                     v, c, h, w, h_r, w_r, vec_ok);
      break;
    case 2:
      rc = launch<2>(grid, s, maps, row_int, c0, k, rb, sigma, out, n_cand,
                     v, c, h, w, h_r, w_r, vec_ok);
      break;
    case 4:
      rc = launch<4>(grid, s, maps, row_int, c0, k, rb, sigma, out, n_cand,
                     v, c, h, w, h_r, w_r, vec_ok);
      break;
    default:
      rc = launch<kMaxGroup>(grid, s, maps, row_int, c0, k, rb, sigma, out,
                             n_cand, v, c, h, w, h_r, w_r, vec_ok);
  }
  return (int)rc;
}

HCMVS_API const char* hcmvs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
