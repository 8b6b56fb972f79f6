// Kernel D: sigma-table lookup of C index columns per table row.
//
// The earlier design (whole table rows staged in shared memory), replaced
// by ../volume_lookup_multi.cu and kept only to be timed against it
// (chip_smoke.py phase 3); it is built into a library of its own, and no
// path calls it.
//
// Replaces the Pallas kernel hcmvs_tpu/ops/volume.py volume_lookup_multi ->
// _lookup_multi_kernel.  Row q of the (P, D) u16 table serves all C
// columns of row q of the index field f (every candidate x patch offset of
// one pixel), in one of three modes:
//   f32:     out = lerp(dec(tab[q, i0]), dec(tab[q, i0 + 1]), f - i0),
//            i0 = clip(floor f, 0, D - 2), dec(u) = u * (1 / 65535);
//   packed:  f is u16 fixed point (f * 64): i0 = min(f >> 6, D - 2),
//            t = (f - 64 i0) / 64, the lerp is taken on the raw u16 scale
//            and out = (u16) rint(lerp) (round half to even, as jnp.round);
//   bounded: packed, and out = min(rint(lerp), 65534) when
//            lo[q] <= f <= hi[q], else the sentinel 0xFFFF.  The bounds
//            panel (P, 128) holds lo in lanes 0..63 and hi in 64..127; only
//            lanes 0 and 64 are read.
// The Mosaic plumbing of the TPU kernel (both lerp taps packed into one
// 128-lane gather, the select-merge over 128-plane chunks, the u16 -> i32
// -> f32 decode hop) does not carry over: a flat index into the row serves
// any D that is a multiple of 128.
//
// What bounds it on the H100: bytes.  At the slice's full sampling
// (P = 1,228,800 rows, C = 9 x 36 = 324) it reads the 315 MB table, the
// 796 MB index field and two 32 B sectors of bounds per row (79 MB), and
// writes a 796 MB panel: about 1.99 GB, 0.59 ms at 3.35 TB/s.  The design:
// one block per kRows rows stages those rows' tables (and lo/hi) in shared
// memory with 16 B loads, so each table row leaves device memory once for
// all C columns (the point of the TPU kernel), then its threads walk the
// rows' kRows x C (row, column) pairs in flat order, which keeps the reads
// of f and the writes of out coalesced.
#include "../common.cuh"

namespace {

constexpr int kRows = 32;          // table rows per block
constexpr int kThreads = 256;
constexpr int kMaxPlanes = 512;    // shared memory: kRows x D u16 <= 32 KB
constexpr int kPackShift = 6;      // F_PACK_SCALE = 64
constexpr int kSentinel = 0xFFFF;

enum Mode { kF32 = 0, kPacked = 1, kBounded = 2 };

template <int M>
__global__ void __launch_bounds__(kThreads)
lookup_multi_kernel(const uint16_t* __restrict__ tab,
                    const void* __restrict__ f_any,
                    const uint16_t* __restrict__ bounds,
                    void* __restrict__ out_any, long long p, int c, int d) {
  extern __shared__ uint4 smem_v[];
  uint16_t* s_tab = reinterpret_cast<uint16_t*>(smem_v);
  __shared__ int s_lo[kRows];
  __shared__ int s_hi[kRows];

  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, p - r0);

  // stage the block's table rows: rows * d u16, d a multiple of 128, so a
  // whole number of 16 B words starting at a 16 B aligned address
  const uint4* src = reinterpret_cast<const uint4*>(tab + r0 * d);
  const int n_words = rows * d / 8;
  for (int i = threadIdx.x; i < n_words; i += kThreads) smem_v[i] = src[i];
  if (M == kBounded && threadIdx.x < rows) {
    s_lo[threadIdx.x] = bounds[(r0 + threadIdx.x) * 128];
    s_hi[threadIdx.x] = bounds[(r0 + threadIdx.x) * 128 + 64];
  }
  __syncthreads();

  const long long base = r0 * c;
  const int n_items = rows * c;
  for (int i = threadIdx.x; i < n_items; i += kThreads) {
    const int r = i / c;
    const uint16_t* row = s_tab + r * d;
    const long long g = base + i;
    if (M == kF32) {
      const float fv = static_cast<const float*>(f_any)[g];
      const float i0 = hcmvs::clampf(floorf(fv), 0.0f, (float)(d - 2));
      const float t = fv - i0;
      const int i0i = (int)i0;
      const float scale = (float)(1.0 / 65535.0);
      const float g0 = (float)row[i0i] * scale;
      const float g1 = (float)row[i0i + 1] * scale;
      static_cast<float*>(out_any)[g] = g0 + (g1 - g0) * t;
    } else {
      const int fi = static_cast<const uint16_t*>(f_any)[g];
      const int i0 = min(fi >> kPackShift, d - 2);
      const float t = (float)(fi - (i0 << kPackShift)) * (1.0f / 64.0f);
      const float g0 = (float)row[i0];
      const float g1 = (float)row[i0 + 1];
      int li = (int)rintf(g0 + (g1 - g0) * t);
      if (M == kBounded) {
        const bool ok = fi >= s_lo[r] && fi <= s_hi[r];
        li = ok ? min(li, kSentinel - 1) : kSentinel;
      }
      // i32 -> u16 keeps the low 16 bits, as the reference's astype does
      static_cast<uint16_t*>(out_any)[g] = (uint16_t)li;
    }
  }
}

template <int M>
int launch(const void* tab, const void* f, const void* bounds, void* out,
           long long p, int c, int d, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((p + kRows - 1) / kRows);
  const size_t smem = (size_t)kRows * d * sizeof(uint16_t);
  lookup_multi_kernel<M><<<blocks, kThreads, smem, stream>>>(
      (const uint16_t*)tab, f, (const uint16_t*)bounds, out, p, c, d);
  return (int)cudaGetLastError();
}

}  // namespace

// tab (p, d) u16 with d a multiple of 128 and <= 512, 16 B aligned;
// f (p, c) f32 (mode 0) or u16 (modes 1, 2); bounds (p, 128) u16 (mode 2,
// else null); out (p, c) f32 (mode 0) or u16.  All contiguous.
HCMVS_API int hcmvs_volume_lookup_multi(const void* tab, const void* f,
                                        const void* bounds, void* out,
                                        long long p, int c, int d, int mode,
                                        void* stream) {
  if (p <= 0 || c <= 0) return (int)cudaGetLastError();
  if (d % 128 != 0 || d > kMaxPlanes || mode < kF32 || mode > kBounded) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kF32) return launch<kF32>(tab, f, bounds, out, p, c, d, s);
  if (mode == kPacked) return launch<kPacked>(tab, f, bounds, out, p, c, d, s);
  return launch<kBounded>(tab, f, bounds, out, p, c, d, s);
}
