// Kernel D: sigma-table lookup of C index columns per table row.
//
// Replaces the Pallas kernel hcmvs_tpu/ops/volume.py volume_lookup_multi ->
// _lookup_multi_kernel.  Row q of the (P, D) u16 table serves all C
// columns of row q of the index field f (every candidate x patch offset of
// one pixel), in one of three modes (common.cuh): f32; packed, f u16
// fixed point (f * 64), the lerp on the raw u16 scale, rounded; bounded,
// packed with the sentinel 0xFFFF outside the row's [lo, hi], which the
// (P, 128) bounds panel holds in lanes 0 and 64.  The Mosaic plumbing of
// the TPU kernel (both lerp taps packed into one 128-lane gather, the
// select-merge over 128-plane chunks, the u16 -> i32 -> f32 decode hop)
// does not carry over: a flat index into the row serves any D that is a
// multiple of 128.
//
// What bounds it on the H100: bytes.  At the hybrid path's full sampling
// (P = 1,228,800 rows, C = 9 x 36 = 324, bounded) it streams the 796 MB
// index field in and the 796 MB panel out, reads two 32 B sectors of
// bounds a row (79 MB) and only the table sectors of in-bounds taps.  It
// is table_lookup.cuh's flat kernel, with C and D taken at launch: a 16 B
// vector of the field (8 u16 items) a thread over the flat (P * C) array
// (C = 81 rows start at odd 2 B offsets), lo and hi read once for the
// one or two rows a vector spans, every tap issued before any is used, no
// table staging, and no tap read for an out-of-bounds item.
#include "table_lookup.cuh"

namespace {

template <int M>
int launch(const void* tab, const void* f, const void* bounds, void* out,
           unsigned n, int c, int d, cudaStream_t stream) {
  return hcmvs::launch_table_lookup<M, 0, 0>(
      (const uint16_t*)tab, f, (const uint16_t*)bounds, out, n, c, d, stream);
}

}  // namespace

// tab (p, d) u16 with d a multiple of 128; f (p, c) f32 (mode
// 0) or u16 (modes 1, 2); bounds (p, 128) u16 (mode 2, else null); out
// (p, c) f32 (mode 0) or u16.  All contiguous, p * c < 2^31.
HCMVS_API int hcmvs_volume_lookup_multi(const void* tab, const void* f,
                                        const void* bounds, void* out,
                                        long long p, int c, int d, int mode,
                                        void* stream) {
  if (p <= 0 || c <= 0) return (int)cudaGetLastError();
  if (d % 128 != 0 || d < 128 || mode < hcmvs::kF32
      || mode > hcmvs::kBounded) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned n = (unsigned)(p * c);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == hcmvs::kF32) {
    return launch<hcmvs::kF32>(tab, f, bounds, out, n, c, d, s);
  }
  if (mode == hcmvs::kPacked) {
    return launch<hcmvs::kPacked>(tab, f, bounds, out, n, c, d, s);
  }
  return launch<hcmvs::kBounded>(tab, f, bounds, out, n, c, d, s);
}
