// Kernel B: sigma-table lookup with a lerp between adjacent planes.
//
// Replaces the Pallas kernel hcmvs_tpu/ops/volume.py volume_lookup ->
// _lookup_kernel, whose semantics (volume_lookup_xla) are
//   out[q, s] = lerp(dec(tab[q, i0]), dec(tab[q, i0 + 1]), f[q, s] - i0)
//   i0 = clip(floor(f[q, s]), 0, D - 2),   dec(u) = u * (1 / 65535).
// The TPU kernel packed both taps of 64 samples into one 128-lane vreg
// gather, and for tables of D = 128 n planes (n_chunks > 1) gathered once
// per 128-plane chunk and select-merged the results by index.  On Hopper a
// thread reads its two u16 values wherever in the row they lie, so the
// chunks do not carry over: one flat index serves any D.
//
// What bounds it on the H100: bytes.  Per (q, s) it streams 4 B of f in
// and 4 B out, and needs the 32 B table sectors its taps fall in: at P =
// 1.23 M rows and S = 64, 629 MB of field and output against 84 MB of
// table at D = 128.  It is table_lookup.cuh's flat kernel in f32 mode: a
// 16 B vector of f (4 samples) a thread, its 8 taps issued before any is
// used, no staging.  S is a template parameter at the paths' widths (36
// and 9 in the exact and hybrid paths, 64 and 16 in the densify path), so
// the row q = i / S is a multiply-shift; any other S takes the generic
// instance, whose divider is fixed at launch.  D = 128 (the rect build's
// tables) is a constant; the per-plane build's deeper tables (any D =
// 128 n) pass D at run time, a multiply per row.
#include "table_lookup.cuh"

namespace {

constexpr int kPlanes = 128;      // D of the rect build's tables

template <int S>
int launch(const void* tab, const void* f, void* out, unsigned n, int s,
           int d, cudaStream_t stream) {
  if (d == kPlanes) {
    return hcmvs::launch_table_lookup<hcmvs::kF32, S, kPlanes>(
        (const uint16_t*)tab, f, nullptr, out, n, s, kPlanes, stream);
  }
  return hcmvs::launch_table_lookup<hcmvs::kF32, S, 0>(
      (const uint16_t*)tab, f, nullptr, out, n, s, d, stream);
}

}  // namespace

// tab (p, d) u16 with d a multiple of 128, f (p, s) f32, out
// (p, s) f32; all contiguous, p * s and p * d < 2^31.
HCMVS_API int hcmvs_volume_lookup(const void* tab, const void* f, void* out,
                                  long long p, int s, int d, void* stream) {
  if (d % kPlanes != 0 || d < kPlanes) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned n = (unsigned)(p * s);
  cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 9: return launch<9>(tab, f, out, n, s, d, st);
    case 16: return launch<16>(tab, f, out, n, s, d, st);
    case 36: return launch<36>(tab, f, out, n, s, d, st);
    case 64: return launch<64>(tab, f, out, n, s, d, st);
    default: return launch<0>(tab, f, out, n, s, d, st);
  }
}
