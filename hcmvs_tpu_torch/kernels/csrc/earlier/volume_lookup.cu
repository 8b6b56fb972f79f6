// Kernel B: sigma-table lookup with a lerp between adjacent planes.
//
// The earlier design (one thread per element), replaced by
// ../volume_lookup.cu and kept only to be timed against it
// (chip_smoke.py phase 3); it is built into a library of its own, and no
// path calls it.
//
// Replaces the Pallas kernel hcmvs_tpu/ops/volume.py volume_lookup ->
// _lookup_kernel, whose semantics (volume_lookup_xla) are
//   out[q, s] = lerp(dec(tab[q, i0]), dec(tab[q, i0 + 1]), f[q, s] - i0)
//   i0 = clip(floor(f[q, s]), 0, D - 2),   dec(u) = u * (1 / 65535).
// The TPU kernel packed both taps of 64 samples into one 128-lane vreg
// gather; on Hopper a thread simply reads its two u16 values.
//
// What bounds it on the H100: bytes.  Per (q, s) it reads 4 B of f and
// two u16 of table row q and writes 4 B; rows are 256 B (D = 128), so the
// S samples of one pixel hit the same two or three 128 B lines.  The
// simple design here is one thread per (q, s), q-major: reads of f and
// writes of out are coalesced, and the table row of a pixel is fetched
// from device memory once and served to its S threads from L1/L2.  At
// the slice's shapes (P = 1.23 M rows, S = 36) that is about 0.5 GB per
// call, ~0.15 ms at the H100's 3.35 TB/s.
#include "../common.cuh"

namespace {

constexpr int kPlanes = 128;   // D: the slice's table depth

// launch geometry: one thread per element
constexpr int kFlatThreads = 256;

inline unsigned flat_blocks(long long n) {
  return (unsigned)((n + kFlatThreads - 1) / kFlatThreads);
}

__global__ void volume_lookup_kernel(const uint16_t* __restrict__ tab,
                                     const float* __restrict__ f,
                                     float* __restrict__ out,
                                     long long n, int s) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long q = i / s;
  float fi = f[i];
  float i0 = hcmvs::clampf(floorf(fi), 0.0f, (float)(kPlanes - 2));
  float t = fi - i0;
  int i0i = (int)i0;
  const uint16_t* row = tab + q * kPlanes;
  const float scale = (float)(1.0 / 65535.0);
  float g0 = (float)row[i0i] * scale;
  float g1 = (float)row[i0i + 1] * scale;
  out[i] = g0 + (g1 - g0) * t;
}

}  // namespace

// tab (p, 128) u16, f (p, s) f32, out (p, s) f32; all contiguous.  This
// design takes only d = 128.
HCMVS_API int hcmvs_volume_lookup(const void* tab, const void* f, void* out,
                                  long long p, int s, int d, void* stream) {
  if (d != kPlanes) return (int)cudaErrorInvalidValue;
  long long n = p * s;
  if (n > 0) {
    volume_lookup_kernel<<<flat_blocks(n), kFlatThreads, 0,
                           (cudaStream_t)stream>>>(
        (const uint16_t*)tab, (const float*)f, (float*)out, n, s);
  }
  return (int)cudaGetLastError();
}
