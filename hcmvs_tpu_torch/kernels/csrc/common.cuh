// Shared declarations of the port's CUDA kernels.
//
// Every entry point has a plain C interface (pointers, sizes and the
// stream come from Python through ctypes), launches on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// The library is built with --fmad=false: each float operation rounds on
// its own, as the plain PyTorch versions (one operator per op) and the
// JAX reference do, so kernel and plain version differ only where the
// hardware's own rounding differs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define HCMVS_API extern "C" __attribute__((visibility("default")))

namespace hcmvs {

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Unsigned division by a divisor fixed at launch, as a multiply-high, an
// add and a shift (Granlund-Montgomery, round-up variant); exact for
// n < 2^31, which the launchers check.
struct Divider {
  unsigned mul, shift;
  explicit Divider(unsigned d) : shift(0) {
    while ((1u << shift) < d) ++shift;
    mul = (unsigned)(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ unsigned operator()(unsigned n) const {
    return (__umulhi(n, mul) + n) >> shift;
  }
};

// ---------------------------------------------------------------------
// The per-tap arithmetic of the sigma-table lookups, kernels B and D, in
// the order of their plain versions (ops/volume.py volume_lookup_plain,
// volume_lookup_multi_plain).  A lookup reads the u16 table row at planes
// i0 and i0 + 1 and interpolates with weight t.
//   f32:     i0 = clip(floor f, 0, d - 2), t = f - i0;
//            value = dec(u0) + (dec(u1) - dec(u0)) * t, dec(u) = u / 65535;
//   packed:  f is u16 fixed point (f * 64): i0 = min(f >> 6, d - 2),
//            t = (f - 64 i0) / 64; value = rint(u0 + (u1 - u0) * t) on the
//            raw scale (round half to even), its low 16 bits kept;
//   bounded: packed, min(value, 65534) where lo <= f <= hi, else the
//            sentinel 0xFFFF, for which no tap is read.
// ---------------------------------------------------------------------

enum LookupMode { kF32 = 0, kPacked = 1, kBounded = 2 };

constexpr int kPackShift = 6;      // F_PACK_SCALE = 64
constexpr int kSentinel = 0xFFFF;

// the element type of a mode's index field and output
template <int M>
using LookupT = std::conditional_t<M == kF32, float, uint16_t>;

struct Tap {
  int i0;
  float t;
};

__device__ __forceinline__ Tap lookup_tap(float f, int d) {
  const float i0 = clampf(floorf(f), 0.0f, (float)(d - 2));
  return {(int)i0, f - i0};
}

__device__ __forceinline__ Tap lookup_tap(uint16_t f, int d) {
  const int i0 = min((int)f >> kPackShift, d - 2);
  return {i0, (float)((int)f - (i0 << kPackShift)) * (1.0f / 64.0f)};
}

// the value from the taps u0, u1 (unread, and ignored, where a bounded
// lookup is out of bounds)
template <int M>
__device__ __forceinline__ LookupT<M> lookup_value(uint16_t u0, uint16_t u1,
                                                   float t, bool in_bounds) {
  if constexpr (M == kF32) {
    const float scale = (float)(1.0 / 65535.0);
    const float g0 = (float)u0 * scale;
    const float g1 = (float)u1 * scale;
    return g0 + (g1 - g0) * t;
  } else {
    const float g0 = (float)u0;
    const float g1 = (float)u1;
    const int li = (int)rintf(g0 + (g1 - g0) * t);
    if constexpr (M == kPacked) {
      return (uint16_t)li;               // the low 16 bits, as astype
    } else {
      return in_bounds ? (uint16_t)min(li, kSentinel - 1)
                       : (uint16_t)kSentinel;
    }
  }
}

}  // namespace hcmvs
