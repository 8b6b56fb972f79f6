// The flat sigma-table lookup shared by kernels B (volume_lookup.cu) and D
// (volume_lookup_multi.cu).
//
// Row q of a (P, d) u16 table serves the C index columns of row q of a
// (P, C) field; the lookup of one (q, c) item is common.cuh's lookup_tap
// and lookup_value.  Kernel B is the f32 mode at d = 128 with C (its S) a
// template parameter; kernel D takes every mode, C and d at run time.
//
// What bounds both on the H100: bytes.  The field and the output stream
// through once; of the table only the 32 B sectors the taps fall in are
// needed (a row's taps cluster: at the densify path's widths about a
// quarter of the table), and of the bounds panel two sectors a row.  The
// design:
// - the items are walked flat over (P * C), not by rows: thread t of
//   block b takes the 16 B vector b * kLookupThreads + t of the field (4
//   f32 or 8 u16 items), so each load and store instruction of a warp
//   covers 512 contiguous bytes whatever C is (C = 9 and C = 81 rows start
//   at unaligned offsets).  The field is read through the read-only path,
//   the output stored with the evict-first hint; a field or output that is
//   not 16 B aligned takes the same walk with scalar accesses;
// - the row and column of a vector's first item are computed once, with a
//   multiply-shift (a constant C, or a Divider fixed at launch); the other
//   items step to the next row by a compare where C >= the items of a
//   vector ("wide"), else take their own division.  All index work is
//   32-bit (P * C and P * D < 2^31);
// - every table tap of a thread is issued before any is used, as
//   read-only (non-coherent, L1-cached) loads straight from the row: a
//   row's sectors leave device memory once and serve its C items from L1.
//   Nothing is staged: whole rows would read 2-4x the sectors the taps
//   need;
// - a bounded vector reads lo and hi (lanes 0 and 64 of the bounds panel)
//   of the one or two rows it spans, once; items outside [lo, hi] read no
//   tap.
#pragma once

#include "common.cuh"

namespace hcmvs {

constexpr int kLookupThreads = 256;

__device__ __forceinline__ void unpack16(uint4 v, float* o) {
  o[0] = __uint_as_float(v.x);
  o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z);
  o[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack16(uint4 v, uint16_t* o) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = (uint16_t)(w[k] & 0xFFFFu);
    o[2 * k + 1] = (uint16_t)(w[k] >> 16);
  }
}

__device__ __forceinline__ uint4 pack16(const float* o) {
  return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]),
                    __float_as_uint(o[2]), __float_as_uint(o[3]));
}

__device__ __forceinline__ uint4 pack16(const uint16_t* o) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = (unsigned)o[2 * k] | ((unsigned)o[2 * k + 1] << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned bounds_of(const uint16_t* bounds,
                                              unsigned q) {
  const uint16_t* b = bounds + (size_t)q * 128;
  return (unsigned)__ldg(b) | ((unsigned)__ldg(b + 64) << 16);
}

// C > 0 / D > 0: the column count / table depth as constants; 0: taken
// from ``c_rt`` and ``cols`` / ``d_rt``.  kWide: C >= the items of a
// vector, so that a vector spans at most two rows.  kVector: field and
// output are 16 B aligned.
template <int M, int C, int D, bool kWide, bool kVector>
__global__ void __launch_bounds__(kLookupThreads)
table_lookup_kernel(const uint16_t* __restrict__ tab,
                    const LookupT<M>* __restrict__ f,
                    const uint16_t* __restrict__ bounds,
                    LookupT<M>* __restrict__ out, unsigned n, int c_rt,
                    int d_rt, Divider cols) {
  using T = LookupT<M>;
  constexpr int kPerVec = 16 / (int)sizeof(T);
  const unsigned c = C > 0 ? C : c_rt;
  const unsigned d = D > 0 ? D : d_rt;
  auto row_of = [&](unsigned i) -> unsigned {
    if constexpr (C > 0) {
      return i / C;
    } else {
      return cols(i);
    }
  };
  const unsigned i = (blockIdx.x * kLookupThreads + threadIdx.x) * kPerVec;
  if (i >= n) return;
  const bool full = i + kPerVec <= n;

  T fv[kPerVec];
  if (kVector && full) {
    unpack16(__ldg(reinterpret_cast<const uint4*>(f + i)), fv);
  } else {
#pragma unroll
    for (int e = 0; e < kPerVec; ++e) {
      fv[e] = i + e < n ? __ldg(f + i + e) : T(0);
    }
  }
  // the first item's row and column; bounded: lo and hi of that row and,
  // where the vector reaches it, of the next
  const unsigned q0 = row_of(i);
  const unsigned col0 = i - q0 * c;
  const unsigned base0 = q0 * d;
  int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  if constexpr (M == kBounded && kWide) {
    const unsigned b0 = bounds_of(bounds, q0);
    const unsigned b1 = col0 + kPerVec > c && (q0 + 1) * c < n
        ? bounds_of(bounds, q0 + 1) : b0;
    lo0 = b0 & 0xFFFFu;
    hi0 = b0 >> 16;
    lo1 = b1 & 0xFFFFu;
    hi1 = b1 >> 16;
  }

  uint16_t u0[kPerVec], u1[kPerVec];
  float t[kPerVec];
  bool ok[kPerVec];
#pragma unroll
  for (int e = 0; e < kPerVec; ++e) {
    unsigned base;
    int lo = 0, hi = 0;
    if constexpr (kWide) {
      const bool next_row = col0 + e >= c;
      base = next_row ? base0 + d : base0;
      lo = next_row ? lo1 : lo0;
      hi = next_row ? hi1 : hi0;
    } else {
      const unsigned q = row_of(min(i + e, n - 1));
      base = q * d;
      if constexpr (M == kBounded) {
        const unsigned b = bounds_of(bounds, q);
        lo = b & 0xFFFFu;
        hi = b >> 16;
      }
    }
    const Tap tap = lookup_tap(fv[e], (int)d);
    t[e] = tap.t;
    ok[e] = full || i + e < n;
    if constexpr (M == kBounded) {
      ok[e] = ok[e] && (int)fv[e] >= lo && (int)fv[e] <= hi;
    }
    u0[e] = u1[e] = 0;
    if (ok[e]) {
      const uint16_t* row = tab + (base + tap.i0);
      u0[e] = __ldg(row);
      u1[e] = __ldg(row + 1);
    }
  }

  T o[kPerVec];
#pragma unroll
  for (int e = 0; e < kPerVec; ++e) {
    o[e] = lookup_value<M>(u0[e], u1[e], t[e], ok[e]);
  }
  if (kVector && full) {
    __stcs(reinterpret_cast<uint4*>(out + i), pack16(o));
  } else {
#pragma unroll
    for (int e = 0; e < kPerVec; ++e) {
      if (i + e < n) __stcs(out + i + e, o[e]);
    }
  }
}

template <int M, int C, int D, bool kWide, bool kVector>
void launch_one(unsigned blocks, cudaStream_t stream, const uint16_t* tab,
                const LookupT<M>* f, const uint16_t* bounds, LookupT<M>* out,
                unsigned n, int c, int d) {
  table_lookup_kernel<M, C, D, kWide, kVector>
      <<<blocks, kLookupThreads, 0, stream>>>(tab, f, bounds, out, n, c, d,
                                              Divider((unsigned)c));
}

// Launch the lookup of n = p * c items of a (p, d) table on ``stream``
// (n and p * d < 2^31, checked by the Python launcher); returns
// cudaGetLastError().
template <int M, int C, int D>
int launch_table_lookup(const uint16_t* tab, const void* f,
                        const uint16_t* bounds, void* out, unsigned n, int c,
                        int d, cudaStream_t stream) {
  if (n == 0) return (int)cudaGetLastError();
  using T = LookupT<M>;
  constexpr int kPerVec = 16 / (int)sizeof(T);
  constexpr unsigned kBlock = kLookupThreads * kPerVec;
  const unsigned blocks = (n + kBlock - 1) / kBlock;
  const bool vector = ((uintptr_t)f | (uintptr_t)out) % 16 == 0;
  const bool wide = c >= kPerVec;
  const T* ft = static_cast<const T*>(f);
  T* ot = static_cast<T*>(out);
  if (wide && vector) {
    launch_one<M, C, D, true, true>(blocks, stream, tab, ft, bounds, ot, n,
                                    c, d);
  } else if (wide) {
    launch_one<M, C, D, true, false>(blocks, stream, tab, ft, bounds, ot, n,
                                     c, d);
  } else if (vector) {
    launch_one<M, C, D, false, true>(blocks, stream, tab, ft, bounds, ot, n,
                                     c, d);
  } else {
    launch_one<M, C, D, false, false>(blocks, stream, tab, ft, bounds, ot,
                                      n, c, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace hcmvs
