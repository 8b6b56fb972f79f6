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
// padding and the pltpu.roll shifts are Mosaic plumbing: here a thread
// reads its shifted neighbours directly.
//
// What bounds it on the H100: bytes.  Phase 0 of the hybrid path (V = 3 at
// 960 x 1280, pad 5, 8 offsets) reads ref_pad (5 MB), warped_pad and
// valid_pad (30 MB), tm, nsq0, hw (15 MB) and acc (59 MB) and writes
// score and var1 (29.5 MB): about 138 MB, 41 us at 3.35 TB/s; its 29.5 M
// exps are far below the special-function units' rate.  The design is one
// thread per (view, pixel), x fastest, so each offset's reads of a warp are
// one contiguous run of a row and the neighbouring offsets hit L1; the
// offsets ride in the kernel's parameter space (uniform across a warp).
// Accumulation order and every rounding step follow the plain version
// (built with --fmad=false; expf, not __expf).
#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 128;

struct Offsets {
  int n;
  signed char dy[kMaxOffsets];
  signed char dx[kMaxOffsets];
};

__global__ void zncc_warped_kernel(const float* __restrict__ ref_pad,
                                   const float* __restrict__ tm,
                                   const float* __restrict__ nsq0,
                                   const float* __restrict__ warped_pad,
                                   const float* __restrict__ valid_pad,
                                   const float* __restrict__ hw,
                                   const float* __restrict__ acc,
                                   float* __restrict__ score,
                                   float* __restrict__ var_out,
                                   const Offsets offs, int v_n, int h, int w,
                                   int pad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long hw_n = (long long)h * w;
  if (i >= (long long)v_n * hw_n) return;
  const int v = (int)(i / hw_n);
  const long long pix = i - (long long)v * hw_n;
  const int y = (int)(pix / w);
  const int x = (int)(pix - (long long)y * w);
  const int wp = w + 2 * pad;
  const long long plane = (long long)(h + 2 * pad) * wp;
  const long long centre = (long long)(y + pad) * wp + (x + pad);
  const float* warp_v = warped_pad + (long long)v * plane;
  const float* valid_v = valid_pad + (long long)v * plane;
  const float* acc_v = acc + (long long)v * 4 * hw_n;

  const float v_c = ref_pad[centre];
  const float tm_p = tm[pix];
  const float hw_p = hw[pix];
  const float inv_2hw2 = -0.5f * (1.0f / (hw_p * hw_p));
  const float inv_2sc2 = -12.5f;        // -1 / (2 * 0.2^2)
  float num = acc_v[pix];
  float s1 = acc_v[hw_n + pix];
  float sq1 = acc_v[2 * hw_n + pix];
  float sw = acc_v[3 * hw_n + pix];

#pragma unroll 1
  for (int k = 0; k < offs.n; ++k) {
    const int dy = offs.dy[k];
    const int dx = offs.dx[k];
    const long long q = centre + (long long)dy * wp + dx;
    const float v_d = ref_pad[q];
    const float w_d = warp_v[q];
    const float ok = valid_v[q];
    const float dc = v_d - v_c;
    const float w_color = (dc * dc) * inv_2sc2;
    const float w_sp = (float)(dy * dy + dx * dx) * inv_2hw2;
    const float in_win = (float)max(abs(dy), abs(dx)) <= hw_p ? 1.0f : 0.0f;
    const float wt = (expf(w_color + w_sp) * in_win) * ok;
    num = num + (wt * (v_d - tm_p)) * w_d;
    s1 = s1 + wt * w_d;
    sq1 = sq1 + (wt * w_d) * w_d;
    sw = sw + wt;
  }
  const float var1 = sq1 - (s1 * s1) / fmaxf(sw, 1e-12f);
  const float denom = sqrtf(fmaxf(nsq0[pix] * var1, 1e-16f));
  const float ncc = hcmvs::clampf(num / denom, -1.0f, 1.0f);
  score[i] = 1.0f - ncc;
  var_out[i] = var1;
}

}  // namespace

// ref_pad (h + 2 pad, w + 2 pad); tm, nsq0, hw (h, w); warped_pad,
// valid_pad (v, h + 2 pad, w + 2 pad); acc (v, 4, h, w); score, var_out
// (v, h, w); all f32, contiguous.  offsets: host array of n (dy, dx)
// int pairs, n <= 128, every |dy|, |dx| <= pad.
HCMVS_API int hcmvs_zncc_warped(const void* ref_pad, const void* tm,
                                const void* nsq0, const void* warped_pad,
                                const void* valid_pad, const void* hw,
                                const void* acc, void* score, void* var_out,
                                const int* offsets, int n_offsets, int v,
                                int h, int w, int pad, void* stream) {
  if (n_offsets < 0 || n_offsets > kMaxOffsets) {
    return (int)cudaErrorInvalidValue;
  }
  Offsets offs;
  offs.n = n_offsets;
  for (int k = 0; k < n_offsets; ++k) {
    const int dy = offsets[2 * k], dx = offsets[2 * k + 1];
    if (dy < -pad || dy > pad || dx < -pad || dx > pad) {
      return (int)cudaErrorInvalidValue;
    }
    offs.dy[k] = (signed char)dy;
    offs.dx[k] = (signed char)dx;
  }
  const long long n = (long long)v * h * w;
  if (n > 0) {
    zncc_warped_kernel<<<hcmvs::flat_blocks(n), hcmvs::kFlatThreads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)ref_pad, (const float*)tm, (const float*)nsq0,
        (const float*)warped_pad, (const float*)valid_pad, (const float*)hw,
        (const float*)acc, (float*)score, (float*)var_out, offs, v, h, w,
        pad);
  }
  return (int)cudaGetLastError();
}
