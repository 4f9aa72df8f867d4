// K4: dense bilinear remap and warp, one thread per output pixel.
//
// Replaces both Pallas warp kernels of dr3_tpu/ops/pallas/warp_pallas.py:
// _vremap_kernel (:83, called through remap_rows :106) and _hremap_kernel
// (:158, through remap_cols :186), and with them their two-pass
// compositions warp_perspective (:303), warp_spherical (:375) and
// warp_cylindrical (:387). It computes what the jnp reference
// dr3_tpu/ops/warp.py computes: bilinear_sample (:23-69) directly over the
// coordinate field, not the Catmull-Smith two-pass approximation, so there
// is no per-tile shift capacity, no far-coordinate sentinel and no XLA
// fallback.
//
//   * dr3_remap samples src over a given field, in one of three forms:
//     (x, y) pairs [n, 2] (ops/warp.remap); rows only, y = v[i, j] with
//     x = j implied (K4a's contract); columns only, x = u[i, j] with y = i
//     implied (K4b's contract).
//   * dr3_warp: each thread computes its own source coordinate: H^-1 p for
//     a homography (9 floats by value, apply_homography's |w| < 1e-12
//     guard) or the spherical / cylindrical field of ops/warp.py:107-140
//     (|zhat| < 1e-9 guard). No [Ho, Wo, 2] field goes through HBM.
//
// Both write out [n, C] (fill outside the image unless clamp) and, when
// given, valid [n] from the unclamped coordinate, as bilinear_sample does.
// Corner indices follow common.cuh corner_index, so NaN, inf and far-out
// coordinates read the border and never out of bounds.
//
// Arithmetic: every coordinate and blend step is one separately rounded
// __f*_rn operation, in the order of the plain PyTorch version in
// dr3_tpu_torch/ops/warp.py, so nvcc cannot contract it into FMAs; sinf and
// cosf are the precise ones. The kernel thus reproduces the plain version
// run on the same card, where each PyTorch op rounds on its own.
//
// What bounds it on the card: memory, four gathered reads and one write
// per output value (C channels of a pixel sit side by side), and at the
// panorama's sizes (a 640x480x3 view, a canvas of a few megapixels) the
// launch. What the design does about it: one thread per output pixel with
// neighbouring threads on neighbouring output columns, so the writes are
// coalesced and, for the smooth warps of this path, the gathers of a warp
// fall in a few cache lines of one or two source rows, read through the
// read-only cache. Shared-memory tiling and TMA are later work.
#include "common.cuh"

namespace {

enum RemapMode { kRemapXY = 0, kRemapRows = 1, kRemapCols = 2 };
enum WarpKind { kHomography = 0, kSpherical = 1, kCylindrical = 2 };

struct WarpParams {
  float h[9];  // row-major H^-1 for kHomography; h[0] = focal length otherwise
};

constexpr int kThreads = 256;

// bilinear_sample of the C channels of src [H, W, C] at (x, y) into
// out[p * C + c], and valid[p] when valid is given.
__device__ __forceinline__ void sample_pixel(const float* __restrict__ src,
                                             int H, int W, int C, float x,
                                             float y, int clamp, float fill,
                                             long long p,
                                             float* __restrict__ out,
                                             bool* __restrict__ valid) {
  const bool ok = (x >= 0.0f) && (y >= 0.0f) &&
                  (x <= static_cast<float>(W - 1)) &&
                  (y <= static_cast<float>(H - 1));
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = __fsub_rn(x, x0);
  const float wy = __fsub_rn(y, y0);
  const float ax = __fsub_rn(1.0f, wx);
  const float ay = __fsub_rn(1.0f, wy);
  const int xi = dr3::corner_index(x0, W);
  const int yi = dr3::corner_index(y0, H);
  const long long x0c = min(max(xi, 0), W - 1);
  const long long x1c = min(max(xi + 1, 0), W - 1);
  const long long r0 = static_cast<long long>(min(max(yi, 0), H - 1)) * W;
  const long long r1 = static_cast<long long>(min(max(yi + 1, 0), H - 1)) * W;
  const float* p00 = src + (r0 + x0c) * C;
  const float* p01 = src + (r0 + x1c) * C;
  const float* p10 = src + (r1 + x0c) * C;
  const float* p11 = src + (r1 + x1c) * C;
  float* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    const float top = __fadd_rn(__fmul_rn(__ldg(p00 + c), ax),
                                __fmul_rn(__ldg(p01 + c), wx));
    const float bot = __fadd_rn(__fmul_rn(__ldg(p10 + c), ax),
                                __fmul_rn(__ldg(p11 + c), wx));
    const float v = __fadd_rn(__fmul_rn(top, ay), __fmul_rn(bot, wy));
    o[c] = (clamp || ok) ? v : fill;
  }
  if (valid != nullptr) valid[p] = ok;
}

__global__ void remap_kernel(const float* __restrict__ src, int H, int W,
                             int C, int mode, const float* __restrict__ field,
                             int Ho, int Wo, int clamp, float fill,
                             float* __restrict__ out, bool* __restrict__ valid) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<long long>(Ho) * Wo) return;
  float x;
  float y;
  if (mode == kRemapXY) {
    x = __ldg(field + 2 * p);
    y = __ldg(field + 2 * p + 1);
  } else if (mode == kRemapRows) {
    x = static_cast<float>(p % Wo);
    y = __ldg(field + p);
  } else {
    x = __ldg(field + p);
    y = static_cast<float>(p / Wo);
  }
  sample_pixel(src, H, W, C, x, y, clamp, fill, p, out, valid);
}

__global__ void warp_kernel(const float* __restrict__ src, int H, int W, int C,
                            int kind, WarpParams prm, int Ho, int Wo,
                            int clamp, float fill, float* __restrict__ out,
                            bool* __restrict__ valid) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<long long>(Ho) * Wo) return;
  const float j = static_cast<float>(p % Wo);
  const float i = static_cast<float>(p / Wo);
  float x;
  float y;
  if (kind == kHomography) {
    // apply_homography: w = (h20 x + h21 y) + h22, u = ((h00 x + h01 y) + h02) / w
    const float* h = prm.h;
    float w = __fadd_rn(__fadd_rn(__fmul_rn(h[6], j), __fmul_rn(h[7], i)), h[8]);
    if (fabsf(w) < 1e-12f) w = 1e-12f;
    x = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(h[0], j), __fmul_rn(h[1], i)), h[2]), w);
    y = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(h[3], j), __fmul_rn(h[4], i)), h[5]), w);
  } else {
    // spherical_warp_field / cylindrical_warp_field over the output grid
    const float f = prm.h[0];
    const float cx = 0.5f * static_cast<float>(Wo);
    const float cy = 0.5f * static_cast<float>(Ho);
    const float a = __fdiv_rn(__fsub_rn(j, cx), f);
    const float b = __fdiv_rn(__fsub_rn(i, cy), f);
    float xh;
    float yh;
    float zh;
    if (kind == kSpherical) {
      const float cb = cosf(b);
      xh = __fmul_rn(sinf(a), cb);
      yh = sinf(b);
      zh = __fmul_rn(cosf(a), cb);
    } else {
      xh = sinf(a);
      yh = b;
      zh = cosf(a);
    }
    if (fabsf(zh) < 1e-9f) zh = 1e-9f;
    x = __fadd_rn(cx, __fdiv_rn(__fmul_rn(f, xh), zh));
    y = __fadd_rn(cy, __fdiv_rn(__fmul_rn(f, yh), zh));
  }
  sample_pixel(src, H, W, C, x, y, clamp, fill, p, out, valid);
}

int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int dr3_remap(const float* src, int h, int w, int c, int mode,
                         const float* field, int ho, int wo, int clamp,
                         float fill, float* out, bool* valid, void* stream) {
  const long long n = static_cast<long long>(ho) * wo;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  remap_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, h, w, c, mode, field, ho, wo, clamp, fill, out, valid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dr3_warp(const float* src, int h, int w, int c, int kind,
                        float h0, float h1, float h2, float h3, float h4,
                        float h5, float h6, float h7, float h8, int ho, int wo,
                        int clamp, float fill, float* out, bool* valid,
                        void* stream) {
  const long long n = static_cast<long long>(ho) * wo;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const WarpParams prm = {{h0, h1, h2, h3, h4, h5, h6, h7, h8}};
  warp_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, h, w, c, kind, prm, ho, wo, clamp, fill, out, valid);
  return static_cast<int>(cudaGetLastError());
}
