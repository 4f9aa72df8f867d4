// Shared device helpers for the dr3_tpu_torch kernels.
//
// Every kernel launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() from its C entry point; the Python wrapper
// raises on a non-zero code.
#pragma once

#include <cuda_runtime.h>

namespace dr3 {

// floor()'d coordinate -> corner index. The float is clamped to [-1, n]
// before the conversion (fmaxf(NaN, -1) = -1), so NaN, inf and huge
// coordinates land on the border instead of an undefined conversion; for
// every finite coordinate the clipped corners equal jnp's
// clip(int32(floor(x)), 0, n-1) and clip(int32(floor(x)) + 1, 0, n-1).
__device__ __forceinline__ int corner_index(float f0, int n) {
  return static_cast<int>(fminf(fmaxf(f0, -1.0f), static_cast<float>(n)));
}

// Edge-clamped bilinear sample of img [H, W] at (x, y):
// dr3_tpu/ops/warp.py bilinear_sample(clamp=True), corner for corner.
// kLdg reads img through the read-only path (global memory only); without
// it img may be a copy staged in shared memory.
template <bool kLdg>
__device__ __forceinline__ float sample_clamp_from(const float* img, int H, int W,
                                                   float x, float y) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = x - x0;
  const float wy = y - y0;
  const int xi = corner_index(x0, W);
  const int yi = corner_index(y0, H);
  const int x0c = min(max(xi, 0), W - 1);
  const int x1c = min(max(xi + 1, 0), W - 1);
  const int y0c = min(max(yi, 0), H - 1);
  const int y1c = min(max(yi + 1, 0), H - 1);
  const float* r0 = img + y0c * W;
  const float* r1 = img + y1c * W;
  const float v00 = kLdg ? __ldg(r0 + x0c) : r0[x0c];
  const float v01 = kLdg ? __ldg(r0 + x1c) : r0[x1c];
  const float v10 = kLdg ? __ldg(r1 + x0c) : r1[x0c];
  const float v11 = kLdg ? __ldg(r1 + x1c) : r1[x1c];
  const float top = v00 * (1.0f - wx) + v01 * wx;
  const float bot = v10 * (1.0f - wx) + v11 * wx;
  return top * (1.0f - wy) + bot * wy;
}

__device__ __forceinline__ float sample_clamp(const float* __restrict__ img,
                                              int H, int W, float x, float y) {
  return sample_clamp_from<true>(img, H, W, x, y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace dr3
