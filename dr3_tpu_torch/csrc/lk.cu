// K1: pyramidal inverse-compositional Lucas-Kanade, one warp per track and
// one launch per pyramid.
//
// Replaces the Pallas kernel dr3_tpu/ops/pallas/lk_pallas.py:117
// (_lk_kernel, pallas_call at :286, driven one level per call by
// track_level_pallas :236 and track_pyramid_pallas :304) and computes what
// the jnp reference dr3_tpu/ops/lk.py computes:
//   * dr3_lk_pyramid: track_pyramid (lk.py:114-143) in one launch. For each
//     track, from guess = (init or pts) * 2^-(L-1), coarsest level first:
//     template T and central-difference gradients sampled from prev[lvl]
//     around pts * 2^-lvl, 2x2 structure tensor + min-eigenvalue gate,
//     `iters` GN steps on next[lvl] with the eps-freeze (track_level,
//     lk.py:48-111), ok_all &= conditioned & centre in image, guess = pos * 2
//     above level 0; then ok = ok_all & valid & (err < max_err), err =
//     mean|I - T| * 255 at level 0. The scales are powers of two, so the
//     products equal the plain pts / 2.0**lvl exactly. With one level and no
//     `valid` it is track_level: (pos, conditioned & centre in image, err).
//   * dr3_lk_align: align_to_templates (lk.py:154-201): templates given as
//     [N, W, W], gradients as jnp.gradient (one-sided at the patch border),
//     the same GN steps, then the max_shift / max_err / keep-the-old-position
//     rule.
//
// What bounds it on the card: by the roofline, the operations, not the
// bytes. A general frame's pyramid call reads ~2.2 MB (546 tracks' template
// and GN windows at 4 levels, each pixel once, and the track arrays): 0.66
// us at 3.35 TB/s. Its float work, with the window's bilinear weights
// shared by all its pixels (9 flops a sample): 55 flops per template pixel,
// 14 per pixel and GN step (4.8 of the 10 steps per level run, on average),
// 12 per pixel of the error pass: ~66 MFLOP, ~1.0 us at 67 TFLOP/s (counted
// by dr3_tpu_torch/tools/bounds.py). Neither is what the time is: each level
// is a chain of up to 10 dependent GN steps (sample -> reduction over the
// window -> 2x2 solve -> next sample), 4 levels deep, and the slowest of
// the 546 chains sets the kernel's time: it is latency-bound.
// What the design does about it:
//   * one warp per track, several tracks (warps) per block: a lane takes
//     ceil(W^2/32) pixels of the window (8 for W=15); the sums are
//     all-reduced by a __shfl_xor_sync butterfly, so every lane holds the
//     same bits and computes the same step and freeze flag itself. No block
//     barrier, no serial solve, no broadcast;
//   * a lane's pixels, their template values and gradients and their
//     offsets in the staged window stay in registers (Track<K>, up to 256
//     pixels), and nothing branches per pixel, so a step starts all of a
//     lane's loads before it uses any: the in-order warp waits once per
//     step, not once per pixel. Larger windows loop over shared memory
//     (Track<0>);
//   * the GN steps sample an image window staged in the warp's slice of
//     shared memory with cp.async (13 copies per lane for W=15, all in
//     flight at once), 2 pixels wider on each side than a step reads: a
//     step that moves less, nearly every step once a level has converged a
//     little, reads no global memory at all. The template stages its
//     (W + 3)^2 pixels the same way. Staged pixels are clamped as
//     sample_clamp clamps them;
//   * the whole coarse-to-fine loop runs inside one launch: one launch
//     latency and one set of wrapper checks per pyramid instead of one per
//     level;
//   * a step under eps is the last to move a track (the freeze uses the
//     previous step's flag, lk.py:95-97), so the warp stops there: the
//     plain version's remaining steps change nothing.
//
// Unlike the TPU kernel, positions are left free (no clamp to a padded
// box) and non-finite inputs are not sanitised: an out-of-bounds TPU load
// crashes the worker, but here only the integer sample indices are clamped
// (common.cuh sample_clamp), as bilinear_sample(clamp=True) does, so a NaN
// track yields a NaN pos and ok = 0 without ever reading out of bounds.
#include "common.cuh"

namespace {

using dr3::sample_clamp;
using dr3::warp_sum;

constexpr int kMaxLevels = 8;
// Tracks (warps) per block: 2, 4 and 8 were timed on the H100 (PERF.md).
constexpr int kWarps = 2;
constexpr size_t kDefaultSmem = 48 * 1024;    // without the opt-in attribute
constexpr size_t kMaxSmem = 232448;           // 227 KB: one block's limit
// Below this, floor(x) and the window's integer offsets are exact floats.
constexpr float kStageLimit = 4194304.0f;
// Pixels the staged GN window reaches beyond the (W + 1)^2 a step reads, on
// each side: steps that move less stay inside and read no memory.
constexpr int kMargin = 2;

struct Levels {
  const float* prev[kMaxLevels];
  const float* next[kMaxLevels];
  int hp[kMaxLevels], wp[kMaxLevels], h[kMaxLevels], w[kMaxLevels];
};

// Side of the staged GN window: the (W + 1)^2 a step reads and the margin.
__host__ __device__ constexpr int window_side(int half) {
  return 2 * half + 2 + 2 * kMargin;
}

// Side of the staged template window: W, a pixel on each side for the
// gradients and one more for the bilinear corner (W + 3).
__host__ __device__ constexpr int template_side(int half) { return 2 * half + 4; }

// Floats of shared memory one track's warp keeps: a W^2 patch area x 3 (T,
// GX, GY of the windows kept in shared memory; a stored template's
// gradients read it) and the staged image window, of the GN steps or of
// the template (which fits in it).
__host__ __device__ constexpr int warp_floats(int half) {
  return 3 * (2 * half + 1) * (2 * half + 1) + window_side(half) * window_side(half);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Calls f(p, ox, oy) for the pixels p = lane, lane + 32, ... of a W x W
// window (W = 2 half + 1), (ox, oy) = (p % W - half, p / W - half) kept
// incrementally: a step of 32 pixels is 32 / W rows and 32 % W columns.
template <int U, typename F>
__device__ __forceinline__ void for_lane_pixels(int half, F&& f) {
  const int W = 2 * half + 1;
  const int P = W * W;
  const int dq = 32 / W;
  const int dr = 32 % W;
  int row = lane_id() / W;
  int col = lane_id() % W;
#pragma unroll (U)
  for (int p = lane_id(); p < P; p += 32) {
    f(p, col - half, row - half);
    col += dr;
    row += dq;
    const bool wrap = col >= W;
    col -= wrap ? W : 0;
    row += wrap ? 1 : 0;
  }
}

// The integer corner (floor) and the bilinear weights of a window centre.
// Every sample (cx + ox, cy + oy) of the window shares them: the plain
// coordinate cx + ox can differ from floor(cx) + ox + fraction only where
// the sum rounds at a power of two, by one ulp, and bilinear interpolation
// is continuous, so the sample moves by that ulp's worth.
struct Cell {
  int x, y;
  float ax, wx, ay, wy;
};

__device__ __forceinline__ bool stageable(float cx, float cy) {
  return fabsf(cx) < kStageLimit && fabsf(cy) < kStageLimit;  // false for NaN
}

__device__ __forceinline__ Cell cell_of(float cx, float cy) {
  const float fx = floorf(cx);
  const float fy = floorf(cy);
  const float wx = cx - fx;
  const float wy = cy - fy;
  return {static_cast<int>(fx), static_cast<int>(fy), 1.0f - wx, wx, 1.0f - wy, wy};
}

// Copies the S x S pixels of img from (x0, y0), each coordinate clamped to
// the image as sample_clamp clamps its corners, into buf (row stride S):
// cp.async, so every lane's copies are in flight at once and none waits in
// a register. On return the whole warp sees the window.
__device__ void stage(const float* __restrict__ img, int h, int w, int x0,
                      int y0, int S, float* buf) {
  __syncwarp();  // every lane is done with the previous window
  const int n = S * S;
  const int dq = 32 / S;
  const int dr = 32 % S;
  int r = lane_id() / S;
  int c = lane_id() % S;
  for (int q = lane_id(); q < n; q += 32) {
    const int y = min(max(y0 + r, 0), h - 1);
    const int x = min(max(x0 + c, 0), w - 1);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf + q));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(img + static_cast<long long>(y) * w + x));
    c += dr;
    r += dq;
    const bool wrap = c >= S;
    c -= wrap ? S : 0;
    r += wrap ? 1 : 0;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Bilinear sample of a staged window at index j (its top-left corner).
__device__ __forceinline__ float bil(const float* buf, int j, int S, const Cell& c) {
  const float top = buf[j] * c.ax + buf[j + 1] * c.wx;
  const float bot = buf[j + S] * c.ax + buf[j + S + 1] * c.wx;
  return top * c.ay + bot * c.wy;
}

// The GN steps' image window in this warp's buf: window_side^2 pixels from
// (x0, y0), restaged only when a step's (W + 1)^2 window leaves it.
struct Staged {
  int x0, y0;
};

__device__ __forceinline__ Staged nothing_staged() { return {-(1 << 30), -(1 << 30)}; }

// The staged pixel under corner c - half of a GN window, staging the image
// around c first if the window is not inside what buf holds.
__device__ __forceinline__ const float* gn_window(const float* __restrict__ img,
                                                  int h, int w, const Cell& c,
                                                  int half, float* buf, Staged& st) {
  const int S = window_side(half);
  int dx = c.x - half - st.x0;
  int dy = c.y - half - st.y0;
  if (dx < 0 || dx > 2 * kMargin || dy < 0 || dy > 2 * kMargin) {
    st = {c.x - half - kMargin, c.y - half - kMargin};
    stage(img, h, w, st.x0, st.y0, S, buf);
    dx = dy = kMargin;
  }
  return buf + dy * S + dx;
}

// T and its central differences (lk.py:63-71) at staged index j, stride S.
__device__ __forceinline__ void template_at(const float* buf, int j, int S,
                                            const Cell& c, float& t, float& gx,
                                            float& gy) {
  t = bil(buf, j, S, c);
  gx = (bil(buf, j + 1, S, c) - bil(buf, j - 1, S, c)) * 0.5f;
  gy = (bil(buf, j + S, S, c) - bil(buf, j - S, S, c)) * 0.5f;
}

// The same from sample_clamp, for a centre that is not stageable.
__device__ __forceinline__ void template_clamped(const float* __restrict__ img,
                                                 int h, int w, float x, float y,
                                                 float& t, float& gx, float& gy) {
  t = sample_clamp(img, h, w, x, y);
  gx = (sample_clamp(img, h, w, x + 1.0f, y) - sample_clamp(img, h, w, x - 1.0f, y)) * 0.5f;
  gy = (sample_clamp(img, h, w, x, y + 1.0f) - sample_clamp(img, h, w, x, y - 1.0f)) * 0.5f;
}

// jnp.gradient of the W x W patch T at pixel p (row a, column b): central
// inside, one-sided at the patch border (lk.py:167).
__device__ __forceinline__ void patch_gradient(const float* T, int p, int a, int b,
                                               int W, float& gx, float& gy) {
  gx = b == 0       ? T[p + 1] - T[p]
       : b == W - 1 ? T[p] - T[p - 1]
                    : (T[p + 1] - T[p - 1]) * 0.5f;
  gy = a == 0       ? T[p + W] - T[p]
       : a == W - 1 ? T[p] - T[p - W]
                    : (T[p + W] - T[p - W]) * 0.5f;
}

// One track's template and its per-step window sums, for a warp. With K >
// 0 the lane's pixels p = lane + 32 k (k < K) and their template values
// stay in registers, each step's samples are read at offsets fixed once,
// and nothing branches per pixel, so all of a lane's loads start before
// any is used: a pixel past the window (p >= W^2) reads the last one and
// counts with weight 0. This serves windows up to 32 K pixels. Track<0>
// serves any window, looping over it with T, GX, GY in shared memory.
// Every method returns this lane's partial sums; the caller reduces them
// over the warp.
template <int K>
struct Track {
  int half, W;
  int px[K];     // the pixel (p, or the last one past the window)
  int at[K];     // its offset in a GN window of stride window_side(half)
  float on[K];   // 1 for a pixel of the window, 0 past it
  float t[K], gx[K], gy[K];
  float* patch;  // W^2 floats: a stored template, for its gradients
  float* buf;    // the staged image window

  __device__ Track(int half_, float* slice)
      : half(half_), W(2 * half_ + 1), patch(slice),
        buf(slice + 3 * (2 * half_ + 1) * (2 * half_ + 1)) {
    const int S = window_side(half);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = lane_id() + 32 * k;
      on[k] = p < W * W ? 1.0f : 0.0f;
      px[k] = min(p, W * W - 1);
      at[k] = (px[k] / W) * S + px[k] % W;
    }
  }

  // zero the gradients past the window; sum (GX^2, GX GY, GY^2) into s
  __device__ void finish_template(float (&s)[3]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gx[k] *= on[k];
      gy[k] *= on[k];
      s[0] += gx[k] * gx[k];
      s[1] += gx[k] * gy[k];
      s[2] += gy[k] * gy[k];
    }
  }

  __device__ void from_image(const float* __restrict__ img, int h, int w, float cx,
                             float cy, float (&s)[3]) {
    if (stageable(cx, cy)) {
      const Cell c = cell_of(cx, cy);
      const int S = template_side(half);
      stage(img, h, w, c.x - half - 1, c.y - half - 1, S, buf);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        template_at(buf, (px[k] / W + 1) * S + px[k] % W + 1, S, c, t[k], gx[k], gy[k]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        template_clamped(img, h, w, cx + static_cast<float>(px[k] % W - half),
                         cy + static_cast<float>(px[k] / W - half), t[k], gx[k], gy[k]);
      }
    }
    finish_template(s);
  }

  __device__ void from_patch(const float* __restrict__ tmpl, float (&s)[3]) {
    for_lane_pixels<1>(half, [&](int p, int, int) { patch[p] = tmpl[p]; });
    __syncwarp();  // the gradients read the neighbouring lanes' pixels
#pragma unroll
    for (int k = 0; k < K; ++k) {
      t[k] = patch[px[k]];
      patch_gradient(patch, px[k], px[k] / W, px[k] % W, W, gx[k], gy[k]);
    }
    finish_template(s);
  }

  // the image's samples under this lane's pixels, centred at (cx, cy)
  __device__ void samples(const float* __restrict__ img, int h, int w, float cx,
                          float cy, Staged& st, float (&v)[K]) {
    if (stageable(cx, cy)) {
      const Cell c = cell_of(cx, cy);
      const float* win = gn_window(img, h, w, c, half, buf, st);
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = bil(win, at[k], window_side(half), c);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[k] = sample_clamp(img, h, w, cx + static_cast<float>(px[k] % W - half),
                            cy + static_cast<float>(px[k] / W - half));
      }
    }
  }

  __device__ void residual_sums(const float* __restrict__ img, int h, int w, float cx,
                                float cy, Staged& st, float& bx, float& by) {
    float v[K];
    samples(img, h, w, cx, cy, st, v);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float r = v[k] - t[k];
      bx += r * gx[k];
      by += r * gy[k];
    }
  }

  __device__ float abs_residual(const float* __restrict__ img, int h, int w, float cx,
                                float cy, Staged& st) {
    float v[K];
    samples(img, h, w, cx, cy, st, v);
    float e = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) e += on[k] * fabsf(v[k] - t[k]);
    return e;
  }
};

template <>
struct Track<0> {
  int half, W;
  float *T, *GX, *GY, *buf;

  __device__ Track(int half_, float* slice)
      : half(half_), W(2 * half_ + 1), T(slice), GX(slice + W * W),
        GY(slice + 2 * W * W), buf(slice + 3 * W * W) {}

  __device__ void put(int p, float t, float gx, float gy, float (&s)[3]) {
    T[p] = t;
    GX[p] = gx;
    GY[p] = gy;
    s[0] += gx * gx;
    s[1] += gx * gy;
    s[2] += gy * gy;
  }

  __device__ void from_image(const float* __restrict__ img, int h, int w, float cx,
                             float cy, float (&s)[3]) {
    if (stageable(cx, cy)) {
      const Cell c = cell_of(cx, cy);
      const int S = template_side(half);
      stage(img, h, w, c.x - half - 1, c.y - half - 1, S, buf);
      for_lane_pixels<1>(half, [&](int p, int ox, int oy) {
        float t, gx, gy;
        template_at(buf, (oy + half + 1) * S + ox + half + 1, S, c, t, gx, gy);
        put(p, t, gx, gy, s);
      });
    } else {
      for_lane_pixels<1>(half, [&](int p, int ox, int oy) {
        float t, gx, gy;
        template_clamped(img, h, w, cx + static_cast<float>(ox),
                         cy + static_cast<float>(oy), t, gx, gy);
        put(p, t, gx, gy, s);
      });
    }
  }

  __device__ void from_patch(const float* __restrict__ tmpl, float (&s)[3]) {
    for_lane_pixels<1>(half, [&](int p, int, int) { T[p] = tmpl[p]; });
    __syncwarp();  // the gradients read the neighbouring lanes' pixels
    for_lane_pixels<1>(half, [&](int p, int ox, int oy) {
      float gx, gy;
      patch_gradient(T, p, oy + half, ox + half, W, gx, gy);
      put(p, T[p], gx, gy, s);
    });
  }

  // f(p, sample) for this lane's pixels of the window centred at (cx, cy)
  template <typename F>
  __device__ void each_sample(const float* __restrict__ img, int h, int w, float cx,
                              float cy, Staged& st, F&& f) {
    if (stageable(cx, cy)) {
      const Cell c = cell_of(cx, cy);
      const float* win = gn_window(img, h, w, c, half, buf, st);
      const int S = window_side(half);
      for_lane_pixels<4>(half, [&](int p, int ox, int oy) {
        f(p, bil(win, (oy + half) * S + ox + half, S, c));
      });
    } else {
      for_lane_pixels<1>(half, [&](int p, int ox, int oy) {
        f(p, sample_clamp(img, h, w, cx + static_cast<float>(ox),
                          cy + static_cast<float>(oy)));
      });
    }
  }

  __device__ void residual_sums(const float* __restrict__ img, int h, int w, float cx,
                                float cy, Staged& st, float& bx, float& by) {
    each_sample(img, h, w, cx, cy, st, [&](int p, float v) {
      const float r = v - T[p];
      bx += r * GX[p];
      by += r * GY[p];
    });
  }

  __device__ float abs_residual(const float* __restrict__ img, int h, int w, float cx,
                                float cy, Staged& st) {
    float e = 0.0f;
    each_sample(img, h, w, cx, cy, st, [&](int p, float v) { e += fabsf(v - T[p]); });
    return e;
  }
};

__device__ __forceinline__ float safe_det(float det) {
  return fabsf(det) < 1e-12f ? 1e-12f : det;
}

__device__ __forceinline__ bool center_in(float x, float y, int h, int w) {
  return (x >= 0.0f) && (y >= 0.0f) && (x <= static_cast<float>(w - 1)) &&
         (y <= static_cast<float>(h - 1));
}

// Inverse-compositional GN steps (lk.py:84-100) from (px, py) on img
// against the track's template. Every lane holds the same sums, so the
// step, the freeze and the exit are uniform over the warp: the step that
// falls under eps is the last. The 2x2 solve divides by det as the plain
// version does.
template <class Tr>
__device__ void gn_steps(Tr& tr, const float* __restrict__ img, int h, int w,
                         Staged& st, int iters, float eps2, const float (&s)[3],
                         float det_safe, float& px, float& py) {
  for (int it = 0; it < iters; ++it) {
    const float cx = px;
    const float cy = py;
    float bx = 0.0f;
    float by = 0.0f;
    tr.residual_sums(img, h, w, cx, cy, st, bx, by);
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float dx = (s[2] * bx - s[1] * by) / det_safe;
    const float dy = (s[0] * by - s[1] * bx) / det_safe;
    px = cx - dx;
    py = cy - dy;
    if (dx * dx + dy * dy < eps2) break;
  }
}

// The structure tensor's sums over the warp, in place; returns its det.
__device__ __forceinline__ float reduce_tensor(float (&s)[3]) {
  s[0] = warp_sum(s[0]);
  s[1] = warp_sum(s[1]);
  s[2] = warp_sum(s[2]);
  return s[0] * s[2] - s[1] * s[1];
}

template <int K>
__global__ void __launch_bounds__(32 * kWarps)
lk_pyramid_kernel(Levels lv, int n_levels, const float* __restrict__ pts,
                  const float* __restrict__ start,
                  const unsigned char* __restrict__ valid, int n, int half,
                  int iters, float eps2, float min_eig_thr, float max_err,
                  float* __restrict__ pos_out, unsigned char* __restrict__ ok_out,
                  float* __restrict__ err_out) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;  // whole warps: nothing below synchronises the block
  const float P = static_cast<float>((2 * half + 1) * (2 * half + 1));
  Track<K> tr(half, sm + warp * warp_floats(half));

  const float x0 = pts[2 * i];
  const float y0 = pts[2 * i + 1];
  const float top = 1.0f / static_cast<float>(1 << (n_levels - 1));
  float px = (start != nullptr ? start[2 * i] : x0) * top;
  float py = (start != nullptr ? start[2 * i + 1] : y0) * top;
  bool ok_all = true;
  float err = 0.0f;
  for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
    const float scale = 1.0f / static_cast<float>(1 << lvl);
    float s[3] = {0.0f, 0.0f, 0.0f};
    tr.from_image(lv.prev[lvl], lv.hp[lvl], lv.wp[lvl], x0 * scale, y0 * scale, s);
    const float det = reduce_tensor(s);
    const float tr2 = s[0] + s[2];
    const float eig = 0.5f * (tr2 - sqrtf(fmaxf(tr2 * tr2 - 4.0f * det, 0.0f))) / P;

    const float* next = lv.next[lvl];
    const int h = lv.h[lvl];
    const int w = lv.w[lvl];
    Staged st = nothing_staged();
    gn_steps(tr, next, h, w, st, iters, eps2, s, safe_det(det), px, py);
    err = (warp_sum(tr.abs_residual(next, h, w, px, py, st)) / P) * 255.0f;
    ok_all = ok_all && (eig > min_eig_thr) && center_in(px, py, h, w);
    if (lvl > 0) {
      px *= 2.0f;
      py *= 2.0f;
    }
  }
  if (lane_id() == 0) {
    pos_out[2 * i] = px;
    pos_out[2 * i + 1] = py;
    err_out[i] = err;
    ok_out[i] = valid == nullptr ? ok_all
                                 : (ok_all && valid[i] && (err < max_err));
  }
}

template <int K>
__global__ void __launch_bounds__(32 * kWarps)
lk_align_kernel(const float* __restrict__ img, int h, int w,
                const float* __restrict__ templates,
                const float* __restrict__ pos_in,
                const unsigned char* __restrict__ valid, int n, int half,
                int iters, float eps2, float max_err, float max_shift,
                float* __restrict__ pos_out, unsigned char* __restrict__ ok_out,
                float* __restrict__ err_out) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;
  const int P = (2 * half + 1) * (2 * half + 1);
  Track<K> tr(half, sm + warp * warp_floats(half));
  const float x0 = pos_in[2 * i];
  const float y0 = pos_in[2 * i + 1];

  float s[3] = {0.0f, 0.0f, 0.0f};
  tr.from_patch(templates + static_cast<long long>(i) * P, s);
  const float det = reduce_tensor(s);
  float px = x0;
  float py = y0;
  Staged st = nothing_staged();
  gn_steps(tr, img, h, w, st, iters, eps2, s, safe_det(det), px, py);
  const float err =
      (warp_sum(tr.abs_residual(img, h, w, px, py, st)) / static_cast<float>(P)) * 255.0f;
  if (lane_id() == 0) {
    const float sx = px - x0;
    const float sy = py - y0;
    const float shift = sqrtf(sx * sx + sy * sy);
    const bool ok = valid[i] && center_in(px, py, h, w) && (err < max_err) &&
                    (shift <= max_shift);
    pos_out[2 * i] = ok ? px : x0;
    pos_out[2 * i + 1] = ok ? py : y0;
    err_out[i] = err;
    ok_out[i] = ok;
  }
}

// Tracks per block for a W x W window: kWarps, or fewer where kWarps
// slices of warp_floats would not fit one block's shared memory; 0 if not
// even one fits (the wrapper refuses such windows first).
int warps_for(int half, size_t* smem) {
  const size_t per_warp = sizeof(float) * warp_floats(half);
  int wpb = kWarps;
  while (wpb > 0 && per_warp * wpb > kMaxSmem) --wpb;
  *smem = per_warp * wpb;
  return wpb;
}

// Pixels per lane kept in registers for a W x W window: 4 up to 128
// pixels (W <= 11), 8 up to 256 (W <= 15), else 0 (the loop over shared
// memory).
int pixels_per_lane(int half) {
  const int P = (2 * half + 1) * (2 * half + 1);
  return P <= 128 ? 4 : P <= 256 ? 8 : 0;
}

// Opts `kernel` in to `bytes` of dynamic shared memory when that is above
// what it was last allowed (48 KB by default).
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}

// Launches kernel<K> (lk_pyramid_kernel or lk_align_kernel) with K pixels
// per lane in registers for this window, opting each instance in to its
// shared memory first.
template <int K, typename... A>
cudaError_t launch_pyramid(int blocks, int threads, size_t smem, cudaStream_t stream,
                           A... args) {
  static size_t allowed = kDefaultSmem;
  const cudaError_t e = allow_smem(lk_pyramid_kernel<K>, smem, &allowed);
  if (e != cudaSuccess) return e;
  lk_pyramid_kernel<K><<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int K, typename... A>
cudaError_t launch_align(int blocks, int threads, size_t smem, cudaStream_t stream,
                         A... args) {
  static size_t allowed = kDefaultSmem;
  const cudaError_t e = allow_smem(lk_align_kernel<K>, smem, &allowed);
  if (e != cudaSuccess) return e;
  lk_align_kernel<K><<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// levels: 2 L device pointers, prev[0..L) then next[0..L); dims: L rows of
// (hp, wp, h, w). start (init or guess) and valid may be null.
extern "C" int dr3_lk_pyramid(int n_levels, const float* const* levels,
                              const int* dims, const float* pts,
                              const float* start, const unsigned char* valid,
                              int n, int half, int iters, float eps2,
                              float min_eig_thr, float max_err, float* pos,
                              unsigned char* ok, float* err, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n_levels < 1 || n_levels > kMaxLevels || half < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const int wpb = warps_for(half, &smem);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.prev[l] = levels[l];
    lv.next[l] = levels[n_levels + l];
    lv.hp[l] = dims[4 * l];
    lv.wp[l] = dims[4 * l + 1];
    lv.h[l] = dims[4 * l + 2];
    lv.w[l] = dims[4 * l + 3];
  }
  const int blocks = (n + wpb - 1) / wpb;
  const auto s = static_cast<cudaStream_t>(stream);
  const int k = pixels_per_lane(half);
  const cudaError_t e =
      k == 4   ? launch_pyramid<4>(blocks, 32 * wpb, smem, s, lv, n_levels, pts, start,
                                   valid, n, half, iters, eps2, min_eig_thr, max_err,
                                   pos, ok, err)
      : k == 8 ? launch_pyramid<8>(blocks, 32 * wpb, smem, s, lv, n_levels, pts, start,
                                   valid, n, half, iters, eps2, min_eig_thr, max_err,
                                   pos, ok, err)
               : launch_pyramid<0>(blocks, 32 * wpb, smem, s, lv, n_levels, pts, start,
                                   valid, n, half, iters, eps2, min_eig_thr, max_err,
                                   pos, ok, err);
  return static_cast<int>(e);
}

extern "C" int dr3_lk_align(const float* img, int h, int w,
                            const float* templates, const float* pos_in,
                            const unsigned char* valid, int n, int half,
                            int iters, float eps2, float max_err,
                            float max_shift, float* pos_out, unsigned char* ok,
                            float* err, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (half < 1) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const int wpb = warps_for(half, &smem);
  if (wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + wpb - 1) / wpb;
  const auto s = static_cast<cudaStream_t>(stream);
  const int k = pixels_per_lane(half);
  const cudaError_t e =
      k == 4   ? launch_align<4>(blocks, 32 * wpb, smem, s, img, h, w, templates, pos_in,
                                 valid, n, half, iters, eps2, max_err, max_shift, pos_out,
                                 ok, err)
      : k == 8 ? launch_align<8>(blocks, 32 * wpb, smem, s, img, h, w, templates, pos_in,
                                 valid, n, half, iters, eps2, max_err, max_shift, pos_out,
                                 ok, err)
               : launch_align<0>(blocks, 32 * wpb, smem, s, img, h, w, templates, pos_in,
                                 valid, n, half, iters, eps2, max_err, max_shift, pos_out,
                                 ok, err);
  return static_cast<int>(e);
}
