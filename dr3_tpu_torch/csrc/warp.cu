// K4: dense bilinear remap and warp, a tile of output pixels per block.
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
//   * dr3_warp: each output pixel's source coordinate is computed here:
//     H^-1 p for a homography (9 floats by value, apply_homography's
//     |w| < 1e-12 guard) or the spherical / cylindrical field of
//     ops/warp.py (|zhat| < 1e-9 guard). No [Ho, Wo, 2] field goes through
//     HBM.
//   * dr3_remap samples src over a given field: rows only, y = v[i, j] with
//     x = j implied (K4a's contract); columns only, x = u[i, j] with y = i
//     implied (K4b's contract); or (x, y) pairs [n, 2] (ops/warp.remap_xy).
//
// Both write out [n, C], fill outside the image (dr3_remap reads the
// border there instead when asked to clamp), and, when given, valid [n]
// from the unclamped coordinate, as bilinear_sample does.
// Corner indices follow common.cuh corner_index, so NaN, inf and far-out
// coordinates read the border and never out of bounds.
//
// Arithmetic: every coordinate and blend step is one separately rounded
// __f*_rn operation, in the order of the plain PyTorch version in
// dr3_tpu_torch/ops/warp.py, so nvcc cannot contract it into FMAs; sinf and
// cosf are the precise ones. A term computed once for a column or a row
// goes through the same operation as it would per pixel, so the kernel
// stays bit-exact against the plain version run on the same card.
//
// What bounds it on the card: memory, each output value written once and,
// inside the image, its four source corners read (a few cache lines per
// warp for these smooth warps), at 3.35 TB/s. At the path's sizes (a
// 640x480x3 view, canvases of 0.6-1 megapixels) that is 2-5 us, so the
// latency of one pass (terms, coordinates, gathers, stores) and the launch
// (1.3 us for one sample) show as much as the bytes. What the design does:
//   * a 2-D grid of tiles of 128 columns by 8 rows (4 for the homography);
//     warp ty writes 128 consecutive pixels of one row, lane tx the pixels
//     tx + 32 k, k < 4, so row and column come from the block and thread
//     indices with no integer division, every load and store instruction
//     covers 32 consecutive pixels, and each lane has four independent
//     gathers in flight. A row's segment starts (i Wo) mod 4 columns early,
//     on a multiple of 4 of the flattened output, so a whole segment of C =
//     3 goes out through shared memory as contiguous float4 stores and
//     valid as one 4-byte store a lane, packed from ballots;
//   * the form is fixed at compile time: one __global__ per field kind,
//     templated on the channel count (1, 3, or any C at run time), so no
//     branch on the kind and no channel loop where C is 1 or 3, and the
//     profiler sees each form by name; each kind has the tile height and
//     register budget (launch bounds) that measured fastest;
//   * sin / cos of the spherical and cylindrical angles are computed once
//     per tile column and tile row into shared memory; the homography's
//     products h0 j, h1 i, ... are three multiplications a pixel, which
//     measured faster than reading them from shared memory;
//   * a pixel whose source lies outside the image issues no gather
//     (predicated on ok || clamp);
//   * a homography tile whose four corner pixels all map beyond one edge of
//     the source, with one sign of w at all four and a margin that bounds
//     the rounding of every pixel's coordinate, holds no valid pixel (the
//     tile's image is the convex quadrilateral of its corners' images):
//     one warp tests it while the others wait at the block's barrier, and
//     the block then writes fill and false and divides nothing. Most of the
//     panorama's paste canvas is such tiles. dr3_warp_shortcut_tiles runs
//     the same test over the same tiles and returns its decisions.
// The xy remap is one sample a thread, the (x, y) pair read as one 8-byte
// load where the field is 8-byte aligned.
#include <cstdint>

#include "common.cuh"

namespace {

enum RemapMode { kRemapXY = 0, kRemapRows = 1, kRemapCols = 2 };
enum Field { kHomography = 0, kSpherical = 1, kCylindrical = 2, kRows = 3, kCols = 4 };

struct WarpParams {
  float h[9];  // row-major H^-1 for kHomography; h[0] = focal length otherwise
};

constexpr int kGroup = 4;                                // pixels of a lane, 32 apart
constexpr int kLanes = 32;                               // lanes of a warp
constexpr int kTileWidth = kGroup * kLanes;              // 128
constexpr int kTileCols = kTileWidth + kGroup - 1;       // columns a tile's rows span
// rows of a tile (a warp each) and the blocks an SM must hold at least (so
// the registers a thread may take): the homography's tiles of 4 rows at 64
// registers, the others' of 8 rows (the separable fields' column terms
// serve 8 rows) at 80
template <int F>
constexpr int kTileRowsOf = F == kHomography ? 4 : 8;
template <int F>
constexpr int kMinBlocksOf = F == kHomography ? 8 : 3;
constexpr int kXYThreads = 256;                          // threads a block, xy remap
constexpr float kUlp = 5.9604645e-8f;                    // 2^-24, float32 unit round-off

// The bilinear cell of (x, y) in an [H, W] image: bilinear_sample's
// validity, weights and clamped corner offsets (in pixels).
struct Cell {
  long long o00, o01, o10, o11;
  float wx, wy, ax, ay;
  bool ok;
};

__device__ __forceinline__ Cell make_cell(float x, float y, int H, int W) {
  Cell c;
  c.ok = (x >= 0.0f) && (y >= 0.0f) && (x <= static_cast<float>(W - 1)) &&
         (y <= static_cast<float>(H - 1));
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  c.wx = __fsub_rn(x, x0);
  c.wy = __fsub_rn(y, y0);
  c.ax = __fsub_rn(1.0f, c.wx);
  c.ay = __fsub_rn(1.0f, c.wy);
  const int xi = dr3::corner_index(x0, W);
  const int yi = dr3::corner_index(y0, H);
  const int x0c = min(max(xi, 0), W - 1);
  const int x1c = min(max(xi + 1, 0), W - 1);
  const long long r0 = static_cast<long long>(min(max(yi, 0), H - 1)) * W;
  const long long r1 = static_cast<long long>(min(max(yi + 1, 0), H - 1)) * W;
  c.o00 = r0 + x0c;
  c.o01 = r0 + x1c;
  c.o10 = r1 + x0c;
  c.o11 = r1 + x1c;
  return c;
}

__device__ __forceinline__ float lerp2(const Cell& c, float v00, float v01, float v10,
                                       float v11) {
  const float top = __fadd_rn(__fmul_rn(v00, c.ax), __fmul_rn(v01, c.wx));
  const float bot = __fadd_rn(__fmul_rn(v10, c.ax), __fmul_rn(v11, c.wx));
  return __fadd_rn(__fmul_rn(top, c.ay), __fmul_rn(bot, c.wy));
}

// C channels of src at the cell into o[0..C): gathers only where they are
// used (load = in range and (ok or clamp)), else fill.
template <int C>
__device__ __forceinline__ void sample(const float* __restrict__ src, const Cell& c,
                                       bool load, bool use, float fill, float* o) {
  float v[4][C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    v[0][ch] = load ? __ldg(src + c.o00 * C + ch) : 0.0f;
    v[1][ch] = load ? __ldg(src + c.o01 * C + ch) : 0.0f;
    v[2][ch] = load ? __ldg(src + c.o10 * C + ch) : 0.0f;
    v[3][ch] = load ? __ldg(src + c.o11 * C + ch) : 0.0f;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    o[ch] = use ? lerp2(c, v[0][ch], v[1][ch], v[2][ch], v[3][ch]) : fill;
  }
}

// any channel count: sample and store pixel p (offset in pixels) directly
__device__ __forceinline__ void sample_store_any(const float* __restrict__ src, int nc,
                                                 const Cell& c, bool clamp, float fill,
                                                 long long p, float* __restrict__ out,
                                                 bool* __restrict__ valid) {
  const bool use = clamp || c.ok;
  for (int ch = 0; ch < nc; ++ch) {
    float v = fill;
    if (use) {
      v = lerp2(c, __ldg(src + c.o00 * nc + ch), __ldg(src + c.o01 * nc + ch),
                __ldg(src + c.o10 * nc + ch), __ldg(src + c.o11 * nc + ch));
    }
    out[p * nc + ch] = v;
  }
  if (valid != nullptr) valid[p] = c.ok;
}

// ---------------------------------------------------------------------------
// separable field terms
// ---------------------------------------------------------------------------

// column j's terms: {h0 j, h3 j, h6 j} or {sin a, cos a}, a = (j - Wo/2) / f
template <int F>
__device__ __forceinline__ float4 column_terms(const WarpParams& prm, int j, int Wo) {
  const float jf = static_cast<float>(j);
  if constexpr (F == kHomography) {
    return make_float4(__fmul_rn(prm.h[0], jf), __fmul_rn(prm.h[3], jf),
                       __fmul_rn(prm.h[6], jf), 0.0f);
  } else {
    const float a = __fdiv_rn(__fsub_rn(jf, 0.5f * static_cast<float>(Wo)), prm.h[0]);
    return make_float4(sinf(a), cosf(a), 0.0f, 0.0f);
  }
}

// row i's terms: {h1 i, h4 i, h7 i}, {sin b, cos b} or {b}, b = (i - Ho/2) / f
template <int F>
__device__ __forceinline__ float4 row_terms(const WarpParams& prm, int i, int Ho) {
  const float ifl = static_cast<float>(i);
  if constexpr (F == kHomography) {
    return make_float4(__fmul_rn(prm.h[1], ifl), __fmul_rn(prm.h[4], ifl),
                       __fmul_rn(prm.h[7], ifl), 0.0f);
  } else {
    const float b = __fdiv_rn(__fsub_rn(ifl, 0.5f * static_cast<float>(Ho)), prm.h[0]);
    if constexpr (F == kSpherical) {
      return make_float4(sinf(b), cosf(b), 0.0f, 0.0f);
    } else {
      return make_float4(b, 0.0f, 0.0f, 0.0f);
    }
  }
}

// a pixel's source coordinate from its column's and row's terms
template <int F>
__device__ __forceinline__ void field_coord(const WarpParams& prm, float4 ct, float4 rt,
                                            int Ho, int Wo, float& x, float& y) {
  if constexpr (F == kHomography) {
    // apply_homography: w = (h6 j + h7 i) + h8, x = ((h0 j + h1 i) + h2) / w
    float w = __fadd_rn(__fadd_rn(ct.z, rt.z), prm.h[8]);
    if (fabsf(w) < 1e-12f) w = 1e-12f;
    x = __fdiv_rn(__fadd_rn(__fadd_rn(ct.x, rt.x), prm.h[2]), w);
    y = __fdiv_rn(__fadd_rn(__fadd_rn(ct.y, rt.y), prm.h[5]), w);
  } else {
    // spherical_warp_field / cylindrical_warp_field
    const float f = prm.h[0];
    float xh;
    float yh;
    float zh;
    if constexpr (F == kSpherical) {
      xh = __fmul_rn(ct.x, rt.y);
      yh = rt.x;
      zh = __fmul_rn(ct.y, rt.y);
    } else {
      xh = ct.x;
      yh = rt.x;
      zh = ct.y;
    }
    if (fabsf(zh) < 1e-9f) zh = 1e-9f;
    x = __fadd_rn(0.5f * static_cast<float>(Wo), __fdiv_rn(__fmul_rn(f, xh), zh));
    y = __fadd_rn(0.5f * static_cast<float>(Ho), __fdiv_rn(__fmul_rn(f, yh), zh));
  }
}

// The homography's whole-tile test, by one warp (lane k & 3 takes corner
// pixel k of [j0, j1] x [i0, i1]): true if no pixel of the tile can be
// valid. Each corner's coordinate is computed as field_coord computes it;
// the bounds below are float32 operations rounded one by one, mirrored by
// tools/warp_tiles.py shortcut_tiles on the host.
//   With |w| >= wmin at the corners, every pixel's computed w is within
//   e_w = 4u A_w of its exact value (A_w = |h6| j1 + |h7| i1 + |h8|, u =
//   2^-24), so w keeps the corners' sign on the tile and |w| >= wl = wmin -
//   2 e_w there; the guard never acts if wl > 1e-12. A coordinate then
//   lies within E = (4u A + q e_w) / wl + 2u q of its exact value (q = A /
//   wl bounds |x|, A = |h0| j1 + |h1| i1 + |h2| for x), and the exact
//   coordinates of the tile lie between those of its corners. All four
//   corners below -m or above W - 1 + m, m = 1 + 4E, leaves every pixel
//   outside [0, W - 1]. NaN anywhere takes the per-pixel path.
__device__ __forceinline__ bool tile_outside(const WarpParams& prm, int H, int W, int j0,
                                             int j1, int i0, int i1) {
  const int lane = threadIdx.x & 3;
  const int j = (lane & 1) ? j1 : j0;
  const int i = (lane & 2) ? i1 : i0;
  const float4 ct = column_terms<kHomography>(prm, j, 0);
  const float4 rt = row_terms<kHomography>(prm, i, 0);
  const float w = __fadd_rn(__fadd_rn(ct.z, rt.z), prm.h[8]);
  const float x = __fdiv_rn(__fadd_rn(__fadd_rn(ct.x, rt.x), prm.h[2]), w);
  const float y = __fdiv_rn(__fadd_rn(__fadd_rn(ct.y, rt.y), prm.h[5]), w);
  const unsigned all = 0xffffffffu;
  const bool nan = __any_sync(all, isnan(x) || isnan(y) || isnan(w));
  const bool pos = __all_sync(all, w > 0.0f);
  const bool neg = __all_sync(all, w < 0.0f);
  float wmin = fabsf(w);
  float xlo = x, xhi = x, ylo = y, yhi = y;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    wmin = fminf(wmin, __shfl_xor_sync(all, wmin, o));
    xlo = fminf(xlo, __shfl_xor_sync(all, xlo, o));
    xhi = fmaxf(xhi, __shfl_xor_sync(all, xhi, o));
    ylo = fminf(ylo, __shfl_xor_sync(all, ylo, o));
    yhi = fmaxf(yhi, __shfl_xor_sync(all, yhi, o));
  }
  if (nan || !(pos || neg)) return false;
  const float jf = static_cast<float>(j1);
  const float ifl = static_cast<float>(i1);
  const float* h = prm.h;
  const float four_u = 4.0f * kUlp;
  const float a_x = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(h[0]), jf), __fmul_rn(fabsf(h[1]), ifl)),
                              fabsf(h[2]));
  const float a_y = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(h[3]), jf), __fmul_rn(fabsf(h[4]), ifl)),
                              fabsf(h[5]));
  const float a_w = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(h[6]), jf), __fmul_rn(fabsf(h[7]), ifl)),
                              fabsf(h[8]));
  const float e_w = __fmul_rn(four_u, a_w);
  const float wl = __fsub_rn(wmin, __fmul_rn(2.0f, e_w));
  if (!(wl > 1e-12f)) return false;
  const float q_x = __fdiv_rn(a_x, wl);
  const float q_y = __fdiv_rn(a_y, wl);
  const float e_x = __fadd_rn(__fdiv_rn(__fadd_rn(__fmul_rn(four_u, a_x), __fmul_rn(q_x, e_w)), wl),
                              __fmul_rn(2.0f * kUlp, q_x));
  const float e_y = __fadd_rn(__fdiv_rn(__fadd_rn(__fmul_rn(four_u, a_y), __fmul_rn(q_y, e_w)), wl),
                              __fmul_rn(2.0f * kUlp, q_y));
  const float m_x = __fadd_rn(1.0f, __fmul_rn(4.0f, e_x));
  const float m_y = __fadd_rn(1.0f, __fmul_rn(4.0f, e_y));
  return xhi < -m_x || xlo > __fadd_rn(static_cast<float>(W - 1), m_x) || yhi < -m_y ||
         ylo > __fadd_rn(static_cast<float>(H - 1), m_y);
}

// tile_outside over the homography tile of block (blockIdx.x, blockIdx.y):
// output rows [R by, R by + R), R = kTileRowsOf<kHomography>, and the
// columns its rows' segments span, [128 bx - 3, 128 bx + 127]
__device__ __forceinline__ bool block_tile_outside(const WarpParams& prm, int H, int W, int Ho,
                                                   int Wo) {
  constexpr int kTileRows = kTileRowsOf<kHomography>;
  const int c0 = blockIdx.x * kTileWidth - (kGroup - 1);
  const int i0 = blockIdx.y * kTileRows;
  return tile_outside(prm, H, W, max(c0, 0), min(c0 + kTileCols - 1, Wo - 1), i0,
                      min(i0 + kTileRows - 1, Ho - 1));
}

// ---------------------------------------------------------------------------
// the tiled body shared by dr3_warp and the rows / columns remaps
// ---------------------------------------------------------------------------

// Stores a warp's segment of kTileWidth consecutive output pixels, p0 the
// flat index of its first (a multiple of 4); lane tx holds pixels tx + 32 k
// where in[k]. A whole segment of C = 3 goes out through shared memory as
// contiguous float4 stores, one of C = 1 as lane-consecutive floats; a
// segment cut by the row's ends stores pixel by pixel.
template <int C>
__device__ __forceinline__ void store_values(const float (&o)[kGroup][C],
                                             const bool (&in)[kGroup], bool whole,
                                             long long p0, float* __restrict__ out,
                                             float4* __restrict__ stage) {
  const int lane = threadIdx.x;
  if (C == 3 && whole && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    float* st = reinterpret_cast<float*>(stage);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) st[(lane + kLanes * k) * C + ch] = o[k][ch];
    }
    __syncwarp();
    float4* dst = reinterpret_cast<float4*>(out + p0 * C);
#pragma unroll
    for (int q = 0; q < C; ++q) dst[lane + kLanes * q] = stage[lane + kLanes * q];
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (in[k]) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) out[(p0 + lane + kLanes * k) * C + ch] = o[k][ch];
      }
    }
  }
}

// valid of the segment: for a whole one 4 bytes a lane, packed from the
// warp's ballots (bytes 4 lane .. 4 lane + 3 are bits (4 lane) mod 32 .. + 3
// of ballot (4 lane) / 32), else byte by byte
__device__ __forceinline__ void store_valid(const bool (&ok)[kGroup], const bool (&in)[kGroup],
                                            bool whole, long long p0,
                                            bool* __restrict__ valid) {
  if (valid == nullptr) return;
  const int lane = threadIdx.x;
  if (whole && (reinterpret_cast<uintptr_t>(valid) & 3) == 0) {
    unsigned m[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) m[k] = __ballot_sync(0xffffffffu, ok[k]);
    const unsigned bits = (m[lane >> 3] >> (4 * (lane & 7))) & 0xfu;
    reinterpret_cast<uint32_t*>(valid + p0)[lane] =
        (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14) | ((bits & 8u) << 21);
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (in[k]) valid[p0 + lane + kLanes * k] = ok[k];
    }
  }
}

// One block writes output rows [R by, R by + R), R = kTileRowsOf<F>; warp
// ty writes, of row i = R by + ty, the segment of columns [128 bx - s,
// 128 bx + 128 - s), s = (i Wo) mod 4, so the segment starts on a multiple
// of 4 of the flattened output; lane tx the columns 128 bx - s + tx + 32 k,
// k < 4. Every lane of a warp stays to the stores (one past the row's end
// holds no pixel). nc is the channel count where C is 0.
template <int F, int C>
__device__ __forceinline__ void tile_body(const float* __restrict__ src, int H, int W, int nc,
                                          const float* __restrict__ field,
                                          const WarpParams& prm, int Ho, int Wo, int clamp,
                                          float fill, float* __restrict__ out,
                                          bool* __restrict__ valid) {
  // sin / cos of the angles once per tile column and row; the homography's
  // products cost no more per pixel than a shared-memory read
  constexpr bool kTerms = F == kSpherical || F == kCylindrical;
  constexpr int kTileRows = kTileRowsOf<F>;
  constexpr int kThreads = kLanes * kTileRows;
  __shared__ float4 cterm[kTerms ? kTileCols : 1];
  __shared__ float4 rterm[kTileRows];
  __shared__ float4 stage[C == 3 ? kTileRows : 1][C == 3 ? kTileWidth * C / 4 : 1];
  __shared__ bool skip;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tile_c0 = blockIdx.x * kTileWidth - (kGroup - 1);   // first column of the span
  const int i = blockIdx.y * kTileRows + ty;
  if constexpr (kTerms) {
    for (int t = ty * kLanes + tx; t < kTileCols + kTileRows; t += kThreads) {
      if (t < kTileCols) {
        const int j = tile_c0 + t;
        if (j >= 0 && j < Wo) cterm[t] = column_terms<F>(prm, j, Wo);
      } else {
        const int r = blockIdx.y * kTileRows + (t - kTileCols);
        if (r < Ho) rterm[t - kTileCols] = row_terms<F>(prm, r, Ho);
      }
    }
  }
  if constexpr (F == kHomography) {
    // a clamped sample is never fill, so clamp takes no shortcut
    if (ty == kTileRows - 1) {
      const bool out_of_image = !clamp && block_tile_outside(prm, H, W, Ho, Wo);
      if (tx == 0) skip = out_of_image;
    }
  }
  if constexpr (kTerms || F == kHomography) __syncthreads();
  if (i >= Ho) return;                                 // the whole warp
  const int seg = tile_c0 + (kGroup - 1) - (((i & 3) * (Wo & 3)) & 3);
  const long long p0 = static_cast<long long>(i) * Wo + seg;   // a multiple of 4
  const bool whole = seg >= 0 && seg + kTileWidth <= Wo;
  bool in[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const int j = seg + tx + kLanes * k;
    in[k] = j >= 0 && j < Wo;
  }

  if constexpr (F == kHomography) {
    if (skip) {
      if constexpr (C > 0) {
        const bool none[kGroup] = {false, false, false, false};
        float o[kGroup][C];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
#pragma unroll
          for (int ch = 0; ch < C; ++ch) o[k][ch] = fill;
        }
        store_values<C>(o, in, whole, p0, out, stage[C == 3 ? ty : 0]);
        store_valid(none, in, whole, p0, valid);
      } else {
        for (int k = 0; k < kGroup; ++k) {
          if (!in[k]) continue;
          const long long p = p0 + tx + kLanes * k;
          for (int ch = 0; ch < nc; ++ch) out[p * nc + ch] = fill;
          if (valid != nullptr) valid[p] = false;
        }
      }
      return;
    }
  }

  // source coordinates
  float x[kGroup];
  float y[kGroup];
  if constexpr (F == kHomography) {
    const float4 rt = row_terms<F>(prm, i, Ho);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      field_coord<F>(prm, column_terms<F>(prm, seg + tx + kLanes * k, Wo), rt, Ho, Wo, x[k],
                     y[k]);
    }
  } else if constexpr (kTerms) {
    const float4 rt = rterm[ty];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float4 ct = cterm[min(seg - tile_c0 + tx + kLanes * k, kTileCols - 1)];
      field_coord<F>(prm, ct, rt, Ho, Wo, x[k], y[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float f = in[k] ? __ldg(field + p0 + tx + kLanes * k) : 0.0f;
      if constexpr (F == kRows) {
        x[k] = static_cast<float>(seg + tx + kLanes * k);
        y[k] = f;
      } else {
        x[k] = f;
        y[k] = static_cast<float>(i);
      }
    }
  }

  Cell cell[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) cell[k] = make_cell(x[k], y[k], H, W);
  if constexpr (C > 0) {
    float o[kGroup][C];
    bool ok[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const bool use = clamp || cell[k].ok;
      sample<C>(src, cell[k], in[k] && use, use, fill, o[k]);
      ok[k] = cell[k].ok;
    }
    store_values<C>(o, in, whole, p0, out, stage[C == 3 ? ty : 0]);
    store_valid(ok, in, whole, p0, valid);
  } else {
    for (int k = 0; k < kGroup; ++k) {
      if (in[k]) {
        sample_store_any(src, nc, cell[k], clamp, fill, p0 + tx + kLanes * k, out, valid);
      }
    }
  }
}

#define DR3_TILE_ARGS                                                                   \
  const float *__restrict__ src, int H, int W, int nc, const float *__restrict__ field, \
      WarpParams prm, int Ho, int Wo, int clamp, float fill, float *__restrict__ out,   \
      bool *__restrict__ valid
#define DR3_TILE_CALL(F) \
  tile_body<F, C>(src, H, W, nc, field, prm, Ho, Wo, clamp, fill, out, valid)

template <int C>
__global__ void __launch_bounds__(kLanes * kTileRowsOf<kHomography>, kMinBlocksOf<kHomography>)
    warp_homography_kernel(DR3_TILE_ARGS) {
  DR3_TILE_CALL(kHomography);
}
template <int C>
__global__ void __launch_bounds__(kLanes * kTileRowsOf<kSpherical>, kMinBlocksOf<kSpherical>)
    warp_spherical_kernel(DR3_TILE_ARGS) {
  DR3_TILE_CALL(kSpherical);
}
template <int C>
__global__ void __launch_bounds__(kLanes * kTileRowsOf<kCylindrical>, kMinBlocksOf<kCylindrical>)
    warp_cylindrical_kernel(DR3_TILE_ARGS) {
  DR3_TILE_CALL(kCylindrical);
}
template <int C>
__global__ void __launch_bounds__(kLanes * kTileRowsOf<kRows>, kMinBlocksOf<kRows>)
    remap_rows_kernel(DR3_TILE_ARGS) {
  DR3_TILE_CALL(kRows);
}
template <int C>
__global__ void __launch_bounds__(kLanes * kTileRowsOf<kCols>, kMinBlocksOf<kCols>)
    remap_cols_kernel(DR3_TILE_ARGS) {
  DR3_TILE_CALL(kCols);
}

// the homography kernel's whole-tile decisions, one warp a tile on the same
// grid: tiles[by * gridDim.x + bx]
__global__ void __launch_bounds__(kLanes)
    shortcut_tiles_kernel(WarpParams prm, int H, int W, int Ho, int Wo, bool* __restrict__ tiles) {
  const bool out_of_image = block_tile_outside(prm, H, W, Ho, Wo);
  if (threadIdx.x == 0) tiles[blockIdx.y * gridDim.x + blockIdx.x] = out_of_image;
}

// (x, y) pairs, one sample a thread: sample p = kXYThreads bx + tx, so every
// load and store instruction of a warp is coalesced.
template <int C>
__global__ void __launch_bounds__(kXYThreads)
    remap_xy_kernel(const float* __restrict__ src, int H, int W, int nc,
                    const float* __restrict__ field, long long n, int clamp, float fill,
                    float* __restrict__ out, bool* __restrict__ valid) {
  const long long p = static_cast<long long>(blockIdx.x) * kXYThreads + threadIdx.x;
  if (p >= n) return;
  float x;
  float y;
  if ((reinterpret_cast<uintptr_t>(field) & 7) == 0) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(field) + p);
    x = q.x;
    y = q.y;
  } else {
    x = __ldg(field + 2 * p);
    y = __ldg(field + 2 * p + 1);
  }
  const Cell cell = make_cell(x, y, H, W);
  if constexpr (C > 0) {
    float o[C];
    const bool use = clamp || cell.ok;
    sample<C>(src, cell, use, use, fill, o);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[p * C + ch] = o[ch];
    if (valid != nullptr) valid[p] = cell.ok;
  } else {
    sample_store_any(src, nc, cell, clamp, fill, p, out, valid);
  }
}

using TileKernel = void (*)(const float*, int, int, int, const float*, WarpParams, int, int,
                            int, float, float*, bool*);

// the instantiation of a tiled kernel for c channels
#define DR3_PICK(kernel, c) \
  ((c) == 1 ? &kernel<1> : (c) == 3 ? &kernel<3> : &kernel<0>)

// the grid of tiles of `rows` rows over an [ho, wo] output: a tile's rows'
// segments start up to 3 columns before 128 bx, so the last may end past wo
dim3 tile_grid(int rows, int ho, int wo) {
  const long long groups = (static_cast<long long>(wo) + 2 * (kGroup - 1)) / kGroup;
  return dim3(static_cast<unsigned>((groups + kLanes - 1) / kLanes),
              static_cast<unsigned>((ho + rows - 1) / rows));
}

int launch_tiled(TileKernel kernel, int rows, const float* src, int h, int w, int c,
                 const float* field, const WarpParams& prm, int ho, int wo, int clamp,
                 float fill, float* out, bool* valid, void* stream) {
  const dim3 grid = tile_grid(rows, ho, wo);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, dim3(kLanes, rows), 0, static_cast<cudaStream_t>(stream)>>>(
      src, h, w, c, field, prm, ho, wo, clamp, fill, out, valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dr3_remap(const float* src, int h, int w, int c, int mode,
                         const float* field, int ho, int wo, int clamp,
                         float fill, float* out, bool* valid, void* stream) {
  const long long n = static_cast<long long>(ho) * wo;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (mode == kRemapXY) {
    const auto kernel = DR3_PICK(remap_xy_kernel, c);
    kernel<<<static_cast<unsigned>((n + kXYThreads - 1) / kXYThreads), kXYThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(src, h, w, c, field, n, clamp, fill, out,
                                                  valid);
    return static_cast<int>(cudaGetLastError());
  }
  const TileKernel kernel = mode == kRemapRows ? DR3_PICK(remap_rows_kernel, c)
                                               : DR3_PICK(remap_cols_kernel, c);
  return launch_tiled(kernel, kTileRowsOf<kRows>, src, h, w, c, field, WarpParams{}, ho, wo,
                      clamp, fill, out, valid, stream);
}

// fill outside the source: the warps never clamp
extern "C" int dr3_warp(const float* src, int h, int w, int c, int kind,
                        float h0, float h1, float h2, float h3, float h4,
                        float h5, float h6, float h7, float h8, int ho, int wo,
                        float fill, float* out, bool* valid, void* stream) {
  const long long n = static_cast<long long>(ho) * wo;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const WarpParams prm = {{h0, h1, h2, h3, h4, h5, h6, h7, h8}};
  const TileKernel kernel = kind == kHomography  ? DR3_PICK(warp_homography_kernel, c)
                            : kind == kSpherical ? DR3_PICK(warp_spherical_kernel, c)
                                                 : DR3_PICK(warp_cylindrical_kernel, c);
  return launch_tiled(kernel, kind == kHomography ? kTileRowsOf<kHomography> : kTileRowsOf<kSpherical>,
                      src, h, w, c, nullptr, prm, ho, wo, 0, fill, out, valid, stream);
}

// The tiles of an [ho, wo] homography warp of an [h, w] source through H^-1
// = (h0 .. h8) that dr3_warp writes as fill without sampling: grid (host
// memory, 2 ints) gets the tiles down and across; tiles, when not null, one
// bool a tile, row-major.
extern "C" int dr3_warp_shortcut_tiles(float h0, float h1, float h2, float h3, float h4,
                                       float h5, float h6, float h7, float h8, int h, int w,
                                       int ho, int wo, bool* tiles, int* grid, void* stream) {
  const dim3 g = tile_grid(kTileRowsOf<kHomography>, ho, wo);
  grid[0] = static_cast<int>(g.y);
  grid[1] = static_cast<int>(g.x);
  if (tiles == nullptr || ho <= 0 || wo <= 0) return static_cast<int>(cudaGetLastError());
  if (g.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const WarpParams prm = {{h0, h1, h2, h3, h4, h5, h6, h7, h8}};
  shortcut_tiles_kernel<<<g, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(prm, h, w, ho, wo,
                                                                             tiles);
  return static_cast<int>(cudaGetLastError());
}
