// K3: fused corner response — FAST-10 score, strict 3x3 NMS and Shi-Tomasi
// min-eigenvalue in one pass over the levels of a detection pyramid.
//
// Replaces the Pallas kernel dr3_tpu/ops/pallas/detect_pallas.py:54
// (_detect_kernel, called through corner_response_map :130 from
// dr3_tpu/ops/corners.py:131). Output equals the jnp oracle
//   where(nms3x3(fast_score_map(img, t)), shi_tomasi_map(img), 0)
// (corners.py:42-146): FAST score = max over the 16 ring starts of the
// 10-arc minimum of +-(ring - centre), kept where that minimum clears the
// threshold (0-255 units); strict 3x3 NMS; Shi-Tomasi min eigenvalue over
// an 8x8 box [-4, 3] of central differences, divided by 2*64; zero outside
// the inner border [5, H-5) x [5, W-5).
//
// Borders: the oracle shifts with wrap-around rolls (corners.py:34-38, 86,
// 94-95). Every value an inner output depends on lies inside the image —
// NMS reads FAST scores at rows/cols >= 4, whose rings reach >= 1, and the
// box reads gradients at >= 1, whose differences reach >= 0 (symmetrically
// at the far edge) — so the wrap never reaches an inner output, and this
// kernel loads its halo with clamped coordinates instead. Outputs outside
// the inner border are written as 0, as the oracle's mask does.
//
// Exactness: FAST scores are differences, minima and maxima of the same
// float32 values img*255 (scaled once into shared memory, so no FMA can
// fuse the scale into the difference), hence bit-equal to the oracle and
// the corner set is exact. The box sums add separately rounded products in
// the oracle's order (columns -4..3 within a row, then rows -4..3); only
// FMA contraction in the eigenvalue differs, within the tests' rtol.
//
// What bounds it on the card: bytes, one image read and one score write per
// level. The float operations are fewer, because few pixels are corners
// (of the finely textured test renders at threshold 10, 18% pass the
// half-ring test below, 13% have a FAST score and 2.7% survive the NMS);
// tools/bounds.py counts them at what an image needs: a test on every pixel,
// arc minima where it passes, NMS where there is a score, a box per
// survivor. So the design makes a pixel pay only for what it is:
//   * every pixel of a tile takes the half-ring test: a contiguous arc of
//     10 on the 16-ring holds 5 consecutive of its 8 even positions (and so
//     two adjacent compass points, positions 0, 4, 8, 12), so a pixel
//     without 5 consecutive even ring pixels all brighter than centre + t
//     or all darker than centre - t scores 0, reads 8 ring pixels and takes
//     no minimum. The compass pair alone rejects too little on fine
//     texture and is not used on its own;
//   * the pixels that pass are compacted into a list in shared memory (a
//     ballot and one shared-memory atomic a warp) and scored by as many
//     threads, the 10-arc minima by doubling (pairs, fours, eights, and a
//     last pair: 64 min per sign instead of 144), so a warp does not pay a
//     full ring for one candidate among 32;
//   * NMS survivors are compacted the same way and 8 lanes share one
//     survivor's 8x8 box, a row each, summed from the staged image tile:
//     no product or box-sum arrays, two barriers fewer, 14 KB of shared
//     memory a block instead of 46;
//   * one launch takes all levels of a pyramid (a tile list over levels).
// The lists' order depends on the run; each entry's result does not.
#include "common.cuh"

namespace {

constexpr int TW = 32;                  // tile width
constexpr int TH = 32;                  // tile height
constexpr int HALO = 5;
constexpr int SW = TW + 2 * HALO;       // image columns staged
constexpr int SH = TH + 2 * HALO;       // image rows staged
constexpr int FW = TW + 2;              // FAST scores for the NMS
constexpr int FH = TH + 2;
constexpr int NTHREADS = 256;
constexpr int kMaxLevels = 8;
static_assert(FW * FH <= 65536, "list entries are 16 bits");

struct Levels {
  const float* img[kMaxLevels];
  float* out[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
  int tiles_x[kMaxLevels];
  int first[kMaxLevels + 1];            // a level's first tile in the grid
  int n;
};

__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// max over the 16 starts of the 10-arc minimum of d, where it clears the
// threshold: the minima of 2, 4, 8 and 10 consecutive ring values by doubling
__device__ __forceinline__ float arc_score(const float (&d)[16], float threshold) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m2[i] = fminf(d[i], d[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i] = fminf(m2[i], m2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m8[i] = fminf(m4[i], m4[(i + 4) & 15]);
  float best = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float m = fminf(m8[i], m2[(i + 8) & 15]);
    if (m > threshold) best = fmaxf(best, m);
  }
  return best;
}

// 5 consecutive (cyclically) of the 8 bits of m set
__device__ __forceinline__ bool run_of_5(unsigned m) {
  m |= m << 8;
  return (m & (m >> 1) & (m >> 2) & (m >> 3) & (m >> 4) & 0xffu) != 0;
}

// Appends value to list where flag is set: a ballot, one atomic on the
// shared counter for the warp, each lane's slot from the lanes below it.
// Every lane of the warp must call it.
__device__ __forceinline__ void append(unsigned short* list, int* counter, bool flag,
                                       int value) {
  const unsigned ball = __ballot_sync(0xffffffffu, flag);
  if (ball == 0) return;
  const int lane = threadIdx.x % 32;
  int base = 0;
  if (lane == 0) base = atomicAdd(counter, __popc(ball));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (flag) list[base + __popc(ball & ((1u << lane) - 1))] = static_cast<unsigned short>(value);
}

__global__ void __launch_bounds__(NTHREADS)
corner_response_kernel(const Levels lv, float threshold) {
  __shared__ float simg[SH][SW + 1];
  __shared__ float sfast[FH][FW + 1];
  __shared__ unsigned short list[FW * FH];   // candidates, then NMS survivors
  __shared__ int n_cand, n_surv;

  int level = 0;
  while (level + 1 < lv.n && static_cast<int>(blockIdx.x) >= lv.first[level + 1]) ++level;
  const float* __restrict__ img = lv.img[level];
  float* __restrict__ out = lv.out[level];
  const int H = lv.h[level], W = lv.w[level];
  const int tile = blockIdx.x - lv.first[level];
  const int ty0 = tile / lv.tiles_x[level] * TH;
  const int tx0 = tile % lv.tiles_x[level] * TW;
  const int tid = threadIdx.x;

  // 1. image tile with halo, scaled to 0-255 units (clamped loads)
  if (tid == 0) {
    n_cand = 0;
    n_surv = 0;
  }
  for (int e = tid; e < SH * SW; e += NTHREADS) {
    const int r = e / SW;
    const int c = e % SW;
    const int y = min(max(ty0 - HALO + r, 0), H - 1);
    const int x = min(max(tx0 - HALO + c, 0), W - 1);
    simg[r][c] = __ldg(img + y * W + x) * 255.0f;
  }
  __syncthreads();

  // 2. half-ring test on the tile plus a 1-px ring (the NMS neighbours);
  //    whole warps take every pass of the loop, for the ballot
  for (int base = 0; base < FH * FW; base += NTHREADS) {
    const int e = base + tid;
    const int r = e / FW;
    const int c = e % FW;
    const int y = ty0 - 1 + r;
    const int x = tx0 - 1 + c;
    bool pass = false;
    if (e < FH * FW) {
      sfast[r][c] = 0.0f;
      if (y >= 3 && y < H - 3 && x >= 3 && x < W - 3) {
        const float centre = simg[r + 4][c + 4];
        // d > t iff t - d is negative, -d > t iff d + t is (a float difference
        // is zero only between equal values): the masks shift in sign bits
        unsigned bright = 0, dark = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = simg[r + 4 + kRingDy[2 * k]][c + 4 + kRingDx[2 * k]] - centre;
          bright = __funnelshift_l(__float_as_uint(threshold - d), bright, 1);
          dark = __funnelshift_l(__float_as_uint(d + threshold), dark, 1);
        }
        pass = run_of_5(bright) || run_of_5(dark);
      }
    }
    append(list, &n_cand, pass, e);
  }
  __syncthreads();

  // 3. FAST-10 scores of the candidates, a thread each (both signs: scoring
  //    only the sign whose half ring has a run makes the lanes of a warp
  //    diverge and measured slower)
  for (int i = tid; i < n_cand; i += NTHREADS) {
    const int r = list[i] / FW;
    const int c = list[i] % FW;
    const float centre = simg[r + 4][c + 4];
    float d[16], nd[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      d[k] = simg[r + 4 + kRingDy[k]][c + 4 + kRingDx[k]] - centre;
      nd[k] = -d[k];
    }
    sfast[r][c] = fmaxf(arc_score(d, threshold), arc_score(nd, threshold));
  }
  __syncthreads();

  // 4. strict 3x3 NMS and the inner-border mask; zeros everywhere else
  for (int base = 0; base < TH * TW; base += NTHREADS) {
    const int e = base + tid;
    const int r = e / TW;
    const int c = e % TW;
    const int y = ty0 + r;
    const int x = tx0 + c;
    const bool inside = e < TH * TW && y < H && x < W;
    const float f = inside ? sfast[r + 1][c + 1] : 0.0f;
    bool keep = false;
    if (f > 0.0f && y >= 5 && y < H - 5 && x >= 5 && x < W - 5) {
      float neigh = sfast[r][c];
      neigh = fmaxf(neigh, sfast[r][c + 1]);
      neigh = fmaxf(neigh, sfast[r][c + 2]);
      neigh = fmaxf(neigh, sfast[r + 1][c]);
      neigh = fmaxf(neigh, sfast[r + 1][c + 2]);
      neigh = fmaxf(neigh, sfast[r + 2][c]);
      neigh = fmaxf(neigh, sfast[r + 2][c + 1]);
      neigh = fmaxf(neigh, sfast[r + 2][c + 2]);
      keep = f > neigh;
    }
    append(list, &n_surv, keep, e);
    if (inside && !keep) out[y * W + x] = 0.0f;
  }
  __syncthreads();

  // 5. Shi-Tomasi at the survivors: 8 lanes a survivor, a box row each
  //    (columns -4..3 in order), then the rows -4..3 in order
  const float inv = 1.0f / 128.0f;
  const int lane = tid % 32;
  const int row = lane % 8;
  for (int base = tid / 32 * 4; base < n_surv; base += NTHREADS / 8) {
    const int i = base + lane / 8;
    const bool active = i < n_surv;
    const int e = list[active ? i : base];
    const int r = e / TW;
    const int c = e % TW;
    const int sr = r + HALO - 4 + row;      // staged row of this lane's box row
    float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int sc = c + HALO - 4 + k;
      const float gx = simg[sr][sc + 1] - simg[sr][sc - 1];
      const float gy = simg[sr + 1][sc] - simg[sr - 1][sc];
      sxx += __fmul_rn(gx, gx);
      sxy += __fmul_rn(gx, gy);
      syy += __fmul_rn(gy, gy);
    }
    float bxx = 0.0f, bxy = 0.0f, byy = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bxx += __shfl_sync(0xffffffffu, sxx, (lane & 24) + k);
      bxy += __shfl_sync(0xffffffffu, sxy, (lane & 24) + k);
      byy += __shfl_sync(0xffffffffu, syy, (lane & 24) + k);
    }
    if (active && row == 0) {
      const float dxx = bxx * inv;
      const float dyy = byy * inv;
      const float dxy = bxy * inv;
      const float tr = dxx + dyy;
      const float det = dxx * dyy - dxy * dxy;
      out[(ty0 + r) * W + tx0 + c] = 0.5f * (tr - sqrtf(fmaxf(tr * tr - 4.0f * det, 0.0f)));
    }
  }
}

}  // namespace

// imgs, outs: n_levels device pointers each; dims: n_levels rows of (h, w).
extern "C" int dr3_corner_response(int n_levels, const float* const* imgs, const int* dims,
                                   float threshold, float* const* outs, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  lv.n = n_levels;
  int tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = dims[2 * l], w = dims[2 * l + 1];
    if (h < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
    lv.img[l] = imgs[l];
    lv.out[l] = outs[l];
    lv.h[l] = h;
    lv.w[l] = w;
    lv.tiles_x[l] = (w + TW - 1) / TW;
    lv.first[l] = tiles;
    tiles += lv.tiles_x[l] * ((h + TH - 1) / TH);   // none for an empty level
  }
  lv.first[n_levels] = tiles;
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  corner_response_kernel<<<tiles, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, threshold);
  return static_cast<int>(cudaGetLastError());
}
