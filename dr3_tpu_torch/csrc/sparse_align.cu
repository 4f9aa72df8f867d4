// K2 in its loop: sparse image alignment, the whole LM chain in one launch.
//
// Replaces, together with csrc/sample.cu, the Pallas kernel
// dr3_tpu/ops/pallas/lk_pallas.py:338 (_sample_kernel, reached through
// sample_patches_pallas :374 from dr3_tpu/ops/sparse_align.py:56-68) where
// that kernel does its work: inside sparse_align's lax.fori_loop
// (dr3_tpu/ops/sparse_align.py:144-167), which on the TPU is one jitted
// program. Here the loop is one kernel: the reference patches and their
// gradients, iters + 1 evaluations of the normal equations (each a patch
// sample of the current image, dr3::sample_clamp_from, the arithmetic of
// sample.cu), the damped 6x6 Cholesky solve, SE3.exp, the pose update and
// the accept test, as dr3_tpu_torch/ops/sparse_align.py _sparse_align_plain
// computes them.
//
// What bounds it on the card: nothing the card counts. 546 points of 5x5
// pixels are 13,650 residuals an evaluation, about half a million float
// operations and 0.2 MB; 13 evaluations are a dependent chain, each waiting
// for the solve before it. The time is that chain's latency.
// What the design does about it:
//   * one thread block cluster of kCluster blocks, each with a share of the
//     points; an evaluation ends in one cluster barrier, after which every
//     block adds the blocks' partial sums from distributed shared memory in
//     rank order and runs the solve itself, so the blocks hold the same
//     pose bit for bit and nothing is broadcast;
//   * kLanes lanes share a point: each computes the point's projection,
//     samples every kLanes-th pixel of its patch, and after a shuffle
//     reduction lanes 0-5 each add one row of the point's H and one entry
//     of b, lane 6 the cost;
//   * H is taken per point as J_uv^T (sum g g^T) J_uv with the 2x2 sum of
//     the reference gradients taken once, not per pixel as the plain
//     version's einsum does: a few per-pixel operations are left (sample,
//     residual, two multiply-adds), at another rounding of H;
//   * the current image is staged once in shared memory with cp.async while
//     the reference stage runs; an image that does not fit is sampled from
//     global memory by the same kernel (kStaged false);
//   * the reference stage samples a point's (W + 2)^2 patch once into
//     shared memory, its lanes' loads in flight together, and takes P_ref
//     and both central differences from it (sampling the five neighbours
//     of every pixel on their own waited for global memory 20 times a lane);
//   * the solve on one thread is a chain of dependent steps: it multiplies
//     by the Cholesky diagonal's reciprocals instead of dividing 27 times
//     (lm_solve), and reads the system where the sums left it: of two
//     buffers one holds the system at T_best and the next trial writes the
//     other, so an accepted step copies nothing;
//   * P_ref, gx, gy of a block's points stay in shared memory for all
//     evaluations (a scratch buffer in global memory where they do not
//     fit): any N and any W launch, with no compile-time pixel count;
//   * every sum is taken in a fixed order (lane partials, xor shuffles,
//     warps in order, blocks in rank order) and there is no float atomic:
//     two launches give the same bits.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;            // blocks of the one cluster
constexpr int kLanes = 8;              // lanes that share a point
constexpr int kMaxThreads = 640;       // 102 registers a thread
constexpr int kSums = 7;               // a lane's sums: a row of H and b, or the cost
constexpr int kPart = kLanes * kSums;  // a block's partial sums
constexpr int kPointFloats = 8;        // X (3), w, Gxx, Gxy, Gyy, pad
constexpr size_t kBlockSmem = 232448;  // shared memory one block may hold

struct AlignArgs {
  const float* img_ref;
  int hr, wr;
  const float* img_cur;
  int hc, wc;
  const float* q_ref;   // [4] wxyz
  const float* t_ref;   // [3]
  const float* q_init;
  const float* t_init;
  const float* fx;      // level-0 intrinsics, one float each
  const float* fy;
  const float* cx;
  const float* cy;
  float scale;          // 2^-level
  const float* pts;     // [n, 3]
  const unsigned char* valid;  // [n]
  int n, half, iters;
  int slice;            // points of one block
  int groups;           // groups of kLanes lanes in a block
  int tmpl_in_smem;     // P_ref, gx, gy in shared memory (else in scratch)
  float* scratch;       // [3, n, P]
  float* out;           // q [4], t [3], cost0, cost
  long long* n_used;
};

// The LM state, kept by thread 0 of every block (identical in all).
struct LmState {
  float q[4], t[3];     // T_best
  float nq[4], nt[3];   // the trial pose
  float best, cost0, lam;
  int at;               // which of the two system buffers holds T_best's
};

__device__ __forceinline__ void quat_normalize(const float (&q)[4], float (&out)[4]) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = q[i] / n;
}

// quat_rotate (geometry/lie.py:46): v + 2 (w qv x v + qv x (qv x v))
__device__ __forceinline__ void quat_rotate(const float (&q)[4], const float (&v)[3],
                                            float (&out)[3]) {
  const float ux = q[2] * v[2] - q[3] * v[1];
  const float uy = q[3] * v[0] - q[1] * v[2];
  const float uz = q[1] * v[1] - q[2] * v[0];
  const float uux = q[2] * uz - q[3] * uy;
  const float uuy = q[3] * ux - q[1] * uz;
  const float uuz = q[1] * uy - q[2] * ux;
  out[0] = v[0] + 2.0f * (q[0] * ux + uux);
  out[1] = v[1] + 2.0f * (q[0] * uy + uuy);
  out[2] = v[2] + 2.0f * (q[0] * uz + uuz);
}

__device__ __forceinline__ float guard_z(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

__device__ __forceinline__ float pick6(const float (&v)[6], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : i == 3 ? v[3] : i == 4 ? v[4] : v[5];
}

// Sum over the kLanes lanes that share a point; every lane gets it.
__device__ __forceinline__ float point_sum(float v) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Starts the copy of count floats from img to dst (16-byte aligned).
__device__ void stage_image(const float* img, int count, float* dst) {
  const int n16 = (reinterpret_cast<uintptr_t>(img) & 15) == 0 ? count / 4 : 0;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(img + 4 * i));
  }
  for (int i = 4 * n16 + threadIdx.x; i < count; i += blockDim.x) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(img + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// delta = (H + lam diag(H) + 1e-8 I)^-1 b by the unrolled Cholesky of
// geometry/linalg.py chol_solve_small, in its elimination order. The solve
// is a chain of dependent steps on one thread, 27 divisions by the
// diagonal among them; here each diagonal entry is inverted once, off the
// chain, and the divisions become products (the products and differences
// fused). That rounds an entry within an ulp or two of the plain version's,
// far below what the sums' order moves H and b by.
// S: the system's sums, row i of H at S[i kSums + 0..5], b[i] at S[i kSums + 6].
__device__ void lm_solve(const float* S, float lam, float (&delta)[6]) {
  float L[6][6], inv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float v = S[i * kSums + j];
      if (i == j) v = (v + lam * v) + 1e-8f;
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = sqrtf(fmaxf(v, 1e-20f));
        inv[i] = 1.0f / L[i][i];
      } else {
        L[i][j] = v * inv[j];
      }
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = S[i * kSums + 6];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * delta[k];
    delta[i] = v * inv[i];
  }
}

// (nq, nt) = (SE3.exp(delta) @ (q, t)).normalize(), geometry/lie.py:120-129,
// :158-174, :196-198, with both Taylor guards.
__device__ void lm_update(const float (&delta)[6], LmState& s) {
  const float rho[3] = {delta[0], delta[1], delta[2]};
  const float om[3] = {delta[3], delta[4], delta[5]};
  const float theta_sq = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
  const bool taylor = theta_sq < 1e-8f;
  const float safe_sq = taylor ? 1.0f : theta_sq;
  const float theta = sqrtf(safe_sq);
  const float half = 0.5f * theta;
  const float k = taylor ? 0.5f - theta_sq / 48.0f : sinf(half) / theta;
  const float dq[4] = {taylor ? 1.0f - theta_sq / 8.0f : cosf(half), k * om[0], k * om[1],
                       k * om[2]};
  const float A = taylor ? 0.5f - theta_sq / 24.0f : (1.0f - cosf(theta)) / safe_sq;
  const float B = taylor ? 1.0f / 6.0f - theta_sq / 120.0f
                         : (theta - sinf(theta)) / (safe_sq * theta);
  // V rho = rho + A om x rho + B om x (om x rho)
  const float c1[3] = {om[1] * rho[2] - om[2] * rho[1], om[2] * rho[0] - om[0] * rho[2],
                       om[0] * rho[1] - om[1] * rho[0]};
  const float c2[3] = {om[1] * c1[2] - om[2] * c1[1], om[2] * c1[0] - om[0] * c1[2],
                       om[0] * c1[1] - om[1] * c1[0]};
  float dqn[4], rt[3], prod[4];
  quat_normalize(dq, dqn);
  quat_rotate(dqn, s.t, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) s.nt[i] = rt[i] + (rho[i] + A * c1[i] + B * c2[i]);
  const float* q = s.q;
  prod[0] = dq[0] * q[0] - dq[1] * q[1] - dq[2] * q[2] - dq[3] * q[3];
  prod[1] = dq[0] * q[1] + dq[1] * q[0] + dq[2] * q[3] - dq[3] * q[2];
  prod[2] = dq[0] * q[2] - dq[1] * q[3] + dq[2] * q[0] + dq[3] * q[1];
  prod[3] = dq[0] * q[3] + dq[1] * q[2] - dq[2] * q[1] + dq[3] * q[0];
  quat_normalize(prod, s.nq);
}

template <bool kStaged>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
sparse_align_kernel(const AlignArgs a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[kMaxThreads / 32][kPart];  // the warps' partial sums
  __shared__ float part[2][kPart];                // this block's, read by all blocks
  __shared__ float sys[2][kPart];                 // the cluster's: H rows, b, cost; the
                                                  // system at T_best and the trial's
  __shared__ float pose[8];                       // evaluation pose: unit q, t
  __shared__ int s_used;
  __shared__ LmState lm;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane8 = tid % kLanes;
  const int n_groups = blockDim.x / kLanes;
  const int W = 2 * a.half + 1;
  const int P = W * W;
  // a lane's pixels are p = lane8, lane8 + kLanes, ...: the first one's patch
  // offsets, and the step to the next (no division in the loops)
  const int dx0 = lane8 % W - a.half, dy0 = lane8 / W - a.half;
  const int step_x = kLanes % W, step_y = kLanes / W;
  const int p0 = rank * a.slice;
  const int n_loc = max(0, min(a.slice, a.n - p0));

  // shared memory: the points' constants, a (W + 2)^2 reference patch per
  // group of lanes, then P_ref / gx / gy, then the image
  const int WB = W + 2;
  const int PB = (WB * WB + 3) & ~3;
  float* pc = dyn;
  float* big = pc + a.slice * kPointFloats + (tid / kLanes) * PB;
  float* tmpl_smem = pc + a.slice * kPointFloats + a.groups * PB;
  const int tmpl_stride = a.tmpl_in_smem ? a.slice * P : a.n * P;
  float* tmpl = a.tmpl_in_smem ? tmpl_smem : a.scratch + static_cast<long long>(p0) * P;
  float* simg = tmpl_smem + (a.tmpl_in_smem ? ((3 * a.slice * P + 3) & ~3) : 0);
  const float* cur = kStaged ? simg : a.img_cur;
  if (kStaged) stage_image(a.img_cur, a.hc * a.wc, simg);
  if (tid == 0) s_used = 0;
  __syncthreads();

  const float fx = __ldg(a.fx) * a.scale, fy = __ldg(a.fy) * a.scale;
  const float cx = __ldg(a.cx) * a.scale, cy = __ldg(a.cy) * a.scale;

  // the start pose, read now so that its loads wait beside the reference stage
  const float qi[4] = {__ldg(a.q_init), __ldg(a.q_init + 1), __ldg(a.q_init + 2),
                       __ldg(a.q_init + 3)};
  const float ti[3] = {__ldg(a.t_init), __ldg(a.t_init + 1), __ldg(a.t_init + 2)};

  // ---- reference stage: P_ref, gx, gy, the 2x2 gradient sums, the mask
  {
    const float qr[4] = {__ldg(a.q_ref), __ldg(a.q_ref + 1), __ldg(a.q_ref + 2),
                         __ldg(a.q_ref + 3)};
    float qn[4];
    quat_normalize(qr, qn);
    const float m = static_cast<float>(a.half);
    // a warp's groups run the same number of passes, for the shuffles
    for (int base = (tid / 32) * (32 / kLanes); base < n_loc; base += n_groups) {
      const int pt = base + (tid % 32) / kLanes;
      const bool active = pt < n_loc;
      const float* Xp = a.pts + 3 * static_cast<long long>(p0 + (active ? pt : 0));
      const float X[3] = {__ldg(Xp), __ldg(Xp + 1), __ldg(Xp + 2)};
      float xc[3];
      quat_rotate(qn, X, xc);
#pragma unroll
      for (int i = 0; i < 3; ++i) xc[i] += __ldg(a.t_ref + i);
      const float z = guard_z(xc[2]);
      const float u = fx * (xc[0] / z) + cx;
      const float v = fy * (xc[1] / z) + cy;
      // the (W + 2)^2 patch around the projection, each sample once: the
      // centre patch and both central differences come from it
      if (active) {
        int bx = lane8 % WB - a.half - 1, by = lane8 / WB - a.half - 1;
#pragma unroll 4
        for (int p = lane8; p < WB * WB; p += kLanes) {
          big[p] = dr3::sample_clamp(a.img_ref, a.hr, a.wr, u + static_cast<float>(bx),
                                     v + static_cast<float>(by));
          bx += kLanes % WB;
          by += kLanes / WB;
          if (bx > a.half + 1) {
            bx -= WB;
            ++by;
          }
        }
      }
      __syncwarp();
      float gxx = 0.0f, gxy = 0.0f, gyy = 0.0f;
      if (active) {
        int dx = dx0, dy = dy0;
        for (int p = lane8; p < P; p += kLanes) {
          const float* b = big + (dy + a.half + 1) * WB + dx + a.half + 1;
          const float gx = (b[1] - b[-1]) * 0.5f;
          const float gy = (b[WB] - b[-WB]) * 0.5f;
          const int at = pt * P + p;
          tmpl[at] = b[0];
          tmpl[tmpl_stride + at] = gx;
          tmpl[2 * tmpl_stride + at] = gy;
          gxx += gx * gx;
          gxy += gx * gy;
          gyy += gy * gy;
          dx += step_x;
          dy += step_y;
          if (dx > a.half) {
            dx -= W;
            ++dy;
          }
        }
      }
      __syncwarp();   // the next pass overwrites the patch
      gxx = point_sum(gxx);
      gxy = point_sum(gxy);
      gyy = point_sum(gyy);
      if (active && lane8 == 0) {
        const bool ref_in = u >= m && u <= static_cast<float>(a.wr - 1) - m && v >= m &&
                            v <= static_cast<float>(a.hr - 1) - m;
        const bool use = a.valid[p0 + pt] != 0 && xc[2] > 1e-3f && ref_in;
        float* c = pc + pt * kPointFloats;
        c[0] = X[0];
        c[1] = X[1];
        c[2] = X[2];
        c[3] = use ? 1.0f : 0.0f;
        c[4] = gxx;
        c[5] = gxy;
        c[6] = gyy;
        if (use) atomicAdd(&s_used, 1);
      }
    }
  }
  if (tid == 0) {
    lm.at = 1;
    float qn[4];
    quat_normalize(qi, qn);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lm.q[i] = qi[i];
      pose[i] = qn[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      lm.t[i] = ti[i];
      pose[4 + i] = ti[i];
    }
  }
  if (kStaged) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- iters + 1 evaluations, each followed by the LM step on thread 0
  for (int e = 0; e <= a.iters; ++e) {
    const float q[4] = {pose[0], pose[1], pose[2], pose[3]};
    const float t[3] = {pose[4], pose[5], pose[6]};
    const int trial = lm.at ^ 1;   // the buffer this evaluation's sums go to
    float acc[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
    for (int base = (tid / 32) * (32 / kLanes); base < n_loc; base += n_groups) {
      const int pt = base + (tid % 32) / kLanes;
      const bool active = pt < n_loc;
      const float* c = pc + (active ? pt : 0) * kPointFloats;
      const float X[3] = {c[0], c[1], c[2]};
      float xc[3];
      quat_rotate(q, X, xc);
#pragma unroll
      for (int i = 0; i < 3; ++i) xc[i] += t[i];
      const float z = guard_z(xc[2]);
      const float u = fx * (xc[0] / z) + cx;
      const float v = fy * (xc[1] / z) + cy;
      float sgx = 0.0f, sgy = 0.0f, srr = 0.0f;
      if (active) {
        int dx = dx0, dy = dy0;
#pragma unroll 4
        for (int p = lane8; p < P; p += kLanes) {
          const float x = u + static_cast<float>(dx);
          const float y = v + static_cast<float>(dy);
          const int at = pt * P + p;
          const float r =
              dr3::sample_clamp_from<!kStaged>(cur, a.hc, a.wc, x, y) - tmpl[at];
          sgx += tmpl[tmpl_stride + at] * r;
          sgy += tmpl[2 * tmpl_stride + at] * r;
          srr += r * r;
          dx += step_x;
          dy += step_y;
          if (dx > a.half) {
            dx -= W;
            ++dy;
          }
        }
      }
      sgx = point_sum(sgx);
      sgy = point_sum(sgy);
      srr = point_sum(srr);
      if (active) {
        const float wi = c[3] * (xc[2] > 1e-3f ? 1.0f : 0.0f);
        if (lane8 < 6) {
          // J_uv = J_proj [I | -hat(xc)], rows for u and v
          const float inv_z = 1.0f / z;
          const float a0 = fx * inv_z, a2 = -fx * (xc[0] * inv_z) * inv_z;
          const float b1 = fy * inv_z, b2 = -fy * (xc[1] * inv_z) * inv_z;
          const float ju[6] = {a0, 0.0f, a2, a2 * xc[1], a0 * xc[2] - a2 * xc[0], -a0 * xc[1]};
          const float jv[6] = {0.0f, b1, b2, b2 * xc[1] - b1 * xc[2], -b2 * xc[0], b1 * xc[0]};
          const float jl0 = pick6(ju, lane8), jl1 = pick6(jv, lane8);
          const float ga = c[4] * jl0 + c[5] * jl1;
          const float gc = c[5] * jl0 + c[6] * jl1;
#pragma unroll
          for (int k = 0; k < 6; ++k) acc[k] += wi * (ga * ju[k] + gc * jv[k]);
          acc[6] -= wi * (jl0 * sgx + jl1 * sgy);
        } else if (lane8 == 6) {
          acc[6] += wi * srr;
        }
      }
    }
    // the warp's groups, then the block's warps in order
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 8);
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 16);
    }
    if (tid % 32 < kLanes) {
#pragma unroll
      for (int i = 0; i < kSums; ++i) red[tid / 32][lane8 * kSums + i] = acc[i];
    }
    __syncthreads();
    const int par = e & 1;
    {
      // 4 adjacent lanes a sum, every 4th warp each, where the block has the
      // threads; the same order in every launch
      const int n_warps = static_cast<int>(blockDim.x) / 32;
      const int ways = static_cast<int>(blockDim.x) >= 4 * kPart ? 4 : 1;
      if (tid < ways * kPart) {
        float s = 0.0f;
        for (int w = tid % ways; w < n_warps; w += ways) s += red[w][tid / ways];
        if (ways == 4) {
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
        }
        if (tid % ways == 0) part[par][tid / ways] = s;
      }
    }
    cluster.sync();
    if (tid < kPart) {
      float s = 0.0f;
      for (int r = 0; r < kCluster; ++r) s += *cluster.map_shared_rank(&part[par][tid], r);
      sys[trial][tid] = s;
    }
    __syncthreads();

    if (tid == 0) {
      const float cost = 0.5f * sys[trial][6 * kSums + 6];
      const bool ok = e == 0 || (cost < lm.best && isfinite(cost));
      if (e == 0) {
        lm.cost0 = cost;
        lm.lam = 1e-3f;
      } else {
        lm.lam = ok ? fmaxf(lm.lam / 2.0f, 1e-8f) : fminf(lm.lam * 4.0f, 1e4f);
      }
      if (ok) {
        lm.best = cost;
        lm.at = trial;             // system reuse: the trial's sums are T_best's now
        if (e > 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) lm.q[i] = lm.nq[i];
#pragma unroll
          for (int i = 0; i < 3; ++i) lm.t[i] = lm.nt[i];
        }
      }
      if (e < a.iters) {
        float delta[6];
        lm_solve(sys[lm.at], lm.lam, delta);
        lm_update(delta, lm);
        float qn[4];
        quat_normalize(lm.nq, qn);
#pragma unroll
        for (int i = 0; i < 4; ++i) pose[i] = qn[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) pose[4 + i] = lm.nt[i];
      }
    }
    __syncthreads();
  }

  if (rank == 0 && tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a.out[i] = lm.q[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) a.out[4 + i] = lm.t[i];
    a.out[7] = lm.cost0;
    a.out[8] = lm.best;
    long long used = 0;
    for (int r = 0; r < kCluster; ++r) used += *cluster.map_shared_rank(&s_used, r);
    *a.n_used = used;
  }
  cluster.sync();  // no block leaves while another may read its shared memory
}

template <bool kStaged>
cudaError_t launch(const AlignArgs& a, int threads, size_t smem, size_t budget,
                   cudaStream_t stream) {
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(sparse_align_kernel<kStaged>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(budget));
    if (e != cudaSuccess) return e;
    allowed = true;
  }
  sparse_align_kernel<kStaged><<<kCluster, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// pose: T_ref's q [4] and t [3], T_init's q and t; intr: fx, fy, cx, cy of
// level 0, one device float each; scale 2^-level. out: q [4], t [3], cost0,
// cost; n_used one int64; scratch [3, n, P] floats.
extern "C" int dr3_sparse_align(const float* img_ref, int hr, int wr, const float* img_cur,
                                int hc, int wc, const float* q_ref, const float* t_ref,
                                const float* q_init, const float* t_init, const float* fx,
                                const float* fy, const float* cx, const float* cy,
                                float scale, const float* pts, const unsigned char* valid,
                                int n, int half, int iters, float* scratch, float* out,
                                long long* n_used, void* stream) {
  if (n < 0 || half < 0 || iters < 0 || hr <= 0 || wr <= 0 || hc <= 0 || wc <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static size_t budget = 0;
  if (budget == 0) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, sparse_align_kernel<true>);
    if (e != cudaSuccess) return static_cast<int>(e);
    budget = kBlockSmem - attr.sharedSizeBytes;
  }
  AlignArgs a = {img_ref, hr, wr, img_cur, hc, wc, q_ref, t_ref, q_init, t_init,
                 fx, fy, cx, cy, scale, pts, valid, n, half, iters,
                 0, 0, 0, scratch, out, n_used};
  const long long P = static_cast<long long>(2 * half + 1) * (2 * half + 1);
  a.slice = n > 0 ? (n + kCluster - 1) / kCluster : 1;
  // a group of kLanes lanes a point, in one pass where the block can hold them
  const long long want = (static_cast<long long>(a.slice) * kLanes + 31) / 32 * 32;
  const int threads = static_cast<int>(want < 64 ? 64 : want > kMaxThreads ? kMaxThreads : want);
  a.groups = threads / kLanes;
  const long long PB = ((2 * half + 3) * (2 * half + 3) + 3) & ~3LL;
  size_t smem = sizeof(float) * (kPointFloats * a.slice + a.groups * PB);
  if (smem > budget) return static_cast<int>(cudaErrorInvalidValue);
  const size_t tmpl = sizeof(float) * ((3 * a.slice * P + 3) & ~3LL);
  a.tmpl_in_smem = smem + tmpl <= budget;
  if (a.tmpl_in_smem) smem += tmpl;
  smem = (smem + 15) & ~static_cast<size_t>(15);
  const size_t img = sizeof(float) * hc * wc;
  const bool staged = smem + img <= budget;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = staged ? launch<true>(a, threads, smem + img, budget, s)
                               : launch<false>(a, threads, smem, budget, s);
  return static_cast<int>(e);
}
