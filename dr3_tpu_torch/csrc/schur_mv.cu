// The matrix-free reduced camera operator of the generic Schur PCG
// (ba/schur_core.py PCG.s_mv; ops/schur_mv.py wraps it):
//
//   y = keep (Hcc_d xk - W Hpp^-1 W^T xk) + (1 - keep) x,   xk = keep x,
//
// with W never formed: one [C, 3] coupling block AtB_o per observation, and
// the point and camera sums taken over the keyed tables that
// schur_core._table_reducer keeps (row ids in index order, padded with O).
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA.
// The port ran them as two [O, C, 3] einsums that torch lowers to cuBLAS
// batched GEMVs over O tiny matrices, with a gather before each and a table
// sum after; at Ladybug-1723's counts (1,723 cameras, 156,502 points,
// 678,718 observations) the GEMVs alone took ~1.7 ms a CG iteration.
//
// Two kernels, one launch each per product:
//
// * schur_mv_point_kernel: one thread a point p walks its row of the point
//   table in order: u_p = sum_o AtB_o^T xk[cam_o], then v_p = Hpp^-1_p u_p.
// * schur_mv_camera_kernel: one block of kCamThreads a camera k walks its
//   row of the camera table, thread t taking the slots t, t + kCamThreads,
//   ... in order, sums the block's partials of sum_o AtB_o v[pt_o] by a
//   halving tree (shared memory to 32 lanes, then warp shuffles), and lane
//   0 of the warp that owns output c writes y_kc with the keep / fixed
//   blend.
//
// What bounds it on the card: the bytes. Each pass reads every coupling
// block (27 floats an observation at C = 9; 73 MB at Ladybug's counts, more
// than L2 holds) and the ids that lead to it; the operations are ~60 an
// observation. A point's observations lie far apart in the observation
// order, so the point pass gathers whole blocks (each 108 bytes, read by one
// thread, its sectors shared through L1 with its neighbours'); a camera's
// observations are usually a contiguous run, so the camera pass reads its
// blocks nearly coalesced. Every point and every camera is resident at once
// (one wave of blocks), so the card keeps many gathers in flight.
//
// Determinism: no float atomics. Every sum has a fixed order (a point's
// table row in order; a camera's slots by thread, then the fixed tree), so
// two runs give the same bits. The arithmetic is written with
// round-to-nearest intrinsics, no fused multiply-add, in the order of the
// plain version (ops/schur_mv.py _schur_mv_plain), all in float32.
#include "common.cuh"

namespace {

constexpr int kPtThreads = 128;
// the camera pass's lanes: ops/schur_mv.py CAM_THREADS, whose order the
// plain version follows
constexpr int kCamThreads = 128;
constexpr int kCamWarps = kCamThreads / 32;
static_assert(kCamThreads == 128, "the tree halves 128 -> 64 -> 32 in shared memory");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// grid ceil(P / kPtThreads)
template <int C>
__global__ void __launch_bounds__(kPtThreads)
schur_mv_point_kernel(const float* __restrict__ AtB, const long long* __restrict__ obs_cam,
                      const long long* __restrict__ pt_table, int d_pt,
                      const float* __restrict__ Hpp_inv, const float* __restrict__ keep,
                      const float* __restrict__ x, long long O, int P,
                      float* __restrict__ v) {
  const int p = blockIdx.x * kPtThreads + threadIdx.x;
  if (p >= P) return;
  const long long* row = pt_table + static_cast<long long>(p) * d_pt;
  float u0 = 0.0f, u1 = 0.0f, u2 = 0.0f;
  for (int d = 0; d < d_pt; ++d) {
    const long long o = row[d];
    if (o < 0 || o >= O) continue;                  // the table's padding
    const long long k = obs_cam[o];
    const float kp = keep[k];
    const float* a = AtB + o * (3 * C);
    const float* xr = x + k * C;
    // t = AtB_o^T xk, its C terms in order
    float xk = mul(xr[0], kp);
    float t0 = mul(a[0], xk), t1 = mul(a[1], xk), t2 = mul(a[2], xk);
#pragma unroll
    for (int c = 1; c < C; ++c) {
      xk = mul(xr[c], kp);
      t0 = add(t0, mul(a[3 * c], xk));
      t1 = add(t1, mul(a[3 * c + 1], xk));
      t2 = add(t2, mul(a[3 * c + 2], xk));
    }
    u0 = add(u0, t0);
    u1 = add(u1, t1);
    u2 = add(u2, t2);
  }
  const float* h = Hpp_inv + 9LL * p;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v[3LL * p + i] = add(add(mul(h[3 * i], u0), mul(h[3 * i + 1], u1)), mul(h[3 * i + 2], u2));
}

// grid K: block k is camera k
template <int C>
__global__ void __launch_bounds__(kCamThreads)
schur_mv_camera_kernel(const float* __restrict__ AtB, const long long* __restrict__ obs_pt,
                       const long long* __restrict__ cam_table, int d_cam,
                       const float* __restrict__ v, const float* __restrict__ Hcc_d,
                       const float* __restrict__ keep, const float* __restrict__ x,
                       long long O, float* __restrict__ y) {
  __shared__ float part[C][kCamThreads];
  const int k = blockIdx.x, t = threadIdx.x;
  const long long* row = cam_table + static_cast<long long>(k) * d_cam;
  float s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.0f;
  for (int d = t; d < d_cam; d += kCamThreads) {
    const long long o = row[d];
    if (o < 0 || o >= O) continue;                  // the table's padding
    const long long p = obs_pt[o];
    const float v0 = v[3 * p], v1 = v[3 * p + 1], v2 = v[3 * p + 2];
    const float* a = AtB + o * (3 * C);
#pragma unroll
    for (int c = 0; c < C; ++c)
      s[c] = add(s[c], add(add(mul(a[3 * c], v0), mul(a[3 * c + 1], v1)), mul(a[3 * c + 2], v2)));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) part[c][t] = s[c];
  __syncthreads();
  if (t < 64) {
#pragma unroll
    for (int c = 0; c < C; ++c) part[c][t] = add(part[c][t], part[c][t + 64]);
  }
  __syncthreads();
  const int warp = t / 32, lane = t % 32;
  const long long kc = static_cast<long long>(k) * C;
  const float kp = keep[k];
  for (int c = warp; c < C; c += kCamWarps) {
    float r = add(part[c][lane], part[c][lane + 32]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) r = add(r, __shfl_down_sync(0xffffffffu, r, off));
    if (lane == 0) {
      // (Hcc_d xk)_c, its C terms in order
      const float* h = Hcc_d + kc * C + c * C;
      float hx = mul(h[0], mul(x[kc], kp));
#pragma unroll
      for (int e = 1; e < C; ++e) hx = add(hx, mul(h[e], mul(x[kc + e], kp)));
      y[kc + c] = add(mul(sub(hx, r), kp), mul(x[kc + c], sub(1.0f, kp)));
    }
  }
}

template <int C>
void launch(const float* AtB, const long long* obs_cam, const long long* obs_pt,
            const long long* pt_table, int d_pt, const long long* cam_table, int d_cam,
            const float* Hpp_inv, const float* Hcc_d, const float* keep, const float* x,
            long long O, int P, int K, float* v, float* y, cudaStream_t stream) {
  if (P > 0) {
    schur_mv_point_kernel<C><<<(P + kPtThreads - 1) / kPtThreads, kPtThreads, 0, stream>>>(
        AtB, obs_cam, pt_table, d_pt, Hpp_inv, keep, x, O, P, v);
  }
  if (K > 0) {
    schur_mv_camera_kernel<C><<<K, kCamThreads, 0, stream>>>(
        AtB, obs_pt, cam_table, d_cam, v, Hcc_d, keep, x, O, y);
  }
}

}  // namespace

// C, the camera block's size: 9 (BAL's Snavely cameras) or 6 (the VO
// window's poses); any other is refused with cudaErrorInvalidValue
extern "C" int dr3_schur_mv(const float* AtB, const long long* obs_cam, const long long* obs_pt,
                            const long long* pt_table, int d_pt, const long long* cam_table,
                            int d_cam, const float* Hpp_inv, const float* Hcc_d,
                            const float* keep, const float* x, long long O, int P, int K,
                            int C, float* v, float* y, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (C == 9) {
    launch<9>(AtB, obs_cam, obs_pt, pt_table, d_pt, cam_table, d_cam, Hpp_inv, Hcc_d, keep, x,
              O, P, K, v, y, s);
  } else if (C == 6) {
    launch<6>(AtB, obs_cam, obs_pt, pt_table, d_pt, cam_table, d_cam, Hpp_inv, Hcc_d, keep, x,
              O, P, K, v, y, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
