// The reduced camera matrix of BAL bundle adjustment from co-visible 9x9
// blocks (ba/snavely.py, the zexplicit solve; ops/schur.py wraps it).
//
// Replaces no Pallas kernel: the JAX package's zexplicit scatters a dense
// [3P, 9K] Z and leaves Z^T Z to XLA as one matrix product. The port did the
// same, and on Dubrovnik-88's counts (88 cameras, 64,298 points, 383,937
// observations) that product was a 2.4e11-flop SIMT SGEMM over a 611 MB Z of
// which 93% is zeros: a point's three rows are non-zero only in the columns of
// the ~6 cameras that see it.
//
// Two kernels, one launch each per LM iteration. Observations are taken in
// camera order (position q holds observation cam_obs[q]: each camera's in
// index order), and a factor row is 9 columns of (g0, g1, g2, 0), 36 floats.
//
// * schur_factor_kernel: per observation o of point p, the 3x9 factor
//   G_o = L_p^T Jp_o^T Jc_o with L_p L_p^T the point's damped inverse
//   (ops/schur.py _inv3x3_flat, _chol3_flat); per camera the column sums of
//   squares of its G_o (Z's column norms) and from them dinv = D^-1/2, the
//   Jacobi scaling of the reduced system; G_o diag dinv_c as row q of Gs;
//   per point the damped inverse itself (Hinv9), which the right-hand side
//   and the back-substitution read.
// * schur_blocks_kernel: one thread block per camera block (i <= j) sums the
//   block's co-visible pairs of rows, each Gs_qi^T Gs_qj (two observations
//   of a point by one camera are a pair of the diagonal block in each
//   order), negates, adds the damped Hcc on the diagonal and writes the 9x9
//   block of S~ = D^-1/2 (Hcc_d - Z^T Z) D^-1/2 and its mirror.
//
// What bounds it on the card: the block kernel stages two rows (2 x 144
// bytes) for each of the ~1.39M pairs, about 400 MB through L2 an
// iteration, for about 0.67 GFLOP (486 flops a pair); the unique bytes (the
// factors' 27 floats an observation 41 MB, the pair list 11 MB, S 2.5 MB)
// take ~16 us at 3.35 TB/s. What
// bounds it in practice is the order: each entry is one owner's chain over
// its block's pairs, and the diagonal blocks, the longest (~4,400 pairs
// here), run their chains from shared memory at ~80 ns a pair while the
// rest of the card has finished (PERF.md, section 6). The design: pairs are
// sorted by (camera block, point) once per solve, so each block reads a
// contiguous range; each of 27 lanes owns three entries of one row of the
// block (one shared-memory read of the row's column serves all three) and
// adds the pairs in that order, while the block's copies (cp.async, no
// registers) keep the next three chunks of 32 pairs in flight, their row
// ids three chunks further ahead (plain loads into two buffers, one barrier
// a chunk, timed 13% slower: 397 us against 351 on an H100); a block is
// small (64 threads, 38 KB), so several share an SM. The factor kernel
// builds a camera's next 512 factors while one warp adds the last 512
// squares into the column sums, stages each chunk's rows in shared memory
// to write them whole, and scales the camera's rows once its dinv is known.
//
// Determinism: no float atomics. Every entry of S and of the column sums
// has one owning thread that adds its terms in a fixed order (the pairs in
// sorted order; the camera's observations in index order), so two runs give
// the same bits. Zero-weight padding rows have zero Jacobians, so their
// factors and every term they bring are exact zeros, wherever they sit in
// the order. The arithmetic is written with round-to-nearest intrinsics, no
// fused multiply-add, in the order of the plain version (ops/schur.py).
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kRow = 36;                   // a factor row: 9 x (g0, g1, g2, 0)
// factor kernel: a camera's observations kFactorChunk at a time, one a
// thread of warps 1.., while lanes 0-8 of warp 0 add the previous chunk's
// squares into their columns' sums (double-buffered)
constexpr int kFactorChunk = 512;
constexpr int kFactorThreads = 32 + kFactorChunk;
// its dynamic shared memory: the squares [2][kFactorChunk][9], the rows
// [kFactorChunk][kRow]
constexpr size_t kFactorSmem = (2 * kFactorChunk * 9 + kFactorChunk * kRow) * sizeof(float);
// block kernel: lane t < kOwners of warp 0 owns entries (a, b0 .. b0 +
// kCols - 1) of the 9x9 block, a = t / (9 / kCols), b0 = kCols (t % (9 /
// kCols)); each of the 2 kChunk threads copies one row of a chunk,
// kStages - 1 chunks ahead
constexpr int kCols = 3;
constexpr int kOwners = 81 / kCols;
constexpr int kChunk = 32;                 // pairs a chunk
constexpr int kStages = 4;
constexpr int kIdSlots = 2 * kStages;      // the ids run kStages - 1 chunks ahead of the rows
constexpr int kBlockThreads = 2 * kChunk;
static_assert(kOwners <= kBlockThreads, "the owners are lanes of the block");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// snavely._inv3x3_flat for one row-major 3x3 block: damped, divided by its
// largest |entry|, adjugate over determinant
__device__ __forceinline__ void damped_inverse(const float* __restrict__ h9, float lam, float* out) {
  const float s = add(1.0f, lam);
  float m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = h9[k];
  m[0] = add(mul(m[0], s), 1e-8f);
  m[4] = add(mul(m[4], s), 1e-8f);
  m[8] = add(mul(m[8], s), 1e-8f);
  float amax = fabsf(m[0]);
#pragma unroll
  for (int k = 1; k < 9; ++k) {
    const float v = fabsf(m[k]);
    amax = (isnan(v) || v > amax) ? v : amax;   // torch.amax keeps NaN
  }
  const float inv_s = dvd(1.0f, clamp_min(amax, 1e-30f));
  const float a = mul(m[0], inv_s), b = mul(m[1], inv_s), c = mul(m[2], inv_s);
  const float d = mul(m[3], inv_s), e = mul(m[4], inv_s), f = mul(m[5], inv_s);
  const float g = mul(m[6], inv_s), h = mul(m[7], inv_s), i = mul(m[8], inv_s);
  const float A00 = sub(mul(e, i), mul(f, h));
  const float A01 = sub(mul(c, h), mul(b, i));
  const float A02 = sub(mul(b, f), mul(c, e));
  const float A10 = sub(mul(f, g), mul(d, i));
  const float A11 = sub(mul(a, i), mul(c, g));
  const float A12 = sub(mul(c, d), mul(a, f));
  const float A20 = sub(mul(d, h), mul(e, g));
  const float A21 = sub(mul(b, g), mul(a, h));
  const float A22 = sub(mul(a, e), mul(b, d));
  const float det = add(add(mul(a, A00), mul(b, A10)), mul(c, A20));
  const float inv_det = dvd(inv_s, fabsf(det) < 1e-20f ? 1e-20f : det);
  out[0] = mul(A00, inv_det); out[1] = mul(A01, inv_det); out[2] = mul(A02, inv_det);
  out[3] = mul(A10, inv_det); out[4] = mul(A11, inv_det); out[5] = mul(A12, inv_det);
  out[6] = mul(A20, inv_det); out[7] = mul(A21, inv_det); out[8] = mul(A22, inv_det);
}

// ops/schur.py _chol3_flat: (l00, l10, l11, l20, l21, l22)
__device__ __forceinline__ void chol3(const float* h, float* l) {
  const float l00 = __fsqrt_rn(clamp_min(h[0], 1e-30f));
  const float l10 = dvd(h[1], l00);
  const float l20 = dvd(h[2], l00);
  const float l11 = __fsqrt_rn(clamp_min(sub(h[4], mul(l10, l10)), 1e-30f));
  const float l21 = dvd(sub(h[5], mul(l20, l10)), l11);
  const float l22 = __fsqrt_rn(clamp_min(sub(sub(h[8], mul(l20, l20)), mul(l21, l21)), 1e-30f));
  l[0] = l00; l[1] = l10; l[2] = l11; l[3] = l20; l[4] = l21; l[5] = l22;
}

// grid: K camera blocks, then ceil(P / kFactorThreads) point blocks
__global__ void __launch_bounds__(kFactorThreads)
schur_factor_kernel(const float* __restrict__ Hpp9, const float* __restrict__ Hcc,
                    const float* __restrict__ lam_p, const float* __restrict__ Jcu,
                    const float* __restrict__ Jcv, const float* __restrict__ Jpu,
                    const float* __restrict__ Jpv, const int* __restrict__ obs_pt,
                    const int* __restrict__ cam_ptr, const int* __restrict__ cam_obs,
                    int K, int P, float* __restrict__ Hinv9, float* __restrict__ Gs,
                    float* __restrict__ dinv) {
  const float lam = *lam_p;
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= K) {
    const int p = (blockIdx.x - K) * kFactorThreads + tid;
    if (p < P) {
      float inv[9];
      damped_inverse(Hpp9 + 9LL * p, lam, inv);
#pragma unroll
      for (int k = 0; k < 9; ++k) Hinv9[9LL * p + k] = inv[k];
    }
    return;
  }
  // camera c: its observations in index order; lane k < 9 of warp 0 owns
  // column k's sum of squares and adds them in that order
  extern __shared__ __align__(16) float smem[];
  float (*sq)[kFactorChunk][9] = reinterpret_cast<float (*)[kFactorChunk][9]>(smem);
  float (*rows)[kRow] = reinterpret_cast<float (*)[kRow]>(smem + 2 * kFactorChunk * 9);
  __shared__ float d[9];
  const int c = blockIdx.x;
  const int beg = cam_ptr[c], end = cam_ptr[c + 1];
  const int n_chunks = (end - beg + kFactorChunk - 1) / kFactorChunk;
  float colsq = 0.0f;
  for (int ch = 0; ch <= n_chunks; ++ch) {
    const int base = beg + ch * kFactorChunk;
    const int n = min(kFactorChunk, end - base);
    if (tid >= 32 && ch < n_chunks && tid - 32 < n) {
      const int q = tid - 32;
      const long long o = cam_obs[base + q];
      const int p = obs_pt[o];
      float inv[9], l[6];
      damped_inverse(Hpp9 + 9LL * p, lam, inv);
      chol3(inv, l);
      // a = L^T Jp^T for the u and v rows; L's columns (l00, l10, l20),
      // (0, l11, l21), (0, 0, l22)
      const float* pu = Jpu + 3 * o;
      const float* pv = Jpv + 3 * o;
      const float au[3] = {add(add(mul(l[0], pu[0]), mul(l[1], pu[1])), mul(l[3], pu[2])),
                           add(mul(l[2], pu[1]), mul(l[4], pu[2])), mul(l[5], pu[2])};
      const float av[3] = {add(add(mul(l[0], pv[0]), mul(l[1], pv[1])), mul(l[3], pv[2])),
                           add(mul(l[2], pv[1]), mul(l[4], pv[2])), mul(l[5], pv[2])};
      const float* cu = Jcu + 9 * o;
      const float* cv = Jcv + 9 * o;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float g0 = add(mul(cu[k], au[0]), mul(cv[k], av[0]));
        const float g1 = add(mul(cu[k], au[1]), mul(cv[k], av[1]));
        const float g2 = add(mul(cu[k], au[2]), mul(cv[k], av[2]));
        *reinterpret_cast<float4*>(&rows[q][4 * k]) = make_float4(g0, g1, g2, 0.0f);
        sq[ch & 1][q][k] = add(add(mul(g0, g0), mul(g1, g1)), mul(g2, g2));
      }
    }
    if (tid < 9 && ch > 0) {   // the previous chunk, while this one is built
      const int n_prev = min(kFactorChunk, end - (base - kFactorChunk));
      const float* col = &sq[(ch - 1) & 1][0][tid];
      for (int q = 0; q < n_prev; ++q) colsq = add(colsq, col[9 * q]);
    }
    __syncthreads();
    if (ch < n_chunks) {       // the chunk's rows, written whole
      float4* dst = reinterpret_cast<float4*>(Gs + static_cast<long long>(base) * kRow);
      const float4* src = reinterpret_cast<const float4*>(&rows[0][0]);
      for (int e = tid; e < n * (kRow / 4); e += kFactorThreads) dst[e] = src[e];
    }
    __syncthreads();
  }
  if (tid < 9) {
    // snavely's Jacobi scaling: diag S = Hcc_d's diagonal less Z's column
    // norms, floored at 1e-10 of it
    const float h = Hcc[81 * c + 10 * tid];
    const float hd = add(h, add(mul(lam, h), 1e-8f));
    const float x = sub(hd, colsq);
    const float y = mul(1e-10f, clamp_min(hd, 1e-20f));
    const float sdiag = (isnan(x) || isnan(y)) ? __int_as_float(0x7fc00000) : fmaxf(x, y);
    d[tid] = dvd(1.0f, __fsqrt_rn(sdiag));
    dinv[9 * c + tid] = d[tid];
  }
  __syncthreads();
  // the camera's rows scaled by its dinv, column k by d_k
  float4* g4 = reinterpret_cast<float4*>(Gs + static_cast<long long>(beg) * kRow);
  for (int e = tid; e < (end - beg) * (kRow / 4); e += kFactorThreads) {
    const float dk = d[e % 9];
    const float4 v = g4[e];
    g4[e] = make_float4(mul(v.x, dk), mul(v.y, dk), mul(v.z, dk), 0.0f);
  }
}

// the 9x9 block's sums over pairs [beg, end) in order, each of the owner's
// kCols entries its own. Chunk ch's two rows a pair sit in g[ch % kStages],
// copied by the group committed kStages - 1 chunks earlier; its row ids in
// ids[ch % kIdSlots], copied kStages - 1 chunks before that
__device__ __forceinline__ void block_sum(float (*g)[kChunk][2 * kRow],
                                          int (*ids)[2][kChunk], const float* Gs,
                                          const int* __restrict__ pi,
                                          const int* __restrict__ pj, int beg, int end,
                                          float* s) {
  const int tid = threadIdx.x;
  const int n_chunks = (end - beg + kChunk - 1) / kChunk;
  // thread t copies row t % kChunk of each chunk, of side t / kChunk
  const int q = tid % kChunk, side = tid / kChunk;
  const int* pid = side ? pj : pi;
  auto copy_id = [&](int ch) {
    const int pos = beg + ch * kChunk + q;
    if (ch < n_chunks && pos < end) __pipeline_memcpy_async(&ids[ch % kIdSlots][side][q], pid + pos, 4);
  };
  auto copy_rows = [&](int ch) {
    const int pos = beg + ch * kChunk + q;
    if (ch < n_chunks && pos < end) {
      float* dst = &g[ch % kStages][q][side * kRow];
      const float* src = Gs + static_cast<long long>(ids[ch % kIdSlots][side][q]) * kRow;
#pragma unroll
      for (int v = 0; v < kRow / 4; ++v) __pipeline_memcpy_async(dst + 4 * v, src + 4 * v, 16);
    }
  };
  // the first kStages - 1 chunks' ids at once, then their rows, each group
  // with the ids of the chunk kStages - 1 further on
  for (int ch = 0; ch < kStages - 1; ++ch) {
    const int pos = beg + ch * kChunk + q;
    if (ch < n_chunks && pos < end) ids[ch % kIdSlots][side][q] = pid[pos];
  }
  for (int ch = 0; ch < kStages - 1; ++ch) {
    copy_rows(ch);
    copy_id(ch + kStages - 1);
    __pipeline_commit();
  }
  const int a = tid / (9 / kCols), b0 = kCols * (tid % (9 / kCols));
  for (int ch = 0; ch < n_chunks; ++ch) {
    // this thread's copies of chunk ch's rows and of chunk ch + kStages - 1's
    // ids landed; after the barrier everyone's, and chunk ch - 1's buffers
    // are free
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();
    copy_rows(ch + kStages - 1);
    copy_id(ch + 2 * (kStages - 1));
    __pipeline_commit();        // one group a chunk, empty or not
    if (tid < kOwners) {
      const int n = min(kChunk, end - (beg + ch * kChunk));
      const float4* gc = reinterpret_cast<const float4*>(g[ch % kStages]);
      for (int pr = 0; pr < n; ++pr) {
        const float4 ga = gc[18 * pr + a];
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
          const float4 gb = gc[18 * pr + 9 + b0 + m];
          s[m] = add(s[m], add(add(mul(ga.x, gb.x), mul(ga.y, gb.y)), mul(ga.z, gb.z)));
        }
      }
    }
  }
}

// grid (K, K): block (j, i) with i <= j sums camera block (i, j)
__global__ void __launch_bounds__(kBlockThreads)
schur_blocks_kernel(const float* __restrict__ Gs, const float* __restrict__ dinv,
                    const float* __restrict__ Hcc, const float* __restrict__ lam_p,
                    const int* __restrict__ pi, const int* __restrict__ pj,
                    const int* __restrict__ blk_ptr, int K, float* __restrict__ S) {
  const int j = blockIdx.x, i = blockIdx.y;
  if (i > j) return;
  __shared__ __align__(16) float g[kStages][kChunk][2 * kRow];
  __shared__ int ids[kIdSlots][2][kChunk];
  const long long key = static_cast<long long>(i) * K + j;
  const int beg = blk_ptr[key], end = blk_ptr[key + 1];
  float s[kCols] = {};
  block_sum(g, ids, Gs, pi, pj, beg, end, s);
  const int tid = threadIdx.x;
  if (tid >= kOwners) return;
  const int a = tid / (9 / kCols), b0 = kCols * (tid % (9 / kCols));
  const long long n9 = 9LL * K;
#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    const int b = b0 + m;
    float v = -s[m];
    if (i == j) {
      float h = Hcc[81LL * i + 9 * a + b];
      if (a == b) h = add(h, add(mul(*lam_p, h), 1e-8f));
      v = add(v, mul(h, mul(dinv[9 * i + a], dinv[9 * i + b])));
    }
    S[(9LL * i + a) * n9 + 9LL * j + b] = v;
    if (i != j) S[(9LL * j + b) * n9 + 9LL * i + a] = v;
  }
}

}  // namespace

extern "C" int dr3_schur_factor(const float* Hpp9, const float* Hcc, const float* lam,
                                const float* Jcu, const float* Jcv, const float* Jpu,
                                const float* Jpv, const int* obs_pt, const int* cam_ptr,
                                const int* cam_obs, int K, int P, float* Hinv9, float* Gs,
                                float* dinv, void* stream) {
  const int blocks = K + (P + kFactorThreads - 1) / kFactorThreads;
  if (blocks > 0) {
    cudaFuncSetAttribute(schur_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kFactorSmem));
    schur_factor_kernel<<<blocks, kFactorThreads, kFactorSmem,
                          static_cast<cudaStream_t>(stream)>>>(
        Hpp9, Hcc, lam, Jcu, Jcv, Jpu, Jpv, obs_pt, cam_ptr, cam_obs, K, P, Hinv9, Gs, dinv);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dr3_schur_blocks(const float* Gs, const float* dinv, const float* Hcc,
                                const float* lam, const int* pi, const int* pj,
                                const int* blk_ptr, int K, float* S, void* stream) {
  if (K > 0) {
    schur_blocks_kernel<<<dim3(K, K), kBlockThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        Gs, dinv, Hcc, lam, pi, pj, blk_ptr, K, S);
  }
  return static_cast<int>(cudaGetLastError());
}
