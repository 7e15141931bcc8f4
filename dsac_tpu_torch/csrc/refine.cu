// Fused IRLS pose refinement: one block per (frame, pose), the whole
// refinement in one launch.
//
// Replaces dsac_tpu/ops/gn_pallas.py:_refine_kernel (wrapper
// refine_pose_fused).  Each of `steps` iterations: soft-inlier weights
// sigmoid((tau - min(e, max_err)) / beta), closed-form 2x6 Jacobian rows,
// 28 statistics (21 upper-triangle JtJ + 6 Jtr + the inlier mass), the
// sticky min-inlier freeze, the Jacobi-normalised damped 6x6 system, an
// unrolled Cholesky solve, the +-1e4 clip, the NaN guard, then
// R <- exp(omega) R and t <- t + dt.  n_in is the inlier mass at the pose
// that entered the last step, as in the reference.
//
// Work per pixel per step: 165 f32 operations (chip_smoke.py's
// IRLS_OPS_PER_PIXEL), counted in irls_stats.cuh, whose per-pixel
// body and block reduction this kernel shares with irls_stats.cu.  Per
// pose per step, ~400 more (REFINE_OPS_PER_SOLVE) for the Jacobi scaling,
// the 6x6 Cholesky solve and Rodrigues.
//
// Bound on the H100: f32 arithmetic; the 20 bytes per pixel come from
// device memory once and from L1 on the other steps.  With 4 poses per
// frame the grid is small (one block per pose), so the design keeps the
// pose in shared memory, lets 256 threads stride over the pixels with the
// 28 sums in registers, reduces them with warp shuffles and one pass
// through shared memory, and has one thread solve the 6x6 system in the
// order of gn_pallas.py:313-375 before the next step reads the new pose.

#include <cuda_runtime.h>
#include <math.h>

#include "irls_stats.cuh"

namespace {

using dsac_irls::kStats;
using dsac_irls::tri;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void refine_kernel(const float* __restrict__ R0,
                              const float* __restrict__ t0,
                              const float* __restrict__ coords,
                              const float* __restrict__ pix, int P, int N,
                              int steps, float f, float cx, float cy,
                              float max_err, float tau, float inv_beta,
                              float min_inliers, float damping,
                              float* __restrict__ R_out,
                              float* __restrict__ t_out,
                              float* __restrict__ n_out) {
  __shared__ float pose[12];
  __shared__ float partial[kWarps][kStats];
  __shared__ float stats[kStats];
  __shared__ int alive;

  const int pid = blockIdx.x;  // flat (frame, pose) index
  const int b = pid / P;
  const int tid = threadIdx.x;
  const float* cb = coords + 3 * static_cast<long long>(b) * N;
  const float* pb = pix + 2 * static_cast<long long>(b) * N;

  if (tid < 9) pose[tid] = R0[9 * pid + tid];
  if (tid < 3) pose[9 + tid] = t0[3 * pid + tid];
  if (tid == 0) alive = 1;
  __syncthreads();

  float n_in = 0.0f;
  for (int step = 0; step < steps; ++step) {
    float R[9], t[3];
    for (int j = 0; j < 9; ++j) R[j] = pose[j];
    for (int j = 0; j < 3; ++j) t[j] = pose[9 + j];

    float acc[kStats];
#pragma unroll
    for (int k = 0; k < kStats; ++k) acc[k] = 0.0f;

    dsac_irls::accumulate<kThreads>(R, t, cb, pb, N, tid, f, cx, cy,
                                    max_err, tau, inv_beta, acc);
    float s = dsac_irls::block_sum<kWarps>(acc, partial, tid);
    if (tid < kStats) stats[tid] = s;
    __syncthreads();

    n_in = stats[27];
    if (tid == 0) {
      int live = alive && (n_in >= min_inliers);
      alive = live;
      float dn[6];
      for (int i = 0; i < 6; ++i)
        dn[i] = 1.0f / sqrtf(stats[tri(i, i)] + 1e-12f);
      float A[6][6];
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) {
          float a = dn[i] * dn[j] * stats[tri(i, j)];
          if (i == j) a += damping + 1e-6f;
          A[i][j] = a;
          A[j][i] = a;
        }
      float bvec[6];
      for (int i = 0; i < 6; ++i) bvec[i] = dn[i] * stats[21 + i];

      float L[6][6];
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j <= i; ++j) {
          float s = A[j][i];
          for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
          L[i][j] = (i == j) ? sqrtf(fmaxf(s, 1e-12f)) : s / L[j][j];
        }
      float y[6], xs[6];
      for (int i = 0; i < 6; ++i) {
        float s = bvec[i];
        for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
        y[i] = s / L[i][i];
      }
      for (int i = 5; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < 6; ++k) s -= L[k][i] * xs[k];
        xs[i] = s / L[i][i];
      }
      float delta[6];
      bool ok = live;
      for (int i = 0; i < 6; ++i) {
        delta[i] = fminf(fmaxf(dn[i] * xs[i], -1e4f), 1e4f);
        ok = ok && (delta[i] == delta[i]) && (fabsf(delta[i]) < 1e30f);
      }
      for (int i = 0; i < 6; ++i)
        if (!ok) delta[i] = 0.0f;

      // Rodrigues: R <- exp(hat(w)) R  (geometry/rotation.py:so3_exp)
      float wx = delta[0], wy = delta[1], wz = delta[2];
      float th2 = wx * wx + wy * wy + wz * wz;
      bool small = th2 < 1e-8f;
      float th = sqrtf(small ? 1.0f : th2);
      float ca = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
      float cb2 = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / th2;
      float dR[9] = {1.0f + cb2 * (-wz * wz - wy * wy),
                     -ca * wz + cb2 * wx * wy,
                     ca * wy + cb2 * wx * wz,
                     ca * wz + cb2 * wx * wy,
                     1.0f + cb2 * (-wz * wz - wx * wx),
                     -ca * wx + cb2 * wy * wz,
                     -ca * wy + cb2 * wx * wz,
                     ca * wx + cb2 * wy * wz,
                     1.0f + cb2 * (-wy * wy - wx * wx)};
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          pose[3 * i + j] = dR[3 * i] * R[j] + dR[3 * i + 1] * R[3 + j] +
                            dR[3 * i + 2] * R[6 + j];
      for (int i = 0; i < 3; ++i) pose[9 + i] = t[i] + delta[3 + i];
    }
    __syncthreads();
  }

  if (tid < 9) R_out[9 * pid + tid] = pose[tid];
  if (tid < 3) t_out[3 * pid + tid] = pose[9 + tid];
  if (tid == 0) n_out[pid] = n_in;
}

}  // namespace

extern "C" int dsac_refine_pose(const float* R0, const float* t0,
                                const float* coords, const float* pix, int B,
                                int P, int N, int steps, float f, float cx,
                                float cy, float max_err, float tau,
                                float inv_beta, float min_inliers,
                                float damping, float* R, float* t,
                                float* n_in, cudaStream_t stream) {
  if (B * P <= 0) return 0;
  refine_kernel<<<B * P, kThreads, 0, stream>>>(
      R0, t0, coords, pix, P, N, steps, f, cx, cy, max_err, tau, inv_beta,
      min_inliers, damping, R, t, n_in);
  return static_cast<int>(cudaGetLastError());
}
