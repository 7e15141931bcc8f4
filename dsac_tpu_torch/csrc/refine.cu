// Fused IRLS pose refinement: the whole refinement of every (frame, pose)
// in one launch, laid out for Hopper's SMs.
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
// IRLS_OPS_PER_PIXEL), in irls_stats.cuh, whose per-pixel body this kernel
// shares with irls_stats.cu.  Per pose per step, ~400 more
// (REFINE_OPS_PER_SOLVE) for the Jacobi scaling, the 6x6 Cholesky solve
// and Rodrigues.
//
// Bound on the H100: f32 arithmetic once the card is full; at the small
// grids of serving (32 poses) and SoftAM training (1 pose, and 12 probes
// in the backward) the latency of a step's dependent chain, since one
// pose's 1,600 pixels are little work.  The layout (ops/gn_cuda.py:
// refine_layout) is one of two (pose_layout.cuh, which this kernel shares
// with irls_stats.cu, so that a step's sums are a pass of that kernel):
//
// * a cluster of C CTAs per pose (C in 2..8, one pose per CTA): the
//   frame's pixels are split into C slices, each CTA sums its slice and
//   every CTA adds the C partial sums, traded through distributed shared
//   memory, in rank order, so every CTA solves the same system on the
//   same sums and holds the same pose: no broadcast, and the sticky freeze
//   agrees across the cluster;
// * G poses of one frame per CTA (C = 1), W warps each: the frame's
//   pixels are staged in shared memory once and read by all G poses on
//   all steps.
//
// In both, the sums of a step go in a fixed order (each thread's pixels,
// a transposed warp butterfly, the pose's warps, the cluster's CTAs)
// through slots double-buffered by the step's parity, so one barrier (or
// one mbarrier wait) a step suffices.  Every warp of a pose then solves
// redundantly and lane-parallel: lane i builds row i of the scaled
// system, the Cholesky factor goes column by column (column j's entries
// on lanes j..5, each with the k order of the one-thread loop, 6
// dependent stages) with the forward substitution folded in, and the
// back substitution and Rodrigues run on every lane.  The pose stays in
// registers; the warps of a pose compute it from the same sums in the
// same order, so they agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "irls_stats.cuh"
#include "pose_layout.cuh"

namespace {

using dsac_irls::kFullMask;
using dsac_irls::kMaxThreads;
using dsac_irls::kStats;
using dsac_irls::tri;

struct RefineArgs {
  const float* R0;
  const float* t0;
  const float* coords;
  const float* pix;
  float* R_out;
  float* t_out;
  float* n_out;
  int P, N, steps;
  float f, cx, cy, max_err, tau, inv_beta, min_inliers, damping;
  int cluster, poses_per_cta, warps_per_pose;
  int slice;  // pixels per CTA: ceil(N / cluster), set at launch
};

__device__ __forceinline__ float pick6(int i, const float (&a)[6]) {
  float r = a[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) r = i == k ? a[k] : r;
  return r;
}

// One IRLS step's solve and pose update from the statistics (lane k of the
// calling warp holds statistic k), on every lane of the warp; R and t are
// the same on every lane before and after.  The arithmetic is that of the
// one-thread solve this replaces (IEEE divides and square roots, the same
// operations in the same order), so the same sums give the same pose.
__device__ __forceinline__ void solve_and_update(float s, int lane,
                                                 bool live, float damping,
                                                 float (&R)[9],
                                                 float (&t)[3]) {
  const int i = lane < 6 ? lane : 5;  // lanes 6..31 shadow row 5
  float dn[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    dn[k] = 1.0f / sqrtf(__shfl_sync(kFullMask, s, tri(k, k)) + 1e-12f);
  const float di = pick6(i, dn);

  // row i of the Jacobi-normalised damped system, and b_i
  float A[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int lo = min(i, j), hi = max(i, j);
    float a = di * dn[j] * __shfl_sync(kFullMask, s, tri(lo, hi));
    if (i == j) a += damping + 1e-6f;
    A[j] = a;
  }
  float bacc = di * __shfl_sync(kFullMask, s, 21 + i);

  // Cholesky, column by column (lane i holds row i of L), with the
  // forward substitution folded in: at column j lane j finishes y_j and
  // every lane below takes L[i][j] y_j off its b_i, in the loop's k order
  float L[6], y[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float acc = A[j];  // A[j][i] = A[i][j]
#pragma unroll
    for (int k = 0; k < j; ++k)
      acc -= L[k] * __shfl_sync(kFullMask, L[k], j);
    const float djj =
        __shfl_sync(kFullMask, sqrtf(fmaxf(acc, 1e-12f)), j);
    L[j] = i == j ? djj : acc / djj;  // rows i < j: unused
    y[j] = __shfl_sync(kFullMask, bacc / djj, j);
    bacc -= L[j] * y[j];
  }

  // back substitution on every lane, in the order of gn_pallas.py:346-351
  float Lf[6][6], xs[6];
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int k = 0; k <= r; ++k)
      Lf[r][k] = __shfl_sync(kFullMask, L[k], r);
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float acc = y[r];
#pragma unroll
    for (int k = r + 1; k < 6; ++k) acc -= Lf[k][r] * xs[k];
    xs[r] = acc / Lf[r][r];
  }
  float delta[6];
  bool ok = live;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    delta[r] = fminf(fmaxf(dn[r] * xs[r], -1e4f), 1e4f);
    ok = ok && (delta[r] == delta[r]) && (fabsf(delta[r]) < 1e30f);
  }
#pragma unroll
  for (int r = 0; r < 6; ++r)
    if (!ok) delta[r] = 0.0f;

  // Rodrigues: R <- exp(hat(w)) R  (geometry/rotation.py:so3_exp)
  float wx = delta[0], wy = delta[1], wz = delta[2];
  float th2 = wx * wx + wy * wy + wz * wz;
  bool small = th2 < 1e-8f;
  float th = sqrtf(small ? 1.0f : th2);
  float sin_th, cos_th;
  sincosf(th, &sin_th, &cos_th);
  float ca = small ? 1.0f - th2 / 6.0f : sin_th / th;
  float cb = small ? 0.5f - th2 / 24.0f : (1.0f - cos_th) / th2;
  float dR[9] = {1.0f + cb * (-wz * wz - wy * wy),
                 -ca * wz + cb * wx * wy,
                 ca * wy + cb * wx * wz,
                 ca * wz + cb * wx * wy,
                 1.0f + cb * (-wz * wz - wx * wx),
                 -ca * wx + cb * wy * wz,
                 -ca * wy + cb * wx * wz,
                 ca * wx + cb * wy * wz,
                 1.0f + cb * (-wy * wy - wx * wx)};
  float Rn[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Rn[3 * r + c] = dR[3 * r] * R[c] + dR[3 * r + 1] * R[3 + c] +
                      dR[3 * r + 2] * R[6 + c];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] += delta[3 + k];
}

__global__ void __launch_bounds__(kMaxThreads, 2)
    refine_kernel(const RefineArgs a) {
  extern __shared__ float4 staged[];  // x, y, z, u, v of the CTA's slice
  __shared__ dsac_irls::PoseSums sums;

  const dsac_irls::Place p =
      dsac_irls::locate(a.cluster, a.poses_per_cta, a.warps_per_pose, a.P,
                        a.N, a.slice);
  // the pose's loads first, so that their latency hides behind staging
  const bool live = p.j < a.P;  // not a pose group past the last pose
  const long long pid = static_cast<long long>(p.b) * a.P + p.j;
  float R[9], t[3];
  if (live) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = a.R0[9 * pid + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = a.t0[3 * pid + k];
  }
  float* pixels = reinterpret_cast<float*>(staged);
  dsac_irls::stage_slice(a.coords, a.pix, a.N, p, pixels);
  __syncthreads();
  if (!live) return;

  dsac_irls::init_exchange(sums, p);
  bool alive = true;
  float n_in = 0.0f;
  for (int step = 0; step < a.steps; ++step) {
    float acc[kStats];
    dsac_irls::sum_pixels(R, t, dsac_irls::StagedPixels{pixels, p.slice},
                          p, a.f, a.cx, a.cy, a.max_err, a.tau, a.inv_beta,
                          acc);
    const float s = dsac_irls::pose_sum(acc, p, step, sums);
    n_in = __shfl_sync(kFullMask, s, 27);
    alive = alive && (n_in >= a.min_inliers);
    solve_and_update(s, p.lane, alive, a.damping, R, t);
  }

  if (p.rank == 0 && p.w == 0 && p.lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) a.R_out[9 * pid + k] = R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) a.t_out[3 * pid + k] = t[k];
    a.n_out[pid] = n_in;
  }
  // No cluster barrier before leaving: every store into this CTA's
  // shared memory landed before its last wait_phase returned, and it
  // stores into another CTA only sums that CTA still waits for.
}

}  // namespace

// Launches the refinement of B x P poses in the layout (cluster,
// poses_per_cta, warps_per_pose) that ops/gn_cuda.py:refine_layout
// chooses (pose_layout.cuh:launch_in_layout).  Returns a CUDA error code.
extern "C" int dsac_refine_pose(const float* R0, const float* t0,
                                const float* coords, const float* pix, int B,
                                int P, int N, int steps, float f, float cx,
                                float cy, float max_err, float tau,
                                float inv_beta, float min_inliers,
                                float damping, int cluster,
                                int poses_per_cta, int warps_per_pose,
                                float* R, float* t, float* n_in,
                                cudaStream_t stream) {
  if (B * P <= 0) return 0;
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const RefineArgs args{R0, t0, coords, pix, R, t, n_in, P, N, steps, f, cx,
                        cy, max_err, tau, inv_beta, min_inliers, damping,
                        cluster, poses_per_cta, warps_per_pose, 0};
  return dsac_irls::launch_in_layout(refine_kernel, args, B, true, stream);
}
