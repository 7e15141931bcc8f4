// The IRLS statistics of one pose at one pixel, and the warp reduction of
// the 28 sums, shared by refine.cu (the whole refinement in one launch)
// and irls_stats.cu (one pass per launch), so that the two kernels cannot
// drift apart in what they sum.  Both also share their layouts and the
// order of their sums (pose_layout.cuh), so in one layout a pass of
// irls_stats.cu is a step's sums of refine.cu bit for bit.
//
// Per pixel (dsac_tpu/ops/gn_pallas.py:_irls_stats_kernel): the rigid
// transform, the 1 mm z-floor, the residual of the x-flipped projection,
// the soft-inlier weight sigmoid((tau - min(e, max_err)) / beta), the
// closed-form 2x6 Jacobian rows, and the 28 weighted sums (21
// upper-triangle JtJ entries, 6 Jtr entries, the inlier mass).  The
// function needs 165 f32 operations a pixel (chip_smoke.py's
// IRLS_OPS_PER_PIXEL): 58 for the residual, the weight and the two
// Jacobian rows; 80 for the JtJ sums, since ju[4] and jv[3] are 0: 10
// entries with both rows' products (w * (a + b) and the add, 5 each), 10
// with one (3 each) and JtJ(3, 4), which is always 0; 26 for the Jtr
// sums (4 x 5, and 2 x 3 for Jtr 3 and 4); 1 for the inlier mass.
// add_pixel does exactly those: it never multiplies by a structural zero
// and leaves JtJ(3, 4) at 0.
//
// The divides, the square root and expf are the IEEE-rounded ones, as in
// the kernel this body came from: the arithmetic is the reference's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dsac_irls {

constexpr int kStats = 28;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int tri(int i, int j) {
  // index of (i, j), i <= j, in the row-major upper triangle of a 6x6
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// Adds the statistics of the scene point (x, y, z) mm seen at pixel
// (pu, pv) under pose R (row-major), t.
__device__ __forceinline__ void add_pixel(
    const float (&R)[9], const float (&t)[3], float x, float y, float z,
    float pu, float pv, float f, float cx, float cy, float max_err,
    float tau, float inv_beta, float (&acc)[kStats]) {
  float ax = R[0] * x + R[1] * y + R[2] * z;
  float ay = R[3] * x + R[4] * y + R[5] * z;
  float az = R[6] * x + R[7] * y + R[8] * z;
  float ex = ax + t[0], ey = ay + t[1], ez = az + t[2];
  if (fabsf(ez) < 1.0f) ez = ez > 0.0f ? 1.0f : -1.0f;  // 1 mm floor
  float inv_z = 1.0f / ez;
  float fz = f * inv_z;
  float ru = pu - (-fz * ex + cx);
  float rv = pv - (fz * ey + cy);
  float err = sqrtf(ru * ru + rv * rv + 1e-8f);
  float w = 1.0f / (1.0f + expf(-(tau - fminf(err, max_err)) * inv_beta));
  float gx = fz * ex * inv_z;
  float gy = fz * ey * inv_z;
  // the Jacobian rows' entries that are not structurally zero
  // (ju = [u0 u1 u2 u3 0 u5], jv = [v0 v1 v2 0 v4 v5])
  float u0 = gx * ay, u1 = -fz * az - gx * ax, u2 = fz * ay, u3 = -fz,
        u5 = gx;
  float v0 = -fz * az - gy * ay, v1 = gy * ax, v2 = fz * ax, v4 = fz,
        v5 = -gy;
  auto both = [&](int k, float a, float b, float c, float d) {
    acc[k] += w * (a * b + c * d);
  };
  auto one = [&](int k, float a, float b) { acc[k] += w * (a * b); };
  both(tri(0, 0), u0, u0, v0, v0);
  both(tri(0, 1), u0, u1, v0, v1);
  both(tri(0, 2), u0, u2, v0, v2);
  one(tri(0, 3), u0, u3);
  one(tri(0, 4), v0, v4);
  both(tri(0, 5), u0, u5, v0, v5);
  both(tri(1, 1), u1, u1, v1, v1);
  both(tri(1, 2), u1, u2, v1, v2);
  one(tri(1, 3), u1, u3);
  one(tri(1, 4), v1, v4);
  both(tri(1, 5), u1, u5, v1, v5);
  both(tri(2, 2), u2, u2, v2, v2);
  one(tri(2, 3), u2, u3);
  one(tri(2, 4), v2, v4);
  both(tri(2, 5), u2, u5, v2, v5);
  one(tri(3, 3), u3, u3);  // JtJ(3, 4) stays 0
  one(tri(3, 5), u3, u5);
  one(tri(4, 4), v4, v4);
  one(tri(4, 5), v4, v5);
  both(tri(5, 5), u5, u5, v5, v5);
  both(21, u0, ru, v0, rv);
  both(22, u1, ru, v1, rv);
  both(23, u2, ru, v2, rv);
  one(24, u3, ru);
  one(25, v4, rv);
  both(26, u5, ru, v5, rv);
  acc[27] += w;
}

// Adds the pixels first, first + stride, ... < len in that order.
// load(n, x, y, z, u, v) reads pixel n.
template <typename Load>
__device__ __forceinline__ void add_pixels(
    const float (&R)[9], const float (&t)[3], int first, int stride,
    int len, Load load, float f, float cx, float cy, float max_err,
    float tau, float inv_beta, float (&acc)[kStats]) {
  for (int n = first; n < len; n += stride) {
    float x, y, z, u, v;
    load(n, x, y, z, u, v);
    add_pixel(R, t, x, y, z, u, v, f, cx, cy, max_err, tau, inv_beta, acc);
  }
}

// One stage of the transposed butterfly: each lane keeps the half of its
// 2 * M values that its lane bit M selects, adds the partner's copy of
// that half, and sends the other half.
template <int M>
__device__ __forceinline__ void butterfly_stage(float (&v)[16], int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float send = up ? v[i] : v[i + M];
    float keep = up ? v[i + M] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, M);
  }
}

// Warp sum of the 28 statistics, transposed: lane k < kStats returns the
// sum over the warp's 32 lanes of acc[k], lanes kStats..31 return 0.  31
// shuffles a warp (16 + 8 + 4 + 2 + 1), against 5 for each of the 28
// sums of one warp-wide reduction per statistic.  Every lane of the warp
// must call it.
__device__ __forceinline__ float warp_sum_transposed(
    const float (&acc)[kStats], int lane) {
  float v[16];
  const bool up = lane & 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float lo = acc[i];
    float hi = i + 16 < kStats ? acc[i + 16] : 0.0f;
    float send = up ? lo : hi;
    float keep = up ? hi : lo;
    v[i] = keep + __shfl_xor_sync(kFullMask, send, 16);
  }
  butterfly_stage<8>(v, lane);
  butterfly_stage<4>(v, lane);
  butterfly_stage<2>(v, lane);
  butterfly_stage<1>(v, lane);
  return v[0];
}

}  // namespace dsac_irls
