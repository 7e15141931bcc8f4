// The clamped reprojection error of (hypothesis, pixel) pairs, shared by
// score.cu and diffmap.cu so that the two kernels compute the same error
// surface.
//
// Pose p holds R row-major in p[0..8] and t in p[9..11].  The scene point
// (x, y, z) mm goes to the camera frame, is projected with the x-flip
// (u = -f X/Z + cx) under the |z| < 1e-8 -> -1e-8 guard, and the error
// sqrt(du^2 + dv^2 + 1e-8) against pixel (pu, pv) is clamped at max_err:
// dsac_tpu/ops/diffmap_pallas.py's body, in its order of operations.  36
// f32 operations a pair (chip_smoke.py's DIFFMAP_OPS_PER_PAIR): 18 for the
// rigid transform, 3 for the depth guard, 1 division, 8 for the two
// projected residuals, 6 for the error and its clamp.  The division and
// the square root are the IEEE-rounded ones: the arithmetic is the
// reference's.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dsac_reproj {

// The errors of V pixels under one pose, each step taken for all V pixels
// before the next, so that the pixels' independent chains interleave
// between the branches of the IEEE divide and square root.
template <int V>
__device__ __forceinline__ void errors(const float (&p)[12],
                                       const float (&x)[V],
                                       const float (&y)[V],
                                       const float (&z)[V],
                                       const float (&pu)[V],
                                       const float (&pv)[V], float f,
                                       float cx, float cy, float max_err,
                                       float (&e)[V]) {
  float ex[V], ey[V], ez[V], inv_z[V], s[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ex[j] = p[0] * x[j] + p[1] * y[j] + p[2] * z[j] + p[9];
    ey[j] = p[3] * x[j] + p[4] * y[j] + p[5] * z[j] + p[10];
    ez[j] = p[6] * x[j] + p[7] * y[j] + p[8] * z[j] + p[11];
    if (fabsf(ez[j]) < 1e-8f) ez[j] = -1e-8f;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) inv_z[j] = 1.0f / ez[j];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float du = pu[j] - (-f * ex[j] * inv_z[j] + cx);
    const float dv = pv[j] - (f * ey[j] * inv_z[j] + cy);
    s[j] = du * du + dv * dv + 1e-8f;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = fminf(sqrtf(s[j]), max_err);
}

// The error of one pixel.
__device__ __forceinline__ float error(const float (&p)[12], float x, float y,
                                       float z, float pu, float pv, float f,
                                       float cx, float cy, float max_err) {
  const float xs[1] = {x}, ys[1] = {y}, zs[1] = {z}, us[1] = {pu},
              vs[1] = {pv};
  float e[1];
  errors<1>(p, xs, ys, zs, us, vs, f, cx, cy, max_err, e);
  return e[0];
}

}  // namespace dsac_reproj
