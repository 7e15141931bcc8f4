// The IRLS statistics of one pose against one frame's pixels, shared by
// refine.cu (the whole refinement in one launch) and irls_stats.cu (one
// pass per launch), so that the two kernels cannot drift apart.
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
// sums (4 x 5, and 2 x 3 for Jtr 3 and 4); 1 for the inlier mass.  The
// loop below also multiplies by those zeros (194 operations a pixel):
// without fast math the compiler may not drop a product with 0.
//
// A block of kThreads threads strides over the pixels with the 28 sums in
// registers, then reduces them with warp shuffles and one pass through
// shared memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace dsac_irls {

constexpr int kStats = 28;

__device__ __forceinline__ int tri(int i, int j) {
  // index of (i, j), i <= j, in the row-major upper triangle of a 6x6
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// Adds the statistics of pixels tid, tid + kThreads, ... < N of one frame
// (coords cb (N, 3) mm, pixels pb (N, 2)) under pose R (row-major), t.
template <int kThreads>
__device__ __forceinline__ void accumulate(
    const float (&R)[9], const float (&t)[3], const float* __restrict__ cb,
    const float* __restrict__ pb, int N, int tid, float f, float cx,
    float cy, float max_err, float tau, float inv_beta,
    float (&acc)[kStats]) {
  for (int n = tid; n < N; n += kThreads) {
    float x = cb[3 * n], y = cb[3 * n + 1], z = cb[3 * n + 2];
    float ax = R[0] * x + R[1] * y + R[2] * z;
    float ay = R[3] * x + R[4] * y + R[5] * z;
    float az = R[6] * x + R[7] * y + R[8] * z;
    float ex = ax + t[0], ey = ay + t[1], ez = az + t[2];
    if (fabsf(ez) < 1.0f) ez = ez > 0.0f ? 1.0f : -1.0f;  // 1 mm floor
    float inv_z = 1.0f / ez;
    float fz = f * inv_z;
    float ru = pb[2 * n] - (-fz * ex + cx);
    float rv = pb[2 * n + 1] - (fz * ey + cy);
    float err = sqrtf(ru * ru + rv * rv + 1e-8f);
    float w = 1.0f / (1.0f + expf(-(tau - fminf(err, max_err)) * inv_beta));
    float gx = fz * ex * inv_z;
    float gy = fz * ey * inv_z;
    float ju[6] = {gx * ay, -fz * az - gx * ax, fz * ay, -fz, 0.0f, gx};
    float jv[6] = {-fz * az - gy * ay, gy * ax, fz * ax, 0.0f, fz, -gy};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j)
        acc[tri(i, j)] += w * (ju[i] * ju[j] + jv[i] * jv[j]);
      acc[21 + i] += w * (ju[i] * ru + jv[i] * rv);
    }
    acc[27] += w;
  }
}

// Block sum of the threads' acc: warp shuffles, then one pass through
// shared memory (partial).  Thread k < kStats gets the block's sum k; the
// other threads get 0.  Every thread of the block must call it.
template <int kWarps>
__device__ __forceinline__ float block_sum(float (&acc)[kStats],
                                           float (*partial)[kStats],
                                           int tid) {
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (tid % 32 == 0) partial[tid / 32][k] = v;
  }
  __syncthreads();
  float s = 0.0f;
  if (tid < kStats)
    for (int w = 0; w < kWarps; ++w) s += partial[w][tid];
  return s;
}

}  // namespace dsac_irls
