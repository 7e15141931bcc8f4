// Fused soft-inlier scoring: one warp per (frame, hypothesis).
//
// Replaces dsac_tpu/ops/diffmap_pallas.py:_score_kernel (wrapper
// soft_inlier_scores_pallas).  For hypothesis [R|t] of frame b and each of
// the frame's N pixels: transform the scene coordinate, project with the
// x-flip (u = -f X/Z + cx), take the error sqrt(du^2 + dv^2 + 1e-8)
// clamped at max_err, and sum sigmoid((tau - e) / beta).  The (H, N)
// error surface is never stored.
//
// Work per (hypothesis, pixel) pair: 42 f32 operations (chip_smoke.py's
// SCORE_OPS_PER_PAIR): 18 for the rigid transform, 3 for the depth guard,
// 1 division, 8 for the two projected residuals, 6 for the error and its
// clamp, 6 for the sigmoid and the sum.
//
// Bound on the H100: f32 arithmetic, those 42 operations against 20 bytes
// of pixel data that every hypothesis of the frame re-reads from L1/L2;
// device memory sees each input once.  The
// design gives each warp one hypothesis (its 12 pose numbers in
// registers), lets the 32 lanes stride over the frame's pixels with
// coalesced loads, and reduces with warp shuffles: no shared memory, no
// atomics, one launch for the whole batch.  Padding is a bounds check.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void score_kernel(const float* __restrict__ R,
                             const float* __restrict__ t,
                             const float* __restrict__ coords,
                             const float* __restrict__ pix, int B, int H,
                             int N, float f, float cx, float cy, float tau,
                             float inv_beta, float max_err,
                             float* __restrict__ out) {
  int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  int lane = threadIdx.x % 32;
  if (warp >= B * H) return;
  int b = warp / H;
  const float* Rh = R + 9 * warp;
  const float* th = t + 3 * warp;
  float r0 = Rh[0], r1 = Rh[1], r2 = Rh[2], r3 = Rh[3], r4 = Rh[4],
        r5 = Rh[5], r6 = Rh[6], r7 = Rh[7], r8 = Rh[8];
  float t0 = th[0], t1 = th[1], t2 = th[2];
  const float* cb = coords + 3 * static_cast<long long>(b) * N;
  const float* pb = pix + 2 * static_cast<long long>(b) * N;

  float acc = 0.0f;
  for (int n = lane; n < N; n += 32) {
    float x = cb[3 * n], y = cb[3 * n + 1], z = cb[3 * n + 2];
    float ex = r0 * x + r1 * y + r2 * z + t0;
    float ey = r3 * x + r4 * y + r5 * z + t1;
    float ez = r6 * x + r7 * y + r8 * z + t2;
    if (fabsf(ez) < 1e-8f) ez = -1e-8f;
    float inv_z = 1.0f / ez;
    float du = pb[2 * n] - (-f * ex * inv_z + cx);
    float dv = pb[2 * n + 1] - (f * ey * inv_z + cy);
    float err = fminf(sqrtf(du * du + dv * dv + 1e-8f), max_err);
    acc += 1.0f / (1.0f + expf(-(tau - err) * inv_beta));
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[warp] = acc;
}

}  // namespace

extern "C" int dsac_soft_inlier_scores(const float* R, const float* t,
                                       const float* coords, const float* pix,
                                       int B, int H, int N, float f, float cx,
                                       float cy, float tau, float inv_beta,
                                       float max_err, float* out,
                                       cudaStream_t stream) {
  if (B * H <= 0) return 0;
  const int blocks = (B * H + kWarpsPerBlock - 1) / kWarpsPerBlock;
  score_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      R, t, coords, pix, B, H, N, f, cx, cy, tau, inv_beta, max_err, out);
  return static_cast<int>(cudaGetLastError());
}
