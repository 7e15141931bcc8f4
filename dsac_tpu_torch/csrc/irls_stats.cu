// One pass of IRLS statistics: one block per (frame, pose).
//
// Replaces dsac_tpu/ops/gn_pallas.py:_irls_stats_kernel (wrapper
// irls_stats), the per-step kernel of refine_pose_fused_steps.  For pose
// [R|t] of frame b: the 28 statistics of irls_stats.cuh (21
// upper-triangle JtJ entries, 6 Jtr entries, the soft-inlier mass) over
// the frame's N pixels, with the 1 mm z-floor.  The 6x6 solve and the
// pose update run in PyTorch (ops/gn_cuda.py).
//
// Work per (pose, pixel) pair: 165 f32 operations (chip_smoke.py's
// IRLS_OPS_PER_PIXEL; breakdown in irls_stats.cuh).
//
// Bound on the H100: f32 arithmetic, 165 operations against 20 bytes of
// pixel data that every pose of the frame re-reads from L1/L2; device
// memory sees each input once and each of the 28 outputs once.  The
// per-pixel body is refine.cu's own (irls_stats.cuh), so the stepwise
// refiner checks what the refine kernel sums; the reduction is laid out
// differently (256 threads stride over the pixels, a transposed warp
// butterfly, one pass through shared memory), so a pass here matches a
// step of the refine kernel to f32 rounding, not bit for bit.  At the
// refine-all shape (256 poses a frame) the grid has B * 256 blocks,
// enough to fill the card.

#include <cuda_runtime.h>

#include "irls_stats.cuh"

namespace {

using dsac_irls::kStats;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void irls_stats_kernel(const float* __restrict__ R,
                                  const float* __restrict__ t,
                                  const float* __restrict__ coords,
                                  const float* __restrict__ pix, int P,
                                  int N, float f, float cx, float cy,
                                  float max_err, float tau, float inv_beta,
                                  float* __restrict__ out) {
  __shared__ float partial[kWarps][32];

  const int pid = blockIdx.x;  // flat (frame, pose) index
  const int b = pid / P;
  const int tid = threadIdx.x;
  const float* cb = coords + 3 * static_cast<long long>(b) * N;
  const float* pb = pix + 2 * static_cast<long long>(b) * N;

  float Rp[9], tp[3];
  for (int j = 0; j < 9; ++j) Rp[j] = R[9 * pid + j];
  for (int j = 0; j < 3; ++j) tp[j] = t[3 * pid + j];

  float acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.0f;
  auto load = [&](int n, float& x, float& y, float& z, float& u,
                  float& v) {
    x = cb[3 * n];
    y = cb[3 * n + 1];
    z = cb[3 * n + 2];
    u = pb[2 * n];
    v = pb[2 * n + 1];
  };
  dsac_irls::add_pixels(Rp, tp, tid, kThreads, N, load, f, cx, cy, max_err,
                        tau, inv_beta, acc);
  partial[tid / 32][tid % 32] = dsac_irls::warp_sum_transposed(acc, tid % 32);
  __syncthreads();
  if (tid < kStats) {
    float s = partial[0][tid];
    for (int w = 1; w < kWarps; ++w) s += partial[w][tid];
    out[kStats * static_cast<long long>(pid) + tid] = s;
  }
}

}  // namespace

extern "C" int dsac_irls_stats(const float* R, const float* t,
                               const float* coords, const float* pix, int B,
                               int P, int N, float f, float cx, float cy,
                               float max_err, float tau, float inv_beta,
                               float* out, cudaStream_t stream) {
  if (B * P <= 0) return 0;
  irls_stats_kernel<<<B * P, kThreads, 0, stream>>>(
      R, t, coords, pix, P, N, f, cx, cy, max_err, tau, inv_beta, out);
  return static_cast<int>(cudaGetLastError());
}
