// One pass of IRLS statistics, in the staged layouts of the refine kernel.
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
// Bound on the H100: f32 arithmetic.  Device memory sees each pixel once
// (20 bytes), each pose once (48 bytes) and each pose's 28 sums once, 165
// operations a pair against that: 8 frames x 256 poses x 1,600 pixels are
// 5.4e8 operations, 0.00807 ms at 67 TFLOP/s, and one frame of 256 poses
// 0.00101 ms.  The IEEE divides, square root and expf are MUFU plus Newton
// steps behind branches to slow paths, so the kernel is issue-bound well
// above that, like the refine kernel's pixel loop.  The first design gave
// each (frame, pose) a CTA of 256 threads that read the frame's pixels as
// arrays of structs from L2 (2,048 CTAs each re-reading 32 KB at 8 x 256),
// ran a ragged pixel loop (6.25 pixels a thread) and ended every CTA in a
// serial tail through shared memory.
//
// This design is a step of the refine kernel's sums without the solve:
// its layouts (pose_layout.cuh; ops/gn_cuda.py:irls_stats_layout picks
// one per launch): a cluster of CTAs per pose, or G poses of one frame per
// CTA over the frame's pixels staged once in shared memory as SoA, W
// warps a pose (one pose a CTA and no cluster reads the frame from device
// memory through the read-only data cache instead, in the same order:
// staging gains nothing where one pose reads each pixel once, and at 1 x
// 256 poses on the H100 it read 0.0069 device ms against 0.0061 unstaged
// and the first design's 0.0068, PERF.md); each thread sums its pixels in
// order, then the transposed
// warp butterfly, the pose's warps in warp order and the cluster's CTAs
// in rank order.  No atomics: two launches agree bit for bit, and in the
// layout of a refine launch this pass's inlier mass is that launch's n_in
// after one step, bit for bit.  Lanes 0..27 of warp 0 of the pose (rank 0
// of its cluster) write the 28 sums.

#include <cuda_runtime.h>

#include "irls_stats.cuh"
#include "pose_layout.cuh"

namespace {

using dsac_irls::kMaxThreads;
using dsac_irls::kStats;

struct IrlsArgs {
  const float* R;
  const float* t;
  const float* coords;
  const float* pix;
  float* out;
  int P, N;
  float f, cx, cy, max_err, tau, inv_beta;
  int cluster, poses_per_cta, warps_per_pose;
  int slice;  // pixels per CTA: ceil(N / cluster), set at launch
};

// kStaged: the CTA's slice staged in shared memory, read by all its
// poses; else (C = G = 1) the CTA's one pose reads the frame from device
// memory (pose_layout.cuh:FramePixels).  The same pixels in the same order
// either way, so the same sums bit for bit.
template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
    irls_stats_kernel(const IrlsArgs a) {
  extern __shared__ float4 staged[];  // x, y, z, u, v of the CTA's slice
  __shared__ dsac_irls::PoseSums sums;

  const dsac_irls::Place p =
      kStaged ? dsac_irls::locate(a.cluster, a.poses_per_cta,
                                  a.warps_per_pose, a.P, a.N, a.slice)
              : dsac_irls::locate_one_pose(a.P, a.N);
  // the pose's loads first, so that their latency hides behind staging
  // (unstaged, the pose is CTA x's: its loads wait on no division)
  const bool live = p.j < a.P;  // not a pose group past the last pose
  const long long pid = kStaged ? static_cast<long long>(p.b) * a.P + p.j
                                : static_cast<long long>(blockIdx.x);
  float R[9], t[3];
  if (live) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = a.R[9 * pid + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = a.t[3 * pid + k];
  }
  float* pixels = reinterpret_cast<float*>(staged);
  if (kStaged) {
    dsac_irls::stage_slice(a.coords, a.pix, a.N, p, pixels);
    __syncthreads();
  }
  if (!live) return;

  dsac_irls::init_exchange(sums, p);
  float acc[kStats];
  if (kStaged)
    dsac_irls::sum_pixels(R, t, dsac_irls::StagedPixels{pixels, p.slice}, p,
                          a.f, a.cx, a.cy, a.max_err, a.tau, a.inv_beta,
                          acc);
  else
    dsac_irls::sum_pixels(R, t,
                          dsac_irls::FramePixels(a.coords, a.pix, a.N, p), p,
                          a.f, a.cx, a.cy, a.max_err, a.tau, a.inv_beta,
                          acc);
  const float s = dsac_irls::pose_sum(acc, p, 0, sums);
  if (p.rank == 0 && p.w == 0 && p.lane < kStats)
    a.out[kStats * pid + p.lane] = s;
}

}  // namespace

// Launches one pass over B x P poses in the layout (cluster,
// poses_per_cta, warps_per_pose) that ops/gn_cuda.py:irls_stats_layout
// chooses (pose_layout.cuh:launch_in_layout).  Returns a CUDA error code.
extern "C" int dsac_irls_stats(const float* R, const float* t,
                               const float* coords, const float* pix, int B,
                               int P, int N, float f, float cx, float cy,
                               float max_err, float tau, float inv_beta,
                               int cluster, int poses_per_cta,
                               int warps_per_pose, float* out,
                               cudaStream_t stream) {
  if (B * P <= 0) return 0;
  const IrlsArgs args{R, t, coords, pix, out, P, N, f, cx, cy, max_err, tau,
                      inv_beta, cluster, poses_per_cta, warps_per_pose, 0};
  const bool staged = cluster > 1 || poses_per_cta > 1;
  return dsac_irls::launch_in_layout(
      staged ? irls_stats_kernel<true> : irls_stats_kernel<false>, args, B,
      staged, stream);
}
