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
// refine_layout) is one of two:
//
// * a cluster of C CTAs per pose (C in 2..8, one pose per CTA): the
//   frame's pixels are split into C slices, each CTA sums its slice and
//   stores the sums into every CTA of the cluster through distributed
//   shared memory (st.async, counted on an mbarrier), and every CTA adds
//   the C partial sums in rank order 0..C-1, so every CTA solves the same
//   system on the same sums and holds the same pose: no broadcast, and
//   the sticky freeze agrees across the cluster;
// * G poses of one frame per CTA (C = 1), W warps each: the frame's
//   pixels are staged in shared memory once and read by all G poses on
//   all steps; the W warps of a pose meet at a named barrier of their
//   own (none when W = 1), so the poses of a CTA never wait on each other.
//
// In both, each CTA stages its slice of the pixels in shared memory
// (structure of arrays, conflict-free), every thread keeps the 28 sums of
// its pixels in registers, a transposed warp butterfly leaves statistic k
// on lane k (31 shuffles), and the partials of the warps (and CTAs) meet
// through double-buffered slots indexed by the step's parity, so one
// barrier (or one mbarrier wait) a step suffices.  Every warp of a pose
// then solves redundantly and lane-parallel: lane i builds row i of the
// scaled system, the Cholesky factor goes column by column (column j's
// entries on lanes j..5, each with the k order of the one-thread loop, 6
// dependent stages) with the forward substitution folded in, and the back
// substitution and Rodrigues run on every lane.  The pose stays in
// registers; the warps of a pose compute it from the same sums in the
// same order, so they agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "irls_stats.cuh"

namespace cg = cooperative_groups;

namespace {

using dsac_irls::kFullMask;
using dsac_irls::kStats;
using dsac_irls::tri;

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size

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
  int slice;  // pixels per CTA: ceil(N / cluster)
};

__device__ __forceinline__ float pick6(int i, const float (&a)[6]) {
  float r = a[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) r = i == k ? a[k] : r;
  return r;
}

// load(0) + load(1) + ... + load(n - 1), n <= kMax, left to right, with
// every load issued before the first add (a loop of n iterations would
// wait out each load, shared or distributed, in turn).
template <int kMax, typename Load>
__device__ __forceinline__ float sum_in_order(int n, Load load) {
  float v[kMax];
#pragma unroll
  for (int r = 0; r < kMax; ++r) v[r] = r < n ? load(r) : 0.0f;
  float s = v[0];
#pragma unroll
  for (int r = 1; r < kMax; ++r)
    if (r < n) s += v[r];
  return s;
}

// The cluster exchange: each CTA stores its 32 sums (st.async) into its
// own slot in every CTA of the cluster, itself included, and each store
// counts its bytes on the receiving CTA's mbarrier for that step's
// parity; a CTA reads the slots once its mbarrier has all C x 128 bytes.
// A one-way store per CTA pair instead of a cluster barrier and C remote
// loads: 680 cycles a step instead of 2,140 on the H100 (PERF.md).
// The slots and mbarriers are double-buffered by step parity: a CTA can
// send step k + 2's sums only after it has every CTA's step k + 1 sums,
// which each CTA sends after reading its step k slots.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbarrier_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
}
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void send(unsigned remote_slot, float v,
                                     unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(remote_slot), "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}
// Waits for the phase of parity `parity` of the local mbarrier `bar`; a
// partner that never sends traps the launch rather than hang the card.
__device__ __forceinline__ void wait_phase(unsigned bar, unsigned parity) {
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred q;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 q, [%1], "
        "%2;\n selp.u32 %0, 1, 0, q;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// Barrier of the `threads` threads of pose group g (ids 1..; 0 is
// __syncthreads').
__device__ __forceinline__ void group_sync(int g, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(threads) : "memory");
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
  extern __shared__ float pixels[];  // x, y, z, u, v of the CTA's slice
  __shared__ float part[2][kMaxWarps][32];  // warp sums, by step parity
  __shared__ float slots[2][kMaxCluster][32];  // the cluster's CTA sums
  __shared__ alignas(8) unsigned long long arrived[2];  // their mbarriers

  const int C = a.cluster, G = a.poses_per_cta, W = a.warps_per_pose;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp / W, w = warp % W;
  const int rank = blockIdx.x % C;  // the CTA's rank in its cluster
  const int unit = blockIdx.x / C;  // the cluster: G poses of one frame
  const int groups = (a.P + G - 1) / G;
  const int b = unit / groups;
  const int j = (unit % groups) * G + g;

  // stage this CTA's slice of frame b's pixels
  const int start = rank * a.slice;
  const int len = max(0, min(a.slice, a.N - start));
  float* sx = pixels;
  float* sy = sx + a.slice;
  float* sz = sy + a.slice;
  float* su = sz + a.slice;
  float* sv = su + a.slice;
  const float* cb = a.coords + 3 * (static_cast<long long>(b) * a.N + start);
  const float* pb = a.pix + 2 * (static_cast<long long>(b) * a.N + start);
  for (int n = tid; n < len; n += blockDim.x) {
    sx[n] = cb[3 * n];
    sy[n] = cb[3 * n + 1];
    sz[n] = cb[3 * n + 2];
    su[n] = pb[2 * n];
    sv[n] = pb[2 * n + 1];
  }
  __syncthreads();
  if (j >= a.P) return;  // a pose group past the frame's last pose

  const long long pid = static_cast<long long>(b) * a.P + j;
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = a.R0[9 * pid + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = a.t0[3 * pid + k];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned bar0 = smem_addr(&arrived[0]);
  if (C > 1) {  // the mbarriers, initialised before any CTA sends
    if (tid == 0) {
      mbarrier_init(bar0);
      mbarrier_init(bar0 + 8);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster.sync();
  }
  const int gthreads = W * 32;
  bool alive = true;
  float n_in = 0.0f;
  for (int step = 0; step < a.steps; ++step) {
    const int p = step & 1;
    float acc[kStats];
#pragma unroll
    for (int k = 0; k < kStats; ++k) acc[k] = 0.0f;
    auto load = [&](int n, float& x, float& y, float& z, float& u,
                    float& v) {
      x = sx[n];
      y = sy[n];
      z = sz[n];
      u = su[n];
      v = sv[n];
    };
    dsac_irls::add_pixels(R, t, w * 32 + lane, gthreads, len, load, a.f,
                          a.cx, a.cy, a.max_err, a.tau, a.inv_beta, acc);
    float s = dsac_irls::warp_sum_transposed(acc, lane);
    if (W > 1) {  // the pose's warps in this CTA, in warp order
      part[p][warp][lane] = s;
      group_sync(g, gthreads);
      s = sum_in_order<kMaxWarps>(W, [&](int q) {
        return part[p][g * W + q][lane];
      });
    }
    if (C > 1) {  // the cluster's CTAs, in rank order
      const unsigned bar = bar0 + 8 * p;
      if (w == 0) {  // this CTA's sums into slot `rank` of every CTA
        if (lane == 0) expect_bytes(bar, C * 32 * sizeof(float));
        const unsigned slot = smem_addr(&slots[p][rank][lane]);
        for (int r = 0; r < C; ++r)
          send(map_rank(slot, r), s, map_rank(bar, r));
      }
      wait_phase(bar, (step >> 1) & 1);
      s = sum_in_order<kMaxCluster>(C, [&](int r) {
        return slots[p][r][lane];
      });
    }
    n_in = __shfl_sync(kFullMask, s, 27);
    alive = alive && (n_in >= a.min_inliers);
    solve_and_update(s, lane, alive, a.damping, R, t);
  }

  if (rank == 0 && w == 0 && lane == 0) {
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
// chooses.  Returns a CUDA error code: cudaErrorInvalidValue for a layout
// the kernel does not take, or whatever the launch reports (a cluster the
// card cannot schedule is an error, never a smaller cluster).
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
  const int C = cluster, G = poses_per_cta, W = warps_per_pose;
  const bool legal = (C == 1 || C == 2 || C == 4 || C == kMaxCluster) &&
                     G >= 1 && W >= 1 && G * W <= kMaxWarps &&
                     (C == 1 || G == 1) && N >= 0 && steps >= 0;
  if (!legal) return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (N + C - 1) / C;
  const size_t smem = sizeof(float) * 5 * static_cast<size_t>(slice);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const RefineArgs args{R0, t0, coords, pix, R, t, n_in, P, N, steps, f, cx,
                        cy, max_err, tau, inv_beta, min_inliers, damping, C,
                        G, W, slice};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * ((P + G - 1) / G) * C));
  cfg.blockDim = dim3(static_cast<unsigned>(G * W * 32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, refine_kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
