// The layouts that the refine kernel (refine.cu) and the IRLS-stats kernel
// (irls_stats.cu) share: where a thread's pose and pixels lie, the staging
// of a CTA's slice of the frame's pixels in shared memory, and the sum of
// a pose's 28 IRLS statistics over its warps and its cluster's CTAs in a
// fixed order.  A pass of irls_stats.cu is one step's sums of refine.cu
// without the solve: in the same layout both add the same pixels in the
// same order, so refine's n_in after one step equals the pass's inlier
// mass (statistic 27) bit for bit.
//
// A layout (ops/gn_cuda.py:RefineLayout) is (cluster C, poses_per_cta G,
// warps_per_pose W) on a grid of B * ceil(P / G) * C CTAs of G * W * 32
// threads; CTA x is rank x % C of cluster x / C, which holds poses
// (x / C % ceil(P / G)) * G + 0..G-1 of frame x / C / ceil(P / G):
// * C in 2..8 (G = 1): a cluster of C CTAs per pose; the frame's pixels
//   are split into C slices of ceil(N / C), each CTA sums its slice and
//   stores the sums into every CTA of the cluster through distributed
//   shared memory (st.async, counted on an mbarrier), and every CTA adds
//   the C partial sums in rank order 0..C-1, so every CTA holds the same
//   sums;
// * C = 1: G poses of one frame per CTA, W warps each, all reading the
//   frame's pixels staged once in the CTA's shared memory; the W warps of a
//   pose meet at a named barrier of their own (none when W = 1), so the
//   poses of a CTA never wait on each other.
// In both, each CTA stages its slice as five SoA arrays (x, y, z, u, v,
// `slice` floats each; conflict-free reads), with 16-byte loads where the
// slice starts 16-byte aligned (irls_stats.cu reads a CTA of one pose and
// no cluster, C = G = 1, from device memory instead: its one pose reads
// each pixel once, so staging only delays it); lane l of warp w of a pose
// takes pixels w * 32 + l, + 32 W, ... of the slice in order, a
// transposed warp butterfly leaves statistic k on lane k (31 shuffles),
// and the partials of the warps (and CTAs) meet through slots
// double-buffered by the step's parity, so one barrier (or one mbarrier
// wait) a step suffices.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "irls_stats.cuh"

namespace dsac_irls {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size

// A thread's place in a layout.
struct Place {
  int C, G, W;         // cluster, poses a CTA, warps a pose
  int lane, warp;      // in the CTA
  int g, w;            // the thread's pose group, and its warp there
  int rank;            // the CTA's rank in its cluster
  int b, j;            // frame, and pose of the frame (j >= P: none)
  int start, len;      // the CTA's slice of the frame's pixels
  int slice;           // ceil(N / C), the stride of the staged arrays
};

__device__ __forceinline__ Place locate(int C, int G, int W, int P, int N,
                                        int slice) {
  Place p;
  p.C = C;
  p.G = G;
  p.W = W;
  p.lane = threadIdx.x & 31;
  p.warp = threadIdx.x >> 5;
  p.g = p.warp / W;
  p.w = p.warp % W;
  p.rank = blockIdx.x % C;
  const int unit = blockIdx.x / C;  // the cluster: G poses of one frame
  const int groups = (P + G - 1) / G;
  p.b = unit / groups;
  p.j = (unit % groups) * G + p.g;
  p.start = p.rank * slice;
  p.len = max(0, min(slice, N - p.start));
  p.slice = slice;
  return p;
}

// The place in a layout of one pose a CTA and no cluster (C = G = 1,
// W = blockDim.x / 32): CTA x holds pose x of the flat (frame, pose)
// index, so none of locate's divisions by the layout's sizes (one by P).
__device__ __forceinline__ Place locate_one_pose(int P, int N) {
  Place p;
  p.C = 1;
  p.G = 1;
  p.W = blockDim.x >> 5;
  p.lane = threadIdx.x & 31;
  p.warp = threadIdx.x >> 5;
  p.g = 0;
  p.w = p.warp;
  p.rank = 0;
  p.b = blockIdx.x / P;
  p.j = blockIdx.x - p.b * P;
  p.start = 0;
  p.len = N;
  p.slice = N;
  return p;
}

// Stages the CTA's slice of frame p.b's pixels into x | y | z | u | v of
// p.slice floats each.  Where the slice starts 16-byte aligned (and the
// arrays' stride keeps float4 stores aligned), a thread moves 4 pixels at
// a time: 3 + 2 16-byte loads, 5 16-byte stores (0.5% off the refine
// kernel's cluster regimes against the scalar loop alone on the H100, no
// difference resolved elsewhere; PERF.md).  Every thread of the CTA must
// call it; the caller synchronises.
__device__ __forceinline__ void stage_slice(const float* __restrict__ coords,
                                            const float* __restrict__ pix,
                                            int N, const Place& p,
                                            float* smem) {
  const long long first = static_cast<long long>(p.b) * N + p.start;
  const float* c = coords + 3 * first;
  const float* q = pix + 2 * first;
  int done = 0;
  if (p.slice % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(q)) %
              16 ==
          0) {
    const float4* c4 = reinterpret_cast<const float4*>(c);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    float4* s4 = reinterpret_cast<float4*>(smem);
    const int t4 = p.slice / 4;
    for (int k = threadIdx.x; k < p.len / 4; k += blockDim.x) {
      const float4 a = c4[3 * k], b = c4[3 * k + 1], d = c4[3 * k + 2];
      const float4 u = q4[2 * k], v = q4[2 * k + 1];
      s4[k] = make_float4(a.x, a.w, b.z, d.y);
      s4[t4 + k] = make_float4(a.y, b.x, b.w, d.z);
      s4[2 * t4 + k] = make_float4(a.z, b.y, d.x, d.w);
      s4[3 * t4 + k] = make_float4(u.x, u.z, v.x, v.z);
      s4[4 * t4 + k] = make_float4(u.y, u.w, v.y, v.w);
    }
    done = p.len / 4 * 4;
  }
  for (int n = done + threadIdx.x; n < p.len; n += blockDim.x) {
    smem[n] = c[3 * n];
    smem[p.slice + n] = c[3 * n + 1];
    smem[2 * p.slice + n] = c[3 * n + 2];
    smem[3 * p.slice + n] = q[2 * n];
    smem[4 * p.slice + n] = q[2 * n + 1];
  }
}

// The pixels of a CTA's staged slice (x | y | z | u | v, `slice` floats
// each), pixel n of the slice.
struct StagedPixels {
  const float* s;
  int slice;
  __device__ __forceinline__ void operator()(int n, float& x, float& y,
                                             float& z, float& u,
                                             float& v) const {
    x = s[n];
    y = s[slice + n];
    z = s[2 * slice + n];
    u = s[3 * slice + n];
    v = s[4 * slice + n];
  }
};

// The pixels of the CTA's slice of frame p.b read from device memory as
// the caller's arrays of structs (coords (N, 3), pix (N, 2)), unstaged,
// through the read-only data cache (__ldg: 0.0061 device ms against
// 0.0069 with plain loads at 1 x 256 poses on the H100, PERF.md).
struct FramePixels {
  const float* __restrict__ c;
  const float* __restrict__ q;
  __device__ __forceinline__ FramePixels(const float* coords,
                                         const float* pix, int N,
                                         const Place& p) {
    const long long first = static_cast<long long>(p.b) * N + p.start;
    c = coords + 3 * first;
    q = pix + 2 * first;
  }
  __device__ __forceinline__ void operator()(int n, float& x, float& y,
                                             float& z, float& u,
                                             float& v) const {
    x = __ldg(c + 3 * n);
    y = __ldg(c + 3 * n + 1);
    z = __ldg(c + 3 * n + 2);
    u = __ldg(q + 2 * n);
    v = __ldg(q + 2 * n + 1);
  }
};

// The statistics of pose R, t over the thread's pixels of the CTA's slice,
// in order, read through `pixels` (StagedPixels or FramePixels: the same
// values, so the same sums).
template <typename Pixels>
__device__ __forceinline__ void sum_pixels(
    const float (&R)[9], const float (&t)[3], const Pixels& pixels,
    const Place& p, float f, float cx, float cy, float max_err, float tau,
    float inv_beta, float (&acc)[kStats]) {
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.0f;
  add_pixels(R, t, p.w * 32 + p.lane, p.W * 32, p.len, pixels, f, cx, cy,
             max_err, tau, inv_beta, acc);
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

// The static shared memory of the sums: the warps' partials and the
// cluster's CTA partials, double-buffered by step parity (8 x 32 floats
// each), and the slots' two mbarriers (ops/gn_cuda.py:
// REFINE_STATIC_SMEM_BYTES).
struct PoseSums {
  float part[2][kMaxWarps][32];
  float slots[2][kMaxCluster][32];
  alignas(8) unsigned long long arrived[2];
};

// Initialises the cluster's mbarriers before any CTA sends; every thread
// of every CTA of the cluster must call it (no-op without a cluster).
__device__ __forceinline__ void init_exchange(PoseSums& sums, const Place& p) {
  if (p.C > 1) {
    if (threadIdx.x == 0) {
      mbarrier_init(smem_addr(&sums.arrived[0]));
      mbarrier_init(smem_addr(&sums.arrived[1]));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cooperative_groups::this_cluster().sync();
  }
}

// The pose's sums of step `step`, in a fixed order: each thread's pixels in
// order (acc), the warp by the transposed butterfly, the pose's W warps in
// warp order, the cluster's C CTAs in rank order.  Lane k < kStats of
// every warp of the pose returns statistic k, in every CTA of the cluster.
// Every warp of the pose (and of its cluster) must call it at every step.
__device__ __forceinline__ float pose_sum(const float (&acc)[kStats],
                                          const Place& p, int step,
                                          PoseSums& sums) {
  const int par = step & 1;
  float s = warp_sum_transposed(acc, p.lane);
  if (p.W > 1) {  // the pose's warps in this CTA, in warp order
    sums.part[par][p.warp][p.lane] = s;
    group_sync(p.g, p.W * 32);
    s = sum_in_order<kMaxWarps>(p.W, [&](int q) {
      return sums.part[par][p.g * p.W + q][p.lane];
    });
  }
  if (p.C > 1) {  // the cluster's CTAs, in rank order
    const unsigned bar = smem_addr(&sums.arrived[par]);
    if (p.w == 0) {  // this CTA's sums into slot `rank` of every CTA
      if (p.lane == 0) expect_bytes(bar, p.C * 32 * sizeof(float));
      const unsigned slot = smem_addr(&sums.slots[par][p.rank][p.lane]);
      for (int r = 0; r < p.C; ++r)
        send(map_rank(slot, r), s, map_rank(bar, r));
    }
    wait_phase(bar, (step >> 1) & 1);
    s = sum_in_order<kMaxCluster>(p.C, [&](int r) {
      return sums.slots[par][r][p.lane];
    });
  }
  return s;
}

// Launches kernel(args) over B frames in the layout of args (its
// cluster, poses_per_cta, warps_per_pose, P and N), after setting
// args.slice = ceil(N / cluster), with the slice's 20 bytes a pixel as
// dynamic shared memory if `staged` (none otherwise; the legal layouts are
// the same).  Returns a CUDA error code:
// cudaErrorInvalidValue for a layout the kernels do not take
// (ops/gn_cuda.py:check_refine_layout), or whatever the launch reports (a
// cluster the card cannot schedule is an error, never a smaller cluster).
template <typename Args>
int launch_in_layout(void (*kernel)(Args), Args args, int B, bool staged,
                     cudaStream_t stream) {
  const int C = args.cluster, G = args.poses_per_cta, W = args.warps_per_pose;
  const bool legal = (C == 1 || C == 2 || C == 4 || C == kMaxCluster) &&
                     G >= 1 && W >= 1 && G * W <= kMaxWarps &&
                     (C == 1 || G == 1) && args.N >= 0;
  if (!legal) return static_cast<int>(cudaErrorInvalidValue);
  args.slice = (args.N + C - 1) / C;
  const size_t smem =
      staged ? sizeof(float) * 5 * static_cast<size_t>(args.slice) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned>(B * ((args.P + G - 1) / G) * C));
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dsac_irls
