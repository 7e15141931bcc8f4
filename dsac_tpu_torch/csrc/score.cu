// Fused soft-inlier scoring: each hypothesis's pixels split over several
// warps of one CTA, summed in a fixed order.
//
// Replaces dsac_tpu/ops/diffmap_pallas.py:_score_kernel (wrapper
// soft_inlier_scores_pallas).  For hypothesis [R|t] of frame b and each of
// the frame's N pixels: the clamped reprojection error of reproj.cuh,
// then the sum of sigmoid((tau - e) / beta).  The (H, N) error surface is
// never stored.
//
// Work per (hypothesis, pixel) pair: 42 f32 operations (chip_smoke.py's
// SCORE_OPS_PER_PAIR): 36 for the error (reproj.cuh), 6 for the sigmoid
// and the sum.
//
// Bound on the H100: f32 issue.  The 42 counted operations are ~80
// instructions in SASS: the IEEE divides (1 / z, and the sigmoid's 1 / (1
// + e)) and the IEEE sqrtf are MUFU plus Newton steps behind a range check
// that branches to a slow path, expf is 9 instructions, and the guard and
// clamp are compare-and-select.  A warp cannot overlap one pixel's chain
// with the next across those branches, so the time is set by the
// instructions issued and by how many warps each SM switches between.
// The first design gave one warp to a (frame, hypothesis): a serve batch
// of 8 x 256 hypotheses was a quarter of the H100's warp slots, each warp
// walking 1,600 pixels in series, at ~0.3 instructions a cycle per
// scheduler.
//
// This design (layout ops/diffmap_cuda.py:ScoreLayout, chosen per launch
// by score_layout):
// - a CTA holds `hyps_per_cta` hypotheses of one frame and gives each
//   `warps_per_hyp` warps, which split its pixels (lane l of warp w takes
//   pixels w * 32 + l, + 32 W, ...): a serve batch fills every SM with a
//   CTA of 32 warps (16 hypotheses x 2 warps);
// - the frame's pixels are staged once per CTA in shared memory as five
//   SoA arrays (x, y, z, u, v; 20 bytes a pixel, 40 KB at the tile of
//   2,048 that holds N = 1,600), with 16-byte loads and stores where the
//   frame is aligned, and read by every hypothesis of the CTA; the tile is
//   a template parameter, so a pixel's five loads take one address
//   register and constant offsets; larger frames go tile by tile; above 48
//   KB the tile is dynamic shared memory;
// - each thread sums its pixels in order, each warp with a shuffle tree,
//   and the W partial sums of a hypothesis go through shared memory and
//   are added in warp order by one thread: one launch, no atomics, and a
//   hypothesis's score is bit-identical from launch to launch in a layout.
// The arithmetic is the reference's: IEEE /, sqrtf and expf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "reproj.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// Stages pixels [n0, n0 + len) of a frame (coordinates cb, pixels pb)
// into the SoA tile x | y | z | u | v of kTile floats each.  Where the
// pixel range starts 16-byte aligned, a thread moves 4 pixels at a time:
// 3 + 2 16-byte loads, 5 16-byte stores, so that a CTA's loads are all in
// flight at once.
template <int kTile>
__device__ __forceinline__ void stage(const float* __restrict__ cb,
                                      const float* __restrict__ pb, int n0,
                                      int len, float* smem) {
  const float* c = cb + 3 * n0;
  const float* q = pb + 2 * n0;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(q)) %
          16 ==
      0) {
    const float4* c4 = reinterpret_cast<const float4*>(c);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    float4* s4 = reinterpret_cast<float4*>(smem);
    constexpr int t4 = kTile / 4;
    for (int k = threadIdx.x; k < len / 4; k += blockDim.x) {
      const float4 a = c4[3 * k], b = c4[3 * k + 1], d = c4[3 * k + 2];
      const float4 u = q4[2 * k], v = q4[2 * k + 1];
      s4[k] = make_float4(a.x, a.w, b.z, d.y);
      s4[t4 + k] = make_float4(a.y, b.x, b.w, d.z);
      s4[2 * t4 + k] = make_float4(a.z, b.y, d.x, d.w);
      s4[3 * t4 + k] = make_float4(u.x, u.z, v.x, v.z);
      s4[4 * t4 + k] = make_float4(u.y, u.w, v.y, v.w);
    }
    done = len / 4 * 4;
  }
  for (int n = done + threadIdx.x; n < len; n += blockDim.x) {
    smem[n] = c[3 * n];
    smem[kTile + n] = c[3 * n + 1];
    smem[2 * kTile + n] = c[3 * n + 2];
    smem[3 * kTile + n] = q[2 * n];
    smem[4 * kTile + n] = q[2 * n + 1];
  }
}

// kTile, the pixels a CTA stages at a time, is a compile-time constant so
// that the five SoA loads of a pixel address one register plus constant
// offsets.
template <int kTile>
__global__ void __launch_bounds__(kMaxThreads)
    score_kernel(const float* __restrict__ R, const float* __restrict__ t,
                 const float* __restrict__ coords,
                 const float* __restrict__ pix, int H, int N,
                 int hyps_per_cta, int warps_per_hyp, float f, float cx,
                 float cy, float tau, float inv_beta, float max_err,
                 float* __restrict__ out) {
  // x, y, z, u, v of kTile pixels, then one partial sum a warp
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* partial = smem + 5 * kTile;

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = warp / warps_per_hyp, w = warp % warps_per_hyp;
  const int step = 32 * warps_per_hyp;
  const float* cb = coords + 3 * static_cast<long long>(b) * N;
  const float* pb = pix + 2 * static_cast<long long>(b) * N;
  const bool one_tile = kTile >= N;
  if (one_tile) {
    stage<kTile>(cb, pb, 0, N, smem);
    __syncthreads();
  }

  const int h0 = blockIdx.x * hyps_per_cta;
  const int h = h0 + g;
  const bool live = h < H;
  float p[12] = {};
  if (live) {
    const long long bh = static_cast<long long>(b) * H + h;
    for (int j = 0; j < 9; ++j) p[j] = R[9 * bh + j];
    for (int j = 0; j < 3; ++j) p[9 + j] = t[3 * bh + j];
  }
  float acc = 0.0f;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    const int len = min(kTile, N - n0);
    if (!one_tile) {
      __syncthreads();  // every warp is done with the last tile
      stage<kTile>(cb, pb, n0, len, smem);
      __syncthreads();
    }
    if (live) {
      for (int n = w * 32 + lane; n < len; n += step) {
        const float* s = smem + n;
        const float err = dsac_reproj::error(
            p, s[0], s[kTile], s[2 * kTile], s[3 * kTile], s[4 * kTile], f,
            cx, cy, max_err);
        acc += 1.0f / (1.0f + expf(-(tau - err) * inv_beta));
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFullMask, acc, off);
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (threadIdx.x < hyps_per_cta && h0 + threadIdx.x < H) {
    float sum = 0.0f;
    for (int k = 0; k < warps_per_hyp; ++k)
      sum += partial[threadIdx.x * warps_per_hyp + k];
    out[static_cast<long long>(b) * H + h0 + threadIdx.x] = sum;
  }
}

template <int kTile>
int launch(const float* R, const float* t, const float* coords,
           const float* pix, int B, int H, int N, int hyps_per_cta,
           int warps_per_hyp, int grid_x, float f, float cx, float cy,
           float tau, float inv_beta, float max_err, float* out,
           cudaStream_t stream) {
  const int threads = hyps_per_cta * warps_per_hyp * 32;
  const size_t smem = sizeof(float) * (5 * kTile + threads / 32);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        score_kernel<kTile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  score_kernel<kTile><<<dim3(grid_x, B), threads, smem, stream>>>(
      R, t, coords, pix, H, N, hyps_per_cta, warps_per_hyp, f, cx, cy, tau,
      inv_beta, max_err, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Grid (grid_x, B) of CTAs of hyps_per_cta x warps_per_hyp warps, each
// CTA hyps_per_cta hypotheses, as ops/diffmap_cuda.py:score_grid computes
// it; `tile` is one of SCORE_TILES there.
extern "C" int dsac_soft_inlier_scores(
    const float* R, const float* t, const float* coords, const float* pix,
    int B, int H, int N, int hyps_per_cta, int warps_per_hyp, int tile,
    int grid_x, float f, float cx, float cy, float tau, float inv_beta,
    float max_err, float* out, cudaStream_t stream) {
  if (B * H <= 0) return 0;
  if (hyps_per_cta < 1 || warps_per_hyp < 1 ||
      hyps_per_cta * warps_per_hyp * 32 > kMaxThreads || grid_x < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  using Launch = int (*)(const float*, const float*, const float*,
                        const float*, int, int, int, int, int, int, float,
                        float, float, float, float, float, float*,
                        cudaStream_t);
  const Launch fn = tile == 256    ? launch<256>
                    : tile == 2048 ? launch<2048>
                                   : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(R, t, coords, pix, B, H, N, hyps_per_cta, warps_per_hyp, grid_x,
            f, cx, cy, tau, inv_beta, max_err, out, stream);
}
