// Dense reprojection-error surface: a grid over (pixel tile, hypothesis
// tile, frame), each thread `vec` consecutive pixels of every hypothesis
// of its tile, written with 16-byte stores.
//
// Replaces dsac_tpu/ops/diffmap_pallas.py:_diffmap_kernel (wrapper
// diffmaps_pallas).  For hypothesis [R|t] of frame b and each of the
// frame's N pixels: the clamped reprojection error of reproj.cuh, written
// to out[b, h, n].  The (B, H, N) surface feeds the score CNN as
// (B * H, G, G) maps.
//
// Work per (hypothesis, pixel) pair: 36 f32 operations (chip_smoke.py's
// DIFFMAP_OPS_PER_PAIR; reproj.cuh has the breakdown).
//
// Bound on the H100: the writes, 4 bytes for every 36 operations (B * H *
// N * 4 bytes, 13.1 MB for a serve batch of 8 frames at H = 256, N =
// 1,600, 0.0039 ms at 3.35 TB/s); close behind, f32 issue, since the IEEE
// divide and sqrtf (MUFU plus Newton steps behind a range check that
// branches to a slow path) make the 36 operations ~45 instructions.  The
// first design ran one CTA per (frame, tile of 8 hypotheses), 256 threads
// along the pixels: 32 CTAs on the H100's 132 SMs for one test_ransac
// frame, 7 pixel rounds a thread with the last a quarter full, and 4-byte
// stores, at 36% of the bound for a batch of 8.
//
// This design (layout ops/diffmap_cuda.py:DiffmapLayout, chosen per launch
// by diffmap_layout from the number of SMs):
// - the grid is (ceil(N / (vec * threads)), ceil(H / hyps_per_cta), B), so
//   that the pixel axis, and not only the hypotheses, spreads over the
//   card: one frame fills every SM (832 CTAs of 4 hypotheses x 128
//   pixels at H = 256);
// - a thread loads its `vec` pixels once (with vec = 4: 3 + 2 16-byte
//   loads of the AoS coordinates and pixels, held in registers as x, y, z,
//   u, v) and, for each hypothesis of the tile (its pose read from shared
//   memory, 3 16-byte broadcasts), computes the 4 errors step by step
//   across the pixels (reproj.cuh:errors, so that their chains interleave
//   between the IEEE branches) and writes them as one float4: a warp
//   writes 512 contiguous bytes of a row.  vec = 4 needs N % 4 == 0 and
//   16-byte aligned inputs (every row then starts 16-byte aligned: 6,400
//   bytes at N = 1,600), and is taken where it still leaves enough
//   threads (a batch of 8 frames); otherwise vec = 1 and scalar stores.  A
//   bounds check, not padding, ends the ragged tiles;
// - stores are plain (the score CNN reads the surface right after, from
//   the 50 MB L2).
// The arithmetic is the reference's: IEEE / and sqrtf.

#include <cuda_runtime.h>
#include <math.h>

#include "reproj.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
    diffmap_kernel(const float* __restrict__ R, const float* __restrict__ t,
                   const float* __restrict__ coords,
                   const float* __restrict__ pix, int H, int N,
                   int hyps_per_cta, float f, float cx, float cy,
                   float max_err, float* __restrict__ out) {
  extern __shared__ float4 pose4[];  // 3 float4 (R row-major, t) a pose
  float* pose = reinterpret_cast<float*>(pose4);

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * hyps_per_cta;
  const int nh = min(hyps_per_cta, H - h0);
  for (int i = threadIdx.x; i < 12 * nh; i += blockDim.x) {
    const int k = i / 12, j = i - 12 * k;
    const long long bh = static_cast<long long>(b) * H + h0 + k;
    pose[i] = j < 9 ? R[9 * bh + j] : t[3 * bh + j - 9];
  }
  __syncthreads();

  const int n = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (n >= N) return;
  const float* cb = coords + 3 * (static_cast<long long>(b) * N + n);
  const float* pb = pix + 2 * (static_cast<long long>(b) * N + n);
  float x[V], y[V], z[V], u[V], v[V];
  if constexpr (V == 4) {
    const float4* c4 = reinterpret_cast<const float4*>(cb);
    const float4* p4 = reinterpret_cast<const float4*>(pb);
    const float4 c0 = c4[0], c1 = c4[1], c2 = c4[2], q0 = p4[0], q1 = p4[1];
    x[0] = c0.x, y[0] = c0.y, z[0] = c0.z, x[1] = c0.w;
    y[1] = c1.x, z[1] = c1.y, x[2] = c1.z, y[2] = c1.w;
    z[2] = c2.x, x[3] = c2.y, y[3] = c2.z, z[3] = c2.w;
    u[0] = q0.x, v[0] = q0.y, u[1] = q0.z, v[1] = q0.w;
    u[2] = q1.x, v[2] = q1.y, u[3] = q1.z, v[3] = q1.w;
  } else {
    x[0] = cb[0], y[0] = cb[1], z[0] = cb[2], u[0] = pb[0], v[0] = pb[1];
  }
  float* ob = out + (static_cast<long long>(b) * H + h0) * N + n;
  for (int k = 0; k < nh; ++k) {
    float p[12];
    const float4 a = pose4[3 * k], c = pose4[3 * k + 1], d = pose4[3 * k + 2];
    p[0] = a.x, p[1] = a.y, p[2] = a.z, p[3] = a.w, p[4] = c.x, p[5] = c.y;
    p[6] = c.z, p[7] = c.w, p[8] = d.x, p[9] = d.y, p[10] = d.z, p[11] = d.w;
    float e[V];
    dsac_reproj::errors<V>(p, x, y, z, u, v, f, cx, cy, max_err, e);
    float* row = ob + static_cast<long long>(k) * N;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(row) = make_float4(e[0], e[1], e[2], e[3]);
    else
      row[0] = e[0];
  }
}

}  // namespace

// Grid (grid_x, ceil(H / hyps_per_cta), B) of `threads`-thread CTAs, as
// ops/diffmap_cuda.py:diffmap_grid computes it.
extern "C" int dsac_diffmaps(const float* R, const float* t,
                             const float* coords, const float* pix, int B,
                             int H, int N, int hyps_per_cta, int threads,
                             int vec, int grid_x, float f, float cx, float cy,
                             float max_err, float* out, cudaStream_t stream) {
  if (B * H <= 0 || N <= 0) return 0;
  if (hyps_per_cta < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || grid_x < 1 || !(vec == 1 || vec == 4) ||
      (vec == 4 && N % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, (H + hyps_per_cta - 1) / hyps_per_cta, B);
  const size_t smem = 3 * sizeof(float4) * hyps_per_cta;
  if (vec == 4)
    diffmap_kernel<4><<<grid, threads, smem, stream>>>(
        R, t, coords, pix, H, N, hyps_per_cta, f, cx, cy, max_err, out);
  else
    diffmap_kernel<1><<<grid, threads, smem, stream>>>(
        R, t, coords, pix, H, N, hyps_per_cta, f, cx, cy, max_err, out);
  return static_cast<int>(cudaGetLastError());
}
