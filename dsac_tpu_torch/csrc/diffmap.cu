// Dense reprojection-error surface: one block per (frame, tile of
// kTile hypotheses), threads along the pixels.
//
// Replaces dsac_tpu/ops/diffmap_pallas.py:_diffmap_kernel (wrapper
// diffmaps_pallas).  For hypothesis [R|t] of frame b and each of the
// frame's N pixels: transform the scene coordinate, project with the
// x-flip (u = -f X/Z + cx) under the |z| < 1e-8 -> -1e-8 guard, and write
// the error sqrt(du^2 + dv^2 + 1e-8) clamped at max_err to out[b, h, n].
// The (B, H, N) surface feeds the score CNN as (B * H, G, G) maps.
//
// Work per (hypothesis, pixel) pair: 36 f32 operations (chip_smoke.py's
// DIFFMAP_OPS_PER_PAIR): 18 for the rigid transform, 3 for the depth
// guard, 1 division, 8 for the two projected residuals, 6 for the error
// and its clamp.
//
// Bound on the H100: the writes.  The kernel stores 4 bytes for every 36
// operations (B * H * N * 4 bytes, 13.1 MB for a serve batch of 8 frames
// at H = 256, N = 1600), far below the card's ~20 operations a byte.  So
// the design keeps the tile's poses in shared memory, gives each thread
// one pixel at a time (its 5 inputs loaded once, in registers, for all
// kTile hypotheses), and lets consecutive threads write consecutive
// pixels of a hypothesis's row: every store of a warp is one coalesced
// 128-byte line.  This is not the TPU's (64, 512) tile grid: no padding,
// a bounds check on the ragged tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;  // hypotheses a block

__global__ void diffmap_kernel(const float* __restrict__ R,
                               const float* __restrict__ t,
                               const float* __restrict__ coords,
                               const float* __restrict__ pix, int H, int N,
                               float f, float cx, float cy, float max_err,
                               float* __restrict__ out) {
  __shared__ float pose[kTile][12];

  const int b = blockIdx.y;
  const int h0 = blockIdx.x * kTile;
  const int nh = min(kTile, H - h0);
  const int tid = threadIdx.x;
  if (tid < nh * 12) {
    const int k = tid / 12, j = tid % 12;
    const long long h = static_cast<long long>(b) * H + h0 + k;
    pose[k][j] = j < 9 ? R[9 * h + j] : t[3 * h + j - 9];
  }
  __syncthreads();

  const float* cb = coords + 3 * static_cast<long long>(b) * N;
  const float* pb = pix + 2 * static_cast<long long>(b) * N;
  float* ob = out + (static_cast<long long>(b) * H + h0) * N;
  for (int n = tid; n < N; n += kThreads) {
    const float x = cb[3 * n], y = cb[3 * n + 1], z = cb[3 * n + 2];
    const float pu = pb[2 * n], pv = pb[2 * n + 1];
    for (int k = 0; k < nh; ++k) {
      const float* p = pose[k];
      float ex = p[0] * x + p[1] * y + p[2] * z + p[9];
      float ey = p[3] * x + p[4] * y + p[5] * z + p[10];
      float ez = p[6] * x + p[7] * y + p[8] * z + p[11];
      if (fabsf(ez) < 1e-8f) ez = -1e-8f;
      float inv_z = 1.0f / ez;
      float du = pu - (-f * ex * inv_z + cx);
      float dv = pv - (f * ey * inv_z + cy);
      ob[static_cast<long long>(k) * N + n] =
          fminf(sqrtf(du * du + dv * dv + 1e-8f), max_err);
    }
  }
}

}  // namespace

extern "C" int dsac_diffmaps(const float* R, const float* t,
                             const float* coords, const float* pix, int B,
                             int H, int N, float f, float cx, float cy,
                             float max_err, float* out, cudaStream_t stream) {
  if (B * H <= 0 || N <= 0) return 0;
  const dim3 grid((H + kTile - 1) / kTile, B);
  diffmap_kernel<<<grid, kThreads, 0, stream>>>(R, t, coords, pix, H, N, f,
                                                cx, cy, max_err, out);
  return static_cast<int>(cudaGetLastError());
}
