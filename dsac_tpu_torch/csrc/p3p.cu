// Batched 4-point minimal P3P: a quad of 4 threads per attempt lane (one
// thread per quartic root), or one thread per lane.
//
// Replaces dsac_tpu/ops/p3p_pallas.py:_p3p_kernel (wrapper
// p3p_solve_pallas).  Per lane: pixel bearings -> Grunert quartic ->
// closed-form roots (Ferrari, Cardano / trigonometric resolvent) -> three
// Newton steps -> ranges -> triad alignment per root -> 4th-point
// disambiguation -> worst-of-4 support reprojection error.  A lane with no
// valid root returns the identity pose.
//
// Work per lane: 80 B in, 53 B out, and about 1,500 f32 operations
// (chip_smoke.py's P3P_OPS_PER_LANE): ~350 shared by the roots (bearings,
// quartic coefficients, resolvent cubic and roots, scene triad), 4 x ~250
// per root (3 Newton steps, ranges, triad alignment, 4th-point check) and
// ~150 for the worst-of-4 support error.
//
// Bound on the H100: neither memory nor the f32 pipes at the serve shapes
// (2k-4k lanes a launch): the dependent chain of one lane's arithmetic
// sets the time.  So the kernel spreads a lane over a quad of 4 adjacent
// threads (kThreadsPerLane = 4): each runs the root-independent prefix
// (~350 operations, redundantly: exchanging it would cost as many
// shuffles as it saves), then thread k polishes and checks root k; the
// quad picks the winner with two shuffle steps of an argmin over the
// 4th-point error that keeps the sequential loop's tie-break (the lowest
// root wins a tie), ORs the validity, and takes the worst support error
// with one support point per thread.  That cuts the chain to about a
// third and puts 4x the threads on the card.  With one thread per lane
// (kThreadsPerLane = 1) the same code runs the four roots in order.
// ops/p3p_cuda.py:p3p_layout picks the variant and the block size by the
// number of lanes.  Every intermediate stays in registers.  CUDA's acosf
// and cbrtf take the place of the TPU kernel's polynomial acos and
// exp/log cube root: only the Newton steps set the root's accuracy.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 a) {
  float inv = 1.0f / sqrtf(dot(a, a) + 1e-12f);
  return {a.x * inv, a.y * inv, a.z * inv};
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T pick4(int k, T a0, T a1, T a2, T a3) {
  return k == 0 ? a0 : k == 1 ? a1 : k == 2 ? a2 : a3;
}

// Reprojection error of scene point X at pixel (u, v) under R, t, with
// the depth guard |z| < 1e-8 -> -1e-8.
__device__ __forceinline__ float reproj_err(const float (&R)[9],
                                            const float (&t)[3], V3 X,
                                            float u, float v, float f,
                                            float cx, float cy) {
  float ex = R[0] * X.x + R[1] * X.y + R[2] * X.z + t[0];
  float ey = R[3] * X.x + R[4] * X.y + R[5] * X.z + t[1];
  float ez = R[6] * X.x + R[7] * X.y + R[8] * X.z + t[2];
  float ezg = fabsf(ez) < 1e-8f ? -1e-8f : ez;
  float du = u - (-f * ex / ezg + cx);
  float dv = v - (f * ey / ezg + cy);
  return sqrtf(du * du + dv * dv + 1e-8f);
}

template <int kThreadsPerLane>
__global__ void p3p_kernel(const float* __restrict__ obj,
                           const float* __restrict__ pix, int M, float f,
                           float cx, float cy, float* __restrict__ R_out,
                           float* __restrict__ t_out,
                           bool* __restrict__ valid_out,
                           float* __restrict__ worst_out) {
  const long long thread =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(thread / kThreadsPerLane);
  const int tq = static_cast<int>(thread % kThreadsPerLane);  // root
  // a quad is 4 adjacent threads of one warp: it leaves (or stays) whole
  if (lane >= M) return;
  const unsigned quad = kThreadsPerLane == 1
                            ? 0u
                            : 0xfu << ((threadIdx.x & 31) & ~3u);
  const float* o = obj + 12 * static_cast<long long>(lane);
  const float* p = pix + 8 * static_cast<long long>(lane);

  V3 X[4];
  float U[4], Vp[4];
  V3 F[4];
  for (int i = 0; i < 4; ++i) {
    X[i] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    U[i] = p[2 * i];
    Vp[i] = p[2 * i + 1];
    float bx = (U[i] - cx) / f;
    float by = -(Vp[i] - cy) / f;
    float inv = 1.0f / sqrtf(bx * bx + by * by + 1.0f);
    F[i] = {bx * inv, by * inv, -inv};
  }

  // ---- Grunert coefficients (geometry/p3p.py:p3p_grunert) ----
  V3 d23 = sub(X[1], X[2]), d13 = sub(X[0], X[2]), d12 = sub(X[0], X[1]);
  float a2 = dot(d23, d23), b2 = dot(d13, d13), c2 = dot(d12, d12);
  float b2s = fmaxf(b2, 1e-12f);
  float ca = dot(F[1], F[2]), cb = dot(F[0], F[2]), cg = dot(F[0], F[1]);
  auto ratio = [b2s](float x) { return clampf(x / b2s, -1e4f, 1e4f); };
  float q = ratio(a2 - c2);
  float s = ratio(a2 + c2);

  float A4 = (q - 1.0f) * (q - 1.0f) - 4.0f * ratio(c2) * ca * ca;
  float A3 = 4.0f * (q * (1.0f - q) * cb - (1.0f - s) * ca * cg +
                     2.0f * ratio(c2) * ca * ca * cb);
  float A2 = 2.0f * (q * q - 1.0f + 2.0f * q * q * cb * cb +
                     2.0f * ratio(b2 - c2) * ca * ca -
                     4.0f * s * ca * cb * cg +
                     2.0f * ratio(b2 - a2) * cg * cg);
  float A1 = 4.0f * (-q * (1.0f + q) * cb + 2.0f * ratio(a2) * cg * cg * cb -
                     (1.0f - s) * ca * cg);
  float A0 = (1.0f + q) * (1.0f + q) - 4.0f * ratio(a2) * cg * cg;
  float nrm = fmaxf(fmaxf(fmaxf(fabsf(A4), fabsf(A3)),
                          fmaxf(fabsf(A2), fabsf(A1))),
                    fabsf(A0)) + 1e-12f;
  A4 /= nrm;
  A3 /= nrm;
  A2 /= nrm;
  A1 /= nrm;
  A0 /= nrm;

  // ---- closed-form quartic (geometry/p3p.py:_solve_quartic_real) ----
  float scale = fabsf(A4) < 1e-12f ? (A4 < 0.0f ? -1e-12f : 1e-12f) : A4;
  float b = clampf(A3 / scale, -1e4f, 1e4f);
  float c = clampf(A2 / scale, -1e4f, 1e4f);
  float d = clampf(A1 / scale, -1e4f, 1e4f);
  float e = clampf(A0 / scale, -1e4f, 1e4f);
  float bb = b * b;
  float pq = c - 3.0f * bb / 8.0f;
  float qq = d - b * c / 2.0f + b * bb / 8.0f;
  float r = e - b * d / 4.0f + bb * c / 16.0f - 3.0f * bb * bb / 256.0f;

  // largest real root of m^3 + pq m^2 + (pq^2/4 - r) m - qq^2/8
  float cb3 = pq, cc3 = pq * pq / 4.0f - r, cd3 = -qq * qq / 8.0f;
  float p3 = cc3 - cb3 * cb3 / 3.0f;
  float q3 = 2.0f * cb3 * cb3 * cb3 / 27.0f - cb3 * cc3 / 3.0f + cd3;
  float disc3 = (q3 / 2.0f) * (q3 / 2.0f) +
                (p3 / 3.0f) * (p3 / 3.0f) * (p3 / 3.0f);
  float sq3 = sqrtf(fmaxf(disc3, 0.0f));
  float t_card = cbrtf(-q3 / 2.0f + sq3) + cbrtf(-q3 / 2.0f - sq3);
  float p_neg = fminf(p3, -1e-20f);
  float mm = 2.0f * sqrtf(-p_neg / 3.0f);
  float arg = clampf(3.0f * q3 / (p_neg * mm), -1.0f, 1.0f);
  float t_trig = mm * cosf(acosf(arg) / 3.0f);
  float m = (disc3 >= 0.0f ? t_card : t_trig) - cb3 / 3.0f;
  m = fmaxf(m, 0.0f);

  float s2q = 2.0f * m;
  float sq = sqrtf(fmaxf(s2q, 0.0f));
  float q_over_2s = qq / fmaxf(2.0f * sq, 1e-12f);
  bool biq = (fabsf(qq) < 1e-10f) && (sq < 1e-10f);
  float disc_b = pq * pq - 4.0f * r;
  float sqdb = sqrtf(fmaxf(disc_b, 0.0f));
  float y2a = (-pq + sqdb) / 2.0f;
  float y2b = (-pq - sqdb) / 2.0f;
  float c1 = pq / 2.0f + m + q_over_2s;
  float c2q = pq / 2.0f + m - q_over_2s;
  float disc1 = s2q / 4.0f - c1;
  float disc2 = s2q / 4.0f - c2q;
  float sq1 = sqrtf(fmaxf(disc1, 0.0f));
  float sq2 = sqrtf(fmaxf(disc2, 0.0f));
  float sq_ba = sqrtf(fmaxf(y2a, 0.0f));
  float sq_bb = sqrtf(fmaxf(y2b, 0.0f));

  // the four roots of the depressed quartic (k = 0..3), and whether each
  // is real, for the general and the biquadratic case
  float y_q0 = sq / 2.0f + sq1, y_q1 = sq / 2.0f - sq1;
  float y_q2 = -sq / 2.0f + sq2, y_q3 = -sq / 2.0f - sq2;
  bool rq1 = disc1 >= -1e-6f, rq2 = disc2 >= -1e-6f;
  float y_biq0 = sq_ba, y_biq1 = -sq_ba, y_biq2 = sq_bb, y_biq3 = -sq_bb;
  bool ra = (disc_b >= 0.0f) && (y2a >= 0.0f);
  bool rb = (disc_b >= 0.0f) && (y2b >= 0.0f);

  bool nondegen = fminf(fminf(a2, b2), c2) > 1.0f;  // > 1 mm^2

  // triad of the scene points is root-independent
  V3 n0a = normalize(sub(X[1], X[0]));
  V3 n2a = normalize(cross(n0a, sub(X[2], X[0])));
  V3 n1a = cross(n2a, n0a);
  V3 cX = {(X[0].x + X[1].x + X[2].x) / 3.0f,
           (X[0].y + X[1].y + X[2].y) / 3.0f,
           (X[0].z + X[1].z + X[2].z) / 3.0f};

  // Each thread takes the roots k = tq, tq + kThreadsPerLane, ... in
  // order and keeps the first with the least 4th-point error; the
  // sequential loop's `err4m < best_err` with best_err = 1e30 at the start
  // is key < best_key with key = err4 where ok and err4 < 1e30, else inf
  // (NaN too).  A finite key needs a valid root, so a lane with no valid
  // root keeps the identity (safeSolvePnP's zero pose).
  float best_key = INFINITY;
  int best_k = 4;
  float bR[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float bt[3] = {0.f, 0.f, 0.f};
  bool any_valid = false;

#pragma unroll
  for (int r = 0; r < 4 / kThreadsPerLane; ++r) {
    const int k = tq + r * kThreadsPerLane;
    float v = (biq ? pick4(k, y_biq0, y_biq1, y_biq2, y_biq3)
                   : pick4(k, y_q0, y_q1, y_q2, y_q3)) - b / 4.0f;
    bool is_real = biq ? (k < 2 ? ra : rb) : (k < 2 ? rq1 : rq2);
    // Newton polish against the normalised coefficients
    for (int it = 0; it < 3; ++it) {
      float dpv = ((4.0f * A4 * v + 3.0f * A3) * v + 2.0f * A2) * v + A1;
      if (fabsf(dpv) < 1e-10f) dpv = (dpv < 0.0f ? -1e-10f : 1e-10f) + 1e-12f;
      float pv = (((A4 * v + A3) * v + A2) * v + A1) * v + A0;
      v = v - clampf(pv / dpv, -10.0f, 10.0f);
      v = clampf(v, -100.0f, 100.0f);
    }
    float denom_u = 2.0f * (cg - v * ca);
    if (fabsf(denom_u) < 1e-3f) denom_u = denom_u < 0.0f ? -1e-3f : 1e-3f;
    float u = clampf(((q - 1.0f) * v * v - 2.0f * q * cb * v + 1.0f + q) /
                         denom_u,
                     -1e3f, 1e3f);
    float s1_sq = b2s / fmaxf(1.0f + v * v - 2.0f * v * cb, 1e-12f);
    float s1 = clampf(sqrtf(fmaxf(s1_sq, 1e-12f)), 0.0f, 1e6f);
    float s2r = u * s1, s3r = v * s1;
    bool rvalid = is_real && (v > 0.0f) && (u > 0.0f) && nondegen;

    V3 Y0 = {s1 * F[0].x, s1 * F[0].y, s1 * F[0].z};
    V3 Y1 = {s2r * F[1].x, s2r * F[1].y, s2r * F[1].z};
    V3 Y2 = {s3r * F[2].x, s3r * F[2].y, s3r * F[2].z};
    V3 n0b = normalize(sub(Y1, Y0));
    V3 n2b = normalize(cross(n0b, sub(Y2, Y0)));
    V3 n1b = cross(n2b, n0b);
    // R = tb @ ta^T
    float nb[3][3] = {{n0b.x, n0b.y, n0b.z},
                      {n1b.x, n1b.y, n1b.z},
                      {n2b.x, n2b.y, n2b.z}};
    float na[3][3] = {{n0a.x, n0a.y, n0a.z},
                      {n1a.x, n1a.y, n1a.z},
                      {n2a.x, n2a.y, n2a.z}};
    float Rk[9];
    for (int bi = 0; bi < 3; ++bi)
      for (int ai = 0; ai < 3; ++ai)
        Rk[3 * bi + ai] = nb[0][bi] * na[0][ai] + nb[1][bi] * na[1][ai] +
                          nb[2][bi] * na[2][ai];
    V3 cY = {(Y0.x + Y1.x + Y2.x) / 3.0f, (Y0.y + Y1.y + Y2.y) / 3.0f,
             (Y0.z + Y1.z + Y2.z) / 3.0f};
    float tk[3] = {cY.x - (Rk[0] * cX.x + Rk[1] * cX.y + Rk[2] * cX.z),
                   cY.y - (Rk[3] * cX.x + Rk[4] * cX.y + Rk[5] * cX.z),
                   cY.z - (Rk[6] * cX.x + Rk[7] * cX.y + Rk[8] * cX.z)};

    // 4th-point disambiguation
    float ez = Rk[6] * X[3].x + Rk[7] * X[3].y + Rk[8] * X[3].z + tk[2];
    bool front = ez < 0.0f;
    float err4 = reproj_err(Rk, tk, X[3], U[3], Vp[3], f, cx, cy);

    bool ok = rvalid && front;
    any_valid = any_valid || ok;
    float key = ok && err4 < 1e30f ? err4 : INFINITY;
    if (key < best_key) {
      best_key = key;
      best_k = k;
      for (int j = 0; j < 9; ++j) bR[j] = Rk[j];
      for (int j = 0; j < 3; ++j) bt[j] = tk[j];
    }
  }

  float worst = 0.0f;
  if (kThreadsPerLane == 1) {
    for (int i = 0; i < 4; ++i)
      worst = fmaxf(worst, reproj_err(bR, bt, X[i], U[i], Vp[i], f, cx, cy));
  } else {
    // the quad's argmin (ties to the lower root) and OR
    for (int off = 1; off < 4; off <<= 1) {
      float other_key = __shfl_xor_sync(quad, best_key, off);
      int other_k = __shfl_xor_sync(quad, best_k, off);
      if (other_key < best_key ||
          (other_key == best_key && other_k < best_k)) {
        best_key = other_key;
        best_k = other_k;
      }
      any_valid = __shfl_xor_sync(quad, static_cast<int>(any_valid), off) ||
                  any_valid;
    }
    // the winner's pose on every thread of the quad (identity if none)
    const bool won = best_key < INFINITY;
    const int src = ((threadIdx.x & 31) & ~3) | (won ? best_k : 0);
    for (int j = 0; j < 9; ++j) {
      float x = __shfl_sync(quad, bR[j], src);
      bR[j] = won ? x : (j % 4 == 0 ? 1.0f : 0.0f);
    }
    for (int j = 0; j < 3; ++j) {
      float x = __shfl_sync(quad, bt[j], src);
      bt[j] = won ? x : 0.0f;
    }
    // worst reprojection error over the 4 support points, one a thread
    worst = fmaxf(worst, reproj_err(bR, bt,
                                    pick4(tq, X[0], X[1], X[2], X[3]),
                                    pick4(tq, U[0], U[1], U[2], U[3]),
                                    pick4(tq, Vp[0], Vp[1], Vp[2], Vp[3]),
                                    f, cx, cy));
    for (int off = 1; off < 4; off <<= 1)
      worst = fmaxf(worst, __shfl_xor_sync(quad, worst, off));
  }
  if (tq == 0) {
    const long long l = lane;
    for (int j = 0; j < 9; ++j) R_out[9 * l + j] = bR[j];
    for (int j = 0; j < 3; ++j) t_out[3 * l + j] = bt[j];
    valid_out[l] = any_valid;
    worst_out[l] = worst;
  }
}

}  // namespace

// Solves M lanes with threads_per_lane (1 or 4) threads each, in blocks of
// `block` threads (a multiple of 32), as ops/p3p_cuda.py:p3p_layout
// chooses.  Returns a CUDA error code (cudaErrorInvalidValue for a layout
// the kernel does not take).
extern "C" int dsac_p3p_solve(const float* obj, const float* pix, int M,
                              float f, float cx, float cy,
                              int threads_per_lane, int block, float* R,
                              float* t, bool* valid, float* worst,
                              cudaStream_t stream) {
  if (M <= 0) return 0;
  if (block < 32 || block > 1024 || block % 32 != 0 ||
      (threads_per_lane != 1 && threads_per_lane != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(M) * threads_per_lane;
  const unsigned blocks =
      static_cast<unsigned>((threads + block - 1) / block);
  if (threads_per_lane == 4)
    p3p_kernel<4><<<blocks, block, 0, stream>>>(obj, pix, M, f, cx, cy, R, t,
                                                valid, worst);
  else
    p3p_kernel<1><<<blocks, block, 0, stream>>>(obj, pix, M, f, cx, cy, R, t,
                                                valid, worst);
  return static_cast<int>(cudaGetLastError());
}
