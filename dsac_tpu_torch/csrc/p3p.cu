// Batched 4-point minimal P3P: one thread per attempt lane.
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
// Bound on the H100: neither memory nor the f32 pipes at the serve shapes:
// a launch of 2k-4k lanes fills under a quarter of the card's threads, so
// the launch and the dependent chain of one lane's arithmetic set the time.
// The design keeps every intermediate in registers (no shared memory, no
// intermediates in device memory), so one launch serves every lane of a
// whole batch of frames.  CUDA's acosf and cbrtf take the place of the
// TPU kernel's polynomial acos and exp/log cube root: only the Newton
// steps set the root's accuracy.

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

__global__ void p3p_kernel(const float* __restrict__ obj,
                           const float* __restrict__ pix, int M, float f,
                           float cx, float cy, float* __restrict__ R_out,
                           float* __restrict__ t_out,
                           bool* __restrict__ valid_out,
                           float* __restrict__ worst_out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= M) return;
  const float* o = obj + 12 * lane;
  const float* p = pix + 8 * lane;

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

  float y_quads[4] = {sq / 2.0f + sq1, sq / 2.0f - sq1, -sq / 2.0f + sq2,
                      -sq / 2.0f - sq2};
  bool real_quads[4] = {disc1 >= -1e-6f, disc1 >= -1e-6f, disc2 >= -1e-6f,
                        disc2 >= -1e-6f};
  float y_biq[4] = {sq_ba, -sq_ba, sq_bb, -sq_bb};
  bool ra = (disc_b >= 0.0f) && (y2a >= 0.0f);
  bool rb = (disc_b >= 0.0f) && (y2b >= 0.0f);
  bool real_biq[4] = {ra, ra, rb, rb};

  bool nondegen = fminf(fminf(a2, b2), c2) > 1.0f;  // > 1 mm^2

  // triad of the scene points is root-independent
  V3 n0a = normalize(sub(X[1], X[0]));
  V3 n2a = normalize(cross(n0a, sub(X[2], X[0])));
  V3 n1a = cross(n2a, n0a);
  V3 cX = {(X[0].x + X[1].x + X[2].x) / 3.0f,
           (X[0].y + X[1].y + X[2].y) / 3.0f,
           (X[0].z + X[1].z + X[2].z) / 3.0f};

  float best_err = 1e30f;
  float bR[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float bt[3] = {0.f, 0.f, 0.f};
  bool any_valid = false;

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v = (biq ? y_biq[k] : y_quads[k]) - b / 4.0f;
    bool is_real = biq ? real_biq[k] : real_quads[k];
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
    float ex = Rk[0] * X[3].x + Rk[1] * X[3].y + Rk[2] * X[3].z + tk[0];
    float ey = Rk[3] * X[3].x + Rk[4] * X[3].y + Rk[5] * X[3].z + tk[1];
    float ez = Rk[6] * X[3].x + Rk[7] * X[3].y + Rk[8] * X[3].z + tk[2];
    bool front = ez < 0.0f;
    float ezg = fabsf(ez) < 1e-8f ? -1e-8f : ez;
    float du = U[3] - (-f * ex / ezg + cx);
    float dv = Vp[3] - (f * ey / ezg + cy);
    float err4 = sqrtf(du * du + dv * dv + 1e-8f);

    bool ok = rvalid && front;
    any_valid = any_valid || ok;
    float err4m = ok ? err4 : 1e30f;
    if (err4m < best_err) {
      best_err = err4m;
      for (int j = 0; j < 9; ++j) bR[j] = Rk[j];
      for (int j = 0; j < 3; ++j) bt[j] = tk[j];
    }
  }

  if (!any_valid) {  // identity fallback (safeSolvePnP zero pose)
    for (int j = 0; j < 9; ++j) bR[j] = (j % 4 == 0) ? 1.0f : 0.0f;
    for (int j = 0; j < 3; ++j) bt[j] = 0.0f;
  }

  // worst reprojection error over the 4 support points
  float worst = 0.0f;
  for (int i = 0; i < 4; ++i) {
    float ex = bR[0] * X[i].x + bR[1] * X[i].y + bR[2] * X[i].z + bt[0];
    float ey = bR[3] * X[i].x + bR[4] * X[i].y + bR[5] * X[i].z + bt[1];
    float ez = bR[6] * X[i].x + bR[7] * X[i].y + bR[8] * X[i].z + bt[2];
    float ezg = fabsf(ez) < 1e-8f ? -1e-8f : ez;
    float du = U[i] - (-f * ex / ezg + cx);
    float dv = Vp[i] - (f * ey / ezg + cy);
    worst = fmaxf(worst, sqrtf(du * du + dv * dv + 1e-8f));
  }

  for (int j = 0; j < 9; ++j) R_out[9 * lane + j] = bR[j];
  for (int j = 0; j < 3; ++j) t_out[3 * lane + j] = bt[j];
  valid_out[lane] = any_valid;
  worst_out[lane] = worst;
}

}  // namespace

extern "C" int dsac_p3p_solve(const float* obj, const float* pix, int M,
                              float f, float cx, float cy, float* R,
                              float* t, bool* valid, float* worst,
                              cudaStream_t stream) {
  if (M <= 0) return 0;
  const int threads = 128;
  const int blocks = (M + threads - 1) / threads;
  p3p_kernel<<<blocks, threads, 0, stream>>>(obj, pix, M, f, cx, cy, R, t,
                                             valid, worst);
  return static_cast<int>(cudaGetLastError());
}
