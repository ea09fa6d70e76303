// Per-pixel Cook-Torrance shading (ops/shade_core.py::shade_core, both modes)
// as device code, shared by the fused forward kernel (raster_shade_row.cu)
// and its adjoint (shade_backward.cu), so the two can never drift.
//
// Uniform row layout (ops/shade_core.py::pack_shading_uniforms):
//   [0:3] eye, [3:6] ambient (unused by the IBL mode), [6:8] pad,
//   [8 + 10 i : 18 + 10 i] light i: strength(3), direction(3), position(3), spot power
//   [8 + 10 L : +27] IBL mode only: SH9 irradiance, sh[k][c] at 3 k + c
// Lights come directional first, then point, then spot.

#pragma once

#include <cuda_runtime.h>

namespace shade_core {

constexpr int kUniLight0 = 8;
constexpr int kUniPerLight = 10;
constexpr float kPi = 3.14159265359f;
constexpr float kInvPi = (float)(1.0 / 3.14159265359);
constexpr float kInvGamma = (float)(1.0 / 2.2);
constexpr float kLn2 = (float)0.6931471805599453;
constexpr int kIblChannels = 11;
// Ramamoorthi-Hanrahan constants c1..c5, and 2 c1, 2 c2 rounded once as the
// plain version rounds them.
constexpr float kC1 = 0.429043f, kC2x2 = (float)(2.0 * 0.511664), kC3 = 0.743125f;
constexpr float kC4 = 0.886227f, kC5 = 0.247708f, kC1x2 = (float)(2.0 * 0.429043);

__device__ __forceinline__ float vdot(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void vnormalize(float a[3]) {
  // math3d.normalize parity: a * rsqrt(max(|a|^2, 1e-20)), with an IEEE
  // sqrt and divide (rsqrtf is not correctly rounded).
  float inv = 1.0f / sqrtf(fmaxf(vdot(a, a), 1e-20f));
  a[0] *= inv;
  a[1] *= inv;
  a[2] *= inv;
}

// d hdr_c / d sh[k][c] of the IBL tail: the SH9 polynomial's basis at n.
__device__ __forceinline__ void sh9_basis(const float n[3], float b[9]) {
  const float x = n[0], y = n[1], z = n[2];
  b[0] = kC4;
  b[1] = kC2x2 * y;
  b[2] = kC2x2 * z;
  b[3] = kC2x2 * x;
  b[4] = kC1x2 * (x * y);
  b[5] = kC1x2 * (y * z);
  b[6] = kC3 * (z * z) - kC5;
  b[7] = kC1x2 * (x * z);
  b[8] = kC1 * (x * x - y * y);
}

// SH9 irradiance / pi at unit normal n for channel c (the plain version's
// order of terms).
__device__ __forceinline__ float sh9_irradiance(const float* sh, const float n[3], int c) {
  const float x = n[0], y = n[1], z = n[2];
  return (kC1 * sh[24 + c] * (x * x - y * y) + kC3 * sh[18 + c] * (z * z) + kC4 * sh[c] -
          kC5 * sh[18 + c] + kC1x2 * (sh[12 + c] * (x * y) + sh[21 + c] * (x * z) + sh[15 + c] * (y * z)) +
          kC2x2 * (sh[9 + c] * x + sh[3 + c] * y + sh[6 + c] * z)) *
         kInvPi;
}

// The IBL tail (shade_core's ibl=True branch): out = (hdr rgb, sf rgb,
// reflect xyz, roughness, opacity). sh points at the 27 SH9 slots.
__device__ __forceinline__ void ibl_tail(const float* sh, const float n[3], const float v[3],
                                         float ndotv, const float f0[3], float one_m_met,
                                         const float pr[9], const float direct[3], float out[11]) {
  const float t = 1.f - ndotv;
  const float t5v = (t * t) * (t * t) * t;
  const float e2 = expf(fminf(-9.28f * ndotv, 0.f) * kLn2);  // env_brdf_approx's exp2
  const float rough = pr[7];
  const float r40 = rough * -1.f + 1.f;
  const float r41 = rough * -0.0275f + 0.0425f;
  const float r42 = rough * -0.572f + 1.04f;
  const float r43 = rough * 0.022f - 0.04f;
  const float a004 = fminf(r40 * r40, e2) * r40 + r41;
  const float scale = a004 * -1.04f + r42;
  const float bias = a004 * 1.04f + r43;
  for (int c = 0; c < 3; ++c) {
    const float ks = f0[c] + (1.f - f0[c]) * t5v;
    const float kd = (1.f - ks) * one_m_met;
    out[c] = direct[c] + kd * sh9_irradiance(sh, n, c) * pr[c];
    out[3 + c] = f0[c] * scale + bias;
  }
  float r[3] = {2.f * ndotv * n[0] - v[0], 2.f * ndotv * n[1] - v[1], 2.f * ndotv * n[2] - v[2]};
  vnormalize(r);  // reflect(-v, n)
  out[6] = r[0];
  out[7] = r[1];
  out[8] = r[2];
  out[9] = rough;
  out[10] = pr[8];
}

// ops/shade_core.py::shade_core: the same expressions in the same order.
// kIbl false: out = (r, g, b, opacity), HDR when apply_tonemap is 0.
// kIbl true: the IBL tail's 11 channels (always HDR).
template <bool kIbl>
__device__ inline void shade(const float* uni, int num_dir, int num_point, int num_spot,
                             int apply_tonemap, const float pos[3], const float nrm[3],
                             const float pr[9], float* out) {
  float n[3] = {nrm[0], nrm[1], nrm[2]};
  vnormalize(n);
  float v[3] = {uni[0] - pos[0], uni[1] - pos[1], uni[2] - pos[2]};
  vnormalize(v);
  const float met = pr[3];
  const float rough = pr[7];
  float f0[3], inv_pi_alb[3], acc[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < 3; ++c) {
    f0[c] = pr[4 + c] + (pr[c] - pr[4 + c]) * met;
    inv_pi_alb[c] = pr[c] * kInvPi;
  }
  const float ndotv = fmaxf(vdot(n, v), 0.f);
  const float r_cl = fmaxf(rough, 0.05f);
  const float a_g = r_cl * r_cl;
  const float a2 = a_g * a_g;
  const float kg = (rough + 1.f) * (rough + 1.f) / 8.f;
  const float gv = ndotv / (ndotv * (1.f - kg) + kg);
  const float one_m_met = 1.f - met;

  const int num_lights = num_dir + num_point + num_spot;
  for (int li = 0; li < num_lights; ++li) {
    const float* L = uni + kUniLight0 + li * kUniPerLight;
    float l[3];
    float atten = 1.f;
    if (li < num_dir) {
      l[0] = -L[3];
      l[1] = -L[4];
      l[2] = -L[5];
    } else {
      float tl[3] = {L[6] - pos[0], L[7] - pos[1], L[8] - pos[2]};
      const float d = sqrtf(fmaxf(vdot(tl, tl), 1e-20f));
      const float inv_d = 1.f / fmaxf(d, 1e-20f);
      l[0] = tl[0] * inv_d;
      l[1] = tl[1] * inv_d;
      l[2] = tl[2] * inv_d;
      const float d_sat = fmaxf(d, 0.01f);
      if (li < num_dir + num_point) {
        atten = d <= 100.f ? 1.f / (d_sat * d_sat) : 0.f;
      } else {
        const float cone = fmaxf(-(l[0] * L[3] + l[1] * L[4] + l[2] * L[5]), 0.f);
        atten = d <= 100.f ? powf(cone, L[9]) / (d_sat * d_sat) : 0.f;
      }
    }
    float h[3] = {v[0] + l[0], v[1] + l[1], v[2] + l[2]};
    vnormalize(h);
    const float ndoth = fmaxf(vdot(n, h), 0.f);
    // ndoth^2 (a2-1) + 1 with 1 - ndoth^2 formed as |n x h|^2 (shade_core.py).
    const float nxh[3] = {n[1] * h[2] - n[2] * h[1], n[2] * h[0] - n[0] * h[2],
                          n[0] * h[1] - n[1] * h[0]};
    const float dn = ndoth > 0.f ? vdot(nxh, nxh) + ndoth * ndoth * a2 : 1.f;
    const float ndf = a2 / (kPi * dn * dn);
    const float ndotl = fmaxf(vdot(n, l), 0.f);
    const float gl = ndotl / (ndotl * (1.f - kg) + kg);
    const float hv = fminf(fmaxf(vdot(h, v), 0.f), 1.f);
    const float t = 1.f - hv;
    const float t2 = t * t;
    const float t5 = t2 * t2 * t;
    const float spec_s = ndf * (gv * gl) / (4.f * ndotv * ndotl + 1e-3f);
    for (int c = 0; c < 3; ++c) {
      const float f = f0[c] + (1.f - f0[c]) * t5;
      acc[c] += ((1.f - f) * one_m_met * inv_pi_alb[c] + spec_s * f) * (L[c] * atten) * ndotl;
    }
  }
  if constexpr (kIbl) {
    ibl_tail(uni + kUniLight0 + num_lights * kUniPerLight, n, v, ndotv, f0, one_m_met, pr, acc, out);
    return;
  }
  for (int c = 0; c < 3; ++c) {
    float lit = uni[3 + c] * pr[c] + acc[c];
    if (apply_tonemap) {
      float x = fmaxf(lit, 0.f);
      x = x / (x + 1.f);
      lit = powf(fmaxf(x, 1e-8f), kInvGamma);
    }
    out[c] = lit;
  }
  out[3] = pr[8];
}

}  // namespace shade_core
