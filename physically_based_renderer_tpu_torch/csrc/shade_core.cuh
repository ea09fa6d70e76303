// Per-pixel Cook-Torrance shading (ops/shade_core.py::shade_core, ibl=False)
// as device code, shared by the fused forward kernel (raster_shade_row.cu)
// and its adjoint (shade_backward.cu), so the two can never drift.
//
// Uniform row layout (ops/shade_core.py::pack_shading_uniforms):
//   [0:3] eye, [3:6] ambient, [6:8] pad,
//   [8 + 10 i : 18 + 10 i] light i: strength(3), direction(3), position(3), spot power
// Lights come directional first, then point, then spot.

#pragma once

#include <cuda_runtime.h>

namespace shade_core {

constexpr int kUniLight0 = 8;
constexpr int kUniPerLight = 10;
constexpr float kPi = 3.14159265359f;
constexpr float kInvPi = (float)(1.0 / 3.14159265359);
constexpr float kInvGamma = (float)(1.0 / 2.2);

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

// ops/shade_core.py::shade_core, ibl=False: the same expressions in the same
// order. out = (r, g, b, opacity); HDR when apply_tonemap is 0.
__device__ inline void shade(const float* uni, int num_dir, int num_point, int num_spot,
                             int apply_tonemap, const float pos[3], const float nrm[3],
                             const float pr[9], float out[4]) {
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
