// Adjoint of the per-pixel shader: the backward of the fused raster+shade
// path, one thread per pixel.
//
// Replaces the TPU kernel
//   physically_based_renderer_tpu/ops/raster_pallas.py::_shade_bwd_kernel
// which re-linearises shade_core with jax.vjp inside the kernel. Here the
// adjoint of shade_core.cuh (ops/shade_core.py::shade_core) is written by
// hand, for both modes: two template instantiations, so the ibl=False code is
// unchanged by the IBL mode. Its plain PyTorch version is
// ops/raster_pallas.py::shade_backward_plain (torch.autograd over shade_core).
//
// Inputs (per pixel p of the rows x W band, row-major):
//   g_chan  (npix, C) f32    cotangent of the shader's channels: (r, g, b,
//                            opacity), one float4 per pixel; or the IBL mode's
//                            11, read with a pixel and a channel stride (the
//                            forward's planes or a pixel-major buffer alike)
//   attrs   (npix, S) f32    residual [pos_w(3), normal_w(3)], row stride S >= 6
//                            (the forward's (rows, W, 7) G-buffer reads with S = 7)
//   mat_id  (npix,) i32      material row; out-of-table ids fetch zeros
//   hit     (npix,) u8       nonzero on hit pixels
//   mat     (M, 9) f32       diffuse rgb, metallic, F0 rgb, roughness, opacity
//   uni     (U,) f32         shading uniforms (shade_core.cuh layout)
// Outputs:
//   g_attrs (npix, 6) f32    zero off-hit
//   g_props (npix, 9) f32    zero off-hit
//   sums    (U + 9M,) f32    [g_uni | g_table]: the uniform cotangent (the IBL
//                            mode's 27 SH9 slots included) and the
//                            (M, 9) material-table cotangent (g_props summed
//                            by material id; out-of-table ids add nothing),
//                            both summed over the band. Each block walks its
//                            pixels (a grid-stride loop over at most
//                            kMaxBlocks blocks) and keeps one partial row:
//                            each thread adds its uniform slots into its own
//                            column of shared memory, each warp its lanes'
//                            g_props, grouped by material id (ballots, warp
//                            sums), into its own table; the block sums the
//                            columns and the tables in a fixed order at its
//                            end. One small kernel then sums the block rows
//                            in a fixed order. No float atomics, so the
//                            result is the same bits on every run.
// g_attrs and g_props may be null: the kernel then does not write them (the
// fused backward needs g_attrs only for geometry gradients and never
// g_props, whose sum by material the kernel forms itself).
//
// Subgradients follow torch's rules, so the kernel and its plain version
// agree at ties: clamp(x, min=a) passes the gradient where x >= a (both ends
// inclusive for clip), torch.where passes it to the selected branch only, and
// pow(c, e) gives 0 (not NaN) to e at c = 0. The JAX package splits a tie
// 0.5/0.5 instead; on the grid scene the ties are measure-zero or killed
// downstream (roughness 0 lies strictly below the 0.05 clamp).
//
// Shape of the adjoint (register use flat in the light count):
//   pass 1 runs the forward (shade_core.cuh, HDR) for lit per channel;
//   the tonemap adjoint gives g_lit (the IBL mode has no tonemap: g_lit is the
//   hdr cotangent, and pass 1 is skipped);
//   the IBL mode then takes the adjoint of the IBL tail (SH9 diffuse, the
//   env-BRDF factor, the reflect direction) into the same prefix accumulators
//   and adds the 27 SH9 slots to the sink, before the light loop so its values
//   are dead by then;
//   pass 2 goes light by light: it recomputes that light's terms, adds their
//   adjoints into the prefix accumulators (n, v, f0, n.v, G(v), k, a^2,
//   1-metallic, albedo/pi, pos) and adds the light's 10 uniform slots;
//   last, the prefix adjoints are pulled back to pos, normal, the 9 props and
//   the eye.
//
// What bounds it on an H100: FP32 issue and latency, about two forward
// shades per hit pixel plus the adjoint's ~3x, at two blocks an SM (the
// adjoint's live state fills the 128 registers that allows); memory traffic
// is ~50 B read per hit pixel, and 60 B a pixel written when both per-pixel
// outputs are asked for. So the design spends no issue slot it need not:
//   * the hit pixels queue up in shared memory and are differentiated
//     kThreads at a time, so no lane idles through an adjoint beside a hit
//     lane (a warp of 32 neighbouring pixels is often only partly hit);
//   * a uniform slot is one add into the thread's own shared-memory column
//     (no shuffles), and a warp adds its g_props to its own (M, 9) table
//     (no block barrier); the block sums both once, in a fixed order;
//   * the accumulators that live through every light but are added to only
//     a few times a light sit in the thread's shared-memory column too
//     (Col), which keeps the adjoint within its registers without a spill;
//   * the per-pixel outputs nobody asked for are not written.
// Built with -fmad=false like the forward. Contracted multiply-adds ran
// 4-6% faster, but move N.L off an exact 0 (the soft raster's clamped
// fringe pixels sit on it): the subgradient there then differs from the
// plain version's, and render_soft's geometry gradients from the CPU's.
// Only when the (M, 9) tables would not let two blocks share an SM (past
// 150 materials under 4 lights, 65 with IBL) does the kernel fall back to
// one row a warp by shuffles and one table that the warps add to in turn,
// which bounds M by the card's 227 KB a block (about 3000 materials; past
// that the launch returns the attribute error).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_core.cuh"

namespace {

using namespace shade_core;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;
constexpr int kMaxBlocks = 1024;  // fixed, so the summation order is too
constexpr size_t kFastSmemBytes = 110 * 1024;  // two blocks an SM (228 KB, 1 KB reserved a block)
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const float* g_chan;
  int g_pix_stride;  // the IBL mode's cotangent strides, in floats
  int g_ch_stride;
  const float* attrs;
  const int* mat_id;
  const unsigned char* hit;
  const float* mat;
  const float* uni;
  float* g_attrs;
  float* g_props;
  float* partials;  // (blocks, U + 9M)
  int npix;
  int attr_stride;
  int num_materials;
  int num_uni;
  int num_dir;
  int num_point;
  int num_spot;
  int apply_tonemap;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Adjoint of a = raw * rsqrt(max(|raw|^2, 1e-20)): g_raw = inv*g + k*raw.
__device__ __forceinline__ void vnormalize_adj(const float raw[3], const float g[3], float g_raw[3]) {
  const float s = vdot(raw, raw);
  const float inv = 1.f / sqrtf(fmaxf(s, 1e-20f));
  const float k = s >= 1e-20f ? -inv * inv * inv * vdot(raw, g) : 0.f;
  for (int c = 0; c < 3; ++c) g_raw[c] = inv * g[c] + k * raw[c];
}

// The same adjoint from the unit vector a = raw * inv that vnormalize formed
// (inv = 1 / |raw| clamped as there): g_raw = inv (g - (a.g) a), and inv g
// where |raw|^2 < 1e-20 (the clamp passes nothing to the length). Keeps raw
// itself dead once a is formed.
__device__ __forceinline__ void unit_adj(const float a[3], float inv, bool unclamped, const float g[3],
                                         float g_raw[3]) {
  const float ag = unclamped ? vdot(a, g) : 0.f;
  for (int c = 0; c < 3; ++c) g_raw[c] = inv * (g[c] - ag * a[c]);
}

// A per-thread accumulator of 3 floats kept in shared memory, one column of a
// (.., kThreads) array (lane i hits bank i), rather than in registers: the
// adjoint adds to it a few times a light, but it lives through every light.
// g_f0 (3), g_ipa (3), g_pos (3), the IBL tail's g_alb (3) and g_rough, g_gv, g_kg, g_a2, and the
// opacity's cotangent (read at the start, written to g_props at the end)
constexpr int kPrivRows = 17;
struct Col {
  float* col;
  __device__ __forceinline__ float& operator[](int i) const { return col[i * kThreads]; }
};

// g_a += b x g_c and g_b += g_c x a for c = a x b.
__device__ __forceinline__ void cross_adj(const float a[3], const float b[3], const float gc[3],
                                          float ga[3], float gb[3]) {
  ga[0] += b[1] * gc[2] - b[2] * gc[1];
  ga[1] += b[2] * gc[0] - b[0] * gc[2];
  ga[2] += b[0] * gc[1] - b[1] * gc[0];
  gb[0] += gc[1] * a[2] - gc[2] * a[1];
  gb[1] += gc[2] * a[0] - gc[0] * a[2];
  gb[2] += gc[0] * a[1] - gc[1] * a[0];
}

// Where the adjoint sums its uniform slots. kFast: into this thread's own
// column of the slot-major (U, kThreads) array (lane i hits bank i: no
// shuffle, no conflict). Otherwise by a warp sum into this warp's row, lane 0
// adding (every lane of the warp must then call).
template <bool kFast>
struct SlotSink {
  float* base;
  int lane;
  __device__ __forceinline__ void add(int slot, float val) const {
    if constexpr (kFast) {
      base[slot * kThreads] += val;
    } else {
      const float s = warp_sum(val);
      if (lane == 0) base[slot] += s;
    }
  }
};

// Add the warp's g_pr into the block's (M, 9) table row, one material id at
// a time in the order of their lowest lane. Every lane of the warp calls it.
__device__ __forceinline__ void table_add(float* s_tab, const float g_pr[9], int mid, bool in_tab,
                                          int lane) {
  unsigned todo = __ballot_sync(kFullMask, in_tab);
  while (todo) {
    const int m = __shfl_sync(kFullMask, mid, __ffs(todo) - 1);
    const bool mine = in_tab && mid == m;
    todo &= ~__ballot_sync(kFullMask, mine);
    for (int k = 0; k < 9; ++k) {
      const float s = warp_sum(mine ? g_pr[k] : 0.f);
      if (lane == 0) s_tab[m * 9 + k] += s;
    }
  }
}

// Adjoint of the IBL tail (shade_core.cuh::ibl_tail) at one pixel, into the
// prefix accumulators; g_alb and g_rough collect the albedo and roughness
// terms that do not pass through a prefix value. Adds the 27 SH9 slots
// (from s0) to the sink. g_out is (hdr rgb, sf rgb, reflect xyz,
// roughness); a tie of an elementwise min splits 0.5/0.5, as torch.minimum.
template <bool kFast>
__device__ __forceinline__ void ibl_tail_adjoint(const float* uni, int s0, const float g_out[10],
                                                 const float n[3], const float v[3], float ndotv,
                                                 const float f0[3], float omm, const float pr[9],
                                                 const SlotSink<kFast>& sink, float g_n[3], float g_v[3],
                                                 float& g_ndotv, const Col& g_f0, float& g_omm,
                                                 const Col& g_alb, float& g_rough) {
  const float* sh = uni + s0;
  const float t = 1.f - ndotv;
  const float t2 = t * t;
  const float t5v = t2 * t2 * t;
  const float q = -9.28f * ndotv;
  const float e2 = expf(fminf(q, 0.f) * kLn2);
  const float rough = pr[7];
  const float r40 = rough * -1.f + 1.f;
  const float r41 = rough * -0.0275f + 0.0425f;
  const float r42 = rough * -0.572f + 1.04f;
  const float r40sq = r40 * r40;
  const float m = fminf(r40sq, e2);
  const float a004 = m * r40 + r41;
  const float scale = a004 * -1.04f + r42;

  // hdr_c = direct_c + kd_c irr_c alb_c, sf_c = f0_c scale + bias
  float g_poly[3], g_t5v = 0.f, g_scale = 0.f, g_bias = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float irr = sh9_irradiance(sh, n, c);
    const float ks = f0[c] + (1.f - f0[c]) * t5v;
    const float kd = (1.f - ks) * omm;
    const float g_h = g_out[c];
    g_alb[c] += g_h * (kd * irr);
    const float g_kdirr = g_h * pr[c];
    const float g_kd = g_kdirr * irr;
    g_poly[c] = g_kdirr * kd * kInvPi;
    g_omm += g_kd * (1.f - ks);
    const float g_ks = -g_kd * omm;
    g_f0[c] += g_ks * (1.f - t5v);
    g_t5v += g_ks * (1.f - f0[c]);
    const float g_sf = g_out[3 + c];
    g_f0[c] += g_sf * scale;
    g_scale += g_sf * f0[c];
    g_bias += g_sf;
  }

  // The SH9 polynomial: its 27 coefficient slots, and n.
  float b[9];
  sh9_basis(n, b);
  for (int k = 0; k < 9; ++k) {
    for (int c = 0; c < 3; ++c) sink.add(s0 + 3 * k + c, g_poly[c] * b[k]);
  }
  float g_xx_yy = 0.f, g_zz = 0.f, g_xy = 0.f, g_xz = 0.f, g_yz = 0.f, g_x = 0.f, g_y = 0.f, g_z = 0.f;
  for (int c = 0; c < 3; ++c) {
    const float gp = g_poly[c];
    g_xx_yy += gp * (kC1 * sh[24 + c]);
    g_zz += gp * (kC3 * sh[18 + c]);
    g_xy += gp * (kC1x2 * sh[12 + c]);
    g_xz += gp * (kC1x2 * sh[21 + c]);
    g_yz += gp * (kC1x2 * sh[15 + c]);
    g_x += gp * (kC2x2 * sh[9 + c]);
    g_y += gp * (kC2x2 * sh[3 + c]);
    g_z += gp * (kC2x2 * sh[6 + c]);
  }
  const float x = n[0], y = n[1], z = n[2];
  g_n[0] += g_x + g_xx_yy * 2.f * x + g_xy * y + g_xz * z;
  g_n[1] += g_y - g_xx_yy * 2.f * y + g_xy * x + g_yz * z;
  g_n[2] += g_z + g_zz * 2.f * z + g_xz * x + g_yz * y;

  // env_brdf_approx: scale = a004 (-1.04) + r42, bias = a004 1.04 + r43,
  // a004 = min(r40^2, e2) r40 + r41, e2 = exp(min(-9.28 n.v, 0) ln2)
  const float g_a004 = g_scale * -1.04f + g_bias * 1.04f;
  const float g_m = g_a004 * r40;
  const float w_sq = r40sq < e2 ? 1.f : (r40sq == e2 ? 0.5f : 0.f);
  const float g_r40 = g_a004 * m + g_m * w_sq * 2.f * r40;
  const float w_q = q < 0.f ? 1.f : (q == 0.f ? 0.5f : 0.f);
  g_ndotv += g_m * (1.f - w_sq) * e2 * kLn2 * w_q * -9.28f;
  g_rough += -g_r40 + g_a004 * -0.0275f + g_scale * -0.572f + g_bias * 0.022f + g_out[9];
  // t5v = (1 - n.v)^5
  g_ndotv -= g_t5v * 5.f * (t2 * t2);

  // r = normalize(2 n.v n - v)
  const float rraw[3] = {2.f * ndotv * n[0] - v[0], 2.f * ndotv * n[1] - v[1], 2.f * ndotv * n[2] - v[2]};
  float g_rr[3];
  vnormalize_adj(rraw, g_out + 6, g_rr);
  for (int c = 0; c < 3; ++c) {
    g_n[c] += g_rr[c] * (2.f * ndotv);
    g_v[c] -= g_rr[c];
    g_ndotv += 2.f * g_rr[c] * n[c];
  }
}

// Adjoint of shade_core::shade<kIbl> for one pixel. Every lane of the warp
// calls it (the slow sink shuffles across the warp); lanes whose pixel is
// not a hit contribute zeros. g_pr receives the pixel's property cotangent.
template <bool kIbl, bool kFast>
__device__ void pixel_adjoint(const Params& p, const float* s_mat, const float* uni, const SlotSink<kFast>& sink,
                              float* priv, bool hit, int pix, int mid, float g_pr[9]) {
  constexpr int kOut = kIbl ? kIblChannels : 4;
  float pos[3] = {0.f, 0.f, 0.f}, nrm[3] = {0.f, 0.f, 1.f}, pr[9], g_out[kOut];
  for (int k = 0; k < 9; ++k) pr[k] = 0.f;
  for (int c = 0; c < kOut; ++c) g_out[c] = 0.f;
  if (hit) {
    const float* a = p.attrs + (size_t)pix * p.attr_stride;
    for (int c = 0; c < 3; ++c) {
      pos[c] = a[c];
      nrm[c] = a[3 + c];
    }
    if (mid >= 0 && mid < p.num_materials) {
      for (int k = 0; k < 9; ++k) pr[k] = s_mat[mid * 9 + k];
    }
    if constexpr (kIbl) {
      const float* g = p.g_chan + (size_t)pix * p.g_pix_stride;
      for (int c = 0; c < kOut; ++c) g_out[c] = g[(size_t)c * p.g_ch_stride];
    } else {
      const float4 g = reinterpret_cast<const float4*>(p.g_chan)[pix];
      g_out[0] = g.x;
      g_out[1] = g.y;
      g_out[2] = g.z;
      g_out[3] = g.w;
    }
  }

  // Pass 1: the forward, HDR, and the tonemap adjoint (shade mode only).
  float g_lit[3];
  if constexpr (kIbl) {
    for (int c = 0; c < 3; ++c) g_lit[c] = g_out[c];
  } else {
    float lit[4];
    shade<false>(uni, p.num_dir, p.num_point, p.num_spot, 0, pos, nrm, pr, lit);
    for (int c = 0; c < 3; ++c) {
      if (p.apply_tonemap) {
        const float x = fmaxf(lit[c], 0.f);
        const float y = x / (x + 1.f);
        float g = y >= 1e-8f ? g_out[c] * (kInvGamma * powf(fmaxf(y, 1e-8f), kInvGamma - 1.f)) : 0.f;
        g = g * (1.f / (x + 1.f) - x / ((x + 1.f) * (x + 1.f)));
        g_lit[c] = lit[c] >= 0.f ? g : 0.f;
      } else {
        g_lit[c] = g_out[c];
      }
      if (!hit) g_lit[c] = 0.f;
    }
  }

  // The shared prefix, as shade() forms it.
  // (vnormalize's arithmetic, with the scale and the clamp kept for the adjoint)
  const float s_n = vdot(nrm, nrm), s_v0 = uni[0] - pos[0], s_v1 = uni[1] - pos[1], s_v2 = uni[2] - pos[2];
  const float inv_n = 1.f / sqrtf(fmaxf(s_n, 1e-20f));
  const float n[3] = {nrm[0] * inv_n, nrm[1] * inv_n, nrm[2] * inv_n};
  const float s_v = s_v0 * s_v0 + s_v1 * s_v1 + s_v2 * s_v2;
  const float inv_v = 1.f / sqrtf(fmaxf(s_v, 1e-20f));
  const float v[3] = {s_v0 * inv_v, s_v1 * inv_v, s_v2 * inv_v};
  const float met = pr[3];
  const float rough = pr[7];
  float f0[3];
  for (int c = 0; c < 3; ++c) f0[c] = pr[4 + c] + (pr[c] - pr[4 + c]) * met;
  const float ndotv_raw = vdot(n, v);
  const float ndotv = fmaxf(ndotv_raw, 0.f);
  const float r_cl = fmaxf(rough, 0.05f);
  const float a_g = r_cl * r_cl;
  const float a2 = a_g * a_g;
  const float kg = (rough + 1.f) * (rough + 1.f) / 8.f;
  const float dv = ndotv * (1.f - kg) + kg;
  const float gv = ndotv / dv;
  const float omm = 1.f - met;

  // Prefix adjoint accumulators.
  // (g_f0, g_ipa, g_pos, the IBL tail's g_alb and g_rough, g_gv, g_kg, g_a2
  // and the opacity's cotangent in this thread's shared-memory column: see Col)
  for (int i = 0; i < kPrivRows; ++i) priv[i * kThreads] = 0.f;
  const Col g_f0{priv}, g_ipa{priv + 3 * kThreads}, g_pos{priv + 6 * kThreads}, g_alb{priv + 9 * kThreads};
  float& g_rough = priv[12 * kThreads];
  float& g_gv = priv[13 * kThreads];
  float& g_kg = priv[14 * kThreads];
  float& g_a2 = priv[15 * kThreads];
  priv[16 * kThreads] = g_out[kOut - 1];
  float g_n[3] = {0.f, 0.f, 0.f}, g_v[3] = {0.f, 0.f, 0.f};
  float g_ndotv = 0.f, g_omm = 0.f;
  const int num_lights = p.num_dir + p.num_point + p.num_spot;

  // The IBL tail (its albedo and roughness terms wait in g_alb, g_rough).
  if constexpr (kIbl) {
    ibl_tail_adjoint(uni, kUniLight0 + kUniPerLight * num_lights, g_out, n, v, ndotv, f0, omm, pr,
                     sink, g_n, g_v, g_ndotv, g_f0, g_omm, g_alb, g_rough);
  }

  // Pass 2: light by light.
#pragma unroll 1
  for (int li = 0; li < num_lights; ++li) {
    const float* L = uni + kUniLight0 + li * kUniPerLight;
    const bool is_dir = li < p.num_dir;
    const bool is_point = !is_dir && li < p.num_dir + p.num_point;
    float l[3], tl[3] = {0.f, 0.f, 0.f};
    float atten = 1.f, s_tl = 0.f, d = 0.f, inv_d = 0.f, d_sat = 0.f, cone_raw = 0.f, cone = 0.f,
          pw = 0.f;
    if (is_dir) {
      l[0] = -L[3];
      l[1] = -L[4];
      l[2] = -L[5];
    } else {
      for (int c = 0; c < 3; ++c) tl[c] = L[6 + c] - pos[c];
      s_tl = vdot(tl, tl);
      d = sqrtf(fmaxf(s_tl, 1e-20f));
      inv_d = 1.f / fmaxf(d, 1e-20f);
      for (int c = 0; c < 3; ++c) l[c] = tl[c] * inv_d;
      d_sat = fmaxf(d, 0.01f);
      if (is_point) {
        atten = d <= 100.f ? 1.f / (d_sat * d_sat) : 0.f;
      } else {
        cone_raw = -(l[0] * L[3] + l[1] * L[4] + l[2] * L[5]);
        cone = fmaxf(cone_raw, 0.f);
        pw = powf(cone, L[9]);
        atten = d <= 100.f ? pw / (d_sat * d_sat) : 0.f;
      }
    }
    const float h_raw[3] = {v[0] + l[0], v[1] + l[1], v[2] + l[2]};
    float h[3] = {h_raw[0], h_raw[1], h_raw[2]};
    vnormalize(h);
    const float ndoth_raw = vdot(n, h);
    const float ndoth = fmaxf(ndoth_raw, 0.f);
    const float nxh[3] = {n[1] * h[2] - n[2] * h[1], n[2] * h[0] - n[0] * h[2],
                          n[0] * h[1] - n[1] * h[0]};
    const float dn = ndoth > 0.f ? vdot(nxh, nxh) + ndoth * ndoth * a2 : 1.f;
    const float ndf = a2 / (kPi * dn * dn);
    const float ndotl_raw = vdot(n, l);
    const float ndotl = fmaxf(ndotl_raw, 0.f);
    const float dl = ndotl * (1.f - kg) + kg;
    const float gl = ndotl / dl;
    const float hv_raw = vdot(h, v);
    const float hv = fminf(fmaxf(hv_raw, 0.f), 1.f);
    const float t = 1.f - hv;
    const float t2 = t * t;
    const float t5 = t2 * t2 * t;
    const float gvgl = gv * gl;
    const float ds = 4.f * ndotv * ndotl + 1e-3f;
    const float spec_s = ndf * gvgl / ds;

    // contrib_c = ((1-f)(1-met) alb/pi + spec_s f) * (strength_c atten) * n.l
    const int base = kUniLight0 + li * kUniPerLight;  // this light's 10 uniform slots
    float gL[10];  // their cotangent: strength, direction, position, spot power
    for (int k = 0; k < 10; ++k) gL[k] = 0.f;
    float g_spec = 0.f, g_t5 = 0.f, g_atten = 0.f, g_ndotl = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float f = f0[c] + (1.f - f0[c]) * t5;
      const float ipa = pr[c] * kInvPi;  // albedo / pi (re-formed a light: fewer live registers)
      const float b = (1.f - f) * omm * ipa + spec_s * f;
      const float sa = L[c] * atten;
      const float g_b = g_lit[c] * ndotl * sa;
      const float g_sa = g_lit[c] * ndotl * b;
      g_ndotl += g_lit[c] * (b * sa);
      gL[c] += g_sa * atten;
      g_atten += g_sa * L[c];
      const float g_f = g_b * (spec_s - omm * ipa);
      g_omm += g_b * ipa * (1.f - f);
      g_ipa[c] += g_b * (1.f - f) * omm;
      g_spec += g_b * f;
      g_f0[c] += g_f * (1.f - t5);
      g_t5 += g_f * (1.f - f0[c]);
    }
    for (int k = 0; k < 3; ++k) sink.add(base + k, gL[k]);  // the strength's slots are final here
    // spec_s = ndf (gv gl) / (4 n.v n.l + 1e-3)
    const float g_ndf = g_spec * gvgl / ds;
    const float g_gvgl = g_spec * ndf / ds;
    g_gv += g_gvgl * gl;
    const float g_gl = g_gvgl * gv;
    const float g_ds = -g_spec * spec_s / ds;
    g_ndotv += g_ds * 4.f * ndotl;
    g_ndotl += g_ds * 4.f * ndotv;
    // t5 = (1 - clip(h.v, 0, 1))^5
    float g_h[3] = {0.f, 0.f, 0.f};
    const float g_hv = (hv_raw >= 0.f && hv_raw <= 1.f) ? -(g_t5 * 5.f * (t2 * t2)) : 0.f;
    for (int c = 0; c < 3; ++c) {
      g_h[c] += g_hv * v[c];
      g_v[c] += g_hv * h[c];
    }
    // gl = n.l / (n.l (1-k) + k)
    g_ndotl += g_gl * (1.f / dl - ndotl * (1.f - kg) / (dl * dl));
    g_kg += g_gl * (-ndotl / (dl * dl)) * (1.f - ndotl);
    // ndf = a2 / (pi dn^2); dn = |n x h|^2 + (n.h)^2 a2 where n.h > 0, else 1
    g_a2 += g_ndf / (kPi * dn * dn);
    const float g_dn = -g_ndf * 2.f * ndf / dn;
    float g_ndoth = 0.f;
    if (ndoth > 0.f) {
      const float g_nxh[3] = {2.f * g_dn * nxh[0], 2.f * g_dn * nxh[1], 2.f * g_dn * nxh[2]};
      cross_adj(n, h, g_nxh, g_n, g_h);
      g_ndoth = g_dn * 2.f * ndoth * a2;
      g_a2 += g_dn * ndoth * ndoth;
    }
    if (ndoth_raw >= 0.f) {
      for (int c = 0; c < 3; ++c) {
        g_n[c] += g_ndoth * h[c];
        g_h[c] += g_ndoth * n[c];
      }
    }
    // n.l
    float g_l[3] = {0.f, 0.f, 0.f};
    if (ndotl_raw >= 0.f) {
      for (int c = 0; c < 3; ++c) {
        g_n[c] += g_ndotl * l[c];
        g_l[c] = g_ndotl * n[c];
      }
    }
    // h = normalize(v + l)
    float g_hraw[3];
    vnormalize_adj(h_raw, g_h, g_hraw);
    for (int c = 0; c < 3; ++c) {
      g_v[c] += g_hraw[c];
      g_l[c] += g_hraw[c];
    }
    // l and the attenuation back to the light's uniforms and pos.
    if (is_dir) {
      for (int c = 0; c < 3; ++c) gL[3 + c] -= g_l[c];
    } else {
      float g_d = 0.f;
      if (d <= 100.f) {
        const float q = d_sat * d_sat;
        float g_dsat;
        if (is_point) {
          g_dsat = -g_atten * 2.f * d_sat / (q * q);
        } else {
          const float sp = L[9];
          const float g_pw = g_atten / q;
          g_dsat = -g_atten * pw * 2.f * d_sat / (q * q);
          const float g_cone = sp != 0.f ? g_pw * (sp * powf(cone, sp - 1.f)) : 0.f;
          gL[9] += (cone == 0.f && sp >= 0.f) ? 0.f : g_pw * (pw * logf(cone));
          if (cone_raw >= 0.f) {
            for (int c = 0; c < 3; ++c) {
              g_l[c] -= g_cone * L[3 + c];
              gL[3 + c] -= g_cone * l[c];
            }
          }
        }
        if (d >= 0.01f) g_d += g_dsat;
      }
      // l = tl / max(d, 1e-20), d = sqrt(max(|tl|^2, 1e-20))
      float g_tl[3];
      for (int c = 0; c < 3; ++c) g_tl[c] = g_l[c] * inv_d;
      if (d >= 1e-20f) g_d -= vdot(g_l, tl) * inv_d * inv_d;
      const float g_s = s_tl >= 1e-20f ? g_d / (2.f * d) : 0.f;
      for (int c = 0; c < 3; ++c) {
        g_tl[c] += 2.f * tl[c] * g_s;
        gL[6 + c] += g_tl[c];
        g_pos[c] -= g_tl[c];
      }
    }
    // The light's other slots: direction, position, spot power.
    if (!is_point) {
      for (int k = 3; k < 6; ++k) sink.add(base + k, gL[k]);
    }
    if (!is_dir) {
      for (int k = 6; k < 9; ++k) sink.add(base + k, gL[k]);
    }
    if (!is_dir && !is_point) sink.add(base + 9, gL[9]);
  }

  // n.v, G(v), k, a2 back to roughness; f0 and albedo/pi back to the props.
  g_ndotv += g_gv * (1.f / dv - ndotv * (1.f - kg) / (dv * dv));
  g_kg += g_gv * (-ndotv / (dv * dv)) * (1.f - ndotv);
  if (ndotv_raw >= 0.f) {
    for (int c = 0; c < 3; ++c) {
      g_n[c] += g_ndotv * v[c];
      g_v[c] += g_ndotv * n[c];
    }
  }
  g_pr[7] = g_kg * (2.f * (rough + 1.f) / 8.f) + g_rough;
  if (rough >= 0.05f) g_pr[7] += g_a2 * 2.f * a_g * 2.f * r_cl;
  g_pr[3] = -g_omm;
  for (int c = 0; c < 3; ++c) {
    // the shade mode's ambient term, or the IBL tail's albedo term
    g_pr[c] = g_ipa[c] * kInvPi + g_f0[c] * met + (kIbl ? g_alb[c] : g_lit[c] * uni[3 + c]);
    g_pr[4 + c] = g_f0[c] * (1.f - met);
    // F0's row read again here, so that it need not stay live through the lights
    g_pr[3] += g_f0[c] * (pr[c] - (hit && mid >= 0 && mid < p.num_materials ? s_mat[mid * 9 + 4 + c] : 0.f));
  }
  g_pr[8] = priv[16 * kThreads];
  float g_vraw[3], g_nrm[3];
  unit_adj(v, inv_v, s_v >= 1e-20f, g_v, g_vraw);
  unit_adj(n, inv_n, s_n >= 1e-20f, g_n, g_nrm);
  for (int c = 0; c < 3; ++c) g_pos[c] -= g_vraw[c];

  if (hit && p.g_attrs) {
    float* ga = p.g_attrs + (size_t)pix * 6;
    for (int c = 0; c < 3; ++c) {
      ga[c] = g_pos[c];
      ga[3 + c] = g_nrm[c];
    }
  }
  if (hit && p.g_props) {
    float* gp = p.g_props + (size_t)pix * 9;
    for (int k = 0; k < 9; ++k) gp[k] = g_pr[k];
  }
  for (int c = 0; c < 3; ++c) {
    sink.add(c, hit ? g_vraw[c] : 0.f);  // eye
    if (!kIbl) sink.add(3 + c, hit ? g_lit[c] * pr[c] : 0.f);  // ambient
  }
}

// Two blocks per SM (__launch_bounds__(kThreads, 2): at most 128 registers).
// Shared memory: the table and the uniform row read, then the sums. kFast:
// one slot-major (U, kThreads) column a thread and one (M, 9) table a warp,
// no barrier in the pixel loop; the block sums them at its end in a fixed
// order (a slot: lane l adds columns l, l + 32, ..., then a warp tree; a
// table entry: warps 0..7 in turn). Otherwise (a table too large for two
// blocks an SM): one row a warp by shuffles and one (M, 9) table that the
// warps add to one at a time, a barrier each. Then the (kPrivRows, kThreads)
// accumulator columns (Col).
template <bool kIbl, bool kFast>
__global__ void __launch_bounds__(kThreads, 2) shade_backward_kernel(Params p) {
  extern __shared__ float smem[];
  const int num_tab = p.num_materials * 9;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_mat = smem;
  float* s_uni = s_mat + num_tab;
  float* s_slots = s_uni + p.num_uni;  // kFast: (U, kThreads); else (kWarps, U)
  float* s_tab = s_slots + p.num_uni * (kFast ? kThreads : kWarps);  // kFast: (kWarps, M, 9); else (M, 9)
  float* s_priv = s_tab + num_tab * (kFast ? kWarps : 1);  // (kPrivRows, kThreads): see Col
  const int num_sums = p.num_uni * (kFast ? kThreads : kWarps) + num_tab * (kFast ? kWarps : 1);
  for (int i = threadIdx.x; i < num_tab; i += kThreads) s_mat[i] = p.mat[i];
  for (int i = threadIdx.x; i < p.num_uni; i += kThreads) s_uni[i] = p.uni[i];
  for (int i = threadIdx.x; i < num_sums; i += kThreads) s_slots[i] = 0.f;
  __syncthreads();

  const SlotSink<kFast> sink{kFast ? s_slots + threadIdx.x : s_slots + warp * p.num_uni, lane};
  // The block's hit pixels queue up (s_queue, in pixel order) and are
  // differentiated kThreads at a time, so that every lane of a warp has a
  // pixel: a warp of 32 neighbouring pixels is often only partly hit.
  __shared__ int s_queue[2 * kThreads];
  __shared__ int s_warp_hits[kWarps];
  int queued = 0;  // block-uniform
  for (int base = blockIdx.x * kThreads;; base += gridDim.x * kThreads) {
    const bool more = base < p.npix;
    if (more) {
      const int pix = base + threadIdx.x;
      const bool in_range = pix < p.npix;
      const bool hit = in_range && p.hit[pix] != 0;
      if (in_range && !hit && p.g_attrs) {
        float* ga = p.g_attrs + (size_t)pix * 6;
        for (int c = 0; c < 6; ++c) ga[c] = 0.f;
      }
      if (in_range && !hit && p.g_props) {
        float* gp = p.g_props + (size_t)pix * 9;
        for (int k = 0; k < 9; ++k) gp[k] = 0.f;
      }
      const unsigned bal = __ballot_sync(kFullMask, hit);
      if (lane == 0) s_warp_hits[warp] = __popc(bal);
      __syncthreads();
      int at = queued, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        at += w < warp ? s_warp_hits[w] : 0;
        total += s_warp_hits[w];
      }
      if (hit) s_queue[at + __popc(bal & ((1u << lane) - 1u))] = pix;
      queued += total;
      __syncthreads();  // the queue is written; s_warp_hits may be reused
    }
    while (queued >= kThreads || (!more && queued > 0)) {
      const int n = min(queued, kThreads);
      const bool hit = (int)threadIdx.x < n;
      const int pix = hit ? s_queue[threadIdx.x] : 0;
      const int mid = hit ? p.mat_id[pix] : -1;
      float g_pr[9];
      for (int k = 0; k < 9; ++k) g_pr[k] = 0.f;
      if (__any_sync(kFullMask, hit)) {  // warp-uniform: the batch's empty tail skips
        pixel_adjoint<kIbl, kFast>(p, s_mat, s_uni, sink, s_priv + threadIdx.x, hit, pix, mid, g_pr);
      }
      const bool in_tab = hit && mid >= 0 && mid < p.num_materials;
      if constexpr (kFast) {
        table_add(s_tab + warp * num_tab, g_pr, mid, in_tab, lane);  // this warp's own table
      } else if (__syncthreads_or(in_tab)) {  // block-uniform
        for (int w = 0; w < kWarps; ++w) {  // one warp at a time: a fixed order
          if (warp == w) table_add(s_tab, g_pr, mid, in_tab, lane);
          __syncthreads();
        }
      }
      __syncthreads();  // every entry of the batch is read
      if ((int)threadIdx.x < queued - n) s_queue[threadIdx.x] = s_queue[n + threadIdx.x];  // n == kThreads here
      queued -= n;
      __syncthreads();
    }
    if (!more) break;
  }
  __syncthreads();
  float* row = p.partials + (size_t)blockIdx.x * (p.num_uni + num_tab);
  if constexpr (kFast) {
    for (int u = warp; u < p.num_uni; u += kWarps) {
      float s = 0.f;
      for (int c = lane; c < kThreads; c += 32) s += s_slots[u * kThreads + c];
      s = warp_sum(s);
      if (lane == 0) row[u] = s;
    }
    for (int i = threadIdx.x; i < num_tab; i += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += s_tab[w * num_tab + i];
      row[p.num_uni + i] = s;
    }
  } else {
    for (int u = threadIdx.x; u < p.num_uni; u += kThreads) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += s_slots[w * p.num_uni + u];
      row[u] = s;
    }
    for (int i = threadIdx.x; i < num_tab; i += kThreads) row[p.num_uni + i] = s_tab[i];
  }
}

// sums[u] = sum over blocks of partials[b, u], one block per slot, in a
// fixed order.
__global__ void __launch_bounds__(kReduceThreads)
    sum_partials_kernel(const float* partials, int blocks, int num_slots, float* sums) {
  __shared__ float s[kReduceThreads];
  const int u = blockIdx.x;
  float acc = 0.f;
  for (int b = threadIdx.x; b < blocks; b += kReduceThreads) acc += partials[(size_t)b * num_slots + u];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int o = kReduceThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[u] = s[0];
}

template <bool kIbl, bool kFast>
cudaError_t launch_adjoint(const Params& p, int blocks, size_t smem, cudaStream_t s) {
  // always: the kernel's static queue counts against the 48 KB default too
  cudaError_t err = cudaFuncSetAttribute(shade_backward_kernel<kIbl, kFast>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  shade_backward_kernel<kIbl, kFast><<<blocks, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shade_backward_blocks(int npix) {
  const int blocks = (npix + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

extern "C" int shade_backward_launch(
    const void* g_chan, const void* attrs, const void* mat_id, const void* hit, const void* mat,
    const void* uni, void* g_attrs, void* g_props, void* partials, void* sums, int npix,
    int g_pix_stride, int g_ch_stride, int attr_stride, int num_materials, int num_uni,
    int num_dir, int num_point, int num_spot, int apply_tonemap, int ibl, void* stream) {
  if (attr_stride < 6 ||
      num_uni < kUniLight0 + kUniPerLight * (num_dir + num_point + num_spot) + (ibl ? 27 : 0)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.g_chan = static_cast<const float*>(g_chan);
  p.g_pix_stride = g_pix_stride;
  p.g_ch_stride = g_ch_stride;
  p.attrs = static_cast<const float*>(attrs);
  p.mat_id = static_cast<const int*>(mat_id);
  p.hit = static_cast<const unsigned char*>(hit);
  p.mat = static_cast<const float*>(mat);
  p.uni = static_cast<const float*>(uni);
  p.g_attrs = static_cast<float*>(g_attrs);
  p.g_props = static_cast<float*>(g_props);
  p.partials = static_cast<float*>(partials);
  p.npix = npix;
  p.attr_stride = attr_stride;
  p.num_materials = num_materials;
  p.num_uni = num_uni;
  p.num_dir = num_dir;
  p.num_point = num_point;
  p.num_spot = num_spot;
  p.apply_tonemap = apply_tonemap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = shade_backward_blocks(npix);
  const size_t num_tab = (size_t)num_materials * 9;
  const size_t priv = (size_t)kPrivRows * kThreads;
  const size_t fast_smem =
      sizeof(float) * (num_tab + num_uni + (size_t)num_uni * kThreads + kWarps * num_tab + priv);
  const bool fast = fast_smem <= kFastSmemBytes;
  if (blocks > 0) {
    const size_t smem = fast ? fast_smem : sizeof(float) * (2 * num_tab + num_uni + (size_t)kWarps * num_uni + priv);
    const cudaError_t err = ibl ? (fast ? launch_adjoint<true, true>(p, blocks, smem, s)
                                        : launch_adjoint<true, false>(p, blocks, smem, s))
                                : (fast ? launch_adjoint<false, true>(p, blocks, smem, s)
                                        : launch_adjoint<false, false>(p, blocks, smem, s));
    if (err != cudaSuccess) return (int)err;
  }
  const int num_slots = num_uni + num_materials * 9;
  sum_partials_kernel<<<num_slots, kReduceThreads, 0, s>>>(p.partials, blocks, num_slots,
                                                           static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

extern "C" const char* shade_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
