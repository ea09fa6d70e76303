// The PS stage's material blend and lighting (renderer.shade_pixels after
// the texel taps) as one kernel, and its adjoint as a second, one pixel a
// thread. Plain PyTorch version: ops/ps_light.py::shade_material_plain (the
// has-weighted blend, ops/brdf.compute_lighting, and the ambient term or the
// IBL split's SH9 and env-BRDF terms).
//
// Replaces no TPU kernel: the JAX package writes this stage as jnp
// elementwise code (physically_based_renderer_tpu/renderer.py::shade_pixels)
// and leaves it to XLA's fusion, which runs it as a few fused loops. Eager
// PyTorch runs the same code as ~500 launches a frame and its autograd as
// about twice that, so this kernel and its adjoint stand in for XLA.
//
// Numerics follow ops/brdf.py formula for formula (GGX with ndoth^2, not
// shade_core.cuh's |n x h|^2 form), in the order and with the functions the
// card's eager ops use (rsqrtf, powf, exp2f, IEEE divides; a divide by a
// Python constant is a multiply by its float reciprocal, as PyTorch does it),
// so the forward matches the plain version's bits on the card where the
// roughness-0 GGX amplifies any rounding. Built with -fmad=false.
//
// Inputs (per pixel p of npix, each at its own pixel stride, channels at
// stride 1; G-buffer slices are read in place):
//   in[kPos], in[kNrm], in[kTan], in[kBit]  (npix, 3) world pos, raw normal,
//                               tangent, bitangent (the last two textured only)
//   in[kProps]  (npix, C >= 9)  fetched material columns: 0:9 the constants,
//                               16:28 the has-texture flags (textured only)
//   in[kTex]    (npix, C >= 12) sampled texels in sample_any's channel order
//                               (null: untextured, the blend is off)
//   uni  (U,) f32               pack_shading_uniforms' row: eye, ambient,
//                               pad, 10 slots a light, then (split) SH9
// Outputs, by mode (each contiguous, pixel-major):
//   ambient   hdr = ambient*albedo + direct (3), opacity (1)
//   split     hdr = direct + kd*SH9(n)*albedo (3), opacity, spec_f (3),
//             rdir (3), roughness (1)
//   material  hdr = direct (3), opacity, albedo (3), F0 (3), metallic,
//             roughness, n (3) — the caller adds the non-split IBL ambient
// The adjoint takes each output's cotangent (null: zero) at its own pixel
// stride and writes, where asked (null: not written), the gradients of the
// four G-buffer slices (npix, 3), of the props columns (npix, C: zeros in the
// columns it does not read) and of the texels (npix, C), and the uniform
// row's cotangent as one partial row a block (blocks, U), which the wrapper
// sums over blocks. Each lane sums its lights in a fixed order and each warp
// reduces a uniform slot by shuffles into its own shared row, which the block
// sums in a fixed order: no float atomics, so two runs give the same bits.
// Ties follow math3d.maximum / clip: max(x, c) passes half the gradient to x
// at x == c, as torch.maximum's backward does (torch.clamp passes all).
//
// What bounds it on an H100: bytes. A pixel reads 12 G-buffer floats, 21
// table columns and 12 texels (~180 B) and writes 16-44 B; at 1080p that is
// ~0.4 GB, 0.12 ms at 3.35 TB/s, against ~400 FP32 operations a pixel
// (0.8 GFLOP, 0.012 ms at 67 TFLOP/s). So every intermediate stays in
// registers: the forward touches each input byte once and each output once,
// the adjoint recomputes the forward per light from the same inputs rather
// than saving anything (the Function saves only its inputs), and writes only
// the gradients autograd asks for. A pixel whose cotangents are all zero (the
// background under the compose's where) writes zeros without shading. The
// adjoint's widest outputs, the props and texel gradient rows (28 and 12
// floats a pixel), are staged a warp at a time in shared memory and written
// out as consecutive floats: stored from registers, each of a warp's 40
// per-pixel stores touched 32 sectors, and the adjoint ran 0.98 ms at 1080p
// on an H100 (0.40 ms staged).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 4096;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kEps = 1e-20f;
constexpr float kPi = 3.14159265359f;  // ops/brdf.PI
constexpr float kInvPi = 1.0f / kPi;  // x / PI on the card: x * (1 / float(PI))
constexpr float kInvPiSh = (float)(1.0 / 3.141592653589793);  // sh9_irradiance's e * (1.0 / math.pi)
constexpr float kLn2 = (float)0.6931471805599453;
// Ramamoorthi-Hanrahan c1..c5 (ops/shade_core.SH_COEFFS); 2 c1 and 2 c2 are
// Python products rounded once.
constexpr float kC1 = 0.429043f, kC3 = 0.743125f, kC4 = 0.886227f, kC5 = 0.247708f;
constexpr float kC1x2 = (float)(2.0 * 0.429043), kC2x2 = (float)(2.0 * 0.511664);
constexpr int kUniLight0 = 8, kUniPerLight = 10;
constexpr int kHas = 16;  // first has-texture column of the props row
// has-texture slots (models/material.SLOT_*)
constexpr int kSlotDiffuse = 0, kSlotSpecular = 1, kSlotMetallic = 2, kSlotRoughness = 3;
constexpr int kSlotNormal = 4, kSlotOpacity = 11;

enum { kPos, kNrm, kTan, kBit, kProps, kTex, kNumIn };
enum { kAmbient = 0, kSplit = 1, kMaterial = 2 };
constexpr int kNumOut = 7;
// output channels by mode (hdr, opacity, then the mode's own)
__device__ __constant__ int kOutCh[3][kNumOut] = {
    {3, 1, 0, 0, 0, 0, 0}, {3, 1, 3, 3, 1, 0, 0}, {3, 1, 3, 3, 1, 1, 3}};

}  // namespace

// One argument block for both entry points (ops/ps_light.py mirrors it as a
// ctypes Structure: every field 8 bytes).
struct PsLightArgs {
  const float* in[kNumIn];
  long long in_stride[kNumIn];
  const float* uni;
  float* out[kNumOut];          // forward outputs
  const float* g_out[kNumOut];  // adjoint: the outputs' cotangents (null: zero)
  long long g_stride[kNumOut];
  float* g_in[kNumIn];  // adjoint: the inputs' gradients (null: not asked for)
  float* partials;      // adjoint: (blocks, num_uni) uniform partial rows (null: not asked for)
  long long npix, props_cols, tex_cols, num_uni, num_dir, num_point, num_spot, mode;
};

namespace {

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// d max(x, c) / dx and d min(x, c) / dx with math3d's 0.5/0.5 tie split.
__device__ __forceinline__ float dmax(float x, float c) { return x > c ? 1.f : (x == c ? 0.5f : 0.f); }
__device__ __forceinline__ float dmin(float x, float c) { return x < c ? 1.f : (x == c ? 0.5f : 0.f); }

// math3d.normalize: x * rsqrt(max(|x|^2, 1e-20)); returns the rsqrt.
__device__ __forceinline__ float normalize3(const float x[3], float out[3]) {
  const float r = rsqrtf(fmaxf(dot3(x, x), kEps));
  out[0] = x[0] * r;
  out[1] = x[1] * r;
  out[2] = x[2] * r;
  return r;
}

// Its adjoint: g_x = r g - r^3 (g.x) x (the clamp passes the gradient only
// at or above its bound).
__device__ __forceinline__ void normalize3_adjoint(const float x[3], float r, const float g[3], float gx[3]) {
  const float s = dot3(x, x) >= kEps ? dot3(g, x) * (r * r * r) : 0.f;
  gx[0] = g[0] * r - s * x[0];
  gx[1] = g[1] * r - s * x[1];
  gx[2] = g[2] * r - s * x[2];
}

__device__ __forceinline__ const float* row(const PsLightArgs& a, int k, long long i) {
  return a.in[k] + i * a.in_stride[k];
}

// The shading inputs of one pixel after the blend (renderer.shade_pixels'
// material lines, in their order).
struct Surface {
  float pos[3], d[3], v[3], rv;  // d = eye - pos, v = d * rv
  float ng[3], rn;               // ng = normal_w * rn
  float n[3], alb[3], f0[3], met, rough, opacity;
};

__device__ __forceinline__ void load_surface(const PsLightArgs& a, const float* uni, long long i, Surface& s) {
  const float* P = row(a, kPos, i);
  const float* N = row(a, kNrm, i);
  const float* pr = row(a, kProps, i);
  float nw[3], c_alb[3], c_f0[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.pos[c] = __ldg(P + c);
    nw[c] = __ldg(N + c);
    c_alb[c] = __ldg(pr + c);
    c_f0[c] = __ldg(pr + 4 + c);
  }
  const float c_met = __ldg(pr + 3), c_rough = __ldg(pr + 7), c_op = __ldg(pr + 8);
  s.rn = normalize3(nw, s.ng);
#pragma unroll
  for (int c = 0; c < 3; ++c) s.d[c] = uni[c] - s.pos[c];
  s.rv = normalize3(s.d, s.v);
  if (a.in[kTex] == nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.alb[c] = c_alb[c];
      s.n[c] = s.ng[c];
      s.f0[c] = c_f0[c] + (c_alb[c] - c_f0[c]) * c_met;
    }
    s.met = c_met;
    s.rough = c_rough;
    s.opacity = c_op;
    return;
  }
  const float* t = row(a, kTex, i);
  const float* T = row(a, kTan, i);
  const float* B = row(a, kBit, i);
  const float hd = __ldg(pr + kHas + kSlotDiffuse), hs = __ldg(pr + kHas + kSlotSpecular);
  const float hm = __ldg(pr + kHas + kSlotMetallic), hr = __ldg(pr + kHas + kSlotRoughness);
  const float hn = __ldg(pr + kHas + kSlotNormal), ho = __ldg(pr + kHas + kSlotOpacity);
#pragma unroll
  for (int c = 0; c < 3; ++c) s.alb[c] = hd * __ldg(t + c) + (1.f - hd) * c_alb[c];
  s.met = hm * __ldg(t + 6) + (1.f - hm) * c_met;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f0c = c_f0[c] + (s.alb[c] - c_f0[c]) * s.met;  // no specular map: lerp(F0, albedo, metallic)
    s.f0[c] = hs * __ldg(t + 3 + c) + (1.f - hs) * f0c;
  }
  s.rough = hr * __ldg(t + 7) + (1.f - hr) * c_rough;
  const float nt0 = 2.f * __ldg(t + 8) - 1.f, nt1 = 2.f * __ldg(t + 9) - 1.f, nt2 = 2.f * __ldg(t + 10) - 1.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float nm = nt0 * __ldg(T + c) + nt1 * __ldg(B + c) + nt2 * s.ng[c];  // not renormalised
    s.n[c] = hn * nm + (1.f - hn) * s.ng[c];
  }
  s.opacity = ho * __ldg(t + 11) + (1.f - ho) * c_op;
}

// One light's direction, radiance and range test (compute_*_light), and what
// the adjoint needs of the point / spot geometry.
struct LightGeom {
  float l[3], rad[3];
  bool live;
  float tl[3], d, dm, ds, att0, pw, cone_raw;
};

__device__ __forceinline__ void light_geom(const float* L, int kind, const float pos[3], LightGeom& g) {
  g.live = true;
  if (kind == 0) {  // directional
    for (int c = 0; c < 3; ++c) {
      g.l[c] = -L[3 + c];
      g.rad[c] = L[c];
    }
    return;
  }
  for (int c = 0; c < 3; ++c) g.tl[c] = L[6 + c] - pos[c];
  g.d = sqrtf(fmaxf(dot3(g.tl, g.tl), kEps));
  g.live = g.d <= 100.f;
  g.dm = fmaxf(g.d, kEps);
  for (int c = 0; c < 3; ++c) g.l[c] = g.tl[c] / g.dm;
  g.ds = fmaxf(g.d, 0.01f);
  g.att0 = 1.f / (g.ds * g.ds);
  float att = g.att0;
  if (kind == 2) {  // spot: att * max(-l.dir, 0)^power
    const float nl[3] = {-g.l[0], -g.l[1], -g.l[2]};
    g.cone_raw = dot3(nl, L + 3);
    g.pw = powf(fmaxf(g.cone_raw, 0.f), L[9]);
    att = g.att0 * g.pw;
  }
  for (int c = 0; c < 3; ++c) g.rad[c] = L[c] * att;
}

__device__ __forceinline__ int light_kind(const PsLightArgs& a, int li) {
  return li < a.num_dir ? 0 : (li < a.num_dir + a.num_point ? 1 : 2);
}

// brdf_cook_torrance(...) * radiance * N.L added to acc.
__device__ __forceinline__ void add_light(const Surface& s, const LightGeom& lg, float acc[3]) {
  const float hv[3] = {s.v[0] + lg.l[0], s.v[1] + lg.l[1], s.v[2] + lg.l[2]};
  float h[3];
  normalize3(hv, h);
  const float r = fmaxf(s.rough, 0.05f);
  const float a = r * r;
  const float a2 = a * a;
  const float ndoth = fmaxf(dot3(s.n, h), 0.f);
  const float dn = ndoth * ndoth * (a2 - 1.f) + 1.f;
  const float ndf = a2 / (kPi * dn * dn);
  const float rp1 = s.rough + 1.f;
  const float k = (rp1 * rp1) * 0.125f;
  const float nv = fmaxf(dot3(s.n, s.v), 0.f);
  const float nl = fmaxf(dot3(s.n, lg.l), 0.f);
  const float g = (nv / (nv * (1.f - k) + k)) * (nl / (nl * (1.f - k) + k));
  const float cs = fminf(fmaxf(dot3(h, s.v), 0.f), 1.f);
  const float p5 = powf(1.f - cs, 5.f);
  const float den = 4.f * nv * nl + 1e-3f;
  const float q = ndf * g;
  const float omm = 1.f - s.met;
  for (int c = 0; c < 3; ++c) {
    const float f = s.f0[c] + (1.f - s.f0[c]) * p5;
    const float spec = q * f / den;
    const float kd = (1.f - f) * omm;
    acc[c] += (kd * s.alb[c] * kInvPi + spec) * lg.rad[c] * nl;
  }
}

// ops/ibl.sh9_irradiance for channel c at unit n (its order of terms).
__device__ __forceinline__ float sh9_irr(const float* sh, const float n[3], int c) {
  const float x = n[0], y = n[1], z = n[2];
  const float e = (kC1 * sh[24 + c]) * (x * x - y * y) + (kC3 * sh[18 + c]) * (z * z) + kC4 * sh[c] -
                  kC5 * sh[18 + c] +
                  kC1x2 * (sh[12 + c] * x * y + sh[21 + c] * x * z + sh[15 + c] * y * z) +
                  kC2x2 * (sh[9 + c] * x + sh[3 + c] * y + sh[6 + c] * z);
  return e * kInvPiSh;
}

// The IBL split's values at the pixel (renderer.shade_pixels' ibl_split lines).
struct Split {
  float nu[3], rnu, nvr, ndv, p5, r40, r41, r42, r43, e2, sq, mn, ab0, ab1, rvec[3], rr;
};

__device__ __forceinline__ void split_values(const Surface& s, Split& t) {
  t.rnu = normalize3(s.n, t.nu);
  t.nvr = dot3(t.nu, s.v);
  t.ndv = fmaxf(t.nvr, 0.f);
  t.p5 = powf(1.f - t.ndv, 5.f);
  t.r40 = s.rough * -1.f + 1.f;
  t.r41 = s.rough * -0.0275f + 0.0425f;
  t.r42 = s.rough * -0.572f + 1.04f;
  t.r43 = s.rough * 0.022f + -0.04f;
  t.e2 = exp2f(-9.28f * t.ndv);
  t.sq = t.r40 * t.r40;
  t.mn = fminf(t.sq, t.e2);
  const float a004 = t.mn * t.r40 + t.r41;
  t.ab0 = a004 * -1.04f + t.r42;
  t.ab1 = a004 * 1.04f + t.r43;
  for (int c = 0; c < 3; ++c) t.rvec[c] = 2.f * t.ndv * t.nu[c] - s.v[c];
}

// ---------------------------------------------------------------- forward

__device__ __forceinline__ void pixel_forward(const PsLightArgs& a, const float* uni, long long i) {
  const int mode = (int)a.mode;
  const int num_lights = (int)(a.num_dir + a.num_point + a.num_spot);
  Surface s;
  load_surface(a, uni, i, s);
  float acc[3] = {0.f, 0.f, 0.f};
  for (int li = 0; li < num_lights; ++li) {
    LightGeom lg;
    light_geom(uni + kUniLight0 + kUniPerLight * li, light_kind(a, li), s.pos, lg);
    if (lg.live) add_light(s, lg, acc);
  }
  a.out[1][i] = s.opacity;
  if (mode == kAmbient) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.out[0][3 * i + c] = uni[3 + c] * s.alb[c] + acc[c];
  } else if (mode == kSplit) {
    Split t;
    split_values(s, t);
    const float* sh = uni + kUniLight0 + kUniPerLight * num_lights;
    float rdir[3];
    normalize3(t.rvec, rdir);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ks = s.f0[c] + (1.f - s.f0[c]) * t.p5;
      const float kd = (1.f - ks) * (1.f - s.met);
      a.out[0][3 * i + c] = acc[c] + kd * sh9_irr(sh, t.nu, c) * s.alb[c];
      a.out[2][3 * i + c] = s.f0[c] * t.ab0 + t.ab1;
      a.out[3][3 * i + c] = rdir[c];
    }
    a.out[4][i] = s.rough;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.out[0][3 * i + c] = acc[c];
      a.out[2][3 * i + c] = s.alb[c];
      a.out[3][3 * i + c] = s.f0[c];
      a.out[6][3 * i + c] = s.n[c];
    }
    a.out[4][i] = s.met;
    a.out[5][i] = s.rough;
  }
}

__global__ void __launch_bounds__(kThreads) ps_light_forward_kernel(PsLightArgs a) {
  extern __shared__ float s_uni[];
  for (int u = threadIdx.x; u < a.num_uni; u += kThreads) s_uni[u] = __ldg(a.uni + u);
  __syncthreads();
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < a.npix;
       i += (long long)gridDim.x * kThreads) {
    pixel_forward(a, s_uni, i);
  }
}

// ---------------------------------------------------------------- adjoint

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Where a pixel's uniform cotangent goes: a warp sum into the warp's own
// shared row (lane 0 adds), or nowhere when no uniform gradient is asked for.
struct UniSink {
  float* dst;  // this warp's row of num_uni floats, or null
  int lane;
  bool on;  // this lane holds a pixel with a nonzero cotangent
  __device__ __forceinline__ void operator()(int u, float val) const {
    if (dst == nullptr) return;
    const float s = warp_sum(on ? val : 0.f);
    if (lane == 0) dst[u] += s;
  }
};

// The accumulated cotangents of the blended surface.
struct SurfaceGrad {
  float n[3], v[3], pos[3], alb[3], f0[3], met, rough;
};

// Adjoint of one light's add_light (and of its geometry), G the hdr
// cotangent. Adds into g, and writes the light's 10 uniform slots to g_uni.
__device__ __forceinline__ void light_adjoint(const Surface& s, const float* L, int kind, const float G[3],
                                              SurfaceGrad& g, float g_uni[kUniPerLight]) {
  LightGeom lg;
  light_geom(L, kind, s.pos, lg);
  for (int j = 0; j < kUniPerLight; ++j) g_uni[j] = 0.f;
  if (!lg.live) return;  // in_range = 0: the light adds nothing, nor its gradient
  const float hv[3] = {s.v[0] + lg.l[0], s.v[1] + lg.l[1], s.v[2] + lg.l[2]};
  float h[3];
  const float rh = normalize3(hv, h);
  const float r = fmaxf(s.rough, 0.05f);
  const float a = r * r;
  const float a2 = a * a;
  const float nh = dot3(s.n, h);
  const float ndoth = fmaxf(nh, 0.f);
  const float am1 = a2 - 1.f;
  // The gradient needs no forward value bit for bit, only the tie tests
  // (nh, nvr, nlr, hvd, rough) do: reciprocals stand for the divides and
  // products for the powers.
  const float dn = ndoth * ndoth * am1 + 1.f;
  const float inv_dn = 1.f / dn;
  const float ndf = a2 * (inv_dn * inv_dn * kInvPi);
  const float rp1 = s.rough + 1.f;
  const float k = (rp1 * rp1) * 0.125f;
  const float omk = 1.f - k;
  const float nvr = dot3(s.n, s.v), nv = fmaxf(nvr, 0.f);
  const float nlr = dot3(s.n, lg.l), nl = fmaxf(nlr, 0.f);
  const float inv_dv = 1.f / (nv * omk + k), inv_dl = 1.f / (nl * omk + k);
  const float gv = nv * inv_dv, gl = nl * inv_dl;
  const float gg = gv * gl;
  const float hvd = dot3(h, s.v);
  const float mx = fmaxf(hvd, 0.f);
  const float om = 1.f - fminf(mx, 1.f);
  const float p4 = (om * om) * (om * om);
  const float p5 = p4 * om;
  const float inv_den = 1.f / (4.f * nv * nl + 1e-3f);
  const float q = ndf * gg;
  const float omm = 1.f - s.met;

  float g_nl = 0.f, g_q = 0.f, g_den = 0.f, g_p5 = 0.f, g_rad[3];
  for (int c = 0; c < 3; ++c) {
    const float f = s.f0[c] + (1.f - s.f0[c]) * p5;
    const float spec = q * f * inv_den;
    const float kd = (1.f - f) * omm;
    const float t = kd * s.alb[c] * kInvPi + spec;
    const float u = t * lg.rad[c];
    g_nl += G[c] * u;
    const float g_u = G[c] * nl;
    const float g_t = g_u * lg.rad[c];
    g_rad[c] = g_u * t;
    const float g_kd = g_t * kInvPi * s.alb[c];
    g.alb[c] += g_t * kd * kInvPi;
    float g_f = -g_kd * omm;
    g.met -= g_kd * (1.f - f);
    g_f += g_t * q * inv_den;
    g_q += g_t * f * inv_den;
    g_den -= g_t * spec * inv_den;
    g.f0[c] += g_f * (1.f - p5);
    g_p5 += g_f * (1.f - s.f0[c]);
  }
  float g_nv = g_den * 4.f * nl;
  g_nl += g_den * 4.f * nv;
  const float g_ndf = g_q * gg, g_gg = g_q * ndf;
  const float g_gv = g_gg * gl, g_gl = g_gg * gv;
  // Schlick-GGX x / (x (1 - k) + k): d/dx = k / D^2, d/dk = -x (1 - x) / D^2
  const float dv2 = inv_dv * inv_dv, dl2 = inv_dl * inv_dl;
  g_nv += g_gv * k * dv2;
  g_nl += g_gl * k * dl2;
  const float g_k = -g_gv * nv * (1.f - nv) * dv2 - g_gl * nl * (1.f - nl) * dl2;
  g.rough += g_k * rp1 * 0.25f;
  const float g_hvd = -(g_p5 * 5.f * p4) * dmin(mx, 1.f) * dmax(hvd, 0.f);
  // GGX: ndf = a2 / (pi dn^2), dn = ndoth^2 (a2 - 1) + 1
  const float g_dn = -2.f * g_ndf * ndf * inv_dn;
  const float g_a2 = g_ndf * (inv_dn * inv_dn * kInvPi) + g_dn * ndoth * ndoth;
  const float g_ndoth = g_dn * 2.f * ndoth * am1;
  g.rough += g_a2 * 2.f * a * 2.f * r * dmax(s.rough, 0.05f);
  const float g_nh = g_ndoth * dmax(nh, 0.f);
  const float g_nvr = g_nv * dmax(nvr, 0.f);
  const float g_nlr = g_nl * dmax(nlr, 0.f);
  float g_h[3], g_l[3];
  for (int c = 0; c < 3; ++c) {
    g.n[c] += g_nh * h[c] + g_nvr * s.v[c] + g_nlr * lg.l[c];
    g_h[c] = g_nh * s.n[c] + g_hvd * s.v[c];
    g.v[c] += g_nvr * s.n[c] + g_hvd * h[c];
    g_l[c] = g_nlr * s.n[c];
  }
  float g_hv[3];
  normalize3_adjoint(hv, rh, g_h, g_hv);
  for (int c = 0; c < 3; ++c) {
    g.v[c] += g_hv[c];
    g_l[c] += g_hv[c];
  }
  if (kind == 0) {
    for (int c = 0; c < 3; ++c) {
      g_uni[c] = g_rad[c];
      g_uni[3 + c] = -g_l[c];
    }
    return;
  }
  const float att = kind == 2 ? lg.att0 * lg.pw : lg.att0;
  float g_att = 0.f;
  for (int c = 0; c < 3; ++c) {
    g_uni[c] = g_rad[c] * att;
    g_att += g_rad[c] * L[c];
  }
  float g_att0 = g_att;
  if (kind == 2) {
    const float cone = fmaxf(lg.cone_raw, 0.f), sp = L[9];
    g_att0 = g_att * lg.pw;
    const float g_pw = g_att * lg.att0;
    // pow(cone, sp): torch's pow backward (0 to the base where sp = 0, 0 to
    // the exponent where cone = 0 and sp >= 0)
    const float g_cone = sp == 0.f ? 0.f : g_pw * (sp * powf(cone, sp - 1.f));
    g_uni[9] = (cone == 0.f && sp >= 0.f) ? 0.f : g_pw * (lg.pw * logf(cone));
    const float g_cr = g_cone * dmax(lg.cone_raw, 0.f);
    for (int c = 0; c < 3; ++c) {
      g_l[c] -= g_cr * L[3 + c];
      g_uni[3 + c] = -g_cr * lg.l[c];
    }
  }
  // att0 = 1 / ds^2, ds = max(d, 0.01); l = tl / max(d, 1e-20); d = sqrt(max(|tl|^2, 1e-20))
  const float inv_dm = 1.f / lg.dm;
  float g_d = -2.f * g_att0 * lg.att0 / lg.ds * dmax(lg.d, 0.01f);
  g_d -= dot3(g_l, lg.tl) * (inv_dm * inv_dm) * dmax(lg.d, kEps);
  const float g_dd = dot3(lg.tl, lg.tl) >= kEps ? g_d / lg.d : 0.f;
  for (int c = 0; c < 3; ++c) {
    const float g_tl = g_l[c] * inv_dm + lg.tl[c] * g_dd;
    g_uni[6 + c] = g_tl;
    g.pos[c] -= g_tl;
  }
}

// Adjoint of the IBL split's outputs (hdr's SH9 diffuse, spec_f, rdir,
// roughness), before the lights; the 27 SH9 slots go to sink.
template <class Sink>
__device__ __forceinline__ void split_adjoint(const Surface& s, const float* sh, const float G[3],
                                              const float GS[3], const float GR[3], float g_rough_out,
                                              SurfaceGrad& g, const Sink& sink, int sh0) {
  Split t;
  split_values(s, t);
  float g_nu[3] = {0.f, 0.f, 0.f};
  float g_ndv = 0.f, g_p5 = 0.f;
  const float omm = 1.f - s.met;
  const float x = t.nu[0], y = t.nu[1], z = t.nu[2];
  for (int c = 0; c < 3; ++c) {
    const float ks = s.f0[c] + (1.f - s.f0[c]) * t.p5;
    const float kd = (1.f - ks) * omm;
    const float irr = sh9_irr(sh, t.nu, c);
    const float g_kd = G[c] * irr * s.alb[c];
    const float g_e = G[c] * kd * s.alb[c] * kInvPiSh;
    g.alb[c] += G[c] * kd * irr;
    const float s8 = kC1 * sh[24 + c], s6 = kC3 * sh[18 + c];
    g_nu[0] += g_e * (s8 * 2.f * x + kC1x2 * (sh[12 + c] * y + sh[21 + c] * z) + kC2x2 * sh[9 + c]);
    g_nu[1] += g_e * (-s8 * 2.f * y + kC1x2 * (sh[12 + c] * x + sh[15 + c] * z) + kC2x2 * sh[3 + c]);
    g_nu[2] += g_e * (s6 * 2.f * z + kC1x2 * (sh[21 + c] * x + sh[15 + c] * y) + kC2x2 * sh[6 + c]);
    const float basis[9] = {kC4, kC2x2 * y, kC2x2 * z, kC2x2 * x, kC1x2 * (x * y),
                            kC1x2 * (y * z), kC3 * (z * z) - kC5, kC1x2 * (x * z), kC1 * (x * x - y * y)};
    for (int b = 0; b < 9; ++b) sink(sh0 + 3 * b + c, g_e * basis[b]);
    const float g_ks = -g_kd * omm;
    g.met -= g_kd * (1.f - ks);
    g.f0[c] += g_ks * (1.f - t.p5) + GS[c] * t.ab0;
    g_p5 += g_ks * (1.f - s.f0[c]);
  }
  const float g_ab0 = GS[0] * s.f0[0] + GS[1] * s.f0[1] + GS[2] * s.f0[2];
  const float g_ab1 = GS[0] + GS[1] + GS[2];
  const float g_a004 = g_ab0 * -1.04f + g_ab1 * 1.04f;
  const float g_mn = g_a004 * t.r40;
  const float w_sq = t.sq < t.e2 ? 1.f : (t.sq == t.e2 ? 0.5f : 0.f);  // torch.minimum's tie split
  const float g_r40 = g_a004 * t.mn + g_mn * w_sq * 2.f * t.r40;
  g_ndv += g_mn * (1.f - w_sq) * t.e2 * kLn2 * -9.28f;
  g.rough += -g_r40 - 0.0275f * g_a004 - 0.572f * g_ab0 + 0.022f * g_ab1 + g_rough_out;
  const float omv = 1.f - t.ndv;
  g_ndv -= g_p5 * 5.f * ((omv * omv) * (omv * omv));
  float g_rv[3];
  normalize3_adjoint(t.rvec, rsqrtf(fmaxf(dot3(t.rvec, t.rvec), kEps)), GR, g_rv);
  g_ndv += 2.f * dot3(g_rv, t.nu);
  const float g_nvr = g_ndv * dmax(t.nvr, 0.f);
  for (int c = 0; c < 3; ++c) {
    g_nu[c] += g_rv[c] * (2.f * t.ndv) + g_nvr * s.v[c];
    g.v[c] += g_nvr * t.nu[c] - g_rv[c];
  }
  float g_n[3];
  normalize3_adjoint(s.n, t.rnu, g_nu, g_n);
  for (int c = 0; c < 3; ++c) g.n[c] += g_n[c];
}

__device__ __forceinline__ float cot(const PsLightArgs& a, int k, long long i, int c) {
  return a.g_out[k] == nullptr ? 0.f : __ldg(a.g_out[k] + i * a.g_stride[k] + c);
}

// Whether any cotangent of pixel i is nonzero.
__device__ __forceinline__ bool any_cotangent(const PsLightArgs& a, long long i) {
  const int mode = (int)a.mode;
  const int nout = mode == kAmbient ? 2 : (mode == kSplit ? 5 : 7);
  bool live = false;
#pragma unroll
  for (int k = 0; k < kNumOut; ++k) {
    if (k >= nout || a.g_out[k] == nullptr) continue;
    const int ch = kOutCh[mode][k];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < ch) live |= cot(a, k, i, c) != 0.f;
    }
  }
  return live;
}

__device__ __forceinline__ void store3(float* dst, long long i, const float v[3]) {
  if (dst == nullptr) return;
  dst[3 * i] = v[0];
  dst[3 * i + 1] = v[1];
  dst[3 * i + 2] = v[2];
}

// The gradients of a pixel whose cotangents are all zero: the G-buffer's to
// global memory, the props and texel rows to pr_out / tex_out (null: not
// asked for).
__device__ __forceinline__ void store_zero_grads(const PsLightArgs& a, long long i, float* pr_out, float* tex_out) {
  const float z[3] = {0.f, 0.f, 0.f};
  store3(a.g_in[kPos], i, z);
  store3(a.g_in[kNrm], i, z);
  store3(a.g_in[kTan], i, z);
  store3(a.g_in[kBit], i, z);
  if (pr_out) {
    for (long long c = 0; c < a.props_cols; ++c) pr_out[c] = 0.f;
  }
  if (tex_out) {
    for (long long c = 0; c < a.tex_cols; ++c) tex_out[c] = 0.f;
  }
}

// The adjoint of pixel i (in_range false: a lane past the last pixel, which
// reads pixel npix - 1 and adds zeros to the warp's uniform sums). The
// G-buffer gradients go to global memory, the props and texel rows to
// pr_out / tex_out (null: not asked for).
template <class Sink>
__device__ __forceinline__ void pixel_backward(const PsLightArgs& a, const float* uni, long long i, bool in_range,
                                               bool live, const Sink& sink, float* pr_out, float* tex_out) {
  const int mode = (int)a.mode;
  const int num_lights = (int)(a.num_dir + a.num_point + a.num_spot);
  const bool textured = a.in[kTex] != nullptr;
  const long long ii = in_range ? i : a.npix - 1;
  Surface s;
  load_surface(a, uni, ii, s);
  float G[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) G[c] = live ? cot(a, 0, ii, c) : 0.f;
  SurfaceGrad g;
#pragma unroll
  for (int c = 0; c < 3; ++c) g.n[c] = g.v[c] = g.pos[c] = g.alb[c] = g.f0[c] = 0.f;
  g.met = g.rough = 0.f;
  if (mode == kAmbient) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g.alb[c] += G[c] * uni[3 + c];
      sink(3 + c, G[c] * s.alb[c]);
    }
  } else if (mode == kSplit) {
    float GS[3], GR[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      GS[c] = live ? cot(a, 2, ii, c) : 0.f;
      GR[c] = live ? cot(a, 3, ii, c) : 0.f;
    }
    const int sh0 = kUniLight0 + kUniPerLight * num_lights;
    split_adjoint(s, uni + sh0, G, GS, GR, live ? cot(a, 4, ii, 0) : 0.f, g, sink, sh0);
  } else if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g.alb[c] += cot(a, 2, ii, c);
      g.f0[c] += cot(a, 3, ii, c);
      g.n[c] += cot(a, 6, ii, c);
    }
    g.met += cot(a, 4, ii, 0);
    g.rough += cot(a, 5, ii, 0);
  }
  for (int li = 0; li < num_lights; ++li) {
    float g_l[kUniPerLight];
    light_adjoint(s, uni + kUniLight0 + kUniPerLight * li, light_kind(a, li), G, g, g_l);
#pragma unroll
    for (int j = 0; j < kUniPerLight; ++j) sink(kUniLight0 + kUniPerLight * li + j, g_l[j]);
  }
  float g_d[3];  // v = normalize(eye - pos)
  normalize3_adjoint(s.d, s.rv, g.v, g_d);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g.pos[c] -= g_d[c];
    sink(c, g_d[c]);
  }
  if (!in_range) return;
  if (!live) {
    store_zero_grads(a, i, pr_out, tex_out);
    return;
  }
  // the blend, backwards
  const float* pr = row(a, kProps, i);
  const float g_op = cot(a, 1, i, 0);
  float g_pr[28], g_tex[12], g_ng[3], g_T[3], g_B[3];
#pragma unroll
  for (int c = 0; c < 28; ++c) g_pr[c] = 0.f;
  if (!textured) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float cf0 = __ldg(pr + 4 + c);
      g_pr[4 + c] = g.f0[c] - g.f0[c] * s.met;  // lerp(a, b, t) = a + (b - a) t
      g.alb[c] += g.f0[c] * s.met;
      g.met += g.f0[c] * (s.alb[c] - cf0);
      g_ng[c] = g.n[c];
      g_pr[c] = g.alb[c];
      g_T[c] = g_B[c] = 0.f;
    }
    g_pr[3] = g.met;
    g_pr[7] = g.rough;
    g_pr[8] = g_op;
  } else {
    const float* t = row(a, kTex, i);
    const float* T = row(a, kTan, i);
    const float* B = row(a, kBit, i);
    const float hd = __ldg(pr + kHas + kSlotDiffuse), hs = __ldg(pr + kHas + kSlotSpecular);
    const float hm = __ldg(pr + kHas + kSlotMetallic), hr = __ldg(pr + kHas + kSlotRoughness);
    const float hn = __ldg(pr + kHas + kSlotNormal), ho = __ldg(pr + kHas + kSlotOpacity);
    g_tex[11] = g_op * ho;
    g_pr[8] = g_op * (1.f - ho);
    g_pr[kHas + kSlotOpacity] = g_op * (__ldg(t + 11) - __ldg(pr + 8));
    const float nt0 = 2.f * __ldg(t + 8) - 1.f, nt1 = 2.f * __ldg(t + 9) - 1.f, nt2 = 2.f * __ldg(t + 10) - 1.f;
    float g_nm[3], tc[3], bc[3], g_hn = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tc[c] = __ldg(T + c);
      bc[c] = __ldg(B + c);
      const float nm = nt0 * tc[c] + nt1 * bc[c] + nt2 * s.ng[c];
      g_nm[c] = g.n[c] * hn;
      g_ng[c] = g.n[c] * (1.f - hn) + g_nm[c] * nt2;
      g_hn += g.n[c] * (nm - s.ng[c]);
      g_T[c] = g_nm[c] * nt0;
      g_B[c] = g_nm[c] * nt1;
    }
    g_pr[kHas + kSlotNormal] = g_hn;
    g_tex[8] = 2.f * dot3(g_nm, tc);
    g_tex[9] = 2.f * dot3(g_nm, bc);
    g_tex[10] = 2.f * dot3(g_nm, s.ng);
    g_tex[7] = g.rough * hr;
    g_pr[7] = g.rough * (1.f - hr);
    g_pr[kHas + kSlotRoughness] = g.rough * (__ldg(t + 7) - __ldg(pr + 7));
    float g_hs = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float cf0 = __ldg(pr + 4 + c);
      const float f0c = cf0 + (s.alb[c] - cf0) * s.met;
      g_tex[3 + c] = g.f0[c] * hs;
      const float g_f0c = g.f0[c] * (1.f - hs);
      g_hs += g.f0[c] * (__ldg(t + 3 + c) - f0c);
      g_pr[4 + c] = g_f0c - g_f0c * s.met;
      g.alb[c] += g_f0c * s.met;
      g.met += g_f0c * (s.alb[c] - cf0);
    }
    g_pr[kHas + kSlotSpecular] = g_hs;
    g_tex[6] = g.met * hm;
    g_pr[3] = g.met * (1.f - hm);
    g_pr[kHas + kSlotMetallic] = g.met * (__ldg(t + 6) - __ldg(pr + 3));
    float g_hd = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_tex[c] = g.alb[c] * hd;
      g_pr[c] = g.alb[c] * (1.f - hd);
      g_hd += g.alb[c] * (__ldg(t + c) - __ldg(pr + c));
    }
    g_pr[kHas + kSlotDiffuse] = g_hd;
  }
  const float* N = row(a, kNrm, i);
  const float nw[3] = {__ldg(N), __ldg(N + 1), __ldg(N + 2)};
  float g_nw[3];
  normalize3_adjoint(nw, s.rn, g_ng, g_nw);
  store3(a.g_in[kPos], i, g.pos);
  store3(a.g_in[kNrm], i, g_nw);
  store3(a.g_in[kTan], i, g_T);
  store3(a.g_in[kBit], i, g_B);
  if (pr_out) {
#pragma unroll
    for (int c = 0; c < 28; ++c) {
      if (c < a.props_cols) pr_out[c] = g_pr[c];
    }
    for (long long c = 28; c < a.props_cols; ++c) pr_out[c] = 0.f;
  }
  if (tex_out) {
#pragma unroll
    for (int c = 0; c < 12; ++c) tex_out[c] = textured ? g_tex[c] : 0.f;
    for (long long c = 12; c < a.tex_cols; ++c) tex_out[c] = 0.f;
  }
}

// Odd row strides of the staged rows: lane l writes column c of its row to
// bank (l * stride + c) mod 32, distinct across the warp.
__device__ __host__ __forceinline__ int staged_stride(long long cols) { return (int)(cols | 1); }

// A warp's staged rows (32 rows of cols floats at an odd stride) copied to
// rows [wbase, wbase + n) of a (npix, cols) output: consecutive lanes write
// consecutive floats.
__device__ __forceinline__ void copy_rows_out(const float* staged, int cols, float* out, long long wbase, int n,
                                              int lane) {
  const int stride = staged_stride(cols);
  int r = 0, c = lane;
  while (c >= cols) {
    c -= cols;
    ++r;
  }
  for (int j = lane; j < n * cols; j += 32) {
    out[wbase * cols + j] = staged[r * stride + c];
    c += 32;
    while (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kThreads) ps_light_backward_kernel(PsLightArgs a) {
  extern __shared__ float smem[];
  const int nu = (int)a.num_uni;
  const bool want_uni = a.partials != nullptr;
  const int pc = (int)a.props_cols, tc = (int)a.tex_cols;
  const int rows_per_warp = 32 * ((a.g_in[kProps] ? staged_stride(pc) : 0) + (a.g_in[kTex] ? staged_stride(tc) : 0));
  float* s_uni = smem;
  float* s_rows = s_uni + nu;                                // (kWarps, num_uni): each warp's uniform sums
  float* s_stage = s_rows + (want_uni ? kWarps * nu : 0);    // (kWarps, rows_per_warp): staged gradient rows
  for (int u = threadIdx.x; u < nu; u += kThreads) s_uni[u] = __ldg(a.uni + u);
  if (want_uni) {
    for (int u = threadIdx.x; u < kWarps * nu; u += kThreads) s_rows[u] = 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* w_pr = s_stage + warp * rows_per_warp;
  float* w_tex = w_pr + (a.g_in[kProps] ? 32 * staged_stride(pc) : 0);
  float* my_pr = a.g_in[kProps] ? w_pr + lane * staged_stride(pc) : nullptr;
  float* my_tex = a.g_in[kTex] ? w_tex + lane * staged_stride(tc) : nullptr;
  // every lane of a warp runs the same iterations (the uniform sums shuffle,
  // and the warp writes its staged rows out together)
  for (long long base = (long long)blockIdx.x * kThreads; base < a.npix; base += (long long)gridDim.x * kThreads) {
    const long long i = base + threadIdx.x;
    const bool in_range = i < a.npix;
    const bool live = in_range && any_cotangent(a, i);
    if (!live && !want_uni) {
      if (in_range) store_zero_grads(a, i, my_pr, my_tex);
    } else {
      pixel_backward(a, s_uni, i, in_range, live, UniSink{want_uni ? s_rows + warp * nu : nullptr, lane, live},
                     my_pr, my_tex);
    }
    __syncwarp();
    const long long wbase = base + warp * 32;
    const int n = wbase < a.npix ? (int)(a.npix - wbase < 32 ? a.npix - wbase : 32) : 0;
    if (my_pr) copy_rows_out(w_pr, pc, a.g_in[kProps], wbase, n, lane);
    if (my_tex) copy_rows_out(w_tex, tc, a.g_in[kTex], wbase, n, lane);
    __syncwarp();
  }
  if (!want_uni) return;
  __syncthreads();
  float* out = a.partials + (long long)blockIdx.x * nu;
  for (int u = threadIdx.x; u < nu; u += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += s_rows[w * nu + u];  // a fixed order
    out[u] = acc;
  }
}

int num_blocks(long long npix) {
  const long long want = (npix + kThreads - 1) / kThreads;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

bool args_ok(const PsLightArgs* a) {
  const long long lights = a->num_dir + a->num_point + a->num_spot;
  return a->mode >= 0 && a->mode <= 2 && a->num_dir >= 0 && a->num_point >= 0 && a->num_spot >= 0 &&
         a->num_uni >= kUniLight0 + kUniPerLight * lights + (a->mode == kSplit ? 27 : 0) &&
         a->props_cols >= (a->in[kTex] ? 28 : 9) && (a->in[kTex] == nullptr || a->tex_cols >= 12);
}

cudaError_t launch(void (*kernel)(PsLightArgs), const PsLightArgs& a, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<num_blocks(a.npix), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The blocks of a launch over npix pixels: the rows of the adjoint's
// uniform partials.
extern "C" int ps_light_blocks(long long npix) { return num_blocks(npix); }

extern "C" int ps_light_forward(const PsLightArgs* a, void* stream) {
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  if (a->npix <= 0) return (int)cudaSuccess;
  return (int)launch(ps_light_forward_kernel, *a, sizeof(float) * a->num_uni, static_cast<cudaStream_t>(stream));
}

extern "C" int ps_light_backward(const PsLightArgs* a, void* stream) {
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  if (a->npix <= 0) return (int)cudaSuccess;
  const size_t staged = 32 * kWarps * ((a->g_in[kProps] ? staged_stride(a->props_cols) : 0) +
                                       (a->g_in[kTex] ? staged_stride(a->tex_cols) : 0));
  const size_t smem = sizeof(float) * (a->num_uni * (a->partials ? 1 + kWarps : 1) + staged);
  return (int)launch(ps_light_backward_kernel, *a, smem, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ps_light_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
