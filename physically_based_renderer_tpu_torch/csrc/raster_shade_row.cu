// Fused raster + depth resolve + perspective-correct interpolation + material
// fetch + Cook-Torrance shading + tonemap, one CTA per screen tile.
//
// Replaces the TPU kernel
//   physically_based_renderer_tpu/ops/raster_row.py::_raster_tile_shade_row_kernel
// (shade mode, ibl=False). The plain PyTorch version of the same function is
// ops/raster_row.py::raster_shade_tiles_plain; both compute exactly what the
// TPU kernel computes, not its blocks.
//
// Inputs (built by ops/raster_bin.py::bin_triangles, pair-major):
//   starts   (ntiles+1,) i32   tile i owns pairs [starts[i], starts[i+1]);
//                              [0, starts[0]) is the jumbo run every tile reads
//   packed   (PAIRS, nf) f32   per-pair fields: 0-8 edge coefficients, 9-10
//                              corner 0, 11-13 depth plane, 14 material, then
//                              three NUM_CH-wide interpolation plane blocks at 16
//   pair_tri (PAIRS,) i32      triangle id of each pair
//   mat      (M, 9) f32        diffuse rgb, metallic, F0 rgb, roughness, opacity
//   uni      (U,) f32          shading uniforms (ops/shade_core.py layout)
// Outputs, written directly in image layout (no tile-major scratch):
//   code (rows, W) i32         tid*mat_stride + mat (tid when mat_stride == 1), -1 bg
//   rgba (rows, W, 4) f32      shaded foreground, 0 at background
//   gbuf (rows, W, 7) f32      optional: 6 attributes + NDC depth, 0 at background
//
// What bounds it on an H100: FP32 ALU on the (pairs x tile pixels) edge and
// depth tests -- every pair of a tile's run is tested against all 1024 pixels
// of the 8x128 tile -- and, far behind, about 70 MB of memory traffic per
// 1080p frame (pair records, the image outputs). The design keeps the test
// loop on-chip: a tile's pair records are staged through shared memory in
// chunks (every thread reads the same record, a broadcast), each thread keeps
// its pixels' best (quantized depth, pair) in registers, and only the
// winner's full record is read from global memory, once per pixel, in the
// epilogue. Work per CTA is proportional to the tile's own run, so sparse
// tiles cost little. cp.async/TMA staging is left for a later change.
//
// Depth semantics (tests pin them): the key is (bits(z) & ~0x7F), signed
// int32; a pair replaces the current winner only when its key is strictly
// smaller, so the minimum quantized depth wins and a tie goes to the first
// pair in processing order (jumbo run first, then the tile's run, ascending
// triangle id). A per-thread sequential loop gives exactly that; a 64-bit
// atomicMin would change tie winners.
//
// Build with -fmad=false. The edge, depth and plane terms are also written
// with __fmul_rn/__fadd_rn so they round exactly as the plain version does:
// a contracted a*b+c flips coverage for pixel centres within an ulp of an edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads per CTA
constexpr int kChunk = 256;       // pair records per shared-memory stage
constexpr int kStageFloats = 16;  // 14 raster fields, triangle id bits, pad
constexpr int kNumCh = 7;         // interpolated channels: pos, normal, 1/w
constexpr int kFieldMaterial = 14;
constexpr int kPlane0 = 16;
constexpr int kUniLight0 = 8;
constexpr int kUniPerLight = 10;
constexpr float kPi = 3.14159265359f;
constexpr float kInvPi = (float)(1.0 / 3.14159265359);
constexpr float kInvGamma = (float)(1.0 / 2.2);

struct Params {
  const int* starts;
  const float* packed;
  const int* pair_tri;
  const float* mat;
  const float* uni;
  int* code;
  float* rgba;
  float* gbuf;  // may be null
  int nf;
  int num_materials;
  int num_uni;
  int width;
  int rows;
  int y_offset;
  int tile_h;
  int tile_w;
  int tiles_x;
  int mat_stride;
  int num_dir;
  int num_point;
  int num_spot;
  int apply_tonemap;
};

__device__ __forceinline__ float plane(float gx, float dx, float gy, float dy, float gc) {
  // (gx*dx + gy*dy) + gc, each step rounded: the plain version's order.
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, dx), __fmul_rn(gy, dy)), gc);
}

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

// ops/shade_core.py::shade_core, ibl=False: the same expressions in the same order.
__device__ void shade(const float* uni, int num_dir, int num_point, int num_spot,
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

template <int PPT>  // pixels per thread: tile_h * tile_w <= kThreads * PPT
__global__ void __launch_bounds__(kThreads) raster_shade_row_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* s_pairs = reinterpret_cast<float*>(smem4);
  float* s_mat = s_pairs + kChunk * kStageFloats;
  float* s_uni = s_mat + p.num_materials * 9;

  const int tile = blockIdx.x;
  const int ty = tile / p.tiles_x;
  const int tx = tile - ty * p.tiles_x;
  const int npix = p.tile_h * p.tile_w;

  for (int i = threadIdx.x; i < p.num_materials * 9; i += kThreads) s_mat[i] = p.mat[i];
  for (int i = threadIdx.x; i < p.num_uni; i += kThreads) s_uni[i] = p.uni[i];

  // Pixel centres, exactly as the plain version forms them.
  const float x_base = (float)(tx * p.tile_w);
  const float y_base = (float)(ty * p.tile_h + p.y_offset);
  float px[PPT], py[PPT];
  int best_zq[PPT], best_pair[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    px[k] = (x_base + (float)(pix % p.tile_w)) + 0.5f;
    py[k] = (y_base + (float)(pix / p.tile_w)) + 0.5f;
    best_zq[k] = 0x7FFFFFFF;
    best_pair[k] = -1;
  }

  const int g_end = p.starts[0];
  const int runs[2][2] = {{0, g_end}, {p.starts[tile], p.starts[tile + 1]}};
  for (int r = 0; r < 2; ++r) {
    for (int c0 = runs[r][0]; c0 < runs[r][1]; c0 += kChunk) {
      const int n = min(kChunk, runs[r][1] - c0);
      __syncthreads();  // the previous chunk has been consumed
      for (int i = threadIdx.x; i < n * kStageFloats; i += kThreads) {
        const int q = i / kStageFloats;
        const int f = i - q * kStageFloats;
        float val = 0.f;
        if (f < 14) {
          val = p.packed[(size_t)(c0 + q) * p.nf + f];
        } else if (f == 14) {
          val = __int_as_float(p.pair_tri[c0 + q]);
        }
        s_pairs[i] = val;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float4* rec = reinterpret_cast<const float4*>(s_pairs + j * kStageFloats);
        const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2], r3 = rec[3];
        if (__float_as_int(r3.z) < 0) continue;  // no triangle (uniform branch)
        // r0 = a0 a1 a2 b0 | r1 = b1 b2 c0 c1 | r2 = c2 x0 y0 za | r3 = zb zc tid -
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float dx = __fsub_rn(px[k], r2.y);
          const float dy = __fsub_rn(py[k], r2.z);
          const float e0 = plane(dx, r0.x, dy, r0.w, r1.z);
          const float e1 = plane(dx, r0.y, dy, r1.x, r1.w);
          const float e2 = plane(dx, r0.z, dy, r1.y, r2.x);
          const float z = plane(dx, r2.w, dy, r3.x, r3.y);
          if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && z >= 0.f && z <= 1.f) {
            const int zq = __float_as_int(z) & ~0x7F;
            if (zq < best_zq[k]) {
              best_zq[k] = zq;
              best_pair[k] = c0 + j;
            }
          }
        }
      }
    }
  }
  __syncthreads();  // s_mat / s_uni visible even when both runs are empty

  // Epilogue: winner fields by index (exact), interpolation, shading.
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    if (pix >= npix) continue;
    const int row = ty * p.tile_h + pix / p.tile_w;
    const int col = tx * p.tile_w + pix % p.tile_w;
    if (row >= p.rows || col >= p.width) continue;
    const size_t o = (size_t)row * p.width + col;
    const int bp = best_pair[k];
    if (bp < 0) {
      p.code[o] = -1;
      reinterpret_cast<float4*>(p.rgba)[o] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p.gbuf) {
        for (int c = 0; c < kNumCh; ++c) p.gbuf[o * kNumCh + c] = 0.f;
      }
      continue;
    }
    const float* f = p.packed + (size_t)bp * p.nf;
    const int tid = p.pair_tri[bp];
    const int matf = (int)f[kFieldMaterial];
    int code, mid;
    if (p.mat_stride > 1) {
      code = tid * p.mat_stride + matf;
      mid = code % p.mat_stride;
    } else {
      code = tid;
      mid = matf;
    }
    p.code[o] = code;

    const float dxp = __fsub_rn(px[k], f[9]);
    const float dyp = __fsub_rn(py[k], f[10]);
    float pl[kNumCh];
#pragma unroll
    for (int c = 0; c < kNumCh; ++c) {
      pl[c] = plane(f[kPlane0 + c], dxp, f[kPlane0 + kNumCh + c], dyp, f[kPlane0 + 2 * kNumCh + c]);
    }
    const float invw = pl[kNumCh - 1];
    const float den = fabsf(invw) > 1e-20f ? invw : 1.f;
    float attrs[kNumCh - 1];
#pragma unroll
    for (int c = 0; c < kNumCh - 1; ++c) attrs[c] = __fdiv_rn(pl[c], den);
    if (p.gbuf) {
      float* g = p.gbuf + o * kNumCh;
      for (int c = 0; c < kNumCh - 1; ++c) g[c] = attrs[c];
      g[kNumCh - 1] = plane(f[11], dxp, f[12], dyp, f[13]);
    }

    float props[9];
    const bool in_table = mid >= 0 && mid < p.num_materials;
    for (int c = 0; c < 9; ++c) props[c] = in_table ? s_mat[mid * 9 + c] : 0.f;
    float out[4];
    shade(s_uni, p.num_dir, p.num_point, p.num_spot, p.apply_tonemap, attrs, attrs + 3, props, out);
    reinterpret_cast<float4*>(p.rgba)[o] = make_float4(out[0], out[1], out[2], out[3]);
  }
}

template <int PPT>
cudaError_t launch(const Params& p, int ntiles, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(raster_shade_row_kernel<PPT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  raster_shade_row_kernel<PPT><<<ntiles, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int raster_shade_row_launch(
    const void* starts, const void* packed, const void* pair_tri, const void* mat,
    const void* uni, void* code, void* rgba, void* gbuf, int nf, int num_materials,
    int num_uni, int width, int rows, int y_offset, int tile_h, int tile_w, int tiles_x,
    int ntiles, int mat_stride, int num_dir, int num_point, int num_spot, int apply_tonemap,
    void* stream) {
  Params p;
  p.starts = static_cast<const int*>(starts);
  p.packed = static_cast<const float*>(packed);
  p.pair_tri = static_cast<const int*>(pair_tri);
  p.mat = static_cast<const float*>(mat);
  p.uni = static_cast<const float*>(uni);
  p.code = static_cast<int*>(code);
  p.rgba = static_cast<float*>(rgba);
  p.gbuf = static_cast<float*>(gbuf);
  p.nf = nf;
  p.num_materials = num_materials;
  p.num_uni = num_uni;
  p.width = width;
  p.rows = rows;
  p.y_offset = y_offset;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  p.tiles_x = tiles_x;
  p.mat_stride = mat_stride;
  p.num_dir = num_dir;
  p.num_point = num_point;
  p.num_spot = num_spot;
  p.apply_tonemap = apply_tonemap;
  if (nf < kPlane0 + 3 * kNumCh) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)kChunk * kStageFloats + (size_t)num_materials * 9 + num_uni);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npix = tile_h * tile_w;
  if (npix <= kThreads) return (int)launch<1>(p, ntiles, smem, s);
  if (npix <= 2 * kThreads) return (int)launch<2>(p, ntiles, smem, s);
  if (npix <= 4 * kThreads) return (int)launch<4>(p, ntiles, smem, s);
  if (npix <= 8 * kThreads) return (int)launch<8>(p, ntiles, smem, s);
  return (int)cudaErrorInvalidConfiguration;
}

extern "C" const char* raster_shade_row_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
