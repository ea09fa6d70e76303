// Fused raster + depth resolve + perspective-correct interpolation + material
// fetch + Cook-Torrance shading + tonemap, one CTA per screen tile; and the
// same raster writing a G-buffer instead of shading.
//
// Replaces the TPU kernel
//   physically_based_renderer_tpu/ops/raster_row.py::_raster_tile_shade_row_kernel
// in its shade mode, both with ibl=False and with ibl=True (sh9 given): two
// template instantiations of one body, so the ibl=False code is unchanged by
// the IBL mode; and in its G-buffer mode (shade=False, the body behind
// rasterize_binned_gbuffer_row): a second kernel, raster_gbuffer_row_kernel,
// with the channel count a template parameter (7: C = 6 attributes, 15: the
// textured C = 14, each + 1/w) and an optional z_floor peel. Both kernels run
// one depth resolve, resolve_tile, inlined into each.
//
// The G-buffer mode also replaces
//   physically_based_renderer_tpu/ops/raster_pallas.py::_raster_tile_gbuf_kernel
// (kernel 4, the v1 layout behind rasterize_binned_gbuffer: the textured path
// of render). It computes the same function -- the same quantized key, first
// processed wins, the jumbo run first, planes / 1/w, the same peel -- under
// another binning (16x128 tiles, no big2 class), so ops/raster_pallas.py::
// rasterize_binned_gbuffer launches this kernel at 16x128 tiles: the PPT = 8
// instantiation, one CTA per 2048-pixel tile. The TPU kernel starts each run
// at a multiple of 128 pairs (it may also evaluate up to 127 pairs before the
// run); that changes a winner only at an exact quantized-depth tie. The plain PyTorch
// versions are ops/raster_row.py::raster_shade_tiles_plain and
// raster_gbuffer_tiles_plain; they compute exactly what the TPU kernel
// computes, not its blocks. The shader is shade_core.cuh, shared with the
// adjoint kernel shade_backward.cu and the G-buffer shader shade_forward.cu.
//
// Inputs (built by ops/raster_bin.py::bin_triangles, pair-major):
//   starts   (ntiles+1,) i32   tile i owns pairs [starts[i], starts[i+1]);
//                              [0, starts[0]) is the jumbo run every tile reads
//   packed   (PAIRS, nf) f32   per-pair fields: 0-8 edge coefficients, 9-10
//                              corner 0, 11-13 depth plane, 14 material, then
//                              three NUM_CH-wide interpolation plane blocks at 16
//   pair_tri (PAIRS,) i32      triangle id of each pair
//   mat      (M, 9) f32        diffuse rgb, metallic, F0 rgb, roughness, opacity
//   uni      (U,) f32          shading uniforms (ops/shade_core.py layout; the
//                              IBL mode's row ends in the 27 SH9 slots)
// Outputs, written directly in image layout (no tile-major scratch):
//   code (rows, W) i32         tid*mat_stride + mat (tid when mat_stride == 1), -1 bg
//   rgba (rows, W, 4) f32      shaded foreground, 0 at background: one float4 store
//                              per pixel (ibl=False)
//   chan (11, rows, W) f32     the IBL mode's channels (hdr rgb, sf rgb, reflect
//                              xyz, roughness, opacity), 0 at background, as
//                              planes: eleven 4-byte stores per pixel, each
//                              coalesced across the warp's consecutive pixels
//                              (a pixel-major (rows, W, 11) row is 44 bytes,
//                              which no vector store covers)
//   gbuf (rows, W, 7) f32      optional: 6 attributes + NDC depth, 0 at background
// The G-buffer mode reads starts, packed (nf >= 16 + 3 num_ch) and pair_tri,
// and z_floor (rows, W) f32 when given: a candidate counts only when its z >
// z_floor at the pixel (a depth peel; -inf where no floor). It writes
//   code (rows, W) i32         as above
//   gbuf (rows, W, num_ch) f32 num_ch - 1 attributes, then the NDC depth plane,
//                              0 at background. No material table, no uniforms.
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

#include "shade_core.cuh"

namespace {

constexpr int kThreads = 256;     // threads per CTA
constexpr int kChunk = 256;       // pair records per shared-memory stage
constexpr int kStageFloats = 16;  // 14 raster fields, triangle id bits, pad
constexpr int kNumCh = 7;         // interpolated channels: pos, normal, 1/w
constexpr int kFieldMaterial = 14;
constexpr int kPlane0 = 16;

struct Params {
  const int* starts;
  const float* packed;
  const int* pair_tri;
  const float* mat;
  const float* uni;
  int* code;
  float* rgba;  // the IBL mode's channel planes
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

// The depth resolve of one tile, both kernels: the tile's pair records are
// staged through shared memory (s_pairs, kChunk x kStageFloats floats) in
// chunks, and each thread keeps its PPT pixels' best (quantized depth, pair)
// in registers. best_pair[k] is the winning pair of pixel k, -1 where none
// covers it. kZFloor: a candidate must also lie strictly behind zf[k].
template <int PPT, bool kZFloor>
__device__ __forceinline__ void resolve_tile(const int* starts, const float* packed, const int* pair_tri,
                                             int nf, int tile, float* s_pairs, const float* px,
                                             const float* py, const float* zf, int* best_pair) {
  int best_zq[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    best_zq[k] = 0x7FFFFFFF;
    best_pair[k] = -1;
  }
  const int g_end = starts[0];
  const int runs[2][2] = {{0, g_end}, {starts[tile], starts[tile + 1]}};
  for (int r = 0; r < 2; ++r) {
    for (int c0 = runs[r][0]; c0 < runs[r][1]; c0 += kChunk) {
      const int n = min(kChunk, runs[r][1] - c0);
      __syncthreads();  // the previous chunk has been consumed
      for (int i = threadIdx.x; i < n * kStageFloats; i += kThreads) {
        const int q = i / kStageFloats;
        const int f = i - q * kStageFloats;
        float val = 0.f;
        if (f < 14) {
          val = packed[(size_t)(c0 + q) * nf + f];
        } else if (f == 14) {
          val = __int_as_float(pair_tri[c0 + q]);
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
          if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && z >= 0.f && z <= 1.f && (!kZFloor || z > zf[k])) {
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
}

// PPT: pixels per thread, tile_h * tile_w <= kThreads * PPT. kIbl: the IBL mode.
template <int PPT, bool kIbl>
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
  int best_pair[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    px[k] = (x_base + (float)(pix % p.tile_w)) + 0.5f;
    py[k] = (y_base + (float)(pix / p.tile_w)) + 0.5f;
  }

  resolve_tile<PPT, false>(p.starts, p.packed, p.pair_tri, p.nf, tile, s_pairs, px, py, nullptr, best_pair);
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
    const size_t img_pix = (size_t)p.rows * p.width;  // one channel plane
    const int bp = best_pair[k];
    if (bp < 0) {
      p.code[o] = -1;
      if constexpr (kIbl) {
        for (int c = 0; c < shade_core::kIblChannels; ++c) p.rgba[c * img_pix + o] = 0.f;
      } else {
        reinterpret_cast<float4*>(p.rgba)[o] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
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
    if constexpr (kIbl) {
      float out[shade_core::kIblChannels];
      shade_core::shade<true>(s_uni, p.num_dir, p.num_point, p.num_spot, 0, attrs, attrs + 3, props, out);
      for (int c = 0; c < shade_core::kIblChannels; ++c) p.rgba[c * img_pix + o] = out[c];
    } else {
      float out[4];
      shade_core::shade<false>(s_uni, p.num_dir, p.num_point, p.num_spot, p.apply_tonemap, attrs, attrs + 3,
                               props, out);
      reinterpret_cast<float4*>(p.rgba)[o] = make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <int PPT, bool kIbl>
cudaError_t launch(const Params& p, int ntiles, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(raster_shade_row_kernel<PPT, kIbl>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  raster_shade_row_kernel<PPT, kIbl><<<ntiles, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kIbl>
cudaError_t launch_tiles(const Params& p, int ntiles, size_t smem, cudaStream_t s) {
  const int npix = p.tile_h * p.tile_w;
  if (npix <= kThreads) return launch<1, kIbl>(p, ntiles, smem, s);
  if (npix <= 2 * kThreads) return launch<2, kIbl>(p, ntiles, smem, s);
  if (npix <= 4 * kThreads) return launch<4, kIbl>(p, ntiles, smem, s);
  if (npix <= 8 * kThreads) return launch<8, kIbl>(p, ntiles, smem, s);
  return cudaErrorInvalidConfiguration;
}

struct GbufParams {
  const int* starts;
  const float* packed;
  const int* pair_tri;
  const float* z_floor;  // may be null
  int* code;
  float* gbuf;
  int nf;
  int width;
  int rows;
  int y_offset;
  int tile_h;
  int tile_w;
  int tiles_x;
  int mat_stride;
};

// The G-buffer mode. PPT as above; kCh: interpolated channels, C + 1.
template <int PPT, int kCh>
__global__ void __launch_bounds__(kThreads) raster_gbuffer_row_kernel(GbufParams p) {
  __shared__ float4 s_pairs4[kChunk * kStageFloats / 4];
  float* s_pairs = reinterpret_cast<float*>(s_pairs4);

  const int tile = blockIdx.x;
  const int ty = tile / p.tiles_x;
  const int tx = tile - ty * p.tiles_x;
  const int npix = p.tile_h * p.tile_w;

  const float x_base = (float)(tx * p.tile_w);
  const float y_base = (float)(ty * p.tile_h + p.y_offset);
  float px[PPT], py[PPT], zf[PPT];
  int best_pair[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    px[k] = (x_base + (float)(pix % p.tile_w)) + 0.5f;
    py[k] = (y_base + (float)(pix / p.tile_w)) + 0.5f;
    const int row = ty * p.tile_h + pix / p.tile_w;
    const int col = tx * p.tile_w + pix % p.tile_w;
    const bool in_band = pix < npix && row < p.rows && col < p.width;
    zf[k] = (p.z_floor != nullptr && in_band) ? p.z_floor[(size_t)row * p.width + col]
                                              : __int_as_float((int)0xff800000);  // -inf: no floor
  }

  resolve_tile<PPT, true>(p.starts, p.packed, p.pair_tri, p.nf, tile, s_pairs, px, py, zf, best_pair);

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    if (pix >= npix) continue;
    const int row = ty * p.tile_h + pix / p.tile_w;
    const int col = tx * p.tile_w + pix % p.tile_w;
    if (row >= p.rows || col >= p.width) continue;
    const size_t o = (size_t)row * p.width + col;
    float* g = p.gbuf + o * kCh;
    const int bp = best_pair[k];
    if (bp < 0) {
      p.code[o] = -1;
#pragma unroll
      for (int c = 0; c < kCh; ++c) g[c] = 0.f;
      continue;
    }
    const float* f = p.packed + (size_t)bp * p.nf;
    const int tid = p.pair_tri[bp];
    p.code[o] = p.mat_stride > 1 ? tid * p.mat_stride + (int)f[kFieldMaterial] : tid;
    const float dxp = __fsub_rn(px[k], f[9]);
    const float dyp = __fsub_rn(py[k], f[10]);
    const float invw = plane(f[kPlane0 + kCh - 1], dxp, f[kPlane0 + 2 * kCh - 1], dyp, f[kPlane0 + 3 * kCh - 1]);
    const float den = fabsf(invw) > 1e-20f ? invw : 1.f;
#pragma unroll
    for (int c = 0; c < kCh - 1; ++c) {
      g[c] = __fdiv_rn(plane(f[kPlane0 + c], dxp, f[kPlane0 + kCh + c], dyp, f[kPlane0 + 2 * kCh + c]), den);
    }
    g[kCh - 1] = plane(f[11], dxp, f[12], dyp, f[13]);  // NDC depth, not 1/w
  }
}

template <int kCh>
cudaError_t launch_gbuffer(const GbufParams& p, int ntiles, cudaStream_t s) {
  const int npix = p.tile_h * p.tile_w;
  if (npix <= kThreads) {
    raster_gbuffer_row_kernel<1, kCh><<<ntiles, kThreads, 0, s>>>(p);
  } else if (npix <= 2 * kThreads) {
    raster_gbuffer_row_kernel<2, kCh><<<ntiles, kThreads, 0, s>>>(p);
  } else if (npix <= 4 * kThreads) {
    raster_gbuffer_row_kernel<4, kCh><<<ntiles, kThreads, 0, s>>>(p);
  } else if (npix <= 8 * kThreads) {
    raster_gbuffer_row_kernel<8, kCh><<<ntiles, kThreads, 0, s>>>(p);
  } else {
    return cudaErrorInvalidConfiguration;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int raster_shade_row_launch(
    const void* starts, const void* packed, const void* pair_tri, const void* mat,
    const void* uni, void* code, void* rgba, void* gbuf, int nf, int num_materials,
    int num_uni, int width, int rows, int y_offset, int tile_h, int tile_w, int tiles_x,
    int ntiles, int mat_stride, int num_dir, int num_point, int num_spot, int apply_tonemap,
    int ibl, void* stream) {
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
  const int num_lights = num_dir + num_point + num_spot;
  if (nf < kPlane0 + 3 * kNumCh ||
      num_uni < shade_core::kUniLight0 + shade_core::kUniPerLight * num_lights + (ibl ? 27 : 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * ((size_t)kChunk * kStageFloats + (size_t)num_materials * 9 + num_uni);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ibl ? launch_tiles<true>(p, ntiles, smem, s) : launch_tiles<false>(p, ntiles, smem, s));
}

extern "C" int raster_gbuffer_row_launch(const void* starts, const void* packed, const void* pair_tri,
                                         const void* z_floor, void* code, void* gbuf, int nf, int num_ch,
                                         int width, int rows, int y_offset, int tile_h, int tile_w,
                                         int tiles_x, int ntiles, int mat_stride, void* stream) {
  if (nf < kPlane0 + 3 * num_ch) return (int)cudaErrorInvalidValue;
  GbufParams p;
  p.starts = static_cast<const int*>(starts);
  p.packed = static_cast<const float*>(packed);
  p.pair_tri = static_cast<const int*>(pair_tri);
  p.z_floor = static_cast<const float*>(z_floor);
  p.code = static_cast<int*>(code);
  p.gbuf = static_cast<float*>(gbuf);
  p.nf = nf;
  p.width = width;
  p.rows = rows;
  p.y_offset = y_offset;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  p.tiles_x = tiles_x;
  p.mat_stride = mat_stride;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_ch == 7) return (int)launch_gbuffer<7>(p, ntiles, s);
  if (num_ch == 15) return (int)launch_gbuffer<15>(p, ntiles, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* raster_shade_row_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
