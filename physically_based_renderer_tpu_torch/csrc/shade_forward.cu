// Shading of a resolved G-buffer band: shade_core per pixel, one thread per
// pixel.
//
// Replaces the TPU kernel
//   physically_based_renderer_tpu/ops/raster_pallas.py::_shade_fwd_kernel
// (shade_forward, the forward of shade_fused): the shading half of the fused
// raster+shade kernel, for paths that resolve their attributes elsewhere (the
// triangle-sharded ring merges G-buffers from every shard, then shades its
// band here). The shader is shade_core.cuh, the one the fused forward
// (raster_shade_row.cu) and the adjoint (shade_backward.cu) run, so the three
// cannot drift. Two template instantiations, the shade mode and the IBL mode.
// Its plain PyTorch version is ops/raster_pallas.py::shade_forward_plain.
//
// Inputs (per pixel p of the rows x W band, row-major):
//   attrs  (npix, S) f32   [pos_w(3), normal_w(3)], row stride S >= 6 (the
//                          first 6 channels of a (rows, W, S) G-buffer)
//   mat_id (npix,) i32     material row; out-of-table ids fetch zeros
//   hit    (npix,) u8      nonzero on covered pixels
//   mat    (M, 9) f32      diffuse rgb, metallic, F0 rgb, roughness, opacity
//   uni    (U,) f32        shading uniforms (shade_core.cuh layout; the IBL
//                          mode's row ends in the 27 SH9 slots)
// Output, zeros at background:
//   out    (npix, 4) f32   (r, g, b, opacity), one float4 store per pixel
//                          (ibl = 0); or the IBL mode's 11 channels as planes
//                          (11, npix), each store coalesced across the warp
//
// What bounds it on an H100: at the 1080p grid, memory and FP32 ALU are
// close. A pixel reads 24 B of attributes, 4 B of id and 1 B of hit and
// writes 16 B (~94 MB a frame, 0.028 ms at 3.35 TB/s); a hit pixel's shade
// with four lights is ~400 FP32 operations (~0.01 ms over the grid's hit
// pixels at 67 TFLOP/s), and background pixels only store zeros. The table
// and the uniforms are staged once per block in shared memory, and each
// block walks a grid stride, so the staging is paid by at most kMaxBlocks
// blocks. The TPU wrapper's padding to 8x128 blocks and 128 lanes is not
// carried over. Built with -fmad=false like the other kernels.

#include <cuda_runtime.h>

#include "shade_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

struct Params {
  const float* attrs;
  const int* mat_id;
  const unsigned char* hit;
  const float* mat;
  const float* uni;
  float* out;
  int npix;
  int attr_stride;
  int num_materials;
  int num_uni;
  int num_dir;
  int num_point;
  int num_spot;
  int apply_tonemap;
};

template <bool kIbl>
__global__ void __launch_bounds__(kThreads) shade_forward_kernel(Params p) {
  extern __shared__ float smem[];
  float* s_mat = smem;
  float* s_uni = s_mat + p.num_materials * 9;
  for (int i = threadIdx.x; i < p.num_materials * 9; i += kThreads) s_mat[i] = p.mat[i];
  for (int i = threadIdx.x; i < p.num_uni; i += kThreads) s_uni[i] = p.uni[i];
  __syncthreads();

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.npix; i += gridDim.x * kThreads) {
    if (!p.hit[i]) {
      if constexpr (kIbl) {
        for (int c = 0; c < shade_core::kIblChannels; ++c) p.out[(size_t)c * p.npix + i] = 0.f;
      } else {
        reinterpret_cast<float4*>(p.out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      continue;
    }
    const float* a = p.attrs + (size_t)i * p.attr_stride;
    float attrs[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) attrs[c] = a[c];
    const int mid = p.mat_id[i];
    const bool in_table = mid >= 0 && mid < p.num_materials;
    float props[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) props[c] = in_table ? s_mat[mid * 9 + c] : 0.f;
    if constexpr (kIbl) {
      float out[shade_core::kIblChannels];
      shade_core::shade<true>(s_uni, p.num_dir, p.num_point, p.num_spot, 0, attrs, attrs + 3, props, out);
      for (int c = 0; c < shade_core::kIblChannels; ++c) p.out[(size_t)c * p.npix + i] = out[c];
    } else {
      float out[4];
      shade_core::shade<false>(s_uni, p.num_dir, p.num_point, p.num_spot, p.apply_tonemap, attrs, attrs + 3,
                               props, out);
      reinterpret_cast<float4*>(p.out)[i] = make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <bool kIbl>
cudaError_t launch(const Params& p, int blocks, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(shade_forward_kernel<kIbl>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  shade_forward_kernel<kIbl><<<blocks, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shade_forward_launch(const void* attrs, const void* mat_id, const void* hit, const void* mat,
                                    const void* uni, void* out, int npix, int attr_stride, int num_materials,
                                    int num_uni, int num_dir, int num_point, int num_spot, int apply_tonemap,
                                    int ibl, void* stream) {
  if (attr_stride < 6 || num_uni < shade_core::kUniLight0 +
                                       shade_core::kUniPerLight * (num_dir + num_point + num_spot) +
                                       (ibl ? 27 : 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (npix <= 0) return (int)cudaSuccess;
  Params p;
  p.attrs = static_cast<const float*>(attrs);
  p.mat_id = static_cast<const int*>(mat_id);
  p.hit = static_cast<const unsigned char*>(hit);
  p.mat = static_cast<const float*>(mat);
  p.uni = static_cast<const float*>(uni);
  p.out = static_cast<float*>(out);
  p.npix = npix;
  p.attr_stride = attr_stride;
  p.num_materials = num_materials;
  p.num_uni = num_uni;
  p.num_dir = num_dir;
  p.num_point = num_point;
  p.num_spot = num_spot;
  p.apply_tonemap = apply_tonemap;
  const int want = (npix + kThreads - 1) / kThreads;
  const int blocks = want < kMaxBlocks ? want : kMaxBlocks;
  const size_t smem = sizeof(float) * ((size_t)num_materials * 9 + num_uni);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(ibl ? launch<true>(p, blocks, smem, s) : launch<false>(p, blocks, smem, s));
}

extern "C" const char* shade_forward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
