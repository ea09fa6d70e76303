// Fused raster + depth resolve + perspective-correct interpolation + material
// fetch + Cook-Torrance shading + tonemap, one CTA per screen tile; the same
// raster writing a G-buffer instead of shading; and the same raster writing
// only the winner's code (and depth) on an exact depth test.
//
// Replaces the TPU kernel
//   physically_based_renderer_tpu/ops/raster_row.py::_raster_tile_shade_row_kernel
// in its shade mode, both with ibl=False and with ibl=True (sh9 given): two
// template instantiations of one body, so the ibl=False code is unchanged by
// the IBL mode; and in its G-buffer mode (shade=False, the body behind
// rasterize_binned_gbuffer_row): a second kernel, raster_gbuffer_row_kernel,
// with the channel count a template parameter (7: C = 6 attributes, 15: the
// textured C = 14, each + 1/w) and an optional z_floor peel. Every mode runs
// one culled depth resolve, resolve_tile_culled.
//
// The G-buffer mode also replaces
//   physically_based_renderer_tpu/ops/raster_pallas.py::_raster_tile_gbuf_kernel
// (kernel 4, the v1 layout behind rasterize_binned_gbuffer: the textured path
// of render). It computes the same function -- the same quantized key, first
// processed wins, the jumbo run first, planes / 1/w, the same peel -- under
// another binning (16x128 tiles, no big2 class), so ops/raster_pallas.py::
// rasterize_binned_gbuffer launches this kernel at 16x128 tiles: the PPT = 8
// instantiation, one CTA per 2048-pixel tile, each warp a 16 x 16 block (at
// the row binning's 8x128 tiles, kernel 2, PPT 4 and 16 x 8 blocks). The TPU
// kernel starts each run
// at a multiple of 128 pairs (it may also evaluate up to 127 pairs before the
// run); that changes a winner only at an exact quantized-depth tie. The shade
// mode also replaces
//   physically_based_renderer_tpu/ops/raster_pallas.py::_raster_tile_shade_kernel
// (kernel 7, rasterize_binned_shade: the v1 fused raster+shade behind
// raster_shade(row_layout=False)): the same key (bits(z) & ~0x7F) with the
// lane as tie-break, so first processed wins, under the v1 binning at 4x128
// tiles, the PPT = 2 instantiation.
//
// The ids mode, raster_ids_kernel, replaces
//   physically_based_renderer_tpu/ops/raster_pallas.py::_raster_tile_kernel
// (kernel 5, rasterize_binned: the depth peels of render_layered and the
// raster of render_wireframe). It runs the shade mode's culled resolve with
// the quantization switched off (resolve_tile_culled<..., kExact = true>):
// the key is the exact f32 depth, compared as an int (z >= 0 there, and -0.0
// is first canonicalised to +0.0). The TPU kernel takes, per 128-pair chunk,
// the exact zmin and the smallest code among the lanes at it, then a strict
// < across chunks; with
// the pairs of a run in ascending triangle id and the jumbo run first, that
// is "the minimum depth wins, a tie goes to the first pair processed", which
// the per-thread strict < computes; the per-warp reject drops only pairs that
// cover none of a warp's pixels, so it changes no winner. It writes the code
// and, optionally, the winner's plane depth (+inf at background), at 16x128
// tiles (PPT = 8, each warp a 16 x 16 block).
//
// The ids mode's dilated variant (kMargin = true) is kernel 5b: the same TPU
// kernel at margin = edge_margin_px > 0, every peel of the soft raster
// (ops/raster_soft.py::peel_layers). Coverage is e_i >= -margin on edges the
// binning packed with unit gradient (raster_bin.py::pack_triangle_fields
// (normalize_edges)), so the margin is in pixels; nothing else bounds it --
// a sliver's dilated wedge reaches as far as the tiles its bbox + margin
// was binned to, exactly as on the TPU. Its per-warp reject moves the
// threshold out by the margin and grows the rounding slack with it
// (warp_mask<true>), and evaluates the edge planes themselves, so it follows
// the wedge. Only the combination the peels use is instantiated: a z floor
// and the depth (the first peel's floor is -inf).
//
// The plain PyTorch versions are ops/raster_row.py::raster_shade_tiles_plain,
// raster_gbuffer_tiles_plain and raster_ids_tiles_plain; they compute exactly what the TPU kernel
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
// The ids mode reads starts, packed (nf >= 16: no planes) and pair_tri, and
// z_floor when given, as the G-buffer mode does. It writes
//   code (rows, W) i32         as above
//   depth (rows, W) f32        optional: the winner's NDC depth plane, +inf at
//                              background
//
// What bounds it on an H100: FP32 issue in the depth resolve, then (the
// shade mode) the shading of each hit pixel; memory traffic is far behind
// (pair records and the image outputs, ~70 MB a 1080p frame). A tile's pair
// records are staged through shared memory in chunks (every thread reads
// the same record, a broadcast), each thread keeps its pixels' best
// (quantized depth, pair) in registers, and only the winner's full record
// is read from global memory, once per pixel, in the epilogue.
//
// Testing every pair of a tile's run against every pixel of the tile (the
// TPU kernel's way) spends nearly all of the resolve on pixels outside the
// pair's triangle: the grid's triangles are a few pixels across, and an
// 8x128 tile has 1024 pixels. So every mode -- shade (kernels 1, 1b, 7, 7b),
// G-buffer (2, 4) and ids (5, 5b) -- runs resolve_tile_culled: each warp
// holds a compact block of the tile (16 x 2*PPT: 16x8 at 8x128 tiles, 16x4
// at 4x128, 16x16 at 16x128) and drops, in a branch uniform across the warp,
// each pair whose triangle provably misses the block: the thread that
// stages a pair evaluates its three edges at each warp block's extreme
// corner (warp_mask, a rounding slack so that a pixel the exact or the
// dilated test covers is never dropped), each warp lists the pairs it keeps
// in order, and only those meet the per-pixel test, which is unchanged.
// What is left to bound the shade mode is the epilogue's shading, which
// each warp runs over its listed hits, and a tail of dense tiles that start
// late; the ids mode's epilogue writes one code and one depth a pixel.
// The G-buffer mode's epilogue forms kCh floats a pixel, which stored one
// at a time at the pixel-major stride (4 kCh bytes) would touch ~kCh times
// the sectors they fill; it stages each slot in shared memory and stores
// whole row segments instead, so it too is left with the tail of dense
// tiles.
//
// Depth semantics of the shade and G-buffer modes (tests pin them): the key
// is (bits(z) & ~0x7F), signed
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
constexpr int kWarps = kThreads / 32;
constexpr float kCullSlack = 0x1p-18f;  // ops/raster_row.py::CULL_SLACK
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
  int compact;   // warp w holds a 16 x 2*PPT block of the tile (else pixel threadIdx + k*kThreads)
  int blocks_x;  // blocks across the tile in the compact map
};

__device__ __forceinline__ float plane(float gx, float dx, float gy, float dy, float gc) {
  // (gx*dx + gy*dy) + gc, each step rounded: the plain version's order.
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, dx), __fmul_rn(gy, dy)), gc);
}

// The tile pixel (lr, lc) of slot k of this warp's lane (ops/raster_row.py::
// warp_pixels): in the compact map warp w holds the 16 x 2*PPT block
// (w mod blocks_x, w div blocks_x) of the tile, lane l its column l mod 16
// and its rows 2k + l div 16; otherwise pixel 32 w + l + k*kThreads. A slot
// past the tile has lr >= tile_h or lc >= tile_w.
template <int PPT>
__device__ __forceinline__ void slot_pixel(int compact, int blocks_x, int tile_w, int k, int lane, int& lr,
                                           int& lc) {
  const int warp = threadIdx.x >> 5;
  if (compact) {
    lc = (warp % blocks_x) * 16 + (lane & 15);
    lr = (warp / blocks_x) * (2 * PPT) + 2 * k + (lane >> 4);
  } else {
    const int pix = warp * 32 + lane + k * kThreads;
    lr = pix / tile_w;
    lc = pix - lr * tile_w;
  }
}

// The pixel centres of this thread's slots, exactly as the plain version
// forms them, and the warp's box of those in the image (exact min / max over
// its lanes; +-inf when it holds none) in s_box[warp].
template <int PPT>
__device__ __forceinline__ void warp_box(int compact, int blocks_x, int tile_h, int tile_w, int rows, int width,
                                         int ty, int tx, float x_base, float y_base, float* px, float* py,
                                         float4* s_box) {
  const int lane = threadIdx.x & 31;
  float4 box = make_float4(__int_as_float(0x7f800000), __int_as_float(0xff800000), __int_as_float(0x7f800000),
                           __int_as_float(0xff800000));
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int lr, lc;
    slot_pixel<PPT>(compact, blocks_x, tile_w, k, lane, lr, lc);
    px[k] = (x_base + (float)lc) + 0.5f;
    py[k] = (y_base + (float)lr) + 0.5f;
    if (lr < tile_h && lc < tile_w && ty * tile_h + lr < rows && tx * tile_w + lc < width) {
      box = make_float4(fminf(box.x, px[k]), fmaxf(box.y, px[k]), fminf(box.z, py[k]), fmaxf(box.w, py[k]));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    box.x = fminf(box.x, __shfl_xor_sync(0xffffffffu, box.x, o));
    box.y = fmaxf(box.y, __shfl_xor_sync(0xffffffffu, box.y, o));
    box.z = fminf(box.z, __shfl_xor_sync(0xffffffffu, box.z, o));
    box.w = fmaxf(box.w, __shfl_xor_sync(0xffffffffu, box.w, o));
  }
  if (lane == 0) s_box[threadIdx.x >> 5] = box;
}

// The per-warp reject (ops/raster_row.py::footprint_rejects, the same float
// arithmetic): bit w of the result is set unless one edge of the pair, at
// the corner of warp w's box of pixel centres where it is largest, is below
// -slack. slack = kCullSlack (|a| DX + |b| DY + |c|) + 1e-30 bounds the
// rounding of that corner value and of every pixel's own plane() (each
// within 4.01 * 2^-24 of the same sum), so a pixel the exact test covers is
// never dropped. r: the pair's staged fields; a NaN never rejects.
//
// kMargin (kernel 5b): a pixel is covered when its rounded edge e >= -m,
// m = margin as a float. With S the sum above, e <= e_corner + 8.02 * 2^-24
// S (both within 4.01 * 2^-24 S of exact values, the exact corner value the
// largest), so a covered pixel has e_corner >= -m - 8.02 * 2^-24 S. The pair
// is dropped when e_corner < -t, t = fl(m + fl(fl(fl(S + m) * 2^-18) +
// 1e-30)). Rounding S + m, the product and the two sums loses at most 4 *
// 2^-24 of each, so t >= (1 - 2^-22) (m + 2^-18 (S + m)) >= m + 63 * 2^-24 S
// + 59 * 2^-24 m: the slack covers the 8.02 * 2^-24 S of the two planes and
// the 2^-24 m that rounding m + slack to a float loses, for any margin (a
// runtime value); margin 0 is the exact test's reject bit for bit. The
// edges are unit-gradient, so a sliver's dilated wedge runs far past its
// box + margin: the reject follows the edge planes, never that box.
template <bool kMargin>
__device__ __forceinline__ unsigned warp_mask(const float* r, const float4* s_box, float margin) {
  unsigned mask = 0;
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    const float4 b = s_box[w];  // x_lo, x_hi, y_lo, y_hi
    if (!(b.x <= b.y)) continue;  // the warp holds no pixel of the image
    const float dxm = fmaxf(fabsf(__fsub_rn(b.x, r[9])), fabsf(__fsub_rn(b.y, r[9])));
    const float dym = fmaxf(fabsf(__fsub_rn(b.z, r[10])), fabsf(__fsub_rn(b.w, r[10])));
    bool keep = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a = r[i], bb = r[3 + i], c = r[6 + i];
      const float e = plane(__fsub_rn(a >= 0.f ? b.y : b.x, r[9]), a, __fsub_rn(bb >= 0.f ? b.w : b.z, r[10]), bb, c);
      const float m = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(a), dxm), __fmul_rn(fabsf(bb), dym)), fabsf(c));
      if constexpr (kMargin) {
        keep = keep && !(e < -__fadd_rn(margin, __fadd_rn(__fmul_rn(__fadd_rn(m, margin), kCullSlack), 1e-30f)));
      } else {
        keep = keep && !(e < -__fadd_rn(__fmul_rn(m, kCullSlack), 1e-30f));
      }
    }
    if (keep) mask |= 1u << w;
  }
  return mask;
}

// The depth resolve of one tile, every mode's: the tile's pair records are
// staged through shared memory (s_pairs, kChunk x kStageFloats floats) in
// chunks, and each thread keeps its PPT pixels' best (key, pair) in
// registers; best_pair[k] is the winning pair of pixel k, -1 where none
// covers it. Whole warps are culled: each chunk is staged one pair a thread,
// which also forms the pair's warp mask (s_mask); each warp then lists the
// chunk's pairs its mask keeps, in order (s_list, ballots), and tests only
// those against its pixels. A dropped (pair, warp) covers none of the warp's
// pixels, so every pixel still meets every pair that can cover it in
// processing order.
// kZFloor: a candidate must also lie strictly behind zf[k]. kExact: the key
// is the exact depth (z + 0 turns -0.0 into +0.0, whose bits would
// otherwise read as the most negative key), not its quantized bits.
// kMargin: coverage is e_i >= -margin (the dilated ids mode), else e_i >= 0.
template <int PPT, bool kZFloor, bool kExact, bool kMargin>
__device__ __forceinline__ void resolve_tile_culled(const int* starts, const float* packed, const int* pair_tri,
                                                    int nf, int tile, float* s_pairs, const float4* s_box,
                                                    unsigned char* s_mask, unsigned char* s_list, const float* px,
                                                    const float* py, const float* zf, int* best_pair,
                                                    float margin) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* list = s_list + warp * kChunk;
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
      __syncthreads();  // the previous chunk has been consumed (and s_box is written)
      if (threadIdx.x < n) {
        const float* f = packed + (size_t)(c0 + threadIdx.x) * nf;
        float rec[kStageFloats];
#pragma unroll
        for (int i = 0; i < 14; ++i) rec[i] = f[i];
        const int tid = pair_tri[c0 + threadIdx.x];
        rec[14] = __int_as_float(tid);
        rec[15] = 0.f;
        float4* dst = reinterpret_cast<float4*>(s_pairs + threadIdx.x * kStageFloats);
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[i] = make_float4(rec[4 * i], rec[4 * i + 1], rec[4 * i + 2], rec[4 * i + 3]);
        s_mask[threadIdx.x] = (unsigned char)(tid >= 0 ? warp_mask<kMargin>(rec, s_box, margin) : 0u);
      }
      __syncthreads();
      int count = 0;  // warp-uniform
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const bool take = j < n && ((s_mask[j] >> warp) & 1u);
        const unsigned bal = __ballot_sync(0xffffffffu, take);
        if (take) list[count + __popc(bal & ((1u << lane) - 1u))] = (unsigned char)j;
        count += __popc(bal);
      }
      __syncwarp();
      for (int i = 0; i < count; ++i) {
        const int j = list[i];
        const float4* rec = reinterpret_cast<const float4*>(s_pairs + j * kStageFloats);
        const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2], r3 = rec[3];
        // r0 = a0 a1 a2 b0 | r1 = b1 b2 c0 c1 | r2 = c2 x0 y0 za | r3 = zb zc tid -
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float dx = __fsub_rn(px[k], r2.y);
          const float dy = __fsub_rn(py[k], r2.z);
          const float e0 = plane(dx, r0.x, dy, r0.w, r1.z);
          const float e1 = plane(dx, r0.y, dy, r1.x, r1.w);
          const float e2 = plane(dx, r0.z, dy, r1.y, r2.x);
          const float z = plane(dx, r2.w, dy, r3.x, r3.y);
          const bool inside = kMargin ? (e0 >= -margin && e1 >= -margin && e2 >= -margin)
                                      : (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f);
          if (inside && z >= 0.f && z <= 1.f && (!kZFloor || z > zf[k])) {
            const int zq = kExact ? __float_as_int(__fadd_rn(z, 0.f)) : (__float_as_int(z) & ~0x7F);
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

// PPT: pixels per thread, tile_h * tile_w <= kThreads * PPT. kIbl: the IBL
// mode. Three blocks an SM in the shade mode up to PPT 4 (at most 80
// registers: 72 there, no spill), two in the IBL mode (its eleven channels
// spill at 80) and at PPT 8.
template <int PPT, bool kIbl>
__global__ void __launch_bounds__(kThreads, (kIbl || PPT >= 8) ? 2 : 3) raster_shade_row_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* s_pairs = reinterpret_cast<float*>(smem4);
  float4* s_box = smem4 + kChunk * kStageFloats / 4;  // (kWarps,): each warp's box of pixel centres
  float* s_mat = reinterpret_cast<float*>(s_box + kWarps);
  float* s_uni = s_mat + p.num_materials * 9;
  unsigned char* s_mask = reinterpret_cast<unsigned char*>(s_uni + p.num_uni);  // (kChunk,)
  unsigned char* s_list = s_mask + kChunk;                                     // (kWarps, kChunk)

  const int tile = blockIdx.x;
  const int ty = tile / p.tiles_x;
  const int tx = tile - ty * p.tiles_x;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < p.num_materials * 9; i += kThreads) s_mat[i] = p.mat[i];
  for (int i = threadIdx.x; i < p.num_uni; i += kThreads) s_uni[i] = p.uni[i];

  const float x_base = (float)(tx * p.tile_w);
  const float y_base = (float)(ty * p.tile_h + p.y_offset);
  float px[PPT], py[PPT];
  int best_pair[PPT];
  warp_box<PPT>(p.compact, p.blocks_x, p.tile_h, p.tile_w, p.rows, p.width, ty, tx, x_base, y_base, px, py, s_box);

  resolve_tile_culled<PPT, false, false, false>(p.starts, p.packed, p.pair_tri, p.nf, tile, s_pairs, s_box, s_mask,
                                                s_list, px, py, nullptr, best_pair, 0.f);
  __syncthreads();  // s_mat / s_uni visible even when both runs are empty

  // Epilogue. Each lane writes its own background pixels; the warp lists its
  // hit slots with their winners (s_hits, over the staged pairs, which the
  // barrier above has freed) and shades them 32 at a time, so that no lane
  // idles through a shade that another lane of its warp runs. Then winner
  // fields by index (exact), interpolation, shading.
  const size_t img_pix = (size_t)p.rows * p.width;  // one channel plane
  int2* hits = reinterpret_cast<int2*>(s_pairs) + (threadIdx.x >> 5) * 32 * PPT;
  int num_hits = 0;  // warp-uniform
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int lr, lc;
    slot_pixel<PPT>(p.compact, p.blocks_x, p.tile_w, k, lane, lr, lc);
    const int row = ty * p.tile_h + lr;
    const int col = tx * p.tile_w + lc;
    const bool in_image = lr < p.tile_h && lc < p.tile_w && row < p.rows && col < p.width;
    const bool hit = in_image && best_pair[k] >= 0;
    if (in_image && !hit) {
      const size_t o = (size_t)row * p.width + col;
      p.code[o] = -1;
      if constexpr (kIbl) {
        for (int c = 0; c < shade_core::kIblChannels; ++c) p.rgba[c * img_pix + o] = 0.f;
      } else {
        reinterpret_cast<float4*>(p.rgba)[o] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (p.gbuf) {
        for (int c = 0; c < kNumCh; ++c) p.gbuf[o * kNumCh + c] = 0.f;
      }
    }
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (hit) hits[num_hits + __popc(bal & ((1u << lane) - 1u))] = make_int2(k * 32 + lane, best_pair[k]);
    num_hits += __popc(bal);
  }
  __syncwarp();
  for (int i = lane; i < num_hits; i += 32) {
    const int2 h = hits[i];
    int lr, lc;
    slot_pixel<PPT>(p.compact, p.blocks_x, p.tile_w, h.x >> 5, h.x & 31, lr, lc);
    const size_t o = (size_t)(ty * p.tile_h + lr) * p.width + tx * p.tile_w + lc;
    const float pxk = (x_base + (float)lc) + 0.5f;  // as the resolve formed it
    const float pyk = (y_base + (float)lr) + 0.5f;
    const int bp = h.y;
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

    const float dxp = __fsub_rn(pxk, f[9]);
    const float dyp = __fsub_rn(pyk, f[10]);
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
cudaError_t launch(Params p, int ntiles, size_t smem, cudaStream_t stream) {
  p.blocks_x = (p.tile_w + 15) / 16;
  p.compact = p.blocks_x * ((p.tile_h + 2 * PPT - 1) / (2 * PPT)) <= kWarps;
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
  int compact;  // as Params::compact
  int blocks_x;
};

// Stores slot k of this warp's 32 pixels (pixel l's kCh channels at
// stage[l * kCh]) into the pixel-major G-buffer, consecutive lanes on
// consecutive floats, so that each store instruction fills the sectors it
// touches. In the compact map the slot is two 16-pixel row segments, each
// 16 kCh floats contiguous in the G-buffer: float4 stores where a segment is
// whole and 16-byte aligned. Otherwise (a partial segment, the strided map)
// each float goes to its pixel's channel, skipping pixels past the image.
template <int PPT, int kCh>
__device__ __forceinline__ void store_slot(const GbufParams& p, const float* stage, int k, int ty, int tx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (p.compact) {
    const int bcol = (warp % p.blocks_x) * 16;
    const int col0 = tx * p.tile_w + bcol;
    const int ncols = min(16, min(p.tile_w - bcol, p.width - col0));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = (warp / p.blocks_x) * (2 * PPT) + 2 * k + half;
      const int row = ty * p.tile_h + lr;
      if (lr >= p.tile_h || row >= p.rows || ncols <= 0) continue;
      const size_t off = ((size_t)row * p.width + col0) * kCh;
      const float* src = stage + half * 16 * kCh;
      if (ncols == 16 && (off & 3) == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* g4 = reinterpret_cast<float4*>(p.gbuf + off);
        for (int i = lane; i < 4 * kCh; i += 32) g4[i] = s4[i];
      } else {
        for (int i = lane; i < ncols * kCh; i += 32) p.gbuf[off + i] = src[i];
      }
    }
    return;
  }
  for (int q = lane; q < 32 * kCh; q += 32) {
    const int l = q / kCh;
    int lr, lc;
    slot_pixel<PPT>(0, p.blocks_x, p.tile_w, k, l, lr, lc);
    const int row = ty * p.tile_h + lr;
    const int col = tx * p.tile_w + lc;
    if (lr < p.tile_h && row < p.rows && col < p.width) {
      p.gbuf[((size_t)row * p.width + col) * kCh + (q - l * kCh)] = stage[q];
    }
  }
}

// The G-buffer mode. PPT as above; kCh: interpolated channels, C + 1. The
// culled resolve of the shade mode on the same pixel map, with the same
// quantized key and a z floor (-inf where none is given, so that z > zf is
// no test). Each slot's winner's planes and NDC depth go to the pixel-major
// G-buffer through the warp's stage (store_slot). Two blocks an SM at PPT 8
// (at most 128 registers).
template <int PPT, int kCh>
__global__ void __launch_bounds__(kThreads, PPT >= 8 ? 2 : 1) raster_gbuffer_row_kernel(GbufParams p) {
  static_assert(kWarps * 32 * kCh <= kChunk * kStageFloats, "each warp's stage lies in s_pairs");
  __shared__ float4 s_pairs4[kChunk * kStageFloats / 4];
  __shared__ float4 s_box[kWarps];                   // each warp's box of pixel centres
  __shared__ unsigned char s_mask[kChunk];           // each staged pair's warp mask
  __shared__ unsigned char s_list[kWarps * kChunk];  // each warp's kept pairs
  float* s_pairs = reinterpret_cast<float*>(s_pairs4);

  const int tile = blockIdx.x;
  const int ty = tile / p.tiles_x;
  const int tx = tile - ty * p.tiles_x;
  const int lane = threadIdx.x & 31;

  const float x_base = (float)(tx * p.tile_w);
  const float y_base = (float)(ty * p.tile_h + p.y_offset);
  float px[PPT], py[PPT], zf[PPT];
  int best_pair[PPT];
  warp_box<PPT>(p.compact, p.blocks_x, p.tile_h, p.tile_w, p.rows, p.width, ty, tx, x_base, y_base, px, py, s_box);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    zf[k] = __int_as_float((int)0xff800000);  // -inf: no floor
    if (p.z_floor != nullptr) {
      int lr, lc;
      slot_pixel<PPT>(p.compact, p.blocks_x, p.tile_w, k, lane, lr, lc);
      const int row = ty * p.tile_h + lr;
      const int col = tx * p.tile_w + lc;
      if (lr < p.tile_h && lc < p.tile_w && row < p.rows && col < p.width) {
        zf[k] = p.z_floor[(size_t)row * p.width + col];
      }
    }
  }

  resolve_tile_culled<PPT, true, false, false>(p.starts, p.packed, p.pair_tri, p.nf, tile, s_pairs, s_box, s_mask,
                                               s_list, px, py, zf, best_pair, 0.f);

  // Epilogue, a slot at a time: each lane forms its pixel's kCh channels
  // (zeros at background) in the warp's stage, over the staged pairs, which
  // the barrier frees; then the warp stores the slot's 32 pixels from there
  // (store_slot), consecutive lanes on consecutive floats.
  __syncthreads();  // every warp is past the resolve
  float* stage = s_pairs + (threadIdx.x >> 5) * 32 * kCh;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int lr, lc;
    slot_pixel<PPT>(p.compact, p.blocks_x, p.tile_w, k, lane, lr, lc);
    const int row = ty * p.tile_h + lr;
    const int col = tx * p.tile_w + lc;
    const bool in_image = lr < p.tile_h && lc < p.tile_w && row < p.rows && col < p.width;
    float* st = stage + lane * kCh;
    const int bp = in_image ? best_pair[k] : -1;
    if (bp < 0) {
      if (in_image) p.code[(size_t)row * p.width + col] = -1;
#pragma unroll
      for (int c = 0; c < kCh; ++c) st[c] = 0.f;
    } else {
      const float* f = p.packed + (size_t)bp * p.nf;
      const int tid = p.pair_tri[bp];
      p.code[(size_t)row * p.width + col] = p.mat_stride > 1 ? tid * p.mat_stride + (int)f[kFieldMaterial] : tid;
      const float dxp = __fsub_rn(px[k], f[9]);
      const float dyp = __fsub_rn(py[k], f[10]);
      const float invw = plane(f[kPlane0 + kCh - 1], dxp, f[kPlane0 + 2 * kCh - 1], dyp, f[kPlane0 + 3 * kCh - 1]);
      const float den = fabsf(invw) > 1e-20f ? invw : 1.f;
#pragma unroll
      for (int c = 0; c < kCh - 1; ++c) {
        st[c] = __fdiv_rn(plane(f[kPlane0 + c], dxp, f[kPlane0 + kCh + c], dyp, f[kPlane0 + 2 * kCh + c]), den);
      }
      st[kCh - 1] = plane(f[11], dxp, f[12], dyp, f[13]);  // NDC depth, not 1/w
    }
    __syncwarp();
    store_slot<PPT, kCh>(p, stage, k, ty, tx);
    __syncwarp();  // the stage is read before the next slot writes it
  }
}

template <int PPT, int kCh>
cudaError_t launch_gbuffer_ppt(GbufParams p, int ntiles, cudaStream_t s) {
  p.blocks_x = (p.tile_w + 15) / 16;
  p.compact = p.blocks_x * ((p.tile_h + 2 * PPT - 1) / (2 * PPT)) <= kWarps;
  raster_gbuffer_row_kernel<PPT, kCh><<<ntiles, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <int kCh>
cudaError_t launch_gbuffer(const GbufParams& p, int ntiles, cudaStream_t s) {
  const int npix = p.tile_h * p.tile_w;
  if (npix <= kThreads) return launch_gbuffer_ppt<1, kCh>(p, ntiles, s);
  if (npix <= 2 * kThreads) return launch_gbuffer_ppt<2, kCh>(p, ntiles, s);
  if (npix <= 4 * kThreads) return launch_gbuffer_ppt<4, kCh>(p, ntiles, s);
  if (npix <= 8 * kThreads) return launch_gbuffer_ppt<8, kCh>(p, ntiles, s);
  return cudaErrorInvalidConfiguration;
}

struct IdsParams {
  const int* starts;
  const float* packed;
  const int* pair_tri;
  const float* z_floor;  // may be null
  int* code;
  float* depth;  // may be null
  int nf;
  int width;
  int rows;
  int y_offset;
  int tile_h;
  int tile_w;
  int tiles_x;
  int mat_stride;
  float margin;  // the dilated mode's edge margin in pixels (kMargin)
  int compact;   // as Params::compact: warp w holds a 16 x 2*PPT block (16 x 16 at PPT 8)
  int blocks_x;
};

// The ids mode. PPT as above; kZFloor: read z_floor; kDepth: write depth;
// kMargin: the dilated edge test (kernel 5b). The culled resolve of the
// shade mode on the same pixel map, with the exact-depth key.
template <int PPT, bool kZFloor, bool kDepth, bool kMargin = false>
__global__ void __launch_bounds__(kThreads) raster_ids_kernel(IdsParams p) {
  __shared__ float4 s_pairs4[kChunk * kStageFloats / 4];
  __shared__ float4 s_box[kWarps];                   // each warp's box of pixel centres
  __shared__ unsigned char s_mask[kChunk];           // each staged pair's warp mask
  __shared__ unsigned char s_list[kWarps * kChunk];  // each warp's kept pairs
  float* s_pairs = reinterpret_cast<float*>(s_pairs4);

  const int tile = blockIdx.x;
  const int ty = tile / p.tiles_x;
  const int tx = tile - ty * p.tiles_x;
  const int lane = threadIdx.x & 31;

  const float x_base = (float)(tx * p.tile_w);
  const float y_base = (float)(ty * p.tile_h + p.y_offset);
  float px[PPT], py[PPT], zf[PPT];
  int best_pair[PPT];
  warp_box<PPT>(p.compact, p.blocks_x, p.tile_h, p.tile_w, p.rows, p.width, ty, tx, x_base, y_base, px, py, s_box);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    zf[k] = __int_as_float((int)0xff800000);  // -inf: no floor
    if constexpr (kZFloor) {
      int lr, lc;
      slot_pixel<PPT>(p.compact, p.blocks_x, p.tile_w, k, lane, lr, lc);
      const int row = ty * p.tile_h + lr;
      const int col = tx * p.tile_w + lc;
      if (lr < p.tile_h && lc < p.tile_w && row < p.rows && col < p.width) {
        zf[k] = p.z_floor[(size_t)row * p.width + col];
      }
    }
  }

  resolve_tile_culled<PPT, kZFloor, true, kMargin>(p.starts, p.packed, p.pair_tri, p.nf, tile, s_pairs, s_box,
                                                   s_mask, s_list, px, py, zf, best_pair, p.margin);

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int lr, lc;
    slot_pixel<PPT>(p.compact, p.blocks_x, p.tile_w, k, lane, lr, lc);
    const int row = ty * p.tile_h + lr;
    const int col = tx * p.tile_w + lc;
    if (lr >= p.tile_h || lc >= p.tile_w || row >= p.rows || col >= p.width) continue;
    const size_t o = (size_t)row * p.width + col;
    const int bp = best_pair[k];
    if (bp < 0) {
      p.code[o] = -1;
      if constexpr (kDepth) p.depth[o] = __int_as_float(0x7f800000);  // +inf
      continue;
    }
    const float* f = p.packed + (size_t)bp * p.nf;
    const int tid = p.pair_tri[bp];
    p.code[o] = p.mat_stride > 1 ? tid * p.mat_stride + (int)f[kFieldMaterial] : tid;
    if constexpr (kDepth) {
      // the resolve's depth plane, in its order: the key's exact value
      p.depth[o] = plane(f[11], __fsub_rn(px[k], f[9]), f[12], __fsub_rn(py[k], f[10]), f[13]);
    }
  }
}

// One instantiation per variant, PPT = 8: tiles of up to 2048 pixels (the
// v1 binning's 16x128, where each warp holds a 16 x 16 block; a smaller tile
// leaves slots idle).
template <bool kZFloor, bool kDepth, bool kMargin = false>
cudaError_t launch_ids(IdsParams p, int ntiles, cudaStream_t s) {
  if (p.tile_h * p.tile_w > 8 * kThreads) return cudaErrorInvalidConfiguration;
  p.blocks_x = (p.tile_w + 15) / 16;
  p.compact = p.blocks_x * ((p.tile_h + 15) / 16) <= kWarps;
  raster_ids_kernel<8, kZFloor, kDepth, kMargin><<<ntiles, kThreads, 0, s>>>(p);
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
  const size_t smem = sizeof(float) * ((size_t)kChunk * kStageFloats + 4 * kWarps + (size_t)num_materials * 9 +
                                       num_uni) +
                      (size_t)kChunk * (1 + kWarps);
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

extern "C" int raster_ids_launch(const void* starts, const void* packed, const void* pair_tri,
                                 const void* z_floor, void* code, void* depth, int nf, int width, int rows,
                                 int y_offset, int tile_h, int tile_w, int tiles_x, int ntiles, int mat_stride,
                                 float margin, void* stream) {
  if (nf < kStageFloats) return (int)cudaErrorInvalidValue;
  // The dilated mode is built for the soft raster's peels only: z floor and depth.
  if (margin > 0.f && (z_floor == nullptr || depth == nullptr)) return (int)cudaErrorInvalidValue;
  IdsParams p;
  p.starts = static_cast<const int*>(starts);
  p.packed = static_cast<const float*>(packed);
  p.pair_tri = static_cast<const int*>(pair_tri);
  p.z_floor = static_cast<const float*>(z_floor);
  p.code = static_cast<int*>(code);
  p.depth = static_cast<float*>(depth);
  p.nf = nf;
  p.width = width;
  p.rows = rows;
  p.y_offset = y_offset;
  p.tile_h = tile_h;
  p.tile_w = tile_w;
  p.tiles_x = tiles_x;
  p.mat_stride = mat_stride;
  p.margin = margin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (margin > 0.f) return (int)launch_ids<true, true, true>(p, ntiles, s);
  if (z_floor != nullptr) {
    return (int)(depth != nullptr ? launch_ids<true, true>(p, ntiles, s) : launch_ids<true, false>(p, ntiles, s));
  }
  return (int)(depth != nullptr ? launch_ids<false, true>(p, ntiles, s) : launch_ids<false, false>(p, ntiles, s));
}

extern "C" const char* raster_shade_row_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
