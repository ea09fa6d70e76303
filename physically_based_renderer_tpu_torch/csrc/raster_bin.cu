// Triangle setup and binning as three hand-written kernels around one
// torch.sort of the pair keys: the CUDA path of ops/raster_bin.py
// (bin_clip_cuda, bin_triangles_cuda). Plain PyTorch versions:
// ops/raster_row.py::bin_for_shade_plain (clip coordinates, corner-major or
// indexed, with the [attrs·1/w, 1/w] corner channels) and
// ops/raster_bin.py::bin_triangles_plain (a ScreenTris).
//
// Replaces no TPU kernel: the JAX package writes the setup and the binning
// as jnp code (physically_based_renderer_tpu/ops/raster.py::setup_corners,
// ops/raster_bin.py::bin_triangles) and leaves them to XLA, which fuses them
// into a few loops around one sort. Eager PyTorch ran the same code as ~200
// launches a call and four host syncs (the index lists of
// ops/raster._edge_coeffs), so at 1080p the binning idled the card for
// 5.4-6.8 ms a frame whatever the triangle count. These kernels stand in for
// XLA: no host sync, no host-to-device copy, no shape that depends on data.
//
//   1. bin_setup_kernel, one thread a triangle: the projection (or the
//      screen setup as given), the signed area and validity, the whole
//      pack_triangle_fields row (edges, depth plane, material, the
//      corner-channel planes, zero padding), the tile bbox and the emission
//      class (small2, big, big2, jumbo). Each block's 128 rows are staged in
//      shared memory and written out as one contiguous run. Per block it
//      counts the big and big2 members, and it fills the dense key blocks
//      with sentinel keys.
//   2. bin_keys_kernel, one thread a triangle: the rank of each big / big2
//      member by id (the counts of the blocks before it plus a ballot scan
//      in the block), so that ranked()'s cap spills the members past it to
//      the jumbo run; then the k0 and k1 keys and the member's dense slots,
//      and the pair total (block sums, integer atomics: the same every run).
//   3. torch.sort of the keys, in the wrapper. Real keys are unique and the
//      sentinels decode alike, so any correct sort gives the plain version's
//      bits.
//   4. bin_pack_kernel, one thread a (pair slot, 16-byte column): decodes
//      pair_tri (-1 past the tiles), writes starts where the tile changes
//      between neighbours (searchsorted's array, empty tiles and the jumbo
//      run included), gathers the fields row (row 0 for -1 pairs) and pads
//      the chunk tail; its first thread writes num_pairs and overflowed.
//
// Numerics: every float is the plain version's on the card, bit for bit,
// NaN payloads aside. The operations and their order are the eager ops'
// (no FMA: built with -fmad=false); a divide by a Python number is a
// multiply by its float reciprocal, as PyTorch's CUDA division by a scalar
// is; 1/x is IEEE; rsqrtf is torch.rsqrt's; a NaN bbox coordinate maps to
// tile 0 as _tile_index's clamp-then-nan_to_num does; torch.sign(NaN) is 0.
//
// What bounds it on an H100: bytes, and at small T the launches. At
// pbr_scene's 230,144 triangles (C = 14, 64 fields a row) the fields table
// and the packed gather are ~59 MB each and the keys ~2.8 MB, about 0.04 ms
// at 3.35 TB/s; the sort of ~690k keys is the rest.

#include <cuda_runtime.h>

// Field by field as ops/raster_bin.py's _BinArgs (outside the unnamed
// namespace: the exported entries take it).
struct BinArgs {
  // geometry: clip (T,3,4) corner-major, or (V,4) with tris; else the screen
  // setup xy (T,3,2), z (T,3), inv_w (T,3), area (T,), valid (T,)
  const float* clip;
  const void* tris;            // (T,3) int32 / int64, or null
  const float* xy;
  const float* z;
  const float* inv_w;
  const float* area;
  const unsigned char* valid;
  const unsigned char* tri_mask;  // (T,) or null (clip input only)
  const float* attrs;          // (T,3,C), or (V,C) with tris: channels attrs*1/w and 1/w
  const float* channels;       // (T,3,CH) corner channels as given
  const void* face_material;   // (T,) int32 / int64, or null
  // scratch
  float* fields;               // (T, NF)
  int4* info;                  // (T,) tile_first, tile_last, span_w, span*8 + class
  int* counts;                 // (groups, 2) big and big2 members a setup block
  void* keys;                  // (N,) int32 / int64
  unsigned long long* total;   // (1,) pairs emitted
  const void* sorted;          // (N,) the keys, sorted
  // outputs
  int* pair_tri;               // (P + chunk,)
  int* starts;                 // (ntiles + 1,)
  float* packed;               // (P + chunk, NF)
  long long* num_pairs;        // ()
  unsigned char* overflowed;   // ()
  long long num_t, num_keys, num_slots, pairs_cap;  // T, N, P = min(N, pairs_cap), the cap
  int num_groups, tris_i64, mat_i64, keys_i64;
  int num_c;                   // C (attrs) or CH (channels)
  int nf, cull, normalize;
  int ntx, nty, ntiles, tile_w, tile_h;
  int max_span, big2_span, big_cap, big2_cap, tri_bits, chunk;
  float half_w, half_h, w_eps, area_eps, len_eps;
  float mg, y_off, x_lo, x_hi, y_lo, y_hi;
};

namespace {

constexpr int kSetupThreads = 128;  // rows staged a block: 128 x (NF + 1) floats
constexpr int kKeysThreads = 1024;
constexpr int kGroups = kKeysThreads / kSetupThreads;  // setup blocks a keys block spans
constexpr int kPackThreads = 256;
constexpr int kSmemMax = 227 * 1024;

enum Class { kNone = 0, kSmall2 = 1, kBig = 2, kBig2 = 3, kJumbo = 4 };

__device__ __forceinline__ long long corner_index(const BinArgs& a, long long t, int i) {
  if (a.tris == nullptr) return t * 3 + i;
  return a.tris_i64 ? static_cast<const long long*>(a.tris)[t * 3 + i]
                    : (long long)static_cast<const int*>(a.tris)[t * 3 + i];
}

// amin / amax over three corners, NaN propagating as the card's reductions do
__device__ __forceinline__ float min3(float p, float q, float r) {
  float m = p;
  m = (isnan(m) || m < q) ? m : q;
  return (isnan(m) || m < r) ? m : r;
}

__device__ __forceinline__ float max3(float p, float q, float r) {
  float m = p;
  m = (isnan(m) || m > q) ? m : q;
  return (isnan(m) || m > r) ? m : r;
}

// _tile_index: floor(coord / size), clamped in float to [-1, n], NaN to 0,
// then to int and to [0, n-1]
__device__ __forceinline__ int tile_index(float coord, float inv_size, int n) {
  float t = floorf(coord * inv_size);
  t = isnan(t) ? 0.f : fminf(fmaxf(t, -1.f), (float)n);
  const int i = (int)t;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ void put_key(const BinArgs& a, long long slot, int tile, int tri) {
  if (a.keys_i64)
    static_cast<long long*>(a.keys)[slot] = (long long)tile * 4294967296LL + tri;  // (tile << 32) | tri
  else
    static_cast<int*>(a.keys)[slot] = ((tile + 1) << a.tri_bits) | tri;
}

__device__ __forceinline__ void decode(const BinArgs& a, long long p, int& tile, int& tri) {
  if (a.keys_i64) {
    const long long k = static_cast<const long long*>(a.sorted)[p];
    tile = (int)(k >> 32);
    tri = (int)(k & 0xFFFFFFFFLL);
  } else {
    const int k = static_cast<const int*>(a.sorted)[p];
    tile = (k >> a.tri_bits) - 1;
    tri = k & ((1 << a.tri_bits) - 1);
  }
  if (tile >= a.ntiles) tri = -1;
}

// A row's plane value coef_0*v_0 + coef_1*v_1 + coef_2*v_2, in that order
__device__ __forceinline__ float plane(const float* coef, float v0, float v1, float v2) {
  return coef[0] * v0 + coef[1] * v1 + coef[2] * v2;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kSetupThreads) bin_setup_kernel(BinArgs a) {
  extern __shared__ float s_rows[];  // kSetupThreads rows at stride NF + 1 (no bank conflicts)
  const int stride = a.nf + 1;
  float* row = s_rows + threadIdx.x * stride;
  const long long t = (long long)blockIdx.x * kSetupThreads + threadIdx.x;
  const bool live = t < a.num_t;
  if (t == 0) *a.total = 0ull;
  int cls = kNone;
  if (live) {
    float x[3], y[3], z[3], iw[3], area;
    bool valid;
    if (a.clip == nullptr) {  // the screen setup as given
      for (int i = 0; i < 3; ++i) {
        x[i] = a.xy[(t * 3 + i) * 2];
        y[i] = a.xy[(t * 3 + i) * 2 + 1];
        z[i] = a.z[t * 3 + i];
        iw[i] = a.inv_w[t * 3 + i];
      }
      area = a.area[t];
      valid = a.valid[t] != 0;
    } else {  // project_corners and _setup_from_corner_data
      bool in_front = true;
      for (int i = 0; i < 3; ++i) {
        const float* c = a.clip + corner_index(a, t, i) * 4;
        const float w = c[3];
        const float r = fabsf(w) > a.w_eps ? 1.0f / w : 0.0f;
        x[i] = (c[0] * r + 1.0f) * a.half_w;
        y[i] = (1.0f - c[1] * r) * a.half_h;
        z[i] = c[2] * r;
        iw[i] = r;
        in_front = in_front && w > a.w_eps;
      }
      const float e01x = x[1] - x[0], e01y = y[1] - y[0];
      const float e02x = x[2] - x[0], e02y = y[2] - y[0];
      area = e01x * e02y - e01y * e02x;
      const bool facing = a.cull ? area > a.area_eps : fabsf(area) > a.area_eps;
      valid = in_front && facing;
      if (a.tri_mask != nullptr) valid = valid && a.tri_mask[t] != 0;
    }

    // pack_triangle_fields: the edges relative to corner 0 (_edge_coeffs)
    float ea[3], eb[3], ec[3];
    for (int i = 0; i < 3; ++i) {
      const int j = (i + 1) % 3, k = (i + 2) % 3;
      ea[i] = y[j] - y[k];
      eb[i] = x[k] - x[j];
      ec[i] = (x[k] - x[j]) * (y[0] - y[j]) - (y[k] - y[j]) * (x[0] - x[j]);
    }
    const float s = (float)((0.f < area) - (area < 0.f));
    for (int i = 0; i < 3; ++i) {
      ea[i] = ea[i] * s;
      eb[i] = eb[i] * s;
      ec[i] = ec[i] * s;
    }
    const float inv_area = 1.0f / fabsf(area);
    row[11] = plane(ea, z[0], z[1], z[2]) * inv_area;
    row[12] = plane(eb, z[0], z[1], z[2]) * inv_area;
    row[13] = plane(ec, z[0], z[1], z[2]) * inv_area;
    for (int i = 0; i < 3; ++i) {
      float ra = ea[i], rb = eb[i], rc = ec[i];
      if (a.normalize) {  // unit-gradient edges for the dilated test
        float q = ra * ra + rb * rb;
        q = isnan(q) ? q : fmaxf(q, a.len_eps);
        const float inv_len = rsqrtf(q);
        ra = ra * inv_len;
        rb = rb * inv_len;
        rc = rc * inv_len;
      }
      row[i] = ra;
      row[3 + i] = rb;
      row[6 + i] = rc;
    }
    row[9] = x[0];
    row[10] = y[0];
    float mat = 0.f;
    if (a.face_material != nullptr)
      mat = a.mat_i64 ? (float)static_cast<const long long*>(a.face_material)[t]
                      : (float)static_cast<const int*>(a.face_material)[t];
    row[14] = mat;
    row[15] = 1.0f;
    // the corner-channel planes [gx | gy | gc], relative to corner 0, raw edges
    int nch = 0;
    if (a.attrs != nullptr) {
      nch = a.num_c + 1;
      long long base[3];
      for (int i = 0; i < 3; ++i) base[i] = corner_index(a, t, i) * a.num_c;
      for (int q = 0; q < nch; ++q) {
        float v[3];
        for (int i = 0; i < 3; ++i) v[i] = q < a.num_c ? a.attrs[base[i] + q] * iw[i] : iw[i];
        row[16 + q] = plane(ea, v[0], v[1], v[2]) * inv_area;
        row[16 + nch + q] = plane(eb, v[0], v[1], v[2]) * inv_area;
        row[16 + 2 * nch + q] = plane(ec, v[0], v[1], v[2]) * inv_area;
      }
    } else if (a.channels != nullptr) {
      nch = a.num_c;
      const float* ch = a.channels + t * 3 * nch;
      for (int q = 0; q < nch; ++q) {
        const float v0 = ch[q], v1 = ch[nch + q], v2 = ch[2 * nch + q];
        row[16 + q] = plane(ea, v0, v1, v2) * inv_area;
        row[16 + nch + q] = plane(eb, v0, v1, v2) * inv_area;
        row[16 + 2 * nch + q] = plane(ec, v0, v1, v2) * inv_area;
      }
    }
    for (int f = nch ? 16 + 3 * nch : 16; f < a.nf; ++f) row[f] = 0.f;

    // the tile bbox and the emission class (bin_triangles_plain)
    const float xmin = min3(x[0], x[1], x[2]), xmax = max3(x[0], x[1], x[2]);
    const float ymin = min3(y[0], y[1], y[2]), ymax = max3(y[0], y[1], y[2]);
    const float inv_tw = 1.0f / (float)a.tile_w, inv_th = 1.0f / (float)a.tile_h;
    const int tx0 = tile_index(xmin - a.mg, inv_tw, a.ntx);
    const int tx1 = tile_index(xmax + a.mg, inv_tw, a.ntx);
    const int ty0 = tile_index(ymin - a.mg - a.y_off, inv_th, a.nty);
    const int ty1 = tile_index(ymax + a.mg - a.y_off, inv_th, a.nty);
    const bool on_screen = xmax >= a.x_lo && xmin < a.x_hi && ymax >= a.y_lo && ymin < a.y_hi;
    valid = valid && on_screen;
    const int span_w = tx1 - tx0 + 1;
    const int span = span_w * (ty1 - ty0 + 1);
    if (valid) {
      if (span <= 2) {
        cls = kSmall2;
      } else if (span <= a.max_span) {
        cls = kBig;
      } else if (span > max(2, a.max_span)) {
        cls = (a.big2_span > a.max_span && span <= a.big2_span) ? kBig2 : kJumbo;
      }
    }
    a.info[t] = make_int4(ty0 * a.ntx + tx0, ty1 * a.ntx + tx1, span_w, span * 8 + cls);

    // sentinel keys in the dense blocks; bin_keys_kernel overwrites the members' rows
    const long long kb = 2 * a.num_t;
    if (t < a.big_cap)
      for (int k = 0; k < a.max_span; ++k) put_key(a, kb + t * a.max_span + k, a.ntiles, (int)t);
    if (a.big2_span > a.max_span && t < a.big2_cap) {
      const long long kb2 = kb + (long long)a.big_cap * a.max_span;
      for (int k = 0; k < a.big2_span; ++k) put_key(a, kb2 + t * a.big2_span + k, a.ntiles, (int)t);
    }
  }
  const int n_big = __syncthreads_count(cls == kBig);
  const int n_big2 = __syncthreads_count(cls == kBig2);
  if (threadIdx.x == 0) {
    a.counts[2 * blockIdx.x] = n_big;
    a.counts[2 * blockIdx.x + 1] = n_big2;
  }
  // the block's rows are one contiguous run of the table
  const long long row0 = (long long)blockIdx.x * kSetupThreads;
  const long long left = a.num_t - row0;
  const int nrows = left < kSetupThreads ? (int)(left > 0 ? left : 0) : kSetupThreads;
  float* out = a.fields + row0 * a.nf;
  for (int e = threadIdx.x; e < nrows * a.nf; e += kSetupThreads) out[e] = s_rows[(e / a.nf) * stride + e % a.nf];
}

__global__ void __launch_bounds__(kKeysThreads) bin_keys_kernel(BinArgs a) {
  __shared__ int s_big[32], s_big2[32], s_off[2];
  __shared__ unsigned long long s_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the members of the setup blocks before this block's first
  const long long g_end = (long long)blockIdx.x * kGroups;
  int ob = 0, ob2 = 0;
  for (long long g = threadIdx.x; g < g_end; g += kKeysThreads) {
    ob += a.counts[2 * g];
    ob2 += a.counts[2 * g + 1];
  }
  ob = warp_sum(ob);
  ob2 = warp_sum(ob2);
  if (lane == 0) {
    s_big[warp] = ob;
    s_big2[warp] = ob2;
  }
  __syncthreads();
  if (warp == 0) {
    const int p = warp_sum(s_big[lane]), q = warp_sum(s_big2[lane]);
    if (lane == 0) {
      s_off[0] = p;
      s_off[1] = q;
    }
  }
  __syncthreads();

  // ranks by id: the offset, the warps before, the lanes before
  const long long t = (long long)blockIdx.x * kKeysThreads + threadIdx.x;
  const bool live = t < a.num_t;
  const int4 inf = live ? a.info[t] : make_int4(0, 0, 0, 0);
  const int cls = inf.w & 7, span = inf.w >> 3;
  const bool is_big = cls == kBig, is_big2 = cls == kBig2;
  const unsigned m_big = __ballot_sync(0xffffffffu, is_big), m_big2 = __ballot_sync(0xffffffffu, is_big2);
  if (lane == 0) {
    s_big[warp] = __popc(m_big);
    s_big2[warp] = __popc(m_big2);
  }
  __syncthreads();
  int wb = 0, wb2 = 0;
  for (int w = 0; w < warp; ++w) {
    wb += s_big[w];
    wb2 += s_big2[w];
  }
  const unsigned before = (1u << lane) - 1u;
  const long long rank = (long long)s_off[0] + wb + __popc(m_big & before);
  const long long rank2 = (long long)s_off[1] + wb2 + __popc(m_big2 & before);

  unsigned long long emitted = 0;
  if (live) {
    const bool spilled = is_big && rank >= a.big_cap;
    const bool spilled2 = is_big2 && rank2 >= a.big2_cap;
    const bool small2 = cls == kSmall2;
    const bool jumbo = cls == kJumbo || spilled || spilled2;
    const int tri = (int)t;
    put_key(a, t, jumbo ? -1 : (small2 ? inf.x : a.ntiles), tri);
    put_key(a, a.num_t + t, (small2 && span > 1) ? inf.y : a.ntiles, tri);
    // the dense row-major bbox slots of a ranked member, sentinel past its span
    const int bw = max(inf.z, 1);
    long long slot0 = -1;
    int slots = 0;
    if (is_big && !spilled) {
      slot0 = 2 * a.num_t + rank * a.max_span;
      slots = a.max_span;
    } else if (is_big2 && !spilled2) {
      slot0 = 2 * a.num_t + (long long)a.big_cap * a.max_span + rank2 * a.big2_span;
      slots = a.big2_span;
    }
    for (int k = 0; k < slots; ++k)
      put_key(a, slot0 + k, k < span ? inf.x + (k / bw) * a.ntx + k % bw : a.ntiles, tri);
    emitted = small2 ? (unsigned long long)min(span, 2) : (slots ? (unsigned long long)span : (jumbo ? 1ull : 0ull));
  }
  emitted = warp_sum(emitted);
  if (lane == 0) s_sum[warp] = emitted;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long b = warp_sum(s_sum[lane]);
    if (lane == 0 && b) atomicAdd(a.total, b);  // integers: the same sum in any order
  }
}

__global__ void __launch_bounds__(kPackThreads) bin_pack_kernel(BinArgs a) {
  const int cols = a.nf / 4;
  const long long idx = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  const long long p = idx / cols;
  const int col = (int)(idx % cols);
  if (p >= a.num_slots + a.chunk) return;
  const bool pair = p < a.num_slots;
  int tile = a.ntiles, tri = -1;
  if (pair) decode(a, p, tile, tri);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (pair) v = reinterpret_cast<const float4*>(a.fields)[(long long)max(tri, 0) * cols + col];
  reinterpret_cast<float4*>(a.packed)[p * cols + col] = v;
  if (col != 0) return;
  a.pair_tri[p] = tri;
  if (p <= a.num_slots) {  // starts[t] = p for the tiles t in (tile[p-1], tile[p]]
    int lo = 0;
    if (p > 0) {
      int prev, unused;
      decode(a, p - 1, prev, unused);
      lo = prev + 1;
    }
    const int hi = min(pair ? tile : a.ntiles, a.ntiles);
    for (int t = max(lo, 0); t <= hi; ++t) a.starts[t] = (int)p;
  }
  if (p == 0) {
    const unsigned long long total = *a.total;
    const unsigned long long cap = (unsigned long long)a.pairs_cap;
    *a.num_pairs = (long long)(total < cap ? total : cap);
    *a.overflowed = total > cap;
  }
}

long long blocks(long long n, int threads) {
  const long long b = (n + threads - 1) / threads;
  return b > 0 ? b : 1;
}

bool args_ok(const BinArgs* a) {
  const bool geometry = a->clip != nullptr || (a->xy && a->z && a->inv_w && a->area && a->valid);
  const long long want_n = 2 * a->num_t + (long long)a->big_cap * a->max_span +
                           (a->big2_span > a->max_span ? (long long)a->big2_cap * a->big2_span : 0);
  const bool keys_fit = a->keys_i64 || (long long)(a->ntiles + 2) <= (1LL << (31 - a->tri_bits));
  return geometry && a->num_t >= 0 && a->num_t < (1LL << 31) && a->nf % 4 == 0 && a->nf >= 16 &&
         a->num_groups == blocks(a->num_t, kSetupThreads) && a->num_keys == want_n &&
         a->num_slots == (want_n < a->pairs_cap ? want_n : a->pairs_cap) && a->ntiles == a->ntx * a->nty &&
         a->ntiles > 0 && a->tile_w > 0 && a->tile_h > 0 && a->tri_bits >= 1 && a->tri_bits <= 31 &&
         a->big_cap >= 0 && a->big_cap <= a->num_t && a->big2_cap >= 0 && a->big2_cap <= a->num_t &&
         a->chunk >= 1 && keys_fit && (int)(sizeof(float) * kSetupThreads * (a->nf + 1)) <= kSmemMax;
}

}  // namespace

// Kernels 1 and 2: the fields table, the per-triangle records and the keys.
extern "C" int raster_bin_keys(const BinArgs* a, void* stream) {
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = (int)sizeof(float) * kSetupThreads * (a->nf + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(bin_setup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  bin_setup_kernel<<<(unsigned)blocks(a->num_t, kSetupThreads), kSetupThreads, smem, s>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bin_keys_kernel<<<(unsigned)blocks(a->num_t, kKeysThreads), kKeysThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

// Kernel 3, after the sort: pair_tri, starts, packed, num_pairs, overflowed.
extern "C" int raster_bin_pack(const BinArgs* a, void* stream) {
  if (!args_ok(a) || a->sorted == nullptr) return (int)cudaErrorInvalidValue;
  const long long n = (a->num_slots + a->chunk) * (a->nf / 4);
  bin_pack_kernel<<<(unsigned)blocks(n, kPackThreads), kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int raster_bin_setup_block() { return kSetupThreads; }

extern "C" const char* raster_bin_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
