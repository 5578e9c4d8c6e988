// Kernels B4 (upscale pyramid) and B5 (downscale ladders) of the pyramid
// noise family, drawing their gaussians in-kernel from philox.cuh.
//
// Plain C interface, bound with ctypes by
// sonar_tpu_torch/kernels/fused_pyramid.py (which holds the plain PyTorch
// versions). Each entry point launches on the stream it is given, allocates
// nothing and returns cudaGetLastError().

#include "philox.cuh"

namespace {

constexpr int kMaxLevels = 16;  // fused_pyramid.py MAX_LEVELS

// ---------------------------------------------------------------------------
// B4: upscale pyramid
// ---------------------------------------------------------------------------
//
// Replaces the Pallas kernel built by _make_kernel
// (sonar_tpu/kernels/fused_pyramid.py:100, entries fused_pyramid and
// fused_pyramid_accumulate):
//   out[bc] = g1 + g2 * level0_discount
//           + sum_i discount_i * Wh_i (h x sh) . small_i[bc] (sh x sw) . WwT_i (sw x w)
// with (g1, g2) the full-size base pair drawn in-kernel (streams 0 and 1 of
// the base key, the counter layout of philox_randn) or a given base.
//
// Bound: an interpolation matrix has 1 (nearest), 2 (bilinear, upscaling
// area) or at most 4 (bicubic) nonzeros a row, so an output pixel needs
// T * T gathered multiply-adds a level (4 for bilinear), not the sh + sw of
// the dense products the TPU ran on its MXU. The small levels (42,543
// floats a plane at 512 x 512) stay in L1/L2; what is left is the one
// output write, 4 bytes a pixel (plus a read of the base where it is
// given), and arithmetic: the two Philox calls and Box-Mullers a group of
// the base pair drawn in-kernel (philox.cuh's, written for their
// arguments) and the gathers, which outweigh them: at 4 x 4 x 512 x 512 on
// an H100 80GB HBM3 at 700 W bilinear takes 43.8 us on a given base and
// 48.6 us with the base drawn, nearest (one tap) with the base drawn 31.8.
//
// Design: the kernel takes each matrix as its padded sparse rows (tap
// tables idx, val of shape (out, T), columns ascending, padding weight 0;
// ops/resample.py resize_taps), never the dense matrix. T is one of 1, 2, 4
// for the whole call (the widest row of any level, padded up) and a
// template parameter, so every tap loop unrolls and the taps live in
// registers. A flat grid over Philox groups: one thread owns the four
// consecutive flat elements 4g..4g+3, draws both base streams once
// (philox_group + normal4; the counter is the element index, so the stream
// is philox_randn's) and stores 16 bytes (masked tail). Per level and output
// it gathers
//   sum_b (sum_a rval[y,a] * small[ridx[y,a], cidx[x,b]]) * cval[x,b],
// rows first, then columns, ascending: the dense sums with their exact
// zeros skipped. When the four elements lie in one row (always when
// w % 4 == 0) the row taps are loaded once for the four and the column taps
// of the four columns, contiguous in their table, come as 16-byte loads
// where aligned: a warp's tap reads are then contiguous, where one
// 4-byte load a tap touched eight cache lines a load. Otherwise
// each element finds its own plane, row and column. Small shapes launch
// 32-thread blocks so that 1 x 4 x 64 x 64 (4,096 groups) still spreads
// over 128 SMs. (Four rows a thread, sharing a level's column taps, was
// tried at 4 x 4 x 512 x 512 on an H100 80GB HBM3 at 700 W: 22 % faster on
// a given base, 5 % slower with the base pair drawn in-kernel, as the
// generator draws it. The flat grid stays.)

constexpr int kMaxTaps = 4;  // ops/resample.py: bicubic's row
constexpr int kUpThreads = 128;
constexpr int kUpThreadsSmall = 32;
constexpr int64_t kUpSmallGroups = 132 * 128;

struct UpLevel {
  const float* small;  // (bc, sh, sw)
  const int* ridx;     // (h, T) rows of small_i tapped by output row y
  const float* rval;   // (h, T)
  const int* cidx;     // (w, T) columns of small_i tapped by output column x
  const float* cval;   // (w, T)
  int sh, sw;
  float discount;
};

struct UpLevels {
  int n;
  UpLevel lv[kMaxLevels];
};

// Plane, row and column of flat element e; 32-bit division where n fits.
__device__ __forceinline__ void up_locate(int64_t e, int64_t hw, int w, bool narrow,
                                          int64_t& bc, int& y, int& x) {
  if (narrow) {
    const unsigned b = (unsigned)e / (unsigned)hw;
    const unsigned rem = (unsigned)e - b * (unsigned)hw;
    y = (int)(rem / (unsigned)w);
    x = (int)(rem - (unsigned)y * (unsigned)w);
    bc = b;
  } else {
    bc = e / hw;
    const int64_t rem = e - bc * hw;
    y = (int)(rem / w);
    x = (int)(rem - (int64_t)y * w);
  }
}

// The T taps of output index o of one axis.
template <int T>
__device__ __forceinline__ void up_taps(const int* __restrict__ idx,
                                        const float* __restrict__ val, int o,
                                        int* ti, float* tv) {
#pragma unroll
  for (int a = 0; a < T; ++a) {
    ti[a] = __ldg(idx + (int64_t)o * T + a);
    tv[a] = __ldg(val + (int64_t)o * T + a);
  }
}

// (Wh_i . small_i[bc] . WwT_i)[y, x]: sm is small_i[bc], rofs the offsets of
// y's tapped rows in it, (ci, cv) x's column taps.
template <int T>
__device__ __forceinline__ float up_value(const float* __restrict__ sm,
                                          const int* rofs, const float* rv,
                                          const int* ci, const float* cv) {
  float up = 0.f;
#pragma unroll
  for (int b = 0; b < T; ++b) {
    float t = 0.f;
#pragma unroll
    for (int a = 0; a < T; ++a) t = fmaf(rv[a], __ldg(sm + rofs[a] + ci[b]), t);
    up = fmaf(t, cv[b], up);
  }
  return up;
}

// The 4 * T column taps of columns x0..x0+3, contiguous in their table: T
// 16-byte loads where (x0 * T) % 4 == 0 and the tables are aligned.
template <int T>
__device__ __forceinline__ void up_col_taps4(const UpLevel& lv, int x0, bool vec,
                                             int* ci, float* cv) {
  if (vec) {
    const int4* pi = reinterpret_cast<const int4*>(lv.cidx + (int64_t)x0 * T);
    const float4* pv = reinterpret_cast<const float4*>(lv.cval + (int64_t)x0 * T);
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int4 qi = __ldg(pi + j);
      const float4 qv = __ldg(pv + j);
      ci[4 * j] = qi.x, ci[4 * j + 1] = qi.y, ci[4 * j + 2] = qi.z, ci[4 * j + 3] = qi.w;
      cv[4 * j] = qv.x, cv[4 * j + 1] = qv.y, cv[4 * j + 2] = qv.z, cv[4 * j + 3] = qv.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < 4 * T; ++f) {
      ci[f] = __ldg(lv.cidx + (int64_t)x0 * T + f);
      cv[f] = __ldg(lv.cval + (int64_t)x0 * T + f);
    }
  }
}

struct UpShard {
  int64_t first, run, stride;
};

// The base pair of Philox group g: g1 + g2 * level0_discount, four values.
__device__ __forceinline__ void up_base_pair(int64_t g, uint32_t k0, uint32_t k1,
                                             float level0_discount, float* acc) {
  const float4 a = sonar::normal4(sonar::philox_group((uint64_t)g, 0u, k0, k1));
  const float4 b = sonar::normal4(sonar::philox_group((uint64_t)g, 1u, k0, k1));
  acc[0] = a.x + b.x * level0_discount;
  acc[1] = a.y + b.y * level0_discount;
  acc[2] = a.z + b.z * level0_discount;
  acc[3] = a.w + b.w * level0_discount;
}

// The base pair drawn for a slice of a larger draw (a rank's shard of the
// latent; the small levels come in already sliced): local element e takes
// the value of global element first + (e / run) * stride + e % run.
// shard 1: first, run and stride are multiples of four, so the thread's four
// elements are one global group; shard 2: each element finds its own group.
__device__ __forceinline__ void up_base_pair_shard(int64_t e0, int cnt, int shard,
                                                   const UpShard& sh, uint32_t k0,
                                                   uint32_t k1, float level0_discount,
                                                   float* acc) {
  if (shard == 1) {
    up_base_pair((sh.first + (e0 / sh.run) * sh.stride + e0 % sh.run) >> 2, k0, k1,
                 level0_discount, acc);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[k] = 0.f;
    if (k < cnt) {
      const int64_t e = e0 + k;
      const int64_t ge = sh.first + (e / sh.run) * sh.stride + e % sh.run;
      float v[4];
      up_base_pair(ge >> 2, k0, k1, level0_discount, v);
      acc[k] = v[ge & 3];
    }
  }
}

template <int T>
__global__ void __launch_bounds__(kUpThreads)
    pyramid_up_kernel(const float* __restrict__ base, float* __restrict__ out,
                      int64_t n, int h, int w, const UpLevels L, int gen,
                      uint32_t k0, uint32_t k1, float level0_discount,
                      int aligned, int shard, const UpShard sh) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t e0 = g << 2;
  if (e0 >= n) return;
  const int cnt = (int)min((int64_t)4, n - e0);
  const int64_t hw = (int64_t)h * w;
  const bool narrow = n <= 0x7fffffffLL;

  float acc[4];
  if (gen && shard) {
    up_base_pair_shard(e0, cnt, shard, sh, k0, k1, level0_discount, acc);
  } else if (gen) {
    up_base_pair(g, k0, k1, level0_discount, acc);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = k < cnt ? base[e0 + k] : 0.f;
  }

  int64_t bc0;
  int y0, x0;
  up_locate(e0, hw, w, narrow, bc0, y0, x0);
  int rofs[T], ci[4 * T];
  float rv[T], cv[4 * T];
  if (x0 + 3 < w) {  // the four elements share plane and row
    const bool vec = aligned && ((x0 * T) & 3) == 0;
#pragma unroll 2
    for (int i = 0; i < L.n; ++i) {
      const UpLevel& lv = L.lv[i];
      const float* __restrict__ sm = lv.small + bc0 * lv.sh * lv.sw;
      up_taps<T>(lv.ridx, lv.rval, y0, rofs, rv);
#pragma unroll
      for (int a = 0; a < T; ++a) rofs[a] *= lv.sw;
      up_col_taps4<T>(lv, x0, vec, ci, cv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = acc[k] + up_value<T>(sm, rofs, rv, ci + k * T, cv + k * T) * lv.discount;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < cnt) {
        int64_t bc;
        int y, x;
        up_locate(e0 + k, hw, w, narrow, bc, y, x);
        float v = acc[k];
        for (int i = 0; i < L.n; ++i) {
          const UpLevel& lv = L.lv[i];
          up_taps<T>(lv.ridx, lv.rval, y, rofs, rv);
#pragma unroll
          for (int a = 0; a < T; ++a) rofs[a] *= lv.sw;
          up_taps<T>(lv.cidx, lv.cval, x, ci, cv);
          v = v + up_value<T>(lv.small + bc * lv.sh * lv.sw, rofs, rv, ci, cv) * lv.discount;
        }
        acc[k] = v;
      }
    }
  }
  if (cnt == 4) {
    reinterpret_cast<float4*>(out)[g] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < cnt) out[e0 + k] = acc[k];
  }
}

// ---------------------------------------------------------------------------
// B5: downscale ladders (highres_pyramid, pyramid_old)
// ---------------------------------------------------------------------------
//
// Replaces the Pallas kernel built by _make_down_kernel
// (sonar_tpu/kernels/fused_pyramid.py:264, entries fused_downscale_pyramid
// and fused_downscale_accumulate). Per output pixel and level:
//   single-field level (identity, nearest, nearest-exact, area): acc += g*coef
//     (area's coef already carries 1/sqrt(block size));
//   bilinear (>= 2x per axis, disjoint taps):
//     acc += (wr0*(wc0*g00 + wc1*g01) + wr1*(wc0*g10 + wc1*g11)) * coef,
//   with the weights from the index in float32, x = (o + 0.5)*ratio - 0.5,
//   f = x - floor(x) (fused_pyramid.py:250-261), ratio = float(in/out).
// The fields are fresh Philox normals on stream 4*level + plane, counter =
// the group of four consecutive flat elements, or read from given
// (bc, 4, h, w) tensors. The oversized level is never built. acc starts at
// the base (or 0) and takes the levels in ladder order; compiled with
// -fmad=false and in the plain version's order of operations, so with given
// fields both kernels match the plain version bit for bit, and a seed's
// draw does not depend on which of the two ran.
//
// Bound: operations. A pixel costs up to 4 bytes read and 4 written, and a
// Philox call and two Box-Mullers for every four pixels and field: five
// fields a pixel (pyramid_old) to thirteen (a four-level bilinear ladder).
//
// Two kernels, picked by the wrapper from the element count alone
// (fused_pyramid.py downscale_variant):
//
// - pyramid_down_spread_kernel, small outputs. With one thread a group,
//   1 x 4 x 64 x 64 is 4,096 threads that each walk the whole ladder, up to
//   thirteen Philox calls back to back on an eighth of the card. Here a
//   block owns 32 groups and has a warp for every field: lane j of warp f
//   draws field f of group j, one Philox call a thread, into shared memory.
//   After one barrier a thread an element adds its levels in ladder order
//   (weights once a thread) and stores 4 bytes, coalesced.
// - pyramid_down_kernel, large outputs, where one thread a group already
//   fills the card: a grid-stride loop, the ladder's loops unrolled (a
//   level is one field or four), 32-bit index arithmetic below 2^31
//   elements, lanes 1-3 located from lane 0 by increments, the row weights
//   once for four elements of one row, one float4 store.
//
// Whether fields are drawn, whether there is a base and whether any level
// is bilinear are template parameters: a pyramid_old draw carries no index
// arithmetic and no weights at all.

constexpr int kDownThreads = 256;
constexpr int64_t kMaxDownBlocks = 132 * 16;
constexpr int kMaxFields = 4 * kMaxLevels;
constexpr int kSpreadGroups = 32;                 // groups a block: a warp's lanes
constexpr int kSpreadElems = 4 * kSpreadGroups;   // elements a block
constexpr int kSpreadMaxWarps = 16;

struct DownLevel {
  const float* g;  // (bc, 4, h, w) given fields, or null when generating
  float coef, ratio_h, ratio_w;
  int planes;  // 1: single field; 4: bilinear taps
};

struct DownLevels {
  int n;
  int fields;  // sum of planes
  DownLevel lv[kMaxLevels];
  unsigned char stream[kMaxFields];  // 4 * level + plane of each field, in ladder order
};

__device__ __forceinline__ float2 down_weights(int o, float ratio) {
  const float x = ((float)o + 0.5f) * ratio - 0.5f;
  const float f = x - floorf(x);
  return make_float2(1.f - f, f);
}

// One bilinear level of one pixel from its four fields.
__device__ __forceinline__ float down_bilinear(float2 wr, float2 wc, float g00,
                                               float g01, float g10, float g11) {
  return wr.x * (wc.x * g00 + wc.y * g01) + wr.y * (wc.x * g10 + wc.y * g11);
}

// The four values of local group g of one field (stream), drawn at their
// global indices. shard 0: the whole draw, local is global; shard 1: first,
// run and stride are multiples of four, so the group is one global group;
// shard 2: each element finds its own global group (a run may start or end
// inside one), those past the end repeat the last element.
__device__ __forceinline__ float4 down_draw4(int64_t g, uint32_t stream,
                                             const sonar::PhiloxKeys& keys, int shard,
                                             const UpShard& sh, int64_t n) {
  if (shard == 0) return sonar::normal4(sonar::philox_group((uint64_t)g, stream, keys));
  const int64_t e0 = g << 2;
  if (shard == 1)
    return sonar::normal4(sonar::philox_group(
        (uint64_t)((sh.first + (e0 / sh.run) * sh.stride + e0 % sh.run) >> 2), stream, keys));
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t e = e0 + k < n ? e0 + k : n - 1;
    const int64_t ge = sh.first + (e / sh.run) * sh.stride + e % sh.run;
    const float4 q = sonar::normal4(sonar::philox_group((uint64_t)(ge >> 2), stream, keys));
    const int c = (int)(ge & 3);
    v[k] = c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool GEN, bool BASE, bool BILINEAR>
__global__ void __launch_bounds__(32 * kSpreadMaxWarps)
    pyramid_down_spread_kernel(const float* __restrict__ base, float* __restrict__ out,
                               unsigned n, unsigned hw, unsigned w, const DownLevels L,
                               uint32_t k0, uint32_t k1, int shard, const UpShard sh) {
  extern __shared__ float4 down_fields4[];  // [field][group of the block]
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const unsigned g = blockIdx.x * kSpreadGroups + lane;
  const unsigned e0 = g << 2;
  if (e0 < n) {
    if (GEN) {
      const sonar::PhiloxKeys keys = sonar::philox_keys(k0, k1);
      // shard 1: the group is one global group, located once for every field
      const int64_t gd = shard == 1
          ? (sh.first + ((int64_t)e0 / sh.run) * sh.stride + (int64_t)e0 % sh.run) >> 2
          : (int64_t)g;
      const int sd = shard == 1 ? 0 : shard;
      for (unsigned f = warp; f < (unsigned)L.fields; f += warps)
        down_fields4[f * kSpreadGroups + lane] =
            down_draw4(gd, (uint32_t)L.stream[f], keys, sd, sh, (int64_t)n);
    } else {
      // plane and offset in it of elements e0..e0+3 (those past the end repeat e0)
      unsigned bc[4], rem[4];
      bc[0] = e0 / hw;
      rem[0] = e0 - bc[0] * hw;
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        if (e0 + k < n) {
          bc[k] = bc[k - 1];
          rem[k] = rem[k - 1] + 1u;
          if (rem[k] == hw) rem[k] = 0u, bc[k] += 1u;
        } else {
          bc[k] = bc[0];
          rem[k] = rem[0];
        }
      }
      for (unsigned f = warp; f < (unsigned)L.fields; f += warps) {
        const unsigned s = L.stream[f];
        const float* __restrict__ gp = L.lv[s >> 2].g;
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = gp[((uint64_t)bc[k] * 4u + (s & 3u)) * hw + rem[k]];
        down_fields4[f * kSpreadGroups + lane] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  __syncthreads();
  const float* fields = reinterpret_cast<const float*>(down_fields4);
  for (unsigned t = threadIdx.x; t < (unsigned)kSpreadElems; t += blockDim.x) {
    const unsigned e = blockIdx.x * kSpreadElems + t;
    if (e >= n) break;
    float acc = BASE ? base[e] : 0.f;
    int row = 0, col = 0;
    if (BILINEAR) {
      const unsigned rem = e % hw;
      row = (int)(rem / w);
      col = (int)(rem - (unsigned)row * w);
    }
    const float* fp = fields + t;
    for (int li = 0; li < L.n; ++li) {
      const DownLevel& lv = L.lv[li];
      if (!BILINEAR || lv.planes == 1) {
        acc = acc + fp[0] * lv.coef;
        fp += kSpreadElems;
      } else {
        const float lvl = down_bilinear(
            down_weights(row, lv.ratio_h), down_weights(col, lv.ratio_w), fp[0],
            fp[kSpreadElems], fp[2 * kSpreadElems], fp[3 * kSpreadElems]);
        acc = acc + lvl * lv.coef;
        fp += 4 * kSpreadElems;
      }
    }
    out[e] = acc;
  }
}

// Plane p of level li for the four elements of group g: drawn, or gathered
// from the level's given fields at (plane bc[k], offset rem[k]).
template <bool GEN>
__device__ __forceinline__ void down_field4(const DownLevel& lv, int li, int p, int64_t g,
                                            const sonar::PhiloxKeys& keys,
                                            const int64_t* bc, const int* rem,
                                            int64_t hw, int shard, const UpShard& sh,
                                            int64_t n, float* v) {
  if (GEN) {
    const float4 q = down_draw4(g, (uint32_t)(4 * li + p), keys, shard, sh, n);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(lv.g + (bc[k] * 4 + p) * hw + rem[k]);
  }
}

template <bool GEN, bool BASE, bool BILINEAR>
__global__ void __launch_bounds__(kDownThreads)
    pyramid_down_kernel(const float* __restrict__ base, float* __restrict__ out,
                        int64_t n, int h, int w, const DownLevels L, uint32_t k0,
                        uint32_t k1, int base_aligned, int shard, const UpShard sh) {
  const int64_t groups = (n + 3) >> 2;
  const int64_t hw = (int64_t)h * w;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const bool narrow = n <= 0x7fffffffLL;
  const sonar::PhiloxKeys keys = sonar::philox_keys(k0, k1);
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += step) {
    const int64_t e0 = g << 2;
    const int cnt = (int)min((int64_t)4, n - e0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (BASE) {
      if (cnt == 4 && base_aligned) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(base) + g);
        acc[0] = b.x, acc[1] = b.y, acc[2] = b.z, acc[3] = b.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = base[e0 + (k < cnt ? k : 0)];
      }
    }
    // plane, row and column of the four elements (those past the end repeat e0)
    int64_t bc[4] = {0, 0, 0, 0};
    int row[4] = {0, 0, 0, 0}, col[4] = {0, 0, 0, 0}, rem[4] = {0, 0, 0, 0};
    if (!GEN || BILINEAR) {
      up_locate(e0, hw, w, narrow, bc[0], row[0], col[0]);
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        if (k < cnt) {
          bc[k] = bc[k - 1], row[k] = row[k - 1], col[k] = col[k - 1] + 1;
          if (col[k] == w) {
            col[k] = 0;
            if (++row[k] == h) row[k] = 0, bc[k] += 1;
          }
        } else {
          bc[k] = bc[0], row[k] = row[0], col[k] = col[0];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) rem[k] = row[k] * w + col[k];
    }
    const bool one_row = col[0] + 3 < w;  // else a lane wraps, even back to this row
    // shard 1: the group is one global group, located once for every field
    const int64_t gd =
        shard == 1 ? (sh.first + (e0 / sh.run) * sh.stride + e0 % sh.run) >> 2 : g;
    const int sd = shard == 1 ? 0 : shard;
    for (int li = 0; li < L.n; ++li) {
      const DownLevel& lv = L.lv[li];
      if (!BILINEAR || lv.planes == 1) {
        float v[4];
        down_field4<GEN>(lv, li, 0, gd, keys, bc, rem, hw, sd, sh, n, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = acc[k] + v[k] * lv.coef;
      } else {
        float f[4][4];  // [plane][lane]
#pragma unroll
        for (int p = 0; p < 4; ++p)
          down_field4<GEN>(lv, li, p, gd, keys, bc, rem, hw, sd, sh, n, f[p]);
        float2 wr = down_weights(row[0], lv.ratio_h);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k > 0 && !one_row) wr = down_weights(row[k], lv.ratio_h);
          const float lvl = down_bilinear(wr, down_weights(col[k], lv.ratio_w), f[0][k],
                                          f[1][k], f[2][k], f[3][k]);
          acc[k] = acc[k] + lvl * lv.coef;
        }
      }
    }
    if (cnt == 4) {
      reinterpret_cast<float4*>(out)[g] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      for (int k = 0; k < cnt; ++k) out[e0 + k] = acc[k];
    }
  }
}

template <bool GEN, bool BASE, bool BILINEAR>
void down_launch(const float* base, float* out, int64_t n, int h, int w,
                 const DownLevels& L, uint32_t k0, uint32_t k1, int variant, int shard,
                 const UpShard& sh, cudaStream_t stream) {
  const int64_t groups = (n + 3) >> 2;
  if (variant == 1) {
    int warps = L.fields < 4 ? 4 : L.fields;
    if (warps > kSpreadMaxWarps) warps = kSpreadMaxWarps;
    const size_t smem = (size_t)(L.fields < 1 ? 1 : L.fields) * kSpreadGroups * sizeof(float4);
    const int64_t blocks = (groups + kSpreadGroups - 1) / kSpreadGroups;
    pyramid_down_spread_kernel<GEN, BASE, BILINEAR>
        <<<(unsigned)blocks, 32 * warps, smem, stream>>>(
            base, out, (unsigned)n, (unsigned)((int64_t)h * w), (unsigned)w, L, k0, k1,
            shard, sh);
  } else {
    int64_t blocks = (groups + kDownThreads - 1) / kDownThreads;
    if (blocks > kMaxDownBlocks) blocks = kMaxDownBlocks;
    const int base_aligned = (reinterpret_cast<uintptr_t>(base) & 15) == 0;
    pyramid_down_kernel<GEN, BASE, BILINEAR><<<(int)blocks, kDownThreads, 0, stream>>>(
        base, out, n, h, w, L, k0, k1, base_aligned, shard, sh);
  }
}

}  // namespace

extern "C" {

// ptrs: 5 per level (small, ridx, rval, cidx, cval) as integers, the tap
// tables all `taps` wide (1, 2 or 4); dims: 2 per level (sh, sw); base is
// null when gen != 0. out: (bc, h, w), contiguous and 16-byte aligned.
// run > 0 (with gen): the base pair is the slice (first, run, stride) of
// the unsharded draw's flat elements, as sonar_philox_fill_shard's; run = 0:
// the whole draw from element 0.
int sonar_pyramid_up(const float* base, float* out, int bc, int h, int w,
                     int n_levels, int taps, const int64_t* ptrs, const int* dims,
                     const float* discounts, int gen, uint32_t k0, uint32_t k1,
                     float level0_discount, int64_t first, int64_t run, int64_t stride,
                     void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || bc <= 0 || h <= 0 || w <= 0 ||
      (taps != 1 && taps != 2 && taps != kMaxTaps))
    return (int)cudaErrorInvalidValue;
  if (run != 0 && (first < 0 || run < 1 || stride < run || ((int64_t)bc * h * w) % run))
    return (int)cudaErrorInvalidValue;
  const UpShard sh = {first, run, stride};
  const int shard = run == 0 ? 0 : (first % 4 == 0 && run % 4 == 0 && stride % 4 == 0) ? 1 : 2;
  UpLevels L;
  L.n = n_levels;
  int aligned = 1;  // the column tables take 16-byte loads
  for (int i = 0; i < n_levels; ++i) {
    UpLevel& lv = L.lv[i];
    lv.small = reinterpret_cast<const float*>(ptrs[5 * i]);
    lv.ridx = reinterpret_cast<const int*>(ptrs[5 * i + 1]);
    lv.rval = reinterpret_cast<const float*>(ptrs[5 * i + 2]);
    lv.cidx = reinterpret_cast<const int*>(ptrs[5 * i + 3]);
    lv.cval = reinterpret_cast<const float*>(ptrs[5 * i + 4]);
    lv.sh = dims[2 * i];
    lv.sw = dims[2 * i + 1];
    lv.discount = discounts[i];
    if (lv.sh < 1 || lv.sw < 1) return (int)cudaErrorInvalidValue;
    if (((ptrs[5 * i + 3] | ptrs[5 * i + 4]) & 15) != 0) aligned = 0;
  }
  const int64_t n = (int64_t)bc * h * w;
  const int64_t groups = (n + 3) >> 2;
  const int threads = groups < kUpSmallGroups ? kUpThreadsSmall : kUpThreads;
  const int64_t blocks = (groups + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto fn = taps == 1 ? pyramid_up_kernel<1>
            : taps == 2 ? pyramid_up_kernel<2> : pyramid_up_kernel<kMaxTaps>;
  fn<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      base, out, n, h, w, L, gen, k0, k1, level0_discount, aligned, shard, sh);
  return (int)cudaGetLastError();
}

// ptrs: 1 per level (given fields, 0 when gen != 0); planes: 1 or 4 per
// level; params: 3 per level (coef, ratio_h, ratio_w). base may be null.
// variant: 1 the spread kernel (below 2^31 elements), 2 one thread a group.
// run > 0 (with gen): every field is the slice (first, run, stride) of the
// unsharded draw's flat elements, as sonar_philox_fill_shard's and
// sonar_pyramid_up's; run = 0: the whole draw from element 0.
int sonar_pyramid_down(const float* base, float* out, int bc, int h, int w,
                       int n_levels, const int64_t* ptrs, const int* planes,
                       const float* params, int gen, uint32_t k0, uint32_t k1,
                       int variant, int64_t first, int64_t run, int64_t stride,
                       void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || bc <= 0 || h <= 0 || w <= 0 ||
      (variant != 1 && variant != 2))
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)bc * h * w;
  if (run != 0 && (gen == 0 || first < 0 || run < 1 || stride < run || n % run))
    return (int)cudaErrorInvalidValue;
  const UpShard sh = {first, run, stride};
  const int shard = run == 0 ? 0 : (first % 4 == 0 && run % 4 == 0 && stride % 4 == 0) ? 1 : 2;
  if (variant == 1 && n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  DownLevels L;
  L.n = n_levels;
  L.fields = 0;
  bool bilinear = false;
  for (int i = 0; i < n_levels; ++i) {
    if (planes[i] != 1 && planes[i] != 4) return (int)cudaErrorInvalidValue;
    L.lv[i].g = reinterpret_cast<const float*>(ptrs[i]);
    L.lv[i].planes = planes[i];
    L.lv[i].coef = params[3 * i];
    L.lv[i].ratio_h = params[3 * i + 1];
    L.lv[i].ratio_w = params[3 * i + 2];
    bilinear = bilinear || planes[i] == 4;
    for (int p = 0; p < planes[i]; ++p) L.stream[L.fields++] = (unsigned char)(4 * i + p);
  }
  for (int f = L.fields; f < kMaxFields; ++f) L.stream[f] = 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((gen != 0) * 4 + (base != nullptr) * 2 + (int)bilinear) {
    case 0: down_launch<false, false, false>(base, out, n, h, w, L, k0, k1, variant, shard, sh, st); break;
    case 1: down_launch<false, false, true>(base, out, n, h, w, L, k0, k1, variant, shard, sh, st); break;
    case 2: down_launch<false, true, false>(base, out, n, h, w, L, k0, k1, variant, shard, sh, st); break;
    case 3: down_launch<false, true, true>(base, out, n, h, w, L, k0, k1, variant, shard, sh, st); break;
    case 4: down_launch<true, false, false>(base, out, n, h, w, L, k0, k1, variant, shard, sh, st); break;
    case 5: down_launch<true, false, true>(base, out, n, h, w, L, k0, k1, variant, shard, sh, st); break;
    case 6: down_launch<true, true, false>(base, out, n, h, w, L, k0, k1, variant, shard, sh, st); break;
    default: down_launch<true, true, true>(base, out, n, h, w, L, k0, k1, variant, shard, sh, st); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
