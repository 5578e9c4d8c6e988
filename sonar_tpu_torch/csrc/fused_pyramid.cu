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

template <int T>
__global__ void __launch_bounds__(kUpThreads)
    pyramid_up_kernel(const float* __restrict__ base, float* __restrict__ out,
                      int64_t n, int h, int w, const UpLevels L, int gen,
                      uint32_t k0, uint32_t k1, float level0_discount,
                      int aligned) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t e0 = g << 2;
  if (e0 >= n) return;
  const int cnt = (int)min((int64_t)4, n - e0);
  const int64_t hw = (int64_t)h * w;
  const bool narrow = n <= 0x7fffffffLL;

  float acc[4];
  if (gen) {
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
// The fields are fresh Philox normals on stream 4*level + plane, or read
// from given (bc, 4, h, w) tensors. The oversized level is never built.
//
// Bound: device memory. Per pixel it reads an optional base and writes the
// output (4-8 bytes); the Philox and Box-Muller work (one call per four
// pixels per field) stays under the write time. One thread owns one Philox
// group of four consecutive flat elements, so every Philox call's four
// normals are used, and stores them as one float4 (masked tail). Compiled
// with -fmad=false and in the plain version's order of operations, so with
// given fields it matches the plain version bit for bit.

constexpr int kDownThreads = 256;
constexpr int64_t kMaxDownBlocks = 132 * 16;

struct DownLevel {
  const float* g;  // (bc, 4, h, w) given fields, or null when generating
  float coef, ratio_h, ratio_w;
  int planes;  // 1: single field; 4: bilinear taps
};

struct DownLevels {
  int n;
  DownLevel lv[kMaxLevels];
};

__device__ __forceinline__ float2 down_weights(int o, float ratio) {
  const float x = ((float)o + 0.5f) * ratio - 0.5f;
  const float f = x - floorf(x);
  return make_float2(1.f - f, f);
}

__global__ void __launch_bounds__(kDownThreads)
    pyramid_down_kernel(const float* __restrict__ base, float* __restrict__ out,
                        int64_t n, int h, int w, const DownLevels L, int gen,
                        uint32_t k0, uint32_t k1) {
  const int64_t groups = (n + 3) >> 2;
  const int64_t hw = (int64_t)h * w;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += step) {
    const int64_t e0 = g << 2;
    const int cnt = (int)min((int64_t)4, n - e0);
    float acc[4];
    int row[4], col[4];
    int64_t bcs[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t e = e0 + (k < cnt ? k : 0);
      bcs[k] = e / hw;
      const int64_t rem = e - bcs[k] * hw;
      row[k] = (int)(rem / w);
      col[k] = (int)(rem - (int64_t)row[k] * w);
      acc[k] = base != nullptr ? base[e] : 0.f;
    }
    for (int li = 0; li < L.n; ++li) {
      const DownLevel lv = L.lv[li];
      float f[4][4];  // [plane][lane]
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= lv.planes) break;
        if (gen) {
          const float4 v = sonar::normal4(
              sonar::philox_group((uint64_t)g, (uint32_t)(4 * li + p), k0, k1));
          f[p][0] = v.x;
          f[p][1] = v.y;
          f[p][2] = v.z;
          f[p][3] = v.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            f[p][k] = lv.g[((bcs[k] * 4 + p) * h + row[k]) * w + col[k]];
        }
      }
      if (lv.planes == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = acc[k] + f[0][k] * lv.coef;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 wr = down_weights(row[k], lv.ratio_h);
          const float2 wc = down_weights(col[k], lv.ratio_w);
          const float lvl = wr.x * (wc.x * f[0][k] + wc.y * f[1][k]) +
                            wr.y * (wc.x * f[2][k] + wc.y * f[3][k]);
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

}  // namespace

extern "C" {

// ptrs: 5 per level (small, ridx, rval, cidx, cval) as integers, the tap
// tables all `taps` wide (1, 2 or 4); dims: 2 per level (sh, sw); base is
// null when gen != 0. out: (bc, h, w), contiguous and 16-byte aligned.
int sonar_pyramid_up(const float* base, float* out, int bc, int h, int w,
                     int n_levels, int taps, const int64_t* ptrs, const int* dims,
                     const float* discounts, int gen, uint32_t k0, uint32_t k1,
                     float level0_discount, void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || bc <= 0 || h <= 0 || w <= 0 ||
      (taps != 1 && taps != 2 && taps != kMaxTaps))
    return (int)cudaErrorInvalidValue;
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
      base, out, n, h, w, L, gen, k0, k1, level0_discount, aligned);
  return (int)cudaGetLastError();
}

// ptrs: 1 per level (given fields, 0 when gen != 0); planes: 1 or 4 per
// level; params: 3 per level (coef, ratio_h, ratio_w). base may be null.
int sonar_pyramid_down(const float* base, float* out, int bc, int h, int w,
                       int n_levels, const int64_t* ptrs, const int* planes,
                       const float* params, int gen, uint32_t k0, uint32_t k1,
                       void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || bc <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  DownLevels L;
  L.n = n_levels;
  for (int i = 0; i < n_levels; ++i) {
    L.lv[i].g = reinterpret_cast<const float*>(ptrs[i]);
    L.lv[i].planes = planes[i];
    L.lv[i].coef = params[3 * i];
    L.lv[i].ratio_h = params[3 * i + 1];
    L.lv[i].ratio_w = params[3 * i + 2];
  }
  const int64_t n = (int64_t)bc * h * w;
  const int64_t groups = (n + 3) >> 2;
  int64_t blocks = (groups + kDownThreads - 1) / kDownThreads;
  if (blocks > kMaxDownBlocks) blocks = kMaxDownBlocks;
  pyramid_down_kernel<<<(int)blocks, kDownThreads, 0, (cudaStream_t)stream>>>(
      base, out, n, h, w, L, gen, k0, k1);
  return (int)cudaGetLastError();
}

}  // extern "C"
