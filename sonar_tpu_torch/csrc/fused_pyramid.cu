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
constexpr int kMaxSmem = 227 * 1024;

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
// Bound: at the ladders pyramid draws (levels shrink by 2-4x each, so the
// sum of the small widths is at most ~0.6 w) the dense interpolation
// products cost about h*w*(sum_i sw_i) multiply-adds per plane, tens of
// flops per output byte, so the kernel is bound by the SMs' fp32 rate and
// its shared-memory reads, not by the one output write. The TPU kernel ran
// these products on the MXU in bf16 (Precision.DEFAULT); this one keeps
// full fp32, as the plain version does.
//
// Design: one block per (bc, tile of kTileRows output rows). It stages, for
// every level, T_i = Wh_i[rows, :] . small_i[bc] (tile_rows x sw_i) in
// shared memory (the same association as the plain version: rows first,
// then columns), then each thread walks output columns x and accumulates
// sum_b T_i[r, b] * WwT_i[b, x] for the tile's rows in registers; WwT is
// read coalesced along x, T is a broadcast. Each output element is written
// once. The base pair of element e is drawn from its Philox group (e >> 2),
// lane e & 3, so it equals philox_randn's element e. Ragged edges: the last
// row tile is masked, columns are a strided loop. Wh's zeros (2 nonzeros
// per row for bilinear) are not skipped yet: that, tensor cores and TMA are
// later work.

constexpr int kTileRows = 8;
constexpr int kUpThreads = 128;

struct UpLevel {
  const float* wh;     // (h, sh)
  const float* small;  // (bc, sh, sw)
  const float* wwt;    // (sw, w)
  int sh, sw;
  float discount;
};

struct UpLevels {
  int n;
  UpLevel lv[kMaxLevels];
};

__global__ void __launch_bounds__(kUpThreads)
    pyramid_up_kernel(const float* __restrict__ base, float* __restrict__ out,
                      int h, int w, int tile_rows, const UpLevels L, int gen,
                      uint32_t k0, uint32_t k1, float level0_discount) {
  extern __shared__ float tmp[];
  const int bc = blockIdx.y;
  const int y0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, h - y0);

  int off = 0;
  for (int i = 0; i < L.n; ++i) {
    const int sh = L.lv[i].sh, sw = L.lv[i].sw;
    const float* __restrict__ sm = L.lv[i].small + (int64_t)bc * sh * sw;
    for (int idx = threadIdx.x; idx < rows * sw; idx += blockDim.x) {
      const int r = idx / sw, b = idx - r * sw;
      const float* __restrict__ whr = L.lv[i].wh + (int64_t)(y0 + r) * sh;
      float acc = 0.f;
      for (int a = 0; a < sh; ++a) acc = fmaf(whr[a], sm[(int64_t)a * sw + b], acc);
      tmp[off + r * sw + b] = acc;
    }
    off += tile_rows * sw;
  }
  __syncthreads();

  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      acc[r] = 0.f;
      if (r < rows) {
        const int64_t e = ((int64_t)bc * h + y0 + r) * w + x;
        acc[r] = gen ? sonar::normal_at((uint64_t)e, 0u, k0, k1) +
                           sonar::normal_at((uint64_t)e, 1u, k0, k1) * level0_discount
                     : base[e];
      }
    }
    int o = 0;
    for (int i = 0; i < L.n; ++i) {
      const int sw = L.lv[i].sw;
      const float* __restrict__ wwt = L.lv[i].wwt;
      const float* T = tmp + o;
      float up[kTileRows];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) up[r] = 0.f;
      for (int b = 0; b < sw; ++b) {
        const float wv = __ldg(wwt + (int64_t)b * w + x);
#pragma unroll
        for (int r = 0; r < kTileRows; ++r)
          if (r < rows) up[r] = fmaf(T[r * sw + b], wv, up[r]);
      }
      const float d = L.lv[i].discount;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] = acc[r] + up[r] * d;
      o += tile_rows * sw;
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
      if (r < rows) out[((int64_t)bc * h + y0 + r) * w + x] = acc[r];
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

// ptrs: 3 per level (wh, small, wwt) as integers; dims: 2 per level
// (sh, sw); base is null when gen != 0. out: (bc, h, w), contiguous.
int sonar_pyramid_up(const float* base, float* out, int bc, int h, int w,
                     int n_levels, const int64_t* ptrs, const int* dims,
                     const float* discounts, int gen, uint32_t k0, uint32_t k1,
                     float level0_discount, void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || bc <= 0 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  UpLevels L;
  L.n = n_levels;
  int64_t sum_sw = 0;
  for (int i = 0; i < n_levels; ++i) {
    L.lv[i].wh = reinterpret_cast<const float*>(ptrs[3 * i]);
    L.lv[i].small = reinterpret_cast<const float*>(ptrs[3 * i + 1]);
    L.lv[i].wwt = reinterpret_cast<const float*>(ptrs[3 * i + 2]);
    L.lv[i].sh = dims[2 * i];
    L.lv[i].sw = dims[2 * i + 1];
    L.lv[i].discount = discounts[i];
    sum_sw += dims[2 * i + 1];
  }
  int tile_rows = kTileRows;
  while (tile_rows > 1 && (int64_t)tile_rows * sum_sw * 4 > kMaxSmem) tile_rows >>= 1;
  const int64_t smem = (int64_t)tile_rows * sum_sw * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pyramid_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((h + tile_rows - 1) / tile_rows, bc);
  pyramid_up_kernel<<<grid, kUpThreads, (size_t)smem, (cudaStream_t)stream>>>(
      base, out, h, w, tile_rows, L, gen, k0, k1, level0_discount);
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
