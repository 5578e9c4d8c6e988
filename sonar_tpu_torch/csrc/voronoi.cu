// Kernel B6: the k smallest toroidal distances per pixel, for Voronoi noise.
//
// Replaces the Pallas kernel built by _make_kernel
// (sonar_tpu/kernels/voronoi.py:78, entry voronoi_ksmallest). For each
// (b, c) plane and each pixel it keeps the k <= 8 smallest distances, in
// ascending order, to the plane's N feature points on the unit 3-torus:
//
//   gy = (ys * scale) mod 1,  fy = (fp_y * scale) mod 1      (same for x, z)
//   dy = ((gy - fy + 0.5) mod 1 - 0.5) * wy                  (same for x, z)
//   euclidean  sqrt(dy*dy + dx*dx + dz*dz)
//   quadratic  dy*dy + dx*dx + dz*dz
//   chebyshev  max(max(|dy|, |dx|), |dz|)
//   minkowski  (|dy|^p + |dx|^p + |dz|^p)^(1/p)
//
// It starts from the caller's tensors: the grid vectors ys (H) and xs (W),
// the feature points fp (BC, N, 3) and the grid's z, a 0-dim device tensor
// read through its pointer (no host sync). The scaling, every wrap and the
// per-axis terms are computed here, in the plain version's operations and
// order (sonar_tpu_torch/kernels/voronoi.py).
//
// Bound: arithmetic, not bytes. Per pixel it writes k floats and reads
// next to nothing, but does N * (2 + 2k) operations (two adds and the
// k-step insertion a point). The (B, C, H, W, N) distance tensor that the
// plain version builds and sorts never exists.
//
// Design. The distance is separable: dy depends on (row, point) and dx on
// (column, point) only. A block owns a tile of 32 columns by 4*G rows of
// one plane and, per chunk of kChunk points, fills shared memory once with
// the per-point terms (fy, fx, the z term), then the row table (4*G rows x
// points) and the column table (32 columns x points) in the form the
// distance adds them (squared, |.| or |.|^p): 4*G + 32 wraps a point where
// one thread a pixel did 2 * 128 * G. The inner loop is two shared-memory
// reads, (row + col) + dz, and the insertion. A warp's lanes are the tile's
// 32 columns: the column table is laid out [point][column] (conflict-free),
// the row table [point][row], and a thread owns four consecutive rows, so
// its row terms are one 16-byte broadcast read and it runs four independent
// insertion chains. The block's 8 warps are G row groups times S = 8/G
// parts of the points: each warp keeps its own sorted k-prefix per pixel
// over its part (+inf where it has fewer than k points) and part 0 merges
// the others' prefixes through shared memory: the k smallest of the union
// of the parts' k smallest are the k smallest, ties included. G is picked
// per shape by the C entry point: the largest of 8, 4, 2, 1 that still
// gives a block per SM (1 x 4 x 64 x 64: G = 1, 128 blocks of 8 warps).
//
// Bit-equality with the plain version (euclidean, quadratic, chebyshev):
// torch.remainder(a, 1) is fmod(a, 1), then + 1 where that is negative;
// fmod(a, 1) is a - trunc(a), exact in float, so mod1 below rounds where
// torch rounds (it differs in the sign of a zero result only, and every
// wrap is followed by an addition that drops it). The build has
// -fmad=false and no fast math. Euclidean selects on the squared distance
// and takes the k roots at the end: sqrtf is correctly rounded, hence
// monotone, so the roots of the k smallest squares are the k smallest
// roots bit for bit. Minkowski keeps its ^(1/p) in the loop (powf is not
// monotone to the last bit); pow follows torch's special cases (2, 3, -2 as
// products, 0.5 as sqrt, -1 as a reciprocal), powf otherwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileW = 32;  // one column a lane
constexpr int kRows = 4;    // rows a thread: one float4 of the row table
constexpr int kChunk = 128;
constexpr int kMaxK = 8;
constexpr int kSMs = 132;

enum Dist { kEuclidean = 0, kQuadratic = 1, kChebyshev = 2, kMinkowski = 3 };

// torch.remainder(a, 1.0f): fmod (a - trunc(a), exact), then the divisor
// added where the result is negative.
__device__ __forceinline__ float mod1(float a) {
  float r = a - truncf(a);
  if (r < 0.0f) r += 1.0f;
  return r;
}

// torch's pow(tensor, scalar) on float: its special cases, powf otherwise.
__device__ __forceinline__ float torch_pow(float x, float e) {
  if (e == 0.5f) return sqrtf(x);
  if (e == -1.0f) return 1.0f / x;
  if (e == 2.0f) return x * x;
  if (e == 3.0f) return x * x * x;
  if (e == -2.0f) return 1.0f / (x * x);
  return powf(x, e);
}

// The wrapped, weighted difference of one axis.
__device__ __forceinline__ float wrapped(float g, float f, float weight) {
  return (mod1(g - f + 0.5f) - 0.5f) * weight;
}

// One axis's term in the form the distance adds it.
template <int D>
__device__ __forceinline__ float axis_term(float d, float p) {
  if (D == kEuclidean || D == kQuadratic) return d * d;
  if (D == kChebyshev) return fabsf(d);
  return torch_pow(fabsf(d), p);
}

// The value the selection orders by (euclidean: the squared distance).
template <int D>
__device__ __forceinline__ float combine(float row, float col, float z, float inv_p) {
  if (D == kChebyshev) return fmaxf(fmaxf(row, col), z);
  const float s = row + col + z;
  return D == kMinkowski ? torch_pow(s, inv_p) : s;
}

// Sorted insertion: mins stays ascending, ties kept.
template <int K>
__device__ __forceinline__ void insert(float (&mins)[K], float d) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float lo = fminf(mins[j], d);
    d = fmaxf(mins[j], d);
    mins[j] = lo;
  }
}

template <int K, int D>
__global__ void __launch_bounds__(kThreads)
    voronoi_ksmallest_kernel(const float* __restrict__ ys, int64_t ys_stride,
                             const float* __restrict__ xs, int64_t xs_stride,
                             const float* __restrict__ fp,
                             const float* __restrict__ z_norm,
                             float* __restrict__ out, int n, int h, int w,
                             int g_shift, float scale, float p, float inv_p,
                             float wy, float wx, float wz) {
  // column table [point][32] then row table [point][4 * G]; the merge
  // reuses the space (kWarps * 128 * K floats at most, the same 32 KB)
  __shared__ __align__(16) float s_tab[2 * kChunk * kTileW];
  __shared__ float s_fy[kChunk];
  __shared__ float s_fx[kChunk];
  __shared__ float s_dz[kChunk];
  __shared__ float s_gy[kWarps * kRows];
  __shared__ float s_gx[kTileW];
  float* s_col = s_tab;
  float* s_row = s_tab + kChunk * kTileW;

  const int parts = kWarps >> g_shift;      // S = 8 / G: parts of the points
  const int rt_shift = g_shift + 2;         // log2 of the tile's rows, 4 * G
  const int tile_h = 1 << rt_shift;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int ty = blockIdx.x / tiles_x;
  const int x0 = (blockIdx.x - ty * tiles_x) * kTileW;
  const int y0 = ty * tile_h;
  const int plane = blockIdx.y;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int grp = warp / parts, part = warp - grp * parts;

  if (t < kTileW) {
    const int x = x0 + t;
    s_gx[t] = x < w ? mod1(xs[(int64_t)x * xs_stride] * scale) : 0.0f;
  } else if (t < kTileW + kWarps * kRows) {
    const int r = t - kTileW, y = y0 + r;
    s_gy[r] = (r < tile_h && y < h) ? mod1(ys[(int64_t)y * ys_stride] * scale) : 0.0f;
  }
  const float gz = mod1(z_norm[0] * scale);
  const float* pfp = fp + (int64_t)plane * n * 3;

  float mins[kRows][K];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int q = 0; q < K; ++q) mins[j][q] = INFINITY;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    __syncthreads();  // the previous chunk's tables have been read
    if (t < m) {
      const float* f = pfp + (int64_t)(c0 + t) * 3;
      s_fy[t] = mod1(f[0] * scale);
      s_fx[t] = mod1(f[1] * scale);
      s_dz[t] = axis_term<D>(wrapped(gz, mod1(f[2] * scale), wz), p);
    }
    __syncthreads();
    for (int idx = t; idx < m * kTileW; idx += kThreads)
      s_col[idx] = axis_term<D>(wrapped(s_gx[idx & (kTileW - 1)], s_fx[idx >> 5], wx), p);
    for (int idx = t; idx < (m << rt_shift); idx += kThreads)
      s_row[idx] = axis_term<D>(
          wrapped(s_gy[idx & (tile_h - 1)], s_fy[idx >> rt_shift], wy), p);
    __syncthreads();
    for (int i = part; i < m; i += parts) {
      const float col = s_col[i * kTileW + lane];
      const float4 row = *reinterpret_cast<const float4*>(
          s_row + (i << rt_shift) + grp * kRows);
      const float z = s_dz[i];
      insert<K>(mins[0], combine<D>(row.x, col, z, inv_p));
      insert<K>(mins[1], combine<D>(row.y, col, z, inv_p));
      insert<K>(mins[2], combine<D>(row.z, col, z, inv_p));
      insert<K>(mins[3], combine<D>(row.w, col, z, inv_p));
    }
  }

  if (parts > 1) {  // uniform over the block
    __syncthreads();  // the tables are free
    float* s_merge = s_tab;  // [warp][row of the thread][q][lane]
    if (part != 0) {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
#pragma unroll
        for (int q = 0; q < K; ++q)
          s_merge[((warp * kRows + j) * K + q) * 32 + lane] = mins[j][q];
    }
    __syncthreads();
    if (part == 0) {
      for (int s = 1; s < parts; ++s) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
#pragma unroll
          for (int q = 0; q < K; ++q)
            insert<K>(mins[j], s_merge[(((warp + s) * kRows + j) * K + q) * 32 + lane]);
      }
    }
  }
  const int x = x0 + lane;
  if (part == 0 && x < w) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = y0 + grp * kRows + j;
      if (y < h) {
        float* o = out + (((int64_t)plane * h + y) * w + x) * K;
        float v[K];
#pragma unroll
        for (int q = 0; q < K; ++q)
          v[q] = D == kEuclidean ? sqrtf(mins[j][q]) : mins[j][q];
        // a pixel's K floats start at a multiple of 4 * K bytes
        if (K % 4 == 0) {
#pragma unroll
          for (int q = 0; q < K; q += 4)
            *reinterpret_cast<float4*>(o + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
        } else if (K == 2) {
          *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int q = 0; q < K; ++q) o[q] = v[q];
        }
      }
    }
  }
}

using KernelFn = void (*)(const float*, int64_t, const float*, int64_t,
                          const float*, const float*, float*, int, int, int,
                          int, float, float, float, float, float, float);

template <int D>
KernelFn pick_k(int k) {
  switch (k) {
    case 1: return voronoi_ksmallest_kernel<1, D>;
    case 2: return voronoi_ksmallest_kernel<2, D>;
    case 3: return voronoi_ksmallest_kernel<3, D>;
    case 4: return voronoi_ksmallest_kernel<4, D>;
    case 5: return voronoi_ksmallest_kernel<5, D>;
    case 6: return voronoi_ksmallest_kernel<6, D>;
    case 7: return voronoi_ksmallest_kernel<7, D>;
    case 8: return voronoi_ksmallest_kernel<8, D>;
  }
  return nullptr;
}

KernelFn pick(int k, int dist) {
  switch (dist) {
    case kEuclidean: return pick_k<kEuclidean>(k);
    case kQuadratic: return pick_k<kQuadratic>(k);
    case kChebyshev: return pick_k<kChebyshev>(k);
    case kMinkowski: return pick_k<kMinkowski>(k);
  }
  return nullptr;
}

int64_t tiles(int bc, int h, int w, int g_shift) {
  const int tile_h = kRows << g_shift;
  return (int64_t)bc * ((h + tile_h - 1) / tile_h) * ((w + kTileW - 1) / kTileW);
}

}  // namespace

extern "C" {

// ys (h) and xs (w) with their element strides, fp (bc, n, 3) contiguous,
// z_norm (one float), out (bc, h, w, k) contiguous: float32 on one device.
// dist: 0 euclidean, 1 quadratic, 2 chebyshev, 3 minkowski (p and
// inv_p = 1/p, rounded to float, are read only there). Requires
// 1 <= k <= min(8, n), bc in [1, 65535], h, w >= 1.
int sonar_voronoi_ksmallest(const float* ys, int64_t ys_stride, const float* xs,
                            int64_t xs_stride, const float* fp,
                            const float* z_norm, float* out, int bc, int n,
                            int h, int w, int k, int dist, float scale, float p,
                            float inv_p, float wy, float wx, float wz,
                            void* stream) {
  const KernelFn fn = pick(k, dist);
  if (fn == nullptr || k > kMaxK || k > n || bc < 1 || bc > 65535 || h < 1 ||
      w < 1)
    return (int)cudaErrorInvalidValue;
  // the tallest tile that still gives every SM a block; rows before points
  int g_shift = 3;
  while (g_shift > 0 && tiles(bc, h, w, g_shift) < kSMs) --g_shift;
  const int64_t per_plane = tiles(1, h, w, g_shift);
  if (per_plane > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)per_plane, (unsigned)bc);
  fn<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      ys, ys_stride, xs, xs_stride, fp, z_norm, out, n, h, w, g_shift, scale, p,
      inv_p, wy, wx, wz);
  return (int)cudaGetLastError();
}

}  // extern "C"
