// Kernel B6: the k smallest toroidal distances per pixel, for Voronoi noise.
//
// Replaces the Pallas kernel built by _make_kernel
// (sonar_tpu/kernels/voronoi.py:78, entry voronoi_ksmallest). For each
// (b, c) plane and each pixel it keeps the k <= 8 smallest distances, in
// ascending order, to the plane's N feature points on the unit 3-torus:
//
//   dy = ((gy - fy + 0.5) mod 1 - 0.5) * wy      (same for x)
//   euclidean  sqrt(dy*dy + dx*dx + dz)
//   quadratic  dy*dy + dx*dx + dz
//   chebyshev  max(max(|dy|, |dx|), dz)
//   minkowski  (|dy|^p + |dx|^p + dz)^(1/p)
//
// The wrapper (sonar_tpu_torch/kernels/voronoi.py) precomputes everything
// without a (pixel, point) dependence on the device, in the plain version's
// operations: the wrapped grid vectors gy (H) and gx (W), the scaled point
// coordinates fy, fx (BC, N), and the per-point z term dz (BC, N), already
// squared, |.| or |.|^p.
//
// Bound: arithmetic, not bytes. Per pixel it reads two floats and writes k,
// but does ~N * (12 + 2k) operations (two wraps, the distance, the k-step
// insertion): 4,096 at N = 256, k = 2. The (B, C, H, W, N) distance tensor
// that the plain version builds and sorts never exists.
//
// Design (Hopper, not the TPU's (tile, W) blocks): one thread per pixel,
// blocks over (row-major pixel tile, plane). The plane's fy, fx and dz are
// staged in shared memory in chunks of kChunk points (12 KB), so any N
// fits; all threads of a warp read the same point, a broadcast. The prefix
// is a sorted min/max insertion chain in registers, unrolled for k and the
// distance mode, which are template parameters: exact, ties included, so
// the values equal torch.topk's. The operations run in the plain version's
// order (including the * wy and * wx when the weight is 1), mod is fmodf
// with torch.remainder's sign fix, and the build has -fmad=false and no
// fast math, so sqrtf is correctly rounded: euclidean, quadratic and
// chebyshev agree with the plain version bit for bit. pow follows torch's
// special cases (2, 3, -2 as products, 0.5 as sqrt, -1 as a reciprocal),
// powf otherwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;
constexpr int kMaxK = 8;

enum Dist { kEuclidean = 0, kQuadratic = 1, kChebyshev = 2, kMinkowski = 3 };

// torch.remainder(a, 1.0f): fmod, then the divisor added where the sign of
// the result differs from the divisor's (here: where it is negative).
__device__ __forceinline__ float mod1(float a) {
  float r = fmodf(a, 1.0f);
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

template <int K, int D>
__global__ void __launch_bounds__(kThreads)
    voronoi_ksmallest_kernel(const float* __restrict__ gy,
                             const float* __restrict__ gx,
                             const float* __restrict__ fy,
                             const float* __restrict__ fx,
                             const float* __restrict__ dz,
                             float* __restrict__ out, int n, int h, int w,
                             float p, float inv_p, float wy, float wx) {
  __shared__ float s_fy[kChunk];
  __shared__ float s_fx[kChunk];
  __shared__ float s_dz[kChunk];
  const int plane = blockIdx.y;
  const int64_t hw = (int64_t)h * w;
  const int64_t pix = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = pix < hw;
  const float py = live ? gy[pix / w] : 0.0f;
  const float px = live ? gx[pix % w] : 0.0f;
  const float* pfy = fy + (int64_t)plane * n;
  const float* pfx = fx + (int64_t)plane * n;
  const float* pdz = dz + (int64_t)plane * n;

  float mins[K];
#pragma unroll
  for (int j = 0; j < K; ++j) mins[j] = INFINITY;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int i = threadIdx.x; i < m; i += kThreads) {
      s_fy[i] = pfy[c0 + i];
      s_fx[i] = pfx[c0 + i];
      s_dz[i] = pdz[c0 + i];
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float dy = (mod1(py - s_fy[i] + 0.5f) - 0.5f) * wy;
      const float dx = (mod1(px - s_fx[i] + 0.5f) - 0.5f) * wx;
      float d;
      if (D == kEuclidean) {
        d = sqrtf(dy * dy + dx * dx + s_dz[i]);
      } else if (D == kQuadratic) {
        d = dy * dy + dx * dx + s_dz[i];
      } else if (D == kChebyshev) {
        d = fmaxf(fmaxf(fabsf(dy), fabsf(dx)), s_dz[i]);
      } else {
        d = torch_pow(torch_pow(fabsf(dy), p) + torch_pow(fabsf(dx), p) + s_dz[i],
                      inv_p);
      }
      // sorted insertion: mins stays ascending, ties kept
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float lo = fminf(mins[j], d);
        d = fmaxf(mins[j], d);
        mins[j] = lo;
      }
    }
  }
  if (live) {
    float* o = out + ((int64_t)plane * hw + pix) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) o[j] = mins[j];
  }
}

using KernelFn = void (*)(const float*, const float*, const float*,
                          const float*, const float*, float*, int, int, int,
                          float, float, float, float);

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

}  // namespace

extern "C" {

// gy (h), gx (w), fy, fx, dz (bc, n), out (bc, h, w, k): float32,
// contiguous, on one device. dist: 0 euclidean, 1 quadratic, 2 chebyshev,
// 3 minkowski (p and inv_p = 1/p, rounded to float, are read only there).
// Requires 1 <= k <= min(8, n), bc in [1, 65535], h * w >= 1.
int sonar_voronoi_ksmallest(const float* gy, const float* gx, const float* fy,
                            const float* fx, const float* dz, float* out,
                            int bc, int n, int h, int w, int k, int dist,
                            float p, float inv_p, float wy, float wx,
                            void* stream) {
  const KernelFn fn = pick(k, dist);
  if (fn == nullptr || k > kMaxK || k > n || bc < 1 || bc > 65535 || h < 1 ||
      w < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t hw = (int64_t)h * w;
  const dim3 grid((unsigned)((hw + kThreads - 1) / kThreads), (unsigned)bc);
  fn<<<grid, kThreads, 0, (cudaStream_t)stream>>>(gy, gx, fy, fx, dz, out, n, h,
                                                   w, p, inv_p, wy, wx);
  return (int)cudaGetLastError();
}

}  // extern "C"
