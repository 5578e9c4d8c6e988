// Hand-written Hopper (sm_90a) kernels for the sonar sampler's hot path.
//
// Build (done at first use by sonar_tpu_torch/kernels/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -o libsonar_fused.so fused.cu
//
// Plain C interface, bound with ctypes. Every entry point launches on the
// stream it is given, allocates nothing (the Python wrapper hands in outputs
// and scratch), never synchronises, and returns cudaGetLastError() so the
// wrapper can raise on a refused launch.
//
// -fmad=false: the plain PyTorch versions run each operation as its own
// rounded step, so the kernels must not contract a*b+c into one FMA if they
// are to agree with them to the last bit.
//
// Element types: float, __nv_bfloat16 and __half (the `dtype` argument of
// the entry points: 0, 1, 2). As in the TPU kernels, whose float32 scalars
// promote the arithmetic, every element is loaded into float32, computed in
// float32 (B2's cross-block sums in double) and stored once, rounded to
// nearest even, in the input's type.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes of elements: one vector load or store (4 floats, 8 halves).
template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

// Pairwise sum of f(v[0..kN)) in float32, in a fixed tree: for float it is
// (f0 + f1) + (f2 + f3).
template <typename T, typename F>
__device__ __forceinline__ float vec_tree_sum(const Vec<T>& a, F f) {
  float t[Vec<T>::kN];
#pragma unroll
  for (int j = 0; j < Vec<T>::kN; ++j) t[j] = f(to_f32(a.v[j]));
#pragma unroll
  for (int w = 1; w < Vec<T>::kN; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < Vec<T>::kN; j += 2 * w) t[j] = t[j] + t[j + w];
  }
  return t[0];
}

// ---------------------------------------------------------------------------
// B1: fused NEW-mode momentum step
// ---------------------------------------------------------------------------
//
// Replaces the Pallas kernel _momentum_kernel (sonar_tpu/kernels/fused.py:68,
// entry fused_momentum_step). One pass over the latent computes
//   d = (x - D)/sigma, the history blend of D/sigma and d, the has /
//   in-window / history-window gates, and x + m*dt + noise*noise_scale.
//
// Bound: device memory. Per element it reads x, denoised, hd, noise and
// writes x', hd' (24 bytes in f32, 12 in bf16/fp16) for ~20 flops, far
// below the H100's ~20 flop/byte f32 ridge at 3.35 TB/s. The design
// therefore only moves each byte once: 16-byte loads and stores (4 floats
// or 8 halves) where all six pointers are aligned, a grid-stride loop sized
// to the card, and a scalar tail.
// The ten step scalars live in device memory (built once per run by
// pack_momentum_scalars), so a step needs no host round trip.
//
// scal: [sigma, dt, momentum, hd_ratio, hd_scale, md_scale, has,
//        noise_scale, in_window, hist_window]

struct MomentumScalars {
  float sigma, dt, momentum, hd_ratio, hd_scale, md_scale, has, noise_scale,
      in_window, hist_window;
};

__device__ __forceinline__ MomentumScalars load_scalars(const float* s) {
  MomentumScalars m;
  m.sigma = __ldg(s + 0);
  m.dt = __ldg(s + 1);
  m.momentum = __ldg(s + 2);
  m.hd_ratio = __ldg(s + 3);
  m.hd_scale = __ldg(s + 4);
  m.md_scale = __ldg(s + 5);
  m.has = __ldg(s + 6);
  m.noise_scale = __ldg(s + 7);
  m.in_window = __ldg(s + 8);
  m.hist_window = __ldg(s + 9);
  return m;
}

// Same order of operations as fused_momentum_step_reference
// (sonar_tpu/kernels/fused.py:104-117).
__device__ __forceinline__ void momentum_elem(const MomentumScalars& s,
                                              float x, float den, float hd,
                                              float noise, float* out_x,
                                              float* out_hd) {
  const float dn_s = den / s.sigma;
  const float hd1_blend =
      dn_s * s.md_scale + (hd * s.hd_scale - dn_s * s.md_scale) * s.hd_ratio;
  const float hd1 =
      s.hist_window > 0.f ? (s.has > 0.f ? hd1_blend : dn_s) : hd;
  const float has1 = fmaxf(s.has, s.hist_window);
  const float d = (x - den) / s.sigma;
  const float mixed = hd1 + (d - hd1) * s.momentum;
  float md = has1 > 0.f ? mixed : d;
  md = s.in_window > 0.f ? md : d;
  const float hd2_blend =
      d * s.md_scale + (hd1 * s.hd_scale - d * s.md_scale) * s.hd_ratio;
  *out_hd = s.hist_window > 0.f ? (has1 > 0.f ? hd2_blend : d) : hd1;
  *out_x = md * s.dt + x + noise * s.noise_scale;
}

template <typename T>
__global__ void momentum_step_kernel(const T* __restrict__ x,
                                     const T* __restrict__ den,
                                     const T* __restrict__ hd,
                                     const T* __restrict__ noise,
                                     const float* __restrict__ scal,
                                     T* __restrict__ out_x,
                                     T* __restrict__ out_hd, int64_t n,
                                     int vec) {
  constexpr int V = Vec<T>::kN;
  const MomentumScalars s = load_scalars(scal);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / V;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    const Vec<T>* dv = reinterpret_cast<const Vec<T>*>(den);
    const Vec<T>* hv = reinterpret_cast<const Vec<T>*>(hd);
    const Vec<T>* zv = reinterpret_cast<const Vec<T>*>(noise);
    Vec<T>* oxv = reinterpret_cast<Vec<T>*>(out_x);
    Vec<T>* ohv = reinterpret_cast<Vec<T>*>(out_hd);
    for (int64_t i = tid; i < nv; i += stride) {
      const Vec<T> a = xv[i], b = dv[i], c = hv[i], z = zv[i];
      Vec<T> ox, oh;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float fx, fh;
        momentum_elem(s, to_f32(a.v[j]), to_f32(b.v[j]), to_f32(c.v[j]),
                      to_f32(z.v[j]), &fx, &fh);
        ox.v[j] = from_f32<T>(fx);
        oh.v[j] = from_f32<T>(fh);
      }
      oxv[i] = ox;
      ohv[i] = oh;
    }
    done = nv * V;
  }
  // masked tail (or the whole tensor when a pointer is not 16-byte aligned)
  for (int64_t i = done + tid; i < n; i += stride) {
    float fx, fh;
    momentum_elem(s, to_f32(x[i]), to_f32(den[i]), to_f32(hd[i]),
                  to_f32(noise[i]), &fx, &fh);
    out_x[i] = from_f32<T>(fx);
    out_hd[i] = from_f32<T>(fh);
  }
}

// ---------------------------------------------------------------------------
// B2: fused scale_noise (global mode)
// ---------------------------------------------------------------------------
//
// Replaces the Pallas kernel built by _make_scale_noise_kernel
// (sonar_tpu/kernels/fused.py:173, entry fused_scale_noise). Computes the
// global mean and the ddof=1 std, applies the 2.5/sqrt(N) dead-band
// (centre only if |mean| > thr, divide by the original std only if
// |1 - std| > thr and std != 0) and multiplies by the factor.
//
// Bound: device memory. It must read the latent twice for the two-pass
// statistics and read and write it once more for the affine: at least 8
// bytes per element, 16 as written. The TPU kernel held the whole latent in
// one VMEM block; a Hopper block cannot, and blocks run in no order, so the
// work is three launches over a fixed grid:
//   1. per-block partial sums of x;
//   2. every block reduces the partial sums to the mean in a fixed order,
//      then writes its partial sum of (x - mean)^2 (two-pass, as
//      fused.py:192-193, never E[x^2] - E[x]^2);
//   3. every block reduces both partial arrays to mean and std in the same
//      fixed order and applies the affine.
// No atomics: the dead-band is a threshold test, so a sum whose order
// changed from run to run could flip a branch between runs. The grid size
// depends only on N, each thread's elements are fixed, and the reductions
// are fixed trees, so the output is bitwise reproducible. Accumulation is
// f32 within a block and f64 across blocks; indices are 64-bit.

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Fixed-order block sum; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = threadIdx.x < kWarps ? smem[threadIdx.x] : T(0);
  if (warp == 0) v = warp_sum(v);
  __syncthreads();  // smem may be reused by the caller
  return v;
}

// Sum of the nparts block partials, in double, identical in every block.
__device__ double reduce_partials(const float* __restrict__ parts, int nparts,
                                  double* smem, double* result) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) acc += (double)parts[i];
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) *result = acc;
  __syncthreads();
  return *result;
}

template <typename T>
__global__ void scale_noise_sum_kernel(const T* __restrict__ x,
                                       float* __restrict__ part_sum,
                                       int64_t n, int vec) {
  constexpr int V = Vec<T>::kN;
  __shared__ float smem[kWarps];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / V;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    for (int64_t i = tid; i < nv; i += stride)
      acc += vec_tree_sum(xv[i], [](float v) { return v; });
    done = nv * V;
  }
  for (int64_t i = done + tid; i < n; i += stride) acc += to_f32(x[i]);
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) part_sum[blockIdx.x] = acc;
}

template <typename T>
__global__ void scale_noise_sqdev_kernel(const T* __restrict__ x,
                                         const float* __restrict__ part_sum,
                                         float* __restrict__ part_sq,
                                         int64_t n, int vec) {
  constexpr int V = Vec<T>::kN;
  __shared__ float smem[kWarps];
  __shared__ double dsmem[kWarps];
  __shared__ double total;
  const float mean =
      (float)(reduce_partials(part_sum, gridDim.x, dsmem, &total) / (double)n);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const auto sq = [mean](float v) {
    const float a = v - mean;
    return a * a;
  };
  float acc = 0.f;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / V;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    for (int64_t i = tid; i < nv; i += stride) acc += vec_tree_sum(xv[i], sq);
    done = nv * V;
  }
  for (int64_t i = done + tid; i < n; i += stride) acc += sq(to_f32(x[i]));
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) part_sq[blockIdx.x] = acc;
}

template <typename T>
__global__ void scale_noise_apply_kernel(const T* __restrict__ x,
                                         const float* __restrict__ part_sum,
                                         const float* __restrict__ part_sq,
                                         T* __restrict__ out, int64_t n,
                                         float threshold, float factor,
                                         int vec) {
  constexpr int V = Vec<T>::kN;
  __shared__ double dsmem[kWarps];
  __shared__ double total;
  const float mean =
      (float)(reduce_partials(part_sum, gridDim.x, dsmem, &total) / (double)n);
  const float sd = (float)sqrt(
      reduce_partials(part_sq, gridDim.x, dsmem, &total) / (double)(n - 1));
  const bool centre = fabsf(mean) > threshold;
  const bool rescale = fabsf(1.f - sd) > threshold && sd != 0.f;
  const float shift = centre ? mean : 0.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // x - 0 and y / 1 are exact, so the branch-free forms below equal the
  // reference's selects bit for bit.
  const float div = rescale ? sd : 1.f;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / V;
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(out);
    for (int64_t i = tid; i < nv; i += stride) {
      const Vec<T> v = xv[i];
      Vec<T> o;
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.v[j] = from_f32<T>(((to_f32(v.v[j]) - shift) / div) * factor);
      ov[i] = o;
    }
    done = nv * V;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = from_f32<T>(((to_f32(x[i]) - shift) / div) * factor);
}

int momentum_grid(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T>
int momentum_step(const void* x, const void* den, const void* hd,
                  const void* noise, const float* scal, void* out_x,
                  void* out_hd, int64_t n, int vec, cudaStream_t stream) {
  const int grid = momentum_grid(vec ? n / Vec<T>::kN : n);
  momentum_step_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)den, (const T*)hd, (const T*)noise, scal,
      (T*)out_x, (T*)out_hd, n, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int scale_noise(const void* x_, void* out_, float* part, int64_t n,
                int nblocks, float threshold, float factor, int vec,
                cudaStream_t s) {
  const T* x = (const T*)x_;
  float* part_sum = part;
  float* part_sq = part + nblocks;
  scale_noise_sum_kernel<T><<<nblocks, kThreads, 0, s>>>(x, part_sum, n, vec);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scale_noise_sqdev_kernel<T><<<nblocks, kThreads, 0, s>>>(x, part_sum,
                                                           part_sq, n, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  scale_noise_apply_kernel<T><<<nblocks, kThreads, 0, s>>>(
      x, part_sum, part_sq, (T*)out_, n, threshold, factor, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16 (x, den, hd, noise and both
// outputs share it); scal stays float32.
int sonar_momentum_step(const void* x, const void* den, const void* hd,
                        const void* noise, const float* scal, void* out_x,
                        void* out_hd, int64_t n, int vec, int dtype,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return momentum_step<float>(x, den, hd, noise, scal, out_x, out_hd, n,
                                  vec, s);
    case 1:
      return momentum_step<__nv_bfloat16>(x, den, hd, noise, scal, out_x,
                                          out_hd, n, vec, s);
    case 2:
      return momentum_step<__half>(x, den, hd, noise, scal, out_x, out_hd, n,
                                   vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

// part: scratch of 2 * nblocks floats; nblocks must be in [1, 1024] and is
// chosen by the caller from n alone, so the reduction order is a function
// of the shape. dtype as for sonar_momentum_step (x and out share it).
int sonar_scale_noise(const void* x, void* out, float* part, int64_t n,
                      int nblocks, float threshold, float factor, int vec,
                      int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return scale_noise<float>(x, out, part, n, nblocks, threshold, factor,
                                vec, s);
    case 1:
      return scale_noise<__nv_bfloat16>(x, out, part, n, nblocks, threshold,
                                        factor, vec, s);
    case 2:
      return scale_noise<__half>(x, out, part, n, nblocks, threshold, factor,
                                 vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* sonar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
