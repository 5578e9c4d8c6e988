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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
// writes x', hd' (24 bytes in f32) for ~20 flops, far below the H100's
// ~20 flop/byte f32 ridge at 3.35 TB/s. The design therefore only moves
// each byte once: 16-byte (float4) loads and stores where all six pointers
// are aligned, a grid-stride loop sized to the card, and a scalar tail.
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

__global__ void momentum_step_kernel(const float* __restrict__ x,
                                     const float* __restrict__ den,
                                     const float* __restrict__ hd,
                                     const float* __restrict__ noise,
                                     const float* __restrict__ scal,
                                     float* __restrict__ out_x,
                                     float* __restrict__ out_hd,
                                     int64_t n, int vec) {
  const MomentumScalars s = load_scalars(scal);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* d4 = reinterpret_cast<const float4*>(den);
    const float4* h4 = reinterpret_cast<const float4*>(hd);
    const float4* z4 = reinterpret_cast<const float4*>(noise);
    float4* ox4 = reinterpret_cast<float4*>(out_x);
    float4* oh4 = reinterpret_cast<float4*>(out_hd);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = x4[i], b = d4[i], c = h4[i], z = z4[i];
      float4 ox, oh;
      momentum_elem(s, a.x, b.x, c.x, z.x, &ox.x, &oh.x);
      momentum_elem(s, a.y, b.y, c.y, z.y, &ox.y, &oh.y);
      momentum_elem(s, a.z, b.z, c.z, z.z, &ox.z, &oh.z);
      momentum_elem(s, a.w, b.w, c.w, z.w, &ox.w, &oh.w);
      ox4[i] = ox;
      oh4[i] = oh;
    }
    done = n4 << 2;
  }
  // masked tail (or the whole tensor when a pointer is not 16-byte aligned)
  for (int64_t i = done + tid; i < n; i += stride) {
    momentum_elem(s, x[i], den[i], hd[i], noise[i], out_x + i, out_hd + i);
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

__global__ void scale_noise_sum_kernel(const float* __restrict__ x,
                                       float* __restrict__ part_sum,
                                       int64_t n, int vec) {
  __shared__ float smem[kWarps];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      acc += (v.x + v.y) + (v.z + v.w);
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) acc += x[i];
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) part_sum[blockIdx.x] = acc;
}

__global__ void scale_noise_sqdev_kernel(const float* __restrict__ x,
                                         const float* __restrict__ part_sum,
                                         float* __restrict__ part_sq,
                                         int64_t n, int vec) {
  __shared__ float smem[kWarps];
  __shared__ double dsmem[kWarps];
  __shared__ double total;
  const float mean =
      (float)(reduce_partials(part_sum, gridDim.x, dsmem, &total) / (double)n);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      const float a = v.x - mean, b = v.y - mean, c = v.z - mean, d = v.w - mean;
      acc += (a * a + b * b) + (c * c + d * d);
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const float a = x[i] - mean;
    acc += a * a;
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) part_sq[blockIdx.x] = acc;
}

__global__ void scale_noise_apply_kernel(const float* __restrict__ x,
                                         const float* __restrict__ part_sum,
                                         const float* __restrict__ part_sq,
                                         float* __restrict__ out, int64_t n,
                                         float threshold, float factor,
                                         int vec) {
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
    const int64_t n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 v = x4[i];
      float4 o;
      o.x = ((v.x - shift) / div) * factor;
      o.y = ((v.y - shift) / div) * factor;
      o.z = ((v.z - shift) / div) * factor;
      o.w = ((v.w - shift) / div) * factor;
      o4[i] = o;
    }
    done = n4 << 2;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = ((x[i] - shift) / div) * factor;
}

int momentum_grid(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

int sonar_momentum_step(const float* x, const float* den, const float* hd,
                        const float* noise, const float* scal, float* out_x,
                        float* out_hd, int64_t n, int vec, void* stream) {
  const int grid = momentum_grid(vec ? (n >> 2) : n);
  momentum_step_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, den, hd, noise, scal, out_x, out_hd, n, vec);
  return (int)cudaGetLastError();
}

// part: scratch of 2 * nblocks floats; nblocks must be in [1, 1024] and is
// chosen by the caller from n alone, so the reduction order is a function
// of the shape.
int sonar_scale_noise(const float* x, float* out, float* part, int64_t n,
                      int nblocks, float threshold, float factor, int vec,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* part_sum = part;
  float* part_sq = part + nblocks;
  scale_noise_sum_kernel<<<nblocks, kThreads, 0, s>>>(x, part_sum, n, vec);
  int err = (int)cudaGetLastError();
  if (err) return err;
  scale_noise_sqdev_kernel<<<nblocks, kThreads, 0, s>>>(x, part_sum, part_sq,
                                                        n, vec);
  err = (int)cudaGetLastError();
  if (err) return err;
  scale_noise_apply_kernel<<<nblocks, kThreads, 0, s>>>(
      x, part_sum, part_sq, out, n, threshold, factor, vec);
  return (int)cudaGetLastError();
}

const char* sonar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
