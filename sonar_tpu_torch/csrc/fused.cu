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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "elem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

using sonar::from_f32;
using sonar::to_f32;

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
// Bound: device memory, 8 bytes an element (one read, one write), where the
// latent is large: 94 us for 18.9 M floats, against 45 us, because two
// thirds of a slice do not fit on chip and are read three times. Below a
// few hundred KB it is a launch and a chain of three dependent passes on
// the few SMs the latent can be spread over without paying more for the
// exchange than for the work; no single launch reaches the bytes' bound
// there. The TPU kernel held the whole latent in one VMEM block. A Hopper
// block has 227 KB of shared memory, a cluster of blocks can read each
// other's, and a cooperative grid can meet at a barrier, so the whole
// function is one launch at every size.
//
// One kernel does all three passes (the sum; the squared deviations from
// the mean, two-pass as fused.py:192-193, never E[x^2] - E[x]^2; the
// affine). The tensor is cut into units of 16 bytes (4 floats, 8 halves);
// block b of the launch owns the contiguous units [b * per, (b + 1) * per)
// and copies them into its dynamic shared memory as it sums them, so the
// later passes read the on-chip copy and device memory is read once and
// written once. What differs between the tiers is how the blocks' partial
// sums meet:
//   kBlock    one block, nothing to exchange (the wrapper sends it up to
//             16,384 elements: the sampler's 1 x 4 x 64 x 64 latent);
//   kCluster  one thread-block cluster of kClusterBlocks blocks (up to
//             262,144 elements): a block writes its partial into its own
//             shared memory, cluster.sync(), and every block adds all
//             partials in rank order, reading the others' through
//             distributed shared memory;
//   kGrid     a cooperative launch over kGridBlocks blocks, a constant so
//             that no bit depends on the card: partials through a scratch
//             array and grid.sync(); a block keeps the first kUnitsOnChip
//             units of its slice on chip and reads the rest of it again,
//             backward in the second pass and forward in the third, so
//             that each pass starts on what the L2 cache still holds.
// The wrapper's limits are measured (kernel_times.py; H100 80GB HBM3,
// 700 W): one block takes 2.9 us for 64 elements (a launch and the chain of
// load, two statistics, store) and 0.6 us more for every 4,096 elements,
// which is one SM's loads, stores and issue slots: 5.3 us at 16,384. A
// cluster of 16 starts at 5.6 us and reaches 8.7 us at 262,144 elements,
// where the grid's two barriers cost as much (8.4 us) and grow slower.
// No atomics: the dead-band is a threshold test, so a sum whose order
// changed from run to run could flip a branch between runs. The launch
// geometry is a function of n and the element size alone, each thread's
// units, the block tree and the order over blocks are fixed, so the output
// repeats bit for bit. A unit is summed in the same tree whether it came as
// one 16-byte load or, where a pointer is not 16-byte aligned, as scalar
// loads: alignment does not change a bit either. Accumulation is f32
// within a block and f64 across blocks; indices are 64-bit.

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

constexpr int kOneThreads = 1024;
constexpr int kOneWarps = kOneThreads / 32;
constexpr int kClusterBlocks = 16;  // above 8: cudaFuncAttributeNonPortableClusterSizeAllowed
constexpr int kGridBlocks = 132;
constexpr int kUnitsOnChip = 192 * 1024 / 16;  // a block's on-chip copy: 192 KiB

enum Exchange { kBlock = 0, kCluster = 1, kGrid = 2 };

// A unit is read from device memory to be kept on chip, or to be read again
// from the L2 cache by a later pass (tier 3, beyond the on-chip copy); the
// first kind and the output stream through the cache (evict-first) so that
// they do not push the second kind out of it.
template <typename T>
__device__ __forceinline__ Vec<T> load_unit(const T* __restrict__ x, int64_t u, int vec,
                                            bool stream) {
  Vec<T> v;
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(x) + u;
    *reinterpret_cast<uint4*>(&v) = stream ? __ldcs(p) : *p;
    return v;
  }
#pragma unroll
  for (int j = 0; j < Vec<T>::kN; ++j) v.v[j] = x[u * Vec<T>::kN + j];
  return v;
}

template <typename T>
__device__ __forceinline__ void store_unit(T* __restrict__ out, int64_t u, const Vec<T>& v,
                                           int vec) {
  if (vec) {
    __stcs(reinterpret_cast<uint4*>(out) + u, *reinterpret_cast<const uint4*>(&v));
    return;
  }
#pragma unroll
  for (int j = 0; j < Vec<T>::kN; ++j) out[u * Vec<T>::kN + j] = v.v[j];
}

struct OneShared {
  float warp_f[kOneWarps];
  double partial[2];  // this block's sum of x, of (x - mean)^2: read by the cluster
  float stat[2];      // the mean, the std: the same in every block
};

// The launch's mean (phase 0: `acc` is a thread's sum of x) or ddof=1 std
// (phase 1: its sum of squared deviations), the same float in every thread
// of every block. The blocks' float partials are added in rank order in
// double; one thread does the double division and root.
template <int kExchange>
__device__ __forceinline__ float launch_stat(float acc, OneShared& sh, int phase,
                                             float* __restrict__ part, int64_t n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) sh.warp_f[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(sh.warp_f[lane]);
    if (lane == 0 && kExchange == kCluster) sh.partial[phase] = (double)acc;
    if (lane == 0 && kExchange == kGrid) part[phase * kGridBlocks + blockIdx.x] = acc;
  }
  if (kExchange == kCluster) cg::this_cluster().sync();
  if (kExchange == kGrid) {
    __threadfence();
    cg::this_grid().sync();
  }
  if (warp == 0) {
    double total = (double)acc;  // kBlock: lane 0 holds the block's sum
    if (kExchange == kCluster) {
      total = lane < kClusterBlocks
                  ? *cg::this_cluster().map_shared_rank(&sh.partial[phase], lane)
                  : 0.0;
      total = warp_sum(total);
    }
    if (kExchange == kGrid) {
      total = 0.0;
      for (int i = lane; i < kGridBlocks; i += 32)
        total += (double)__ldcg(part + phase * kGridBlocks + i);
      total = warp_sum(total);
    }
    if (lane == 0)
      sh.stat[phase] = phase == 0 ? (float)(total / (double)n)
                                  : (float)sqrt(total / (double)(n - 1));
  }
  __syncthreads();
  return sh.stat[phase];
}

template <typename T, int kExchange>
__global__ void __launch_bounds__(kOneThreads)
    scale_noise_one_kernel(const T* __restrict__ x, T* __restrict__ out,
                           float* __restrict__ part, int64_t n, float threshold,
                           float factor, int vec) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char on_chip_raw[];
  Vec<T>* on_chip = reinterpret_cast<Vec<T>*>(on_chip_raw);
  __shared__ OneShared sh;
  const int64_t units = n / V;
  const int64_t per = (units + gridDim.x - 1) / gridDim.x;
  const int64_t lo = min((int64_t)blockIdx.x * per, units);
  const int64_t mine = min(lo + per, units) - lo;
  // This block's units, counted from lo: [0, kept) go on chip (all of them
  // in tiers 1 and 2, where the host has checked that they fit); a thread's
  // units beyond go on at kept + threadIdx.x + i * kOneThreads, i < more.
  // The passes walk those forward, backward, forward: each starts on what
  // the pass before read last, which the L2 cache still holds.
  static_assert(kUnitsOnChip % kOneThreads == 0, "a thread keeps its stride past the copy");
  const int kept = (int)min(mine, (int64_t)kUnitsOnChip);
  const int64_t beyond = (int64_t)kept + threadIdx.x;
  const int64_t more =
      kExchange == kGrid && beyond < mine ? (mine - beyond + kOneThreads - 1) / kOneThreads : 0;
  x += lo * V;
  out += lo * V;
  // the n % V elements after the last unit: one each for the first threads
  // of the last block
  const int64_t tail = (units - lo) * V + threadIdx.x;
  const bool has_tail = blockIdx.x == gridDim.x - 1 && lo * V + tail < n;
  const float tail_x = has_tail ? to_f32(x[tail]) : 0.f;
  const auto same = [](float a) { return a; };

  float acc = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < kept; i += kOneThreads) {
    const Vec<T> v = load_unit(x, i, vec, true);
    on_chip[i] = v;
    acc += vec_tree_sum(v, same);
  }
#pragma unroll 4
  for (int64_t i = 0; i < more; ++i)
    acc += vec_tree_sum(load_unit(x, beyond + i * kOneThreads, vec, false), same);
  acc += tail_x;
  const float mean = launch_stat<kExchange>(acc, sh, 0, part, n);

  const auto sq = [mean](float a) {
    const float d = a - mean;
    return d * d;
  };
  acc = 0.f;
  for (int i = threadIdx.x; i < kept; i += kOneThreads) acc += vec_tree_sum(on_chip[i], sq);
#pragma unroll 4
  for (int64_t i = more - 1; i >= 0; --i)
    acc += vec_tree_sum(load_unit(x, beyond + i * kOneThreads, vec, false), sq);
  if (has_tail) acc += sq(tail_x);
  const float sd = launch_stat<kExchange>(acc, sh, 1, part, n);

  const bool centre = fabsf(mean) > threshold;
  const bool rescale = fabsf(1.f - sd) > threshold && sd != 0.f;
  // x - 0 and y / 1 are exact, so the branch-free forms below equal the
  // reference's selects bit for bit.
  const float shift = centre ? mean : 0.f;
  const float div = rescale ? sd : 1.f;
  const auto affine = [=](float a) { return ((a - shift) / div) * factor; };
  const auto affine_unit = [&](const Vec<T>& v) {
    Vec<T> o;
#pragma unroll
    for (int j = 0; j < V; ++j) o.v[j] = from_f32<T>(affine(to_f32(v.v[j])));
    return o;
  };
  for (int i = threadIdx.x; i < kept; i += kOneThreads)
    store_unit(out, i, affine_unit(on_chip[i]), vec);
#pragma unroll 4
  for (int64_t i = 0; i < more; ++i) {
    const int64_t u = beyond + i * kOneThreads;
    store_unit(out, u, affine_unit(load_unit(x, u, vec, true)), vec);
  }
  if (has_tail) out[tail] = from_f32<T>(affine(tail_x));
  // a block's shared memory must outlive the other blocks' reads of it
  if (kExchange == kCluster) cg::this_cluster().sync();
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

// The one-launch tiers. The on-chip copy must hold a block's whole slice in
// kBlock and kCluster (the caller picks the tier from n and the element size
// so that it does); kGrid must fit the card all at once, which is checked
// on its first launch.
template <typename T, int kExchange>
int scale_noise_one(const void* x, void* out, float* part, int64_t n, float threshold,
                    float factor, int vec, cudaStream_t s) {
  auto kernel = scale_noise_one_kernel<T, kExchange>;
  const unsigned blocks =
      kExchange == kBlock ? 1 : kExchange == kCluster ? kClusterBlocks : kGridBlocks;
  const int64_t per = (n / Vec<T>::kN + blocks - 1) / blocks;
  if (kExchange != kGrid && per > kUnitsOnChip) return (int)cudaErrorInvalidValue;
  if (kExchange == kGrid && part == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(per < kUnitsOnChip ? per : kUnitsOnChip) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kUnitsOnChip * 16);
  if (err != cudaSuccess) return (int)err;
  if (kExchange == kCluster &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                  1)) != cudaSuccess)
    return (int)err;
  const T* xp = (const T*)x;
  T* op = (T*)out;
  if (kExchange == kGrid) {
    static int fits = -1;  // grid.sync() needs every block resident at once
    if (fits < 0) {
      int device = 0, sms = 0, per_sm = 0;
      if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
        return (int)err;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, kOneThreads, (size_t)kUnitsOnChip * 16)) != cudaSuccess)
        return (int)err;
      fits = per_sm * sms >= kGridBlocks;
    }
    if (!fits) return (int)cudaErrorCooperativeLaunchTooLarge;
    void* args[] = {&xp, &op, &part, &n, &threshold, &factor, &vec};
    return (int)cudaLaunchCooperativeKernel((void*)kernel, dim3(blocks), dim3(kOneThreads),
                                            args, smem, s);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kOneThreads);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = kExchange == kCluster ? 1 : 0;
  return (int)cudaLaunchKernelEx(&config, kernel, xp, op, part, n, threshold, factor, vec);
}

template <typename T>
int scale_noise_tier(int tier, const void* x, void* out, float* part, int64_t n,
                     float threshold, float factor, int vec, cudaStream_t s) {
  switch (tier) {
    case 1:
      return scale_noise_one<T, kBlock>(x, out, part, n, threshold, factor, vec, s);
    case 2:
      return scale_noise_one<T, kCluster>(x, out, part, n, threshold, factor, vec, s);
    case 3:
      return scale_noise_one<T, kGrid>(x, out, part, n, threshold, factor, vec, s);
  }
  return (int)cudaErrorInvalidValue;
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

// tier: 1 one block, 2 one cluster (part unused: null), 3 one cooperative
// grid (part: scratch of 2 * 132 floats). The caller picks the tier from n
// and the element size alone, so the reduction order is a function of the
// shape. dtype as for sonar_momentum_step (x and out share it).
int sonar_scale_noise(const void* x, void* out, float* part, int64_t n, int tier,
                      float threshold, float factor, int vec, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return scale_noise_tier<float>(tier, x, out, part, n, threshold, factor, vec, s);
    case 1:
      return scale_noise_tier<__nv_bfloat16>(tier, x, out, part, n, threshold, factor,
                                             vec, s);
    case 2:
      return scale_noise_tier<__half>(tier, x, out, part, n, threshold, factor, vec, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* sonar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
