// Kernel B3: the Philox4x32-10 Box-Muller gaussian (and its uniforms).
//
// Replaces the Pallas kernel _gauss_kernel (sonar_tpu/kernels/hwrng.py:63,
// entry hw_randn) and its bit source box_muller_uniforms (hwrng.py:49). The
// TPU kernel reseeded the hardware generator per grid block, so its stream
// depended on the block size; this one draws element group g from the
// counter (g, stream) alone (philox.cuh), so the plain PyTorch version in
// sonar_tpu_torch/kernels/hwrng.py reproduces it bit for bit in the
// uniforms and to a few ulps in the normals.
//
// Bound: the instructions it issues, at every size. It reads nothing and
// writes 4 bytes an element (2 in bf16/fp16), which the card could do in
// 22.5 us for 18.9 M floats; with libdevice's logf, sqrtf, cosf and sinf
// the arithmetic alone took 53 us there (H100 80GB HBM3, 700 W): ten
// Philox rounds of two 32 x 32 -> 64 multiplies on the half-rate integer
// pipe, then four general-purpose functions, each with its own argument
// reduction and slow-path test, in one dependent chain a thread. So the
// design cuts instructions and keeps more of them in flight:
// - the Box-Muller of philox.cuh, written for these arguments only (one
//   exact integer reduction for sine and cosine, a logarithm for (0, 1],
//   rsqrt with a Newton step);
// - the ten round keys computed on the host and passed by value: they
//   reach the rounds as constant-bank operands;
// - two groups a thread in flight, so one chain's latency hides behind
//   the other's;
// - the element type asked for is stored directly (float, bf16, fp16:
//   computed in float32, rounded once to nearest even), 16 bytes a thread
//   and store: no second pass to convert;
// - a block of 32 threads and one group a thread where the draw is small,
//   so that 1 x 4 x 64 x 64 (4,096 groups) spreads over 128 SMs; there the
//   time is a launch's floor, which no single kernel gets under.
// The wrapper allocates the output, so it is 16-byte aligned.

#include "elem.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kThreadsSmall = 32;
constexpr int64_t kSmallGroups = 2 * 132 * kThreads;  // below: one group a thread
constexpr int64_t kMaxBlocks = 132 * 16;

using sonar::from_f32;

template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

template <typename T>
__device__ __forceinline__ Quad<T> to_quad(float4 v) {
  Quad<T> q;
  q.v[0] = from_f32<T>(v.x);
  q.v[1] = from_f32<T>(v.y);
  q.v[2] = from_f32<T>(v.z);
  q.v[3] = from_f32<T>(v.w);
  return q;
}

template <bool kNormal>
__device__ __forceinline__ float4 draw_group(int64_t g, uint32_t stream,
                                             const sonar::PhiloxKeys& keys) {
  const uint4 bits = sonar::philox_group((uint64_t)g, stream, keys);
  return kNormal ? sonar::normal4(bits) : sonar::uniform4(bits);
}

// Group g's four values: one vector store, or the masked tail.
template <typename T>
__device__ __forceinline__ void store_group(T* __restrict__ out, int64_t n, int64_t g,
                                            float4 v) {
  const Quad<T> q = to_quad<T>(v);
  const int64_t e = g << 2;
  if (e + 4 <= n) {
    reinterpret_cast<Quad<T>*>(out)[g] = q;
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (e + j < n) out[e + j] = q.v[j];
  }
}

// Two groups a thread and loop turn, in a grid-stride loop. A 4-byte type
// takes groups i and i + (threads in the grid), so each of its two 16-byte
// stores is contiguous over the warp; a 2-byte type takes the neighbours
// 2i and 2i + 1 and stores their eight elements as one 16-byte vector.
template <typename T, bool kNormal>
__global__ void __launch_bounds__(kThreads)
    philox_fill_kernel(T* __restrict__ out, int64_t n, const sonar::PhiloxKeys keys,
                       uint32_t stream) {
  constexpr bool kNeighbours = sizeof(T) == 2;
  const int64_t groups = (n + 3) >> 2;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t turns = kNeighbours ? (groups + 1) >> 1 : groups;
  const int64_t stride = kNeighbours ? step : 2 * step;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < turns; i += stride) {
    const int64_t g0 = kNeighbours ? i << 1 : i;
    const int64_t g1 = kNeighbours ? g0 + 1 : i + step;
    const float4 a = draw_group<kNormal>(g0, stream, keys);
    if (g1 >= groups) {
      store_group(out, n, g0, a);
      continue;
    }
    const float4 b = draw_group<kNormal>(g1, stream, keys);
    if constexpr (kNeighbours) {
      if ((g0 << 2) + 8 <= n) {
        struct alignas(16) Oct {
          Quad<T> lo, hi;
        } o = {to_quad<T>(a), to_quad<T>(b)};
        reinterpret_cast<Oct*>(out)[i] = o;
        continue;
      }
    }
    store_group(out, n, g0, a);
    store_group(out, n, g1, b);
  }
}

// One group a thread, for draws too small to fill the card otherwise.
template <typename T, bool kNormal>
__global__ void __launch_bounds__(kThreadsSmall)
    philox_fill_small_kernel(T* __restrict__ out, int64_t n, const sonar::PhiloxKeys keys,
                             uint32_t stream) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g < ((n + 3) >> 2)) store_group(out, n, g, draw_group<kNormal>(g, stream, keys));
}

template <typename T, bool kNormal>
int launch_fill(void* out, int64_t n, const sonar::PhiloxKeys& keys, uint32_t stream,
                cudaStream_t s) {
  const int64_t groups = (n + 3) >> 2;
  if (groups < kSmallGroups) {
    const int64_t blocks = (groups + kThreadsSmall - 1) / kThreadsSmall;
    philox_fill_small_kernel<T, kNormal><<<(int)blocks, kThreadsSmall, 0, s>>>(
        (T*)out, n, keys, stream);
  } else {
    int64_t blocks = ((groups + 1) / 2 + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    philox_fill_kernel<T, kNormal><<<(int)blocks, kThreads, 0, s>>>((T*)out, n, keys,
                                                                   stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int philox_fill(void* out, int64_t n, const sonar::PhiloxKeys& keys, uint32_t stream,
                int normal, cudaStream_t s) {
  return normal ? launch_fill<T, true>(out, n, keys, stream, s)
                : launch_fill<T, false>(out, n, keys, stream, s);
}

// The radius of every u1 and the cosine and sine of every u2: argument
// `first + i` is the 24-bit integer both are made from.
__global__ void box_muller_probe_kernel(float* __restrict__ radius, float* __restrict__ cosv,
                                        float* __restrict__ sinv, uint32_t first,
                                        int64_t count) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t bits = (first + (uint32_t)i) << 8;
  radius[i] = sonar::box_muller_radius(bits);
  sonar::box_muller_sincos(bits, cosv + i, sinv + i);
}

}  // namespace

extern "C" {

// out: n elements of `dtype` (0 float32, 1 bfloat16, 2 float16), 16-byte
// aligned. normal != 0: N(0,1); else U[0,1).
int sonar_philox_fill(void* out, int64_t n, uint32_t k0, uint32_t k1, uint32_t stream,
                      int normal, int dtype, void* cuda_stream) {
  if (n <= 0) return 0;
  const sonar::PhiloxKeys keys = sonar::philox_keys(k0, k1);
  cudaStream_t s = (cudaStream_t)cuda_stream;
  switch (dtype) {
    case 0:
      return philox_fill<float>(out, n, keys, stream, normal, s);
    case 1:
      return philox_fill<__nv_bfloat16>(out, n, keys, stream, normal, s);
    case 2:
      return philox_fill<__half>(out, n, keys, stream, normal, s);
  }
  return (int)cudaErrorInvalidValue;
}

// For checking Box-Muller's two factors over every argument: radius[i],
// cosv[i], sinv[i] (count floats each) of the 24-bit argument first + i,
// which is u1 = (first + i + 1) 2^-24 and u2 = (first + i) 2^-24.
int sonar_box_muller_probe(float* radius, float* cosv, float* sinv, uint32_t first,
                           int64_t count, void* cuda_stream) {
  if (count <= 0) return 0;
  box_muller_probe_kernel<<<(int)((count + 255) / 256), 256, 0,
                            (cudaStream_t)cuda_stream>>>(radius, cosv, sinv, first, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
