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
// Bound: device memory at large N. It writes 4 bytes per element and reads
// nothing; per four elements it spends 10 Philox rounds (two 32-bit
// multiplies each) and two log/sqrt/cos/sin sets, which the SMs finish well
// inside the write time. So the design only keeps the writes wide: one
// thread makes one Philox call and stores its four values as one float4,
// in a grid-stride loop over 64-bit group indices, with a masked tail for
// the last partial group. The wrapper allocates the output, so it is
// 16-byte aligned.

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
    philox_fill_kernel(float* __restrict__ out, int64_t n, uint32_t k0,
                       uint32_t k1, uint32_t stream, int normal) {
  const int64_t groups = (n + 3) >> 2;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += step) {
    const uint4 bits = sonar::philox_group((uint64_t)g, stream, k0, k1);
    const float4 v = normal ? sonar::normal4(bits) : sonar::uniform4(bits);
    const int64_t e = g << 2;
    if (e + 4 <= n) {
      reinterpret_cast<float4*>(out)[g] = v;
    } else {
      out[e] = v.x;
      if (e + 1 < n) out[e + 1] = v.y;
      if (e + 2 < n) out[e + 2] = v.z;
    }
  }
}

}  // namespace

extern "C" {

// out: n floats, 16-byte aligned. normal != 0: N(0,1); else U[0,1).
int sonar_philox_fill(float* out, int64_t n, uint32_t k0, uint32_t k1,
                      uint32_t stream, int normal, void* cuda_stream) {
  if (n <= 0) return 0;
  const int64_t groups = (n + 3) >> 2;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  philox_fill_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)cuda_stream>>>(
      out, n, k0, k1, stream, normal);
  return (int)cudaGetLastError();
}

}  // extern "C"
