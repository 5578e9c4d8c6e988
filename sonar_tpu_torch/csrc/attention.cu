// Kernel B7: the denoisers' attention core, softmax(q·kᵀ·scale)·v, in one
// pass over key tiles (flash-style).
//
// It replaces no TPU kernel: the JAX package leaves the UNet's and the
// DiT's attention to XLA (sonar_tpu/models/unet.py Attention,
// sonar_tpu/models/dit.py reaching JAX's own flash_attention). It was
// added because the port's operator path made four passes over float32
// logits that never fit on chip (8 × 16,384² × 4 B = 8.6 GB at the UNet's
// level 0): the score GEMM, the scaling pass, the softmax and the value
// GEMM, which together took ~86 % of the UNet cell's device time.
//
// What bounds it: arithmetic. q, k, v and the output are read or written
// once (~2 MB a head); the products are 4·n²·d operations a head and the
// softmax n² exponentials. With matmul TF32 off (the SD v1 cell) the
// products run on the FP32 FMA units (67 TFLOP/s); with it on (the DiT
// cell) on the tensor cores in TF32.
//
// What the design does about it: a block holds a tile of query rows and
// walks the key tiles, keeping a running row maximum and a running sum in
// float32 and its output tile in registers; no logit or probability leaves
// the SM. Key and value tiles stream into shared memory by cp.async, two
// stages deep, while the previous tile is computed.
// The running maximum is kept times c, so the rescale factor is 2^(m_old −
// m_new) exactly where p took its exponents (with FMA contraction, c·m_old −
// c·m_new would make it 1 ± 1e-6 on every tile, compounding over hundreds).
//   - FFMA (TF32 off): each warp owns WM rows, its lanes RG row groups by
//     32/RG key groups; a thread holds a WM/RG × BN·RG/32 block of the
//     tile's scores and a WM/RG × D·RG/32 block of the output, read from
//     shared memory as float4 (q and k stored dimension-major, the keys of
//     one thread side by side). Shared memory gives an SM one float a lane
//     a clock against four FMAs: at SD v1's level 0 (d = 40) a warp owns 64
//     rows, so a thread makes 64 FMAs for 16 loaded values in the score
//     product and 80 for 18 in the value product. The probabilities go
//     through a small per-warp buffer between the two: no block barrier.
//   - TF32 (TF32 on): mma.sync m16n8k8 with float32 accumulation; q, k, P
//     and v are rounded to TF32 (cvt.rna) where torch.matmul rounds them,
//     q, k and v once in shared memory. The score fragment of two keys per
//     lane becomes the probability fragment of the value product by
//     relabelling the keys (a lane's keys 2t, 2t+1 are read as the
//     product's k-indices t, t+4); likewise lane t's k-indices t, t+4 of two
//     k-steps are the dimensions 4t..4t+3 of a group of 16, so one 16-byte
//     load feeds two k-steps.
// Tiles are copied 16 bytes at a time where the strides allow it. A bf16
// or fp16 qkv reaches it widened to float32 by the wrapper, which rounds the
// output back: versions that widened inside the copies (plain loads, as
// cp.async copies bytes unchanged) ran the float32 TF32 tile 12-14 % slower
// at the DiT's shape.
// The head widths 40, 64, 72, 80, 160 and 256 are instantiated; a narrower
// width runs on the next one up with the extra dimensions zero-filled.
// Token counts that are not a multiple of the tiles are masked. The
// wrapper is sonar_tpu_torch/kernels/attention.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* qkv;
  long long sb, sn, sh, sw;  // element strides: batch, token, head, which of q/k/v
  float* out;
  long long ob, on, oh;  // element strides of the output; a head's d values are contiguous
  int n, heads, d;
  float c;   // the softmax scale times log2(e): p = 2^(s·c − m·c)
  bool vec;  // 16-byte copies: the base, every input stride and d multiples of 4 floats
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// 4-byte asynchronous copy to shared memory; zero-filled where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// 16-byte asynchronous copy (L2 only); zero-filled where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [t0, t0 + ROWS) of one of q, k, v (`src`: the head's base plus that
// one's offset) into shared memory at row stride `stride`, dimensions
// [0, WIDTH), those at or past d and the rows at or past n zero-filled. `vec`
// (every stride and the base a multiple of 4 floats, d too): 16-byte copies.
template <int ROWS, int WIDTH>
__device__ __forceinline__ void copy_rows(const Args& a, const float* src, int t0, float* dst,
                                          int stride, int tid, bool vec) {
  if (vec) {
    constexpr int CH = WIDTH / 4;
#pragma unroll 2
    for (int e = tid; e < ROWS * CH; e += kThreads) {
      const int r = e / CH, c = (e - r * CH) * 4;
      const bool ok = t0 + r < a.n && c < a.d;
      cp_async16(dst + r * stride + c, ok ? src + (long long)(t0 + r) * a.sn + c : a.qkv, ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < ROWS * WIDTH; e += kThreads) {
      const int r = e / WIDTH, c = e - r * WIDTH;
      const bool ok = t0 + r < a.n && c < a.d;
      cp_async4(dst + r * stride + c, ok ? src + (long long)(t0 + r) * a.sn + c : a.qkv, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// FFMA: float32 products on the FMA units
// ---------------------------------------------------------------------------

template <int D_, int WM_, int BN_, int RG_>
struct Ffma {
  static constexpr int D = D_, WM = WM_, BN = BN_;
  static constexpr int RG = RG_, KG = 32 / RG;  // lanes: RG row groups × KG key (column) groups
  static constexpr int BM = kWarps * WM;
  static constexpr int TR = WM / RG;                // query rows a thread holds
  static constexpr int TK = BN / KG;                // keys a thread holds in a tile
  static constexpr int CA = D / (4 * KG);           // output columns a thread holds: CA float4
  static constexpr int CB = (D % (4 * KG)) / KG;    // groups and CB single columns
  static constexpr int TD = 4 * CA + CB;            // = D / KG
  // padded row strides; RP keeps a quarter warp's probability stores in distinct banks
  static constexpr int RQ = BM + 4, RK = BN + 4, RP = WM + (KG == 4 ? 8 : 4);
  static constexpr int Q_FLOATS = D * RQ;   // q, dimension-major
  static constexpr int K_FLOATS = D * RK;   // one stage of k, dimension-major
  static constexpr int V_FLOATS = BN * D;   // one stage of v, token-major
  static constexpr int P_FLOATS = BN * RP;  // one warp's probabilities, key-major
  static constexpr int SMEM = 4 * (Q_FLOATS + 2 * K_FLOATS + 2 * V_FLOATS + kWarps * P_FLOATS);
  static_assert(D % KG == 0 && TR % 4 == 0 && TK % 4 == 0, "tile shape");
  static_assert((BN * D) % kThreads == 0, "whole copies per thread");
};

// Where key `key` of a tile sits in a dimension row of k: the keys a thread
// holds (kg + KG·j) side by side in groups of four, the groups of
// neighbouring threads next to each other.
template <int KG>
__device__ __forceinline__ int key_slot(int key) {
  const int j = key / KG;
  return (j >> 2) * 4 * KG + (key % KG) * 4 + (j & 3);
}

template <int KG>
__device__ __forceinline__ float group_max(float v) {  // over the KG lanes of a row group
#pragma unroll
  for (int x = 1; x < KG; x <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, x));
  return v;
}

template <int KG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int x = 1; x < KG; x <<= 1) v += __shfl_xor_sync(0xffffffffu, v, x);
  return v;
}

template <class C>
__device__ __forceinline__ void ffma_load_kv(const Args& a, const float* head, int kt0,
                                             float* Ks, float* Vs, int tid) {
#pragma unroll 4
  for (int e = tid; e < C::BN * C::D; e += kThreads) {
    const int key = e / C::D, dim = e - key * C::D;
    const bool ok = kt0 + key < a.n && dim < a.d;
    cp_async4(Ks + dim * C::RK + key_slot<C::KG>(key),
              ok ? head + (long long)(kt0 + key) * a.sn + a.sw + dim : a.qkv, ok);
  }
  copy_rows<C::BN, C::D>(a, head + 2 * a.sw, kt0, Vs, C::D, tid, a.vec);
}

template <class C>
__global__ void __launch_bounds__(kThreads) attention_ffma_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + C::Q_FLOATS;
  float* Vs = Ks + 2 * C::K_FLOATS;
  float* Ps = Vs + 2 * C::V_FLOATS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane / C::KG, kg = lane % C::KG;  // row group, key (and output column) group
  const int bh = blockIdx.y, b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.x * C::BM;
  const float* head = a.qkv + b * a.sb + h * a.sh;
  float* Pw = Ps + warp * C::P_FLOATS;
  const int tiles = (a.n + C::BN - 1) / C::BN;

  ffma_load_kv<C>(a, head, 0, Ks, Vs, tid);
  cp_commit();
  for (int e = tid; e < C::BM * C::D; e += kThreads) {
    const int r = e / C::D, dim = e - r * C::D;
    const int t = q0 + r;
    Qs[dim * C::RQ + r] = (t < a.n && dim < a.d) ? head[(long long)t * a.sn + dim] : 0.f;
  }

  // thread rows i·4RG + rg·4 + e of the warp's WM, keys kg + KG·j of a tile
  float o[C::TR][C::TD], m[C::TR], l[C::TR];  // m: the running row maximum times c
#pragma unroll
  for (int r = 0; r < C::TR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < C::TD; ++j) o[r][j] = 0.f;
  }
  const float* Qw = Qs + warp * C::WM + rg * 4;

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      ffma_load_kv<C>(a, head, (it + 1) * C::BN, Ks + (st ^ 1) * C::K_FLOATS,
                      Vs + (st ^ 1) * C::V_FLOATS, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * C::K_FLOATS + kg * 4;
    const float* Vt = Vs + st * C::V_FLOATS;

    float s[C::TR][C::TK];
#pragma unroll
    for (int r = 0; r < C::TR; ++r)
#pragma unroll
      for (int j = 0; j < C::TK; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < C::D; ++k) {
      float qa[C::TR], kb[C::TK];
#pragma unroll
      for (int i = 0; i < C::TR / 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(Qw + k * C::RQ + i * 4 * C::RG);
        qa[4 * i] = x.x; qa[4 * i + 1] = x.y; qa[4 * i + 2] = x.z; qa[4 * i + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < C::TK / 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(Kt + k * C::RK + i * 4 * C::KG);
        kb[4 * i] = x.x; kb[4 * i + 1] = x.y; kb[4 * i + 2] = x.z; kb[4 * i + 3] = x.w;
      }
#pragma unroll
      for (int r = 0; r < C::TR; ++r)
#pragma unroll
        for (int j = 0; j < C::TK; ++j) s[r][j] = fmaf(qa[r], kb[j], s[r][j]);
    }
    const int kt0 = it * C::BN;
    if (kt0 + C::BN > a.n) {
#pragma unroll
      for (int j = 0; j < C::TK; ++j)
        if (kt0 + kg + C::KG * j >= a.n)
#pragma unroll
          for (int r = 0; r < C::TR; ++r) s[r][j] = -INFINITY;
    }

#pragma unroll
    for (int r = 0; r < C::TR; ++r) {
      float mx = s[r][0];
#pragma unroll
      for (int j = 1; j < C::TK; ++j) mx = fmaxf(mx, s[r][j]);
      const float mn = fmaxf(m[r], group_max<C::KG>(mx) * a.c);  // finite: the first tile holds a key
      const float alpha = ex2(m[r] - mn);  // 0 on the first tile, exactly 1 while m holds
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::TK; ++j) {
        const float p = ex2(fmaf(s[r][j], a.c, -mn));
        s[r][j] = p;
        sum += p;
      }
      l[r] = fmaf(l[r], alpha, sum);
#pragma unroll
      for (int j = 0; j < C::TD; ++j) o[r][j] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < C::TR / 4; ++i)
#pragma unroll
      for (int j = 0; j < C::TK; ++j)
        *reinterpret_cast<float4*>(Pw + (kg + C::KG * j) * C::RP + i * 4 * C::RG + rg * 4) =
            make_float4(s[4 * i][j], s[4 * i + 1][j], s[4 * i + 2][j], s[4 * i + 3][j]);
    __syncwarp();

#pragma unroll 8
    for (int key = 0; key < C::BN; ++key) {
      float pa[C::TR], va[C::TD];
#pragma unroll
      for (int i = 0; i < C::TR / 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(Pw + key * C::RP + i * 4 * C::RG + rg * 4);
        pa[4 * i] = x.x; pa[4 * i + 1] = x.y; pa[4 * i + 2] = x.z; pa[4 * i + 3] = x.w;
      }
      const float* vrow = Vt + key * C::D;
#pragma unroll
      for (int g = 0; g < C::CA; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(vrow + g * 4 * C::KG + kg * 4);
        va[4 * g] = x.x; va[4 * g + 1] = x.y; va[4 * g + 2] = x.z; va[4 * g + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < C::CB; ++g) va[4 * C::CA + g] = vrow[C::CA * 4 * C::KG + kg + C::KG * g];
#pragma unroll
      for (int r = 0; r < C::TR; ++r)
#pragma unroll
        for (int j = 0; j < C::TD; ++j) o[r][j] = fmaf(pa[r], va[j], o[r][j]);
    }
    __syncthreads();  // the stage and the probabilities are free again
  }

  float* ob = a.out + b * a.ob + h * a.oh;
#pragma unroll
  for (int r = 0; r < C::TR; ++r) {
    const float inv = 1.f / group_sum<C::KG>(l[r]);
    const int row = q0 + warp * C::WM + (r >> 2) * 4 * C::RG + rg * 4 + (r & 3);
    if (row >= a.n) continue;
    float* orow = ob + (long long)row * a.on;
#pragma unroll
    for (int j = 0; j < C::TD; ++j) {
      const int col = j < 4 * C::CA ? (j >> 2) * 4 * C::KG + kg * 4 + (j & 3)
                                    : C::CA * 4 * C::KG + kg + C::KG * (j - 4 * C::CA);
      if (col < a.d) orow[col] = o[r][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// TF32: tensor-core products, mma.sync m16n8k8, float32 accumulation
// ---------------------------------------------------------------------------

template <int D_, int MT_>
struct Tf32 {
  static constexpr int D = D_, MT = MT_;
  static constexpr int BN = 32;
  static constexpr int WM = 16 * MT, BM = kWarps * WM;
  static constexpr int D16 = (D + 15) / 16 * 16;            // q·k dims: k-steps in pairs
  static constexpr int SQ = D16 % 32 == 16 ? D16 : D16 + 16;  // ≡ 16 (mod 32): no bank conflict
  static constexpr int SV = D + 4;                           // ≡ 4 or 12 (mod 16): likewise
  static constexpr int NT = BN / 8;                          // key n-tiles of a tile
  static constexpr int ND = D / 8;                           // output n-tiles
  static constexpr int Q_FLOATS = BM * SQ, K_FLOATS = BN * SQ, V_FLOATS = BN * SV;
  static constexpr int SMEM = 4 * (Q_FLOATS + 2 * K_FLOATS + 2 * V_FLOATS);
  static_assert(D % 8 == 0, "tile shape");
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {  // over the 4 lanes of a fragment row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Round this thread's share of a copied tile (as copy_rows handed it out)
// to TF32 in place, once, where torch.matmul rounds its operands.
template <int ROWS, int WIDTH>
__device__ __forceinline__ void round_rows(float* dst, int stride, int tid, bool vec) {
  if (vec) {
    constexpr int CH = WIDTH / 4;
#pragma unroll 2
    for (int e = tid; e < ROWS * CH; e += kThreads) {
      const int r = e / CH, c = (e - r * CH) * 4;
      float4* p = reinterpret_cast<float4*>(dst + r * stride + c);
      float4 x = *p;
      x.x = __uint_as_float(tf32_bits(x.x));
      x.y = __uint_as_float(tf32_bits(x.y));
      x.z = __uint_as_float(tf32_bits(x.z));
      x.w = __uint_as_float(tf32_bits(x.w));
      *p = x;
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < ROWS * WIDTH; e += kThreads) {
      const int r = e / WIDTH, c = e - r * WIDTH;
      dst[r * stride + c] = __uint_as_float(tf32_bits(dst[r * stride + c]));
    }
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads) attention_tf32_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + C::Q_FLOATS;
  float* Vs = Ks + 2 * C::K_FLOATS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.x * C::BM;
  const float* head = a.qkv + b * a.sb + h * a.sh;
  const int tiles = (a.n + C::BN - 1) / C::BN;

  copy_rows<C::BM, C::D16>(a, head, q0, Qs, C::SQ, tid, a.vec);
  copy_rows<C::BN, C::D16>(a, head + a.sw, 0, Ks, C::SQ, tid, a.vec);
  copy_rows<C::BN, C::D>(a, head + 2 * a.sw, 0, Vs, C::SV, tid, a.vec);
  cp_commit();
  cp_wait<0>();
  round_rows<C::BM, C::D16>(Qs, C::SQ, tid, a.vec);

  float o[C::MT][C::ND][4], m[C::MT][2], l[C::MT][2];  // m: the running row maximum times c
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = -INFINITY;
      l[mt][hf] = 0.f;
    }
#pragma unroll
    for (int nd = 0; nd < C::ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][nd][i] = 0.f;
  }
  const float* Qw = Qs + (warp * C::WM + g) * C::SQ + 4 * t4;

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      copy_rows<C::BN, C::D16>(a, head + a.sw, (it + 1) * C::BN, Ks + (st ^ 1) * C::K_FLOATS,
                               C::SQ, tid, a.vec);
      copy_rows<C::BN, C::D>(a, head + 2 * a.sw, (it + 1) * C::BN, Vs + (st ^ 1) * C::V_FLOATS,
                             C::SV, tid, a.vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    round_rows<C::BN, C::D16>(Ks + st * C::K_FLOATS, C::SQ, tid, a.vec);
    round_rows<C::BN, C::D>(Vs + st * C::V_FLOATS, C::SV, tid, a.vec);
    __syncthreads();
    const float* Kt = Ks + st * C::K_FLOATS + g * C::SQ + 4 * t4;
    const float* Vt = Vs + st * C::V_FLOATS;

    float s[C::MT][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
#pragma unroll
    for (int G = 0; G < C::D16 / 16; ++G) {
      float4 qa[C::MT][2];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          qa[mt][hf] = *reinterpret_cast<const float4*>(Qw + (mt * 16 + hf * 8) * C::SQ + 16 * G);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const float4 kv = *reinterpret_cast<const float4*>(Kt + nt * 8 * C::SQ + 16 * G);
        const uint32_t b0 = __float_as_uint(kv.x), b1 = __float_as_uint(kv.y);
        const uint32_t b2 = __float_as_uint(kv.z), b3 = __float_as_uint(kv.w);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          const float4 x = qa[mt][0], y = qa[mt][1];
          mma_tf32(s[mt][nt], __float_as_uint(x.x), __float_as_uint(y.x), __float_as_uint(x.y),
                   __float_as_uint(y.y), b0, b1);
          mma_tf32(s[mt][nt], __float_as_uint(x.z), __float_as_uint(y.z), __float_as_uint(x.w),
                   __float_as_uint(y.w), b2, b3);
        }
      }
    }
    const int kt0 = it * C::BN;
    if (kt0 + C::BN > a.n) {
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (kt0 + nt * 8 + 2 * t4 + (i & 1) >= a.n)
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt) s[mt][nt][i] = -INFINITY;
    }

#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = s[mt][0][2 * hf];
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hf], s[mt][nt][2 * hf + 1]));
        const float mn = fmaxf(m[mt][hf], quad_max(mx) * a.c);
        const float alpha = ex2(m[mt][hf] - mn);
        m[mt][hf] = mn;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
          for (int i = 2 * hf; i < 2 * hf + 2; ++i) {
            const float p = ex2(fmaf(s[mt][nt][i], a.c, -mn));
            s[mt][nt][i] = p;
            sum += p;
          }
        l[mt][hf] = fmaf(l[mt][hf], alpha, sum);
#pragma unroll
        for (int nd = 0; nd < C::ND; ++nd) {
          o[mt][nd][2 * hf] *= alpha;
          o[mt][nd][2 * hf + 1] *= alpha;
        }
      }
    }

    // the probability fragment of key n-tile kk: a lane's keys 2t, 2t+1 read
    // as k-indices t, t+4, and v's rows 2t, 2t+1 as the same
#pragma unroll
    for (int kk = 0; kk < C::NT; ++kk) {
      uint32_t pa[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        pa[mt][0] = tf32_bits(s[mt][kk][0]);
        pa[mt][1] = tf32_bits(s[mt][kk][2]);
        pa[mt][2] = tf32_bits(s[mt][kk][1]);
        pa[mt][3] = tf32_bits(s[mt][kk][3]);
      }
      const float* v0 = Vt + (kk * 8 + 2 * t4) * C::SV + g;
#pragma unroll
      for (int nd = 0; nd < C::ND; ++nd) {
        const uint32_t b0 = __float_as_uint(v0[nd * 8]), b1 = __float_as_uint(v0[C::SV + nd * 8]);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
          mma_tf32(o[mt][nd], pa[mt][0], pa[mt][1], pa[mt][2], pa[mt][3], b0, b1);
      }
    }
    __syncthreads();
  }

  float* ob = a.out + b * a.ob + h * a.oh;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float inv = 1.f / quad_sum(l[mt][hf]);
      const int row = q0 + warp * C::WM + mt * 16 + hf * 8 + g;
      if (row >= a.n) continue;
      float* orow = ob + (long long)row * a.on;
#pragma unroll
      for (int nd = 0; nd < C::ND; ++nd)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = nd * 8 + 2 * t4 + i;
          if (col < a.d) orow[col] = o[mt][nd][2 * hf + i] * inv;
        }
    }
}

// One launch of instantiation C; its shared-memory limit raised once a device.
template <class C>
int run(void (*kernel)(Args), const Args& a, int batch, cudaStream_t stream) {
  static unsigned long long ready = 0;  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && !(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready |= 1ull << dev;
  }
  const dim3 grid((a.n + C::BM - 1) / C::BM, batch * a.heads);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int run_ffma(const Args& a, int batch, cudaStream_t s) {
  return run<C>(attention_ffma_kernel<C>, a, batch, s);
}

template <class C>
int run_tf32(const Args& a, int batch, cudaStream_t s) {
  return run<C>(attention_tf32_kernel<C>, a, batch, s);
}

}  // namespace

extern "C" {

// softmax(q·kᵀ·scale)·v for every (batch, head) of a packed qkv: element
// (b, token, head, which, dim) at qkv[b·sb + token·sn + head·sh + which·sw
// + dim], the output's at out[b·ob + token·on + head·oh + dim]. `width` is
// the instantiated head width (one of 40, 64, 72, 80, 160, 256, at least
// d); the wrapper checks every argument. Returns the launch's CUDA error.
int sonar_attention(const float* qkv, long long sb, long long sn, long long sh, long long sw,
                    int batch, int n, int heads, int d, int width, float* out, long long ob,
                    long long on, long long oh, float scale, int tf32, void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 && sb % 4 == 0 && sn % 4 == 0 &&
                   sh % 4 == 0 && sw % 4 == 0 && d % 4 == 0;
  Args a{qkv, sb, sn, sh, sw, out, ob, on, oh, n, heads, d, scale * kLog2e, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tf32) {
    switch (width) {
      case 40: return run_tf32<Tf32<40, 2>>(a, batch, s);
      case 64: return run_tf32<Tf32<64, 2>>(a, batch, s);
      case 72: return run_tf32<Tf32<72, 2>>(a, batch, s);
      case 80: return run_tf32<Tf32<80, 2>>(a, batch, s);
      case 160: return run_tf32<Tf32<160, 1>>(a, batch, s);
      case 256: return run_tf32<Tf32<256, 1>>(a, batch, s);
    }
  } else {
    switch (width) {
      case 40: return run_ffma<Ffma<40, 64, 32, 8>>(a, batch, s);
      case 64: return run_ffma<Ffma<64, 32, 32, 4>>(a, batch, s);
      case 72: return run_ffma<Ffma<72, 32, 32, 4>>(a, batch, s);
      case 80: return run_ffma<Ffma<80, 32, 32, 4>>(a, batch, s);
      case 160: return run_ffma<Ffma<160, 16, 32, 4>>(a, batch, s);
      case 256: return run_ffma<Ffma<256, 16, 32, 4>>(a, batch, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
