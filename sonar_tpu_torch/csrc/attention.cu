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
//   - TF32 on Hopper (TF32 on, head widths 72 and 128, 16-byte aligned):
//     warpgroup products, wgmma m64nNk8 with float32 accumulation in
//     registers, A from registers, B from shared memory. A block of 384
//     threads holds 128 query rows. Two consumer warpgroups own 64 rows each:
//     q as the score product's A (rounded once), s = q·kᵀ over a tile of 64
//     keys (N = 64), the softmax on the accumulators, then o += p·v (N = the
//     head width) with p, rounded, as A through the same relabelling of keys
//     as mma.sync's. TF32 wgmma reads B only K-major, so v has to reach
//     shared memory transposed (keys contiguous). A producer warpgroup, its
//     registers lowered by setmaxnreg, keeps a ring of stages full: one lane
//     issues TMA copies, guarded by mbarriers (k in boxes of 4 dimensions ×
//     64 keys that land as the product's core matrices, v as 64 rows into a
//     staging slot); its other three warps round k in place and write v
//     transposed and rounded, off the consumers' path. No swizzle: every
//     core matrix is 128 contiguous bytes, and the rounders' reads and
//     writes fall in distinct banks. Feeding the ring by the producer's own
//     loads through registers, or by cp.async, left the consumers waiting
//     (3.6 and 1.5 times this tile's time at FLUX.1's shape); turns between
//     the consumers (named barriers) and issuing the next score product
//     before the softmax were slower too.
//     What bounds it: the TF32 products, with the float32 softmax's ex2 at
//     ~1/4 of their time at width 128 (a warpgroup's tile: 64·64 ex2 on an
//     SM's 16 special-function lanes, 256 clocks, against 2·64·64·128 TF32
//     multiply-adds at 1,024 a clock, 1,024 clocks). The widths 160 and
//     256 keep mma.sync: a 64 × width float32 accumulator beside q's
//     fragments and the scores would not fit a consumer's registers; so
//     does every misaligned qkv, which TMA cannot read. The wrapper's
//     b7_tile picks the tile.
// Tiles are copied 16 bytes at a time where the strides allow it. A bf16
// or fp16 qkv reaches it widened to float32 by the wrapper, which rounds the
// output back: versions that widened inside the copies (plain loads, as
// cp.async copies bytes unchanged) ran the float32 TF32 tile 12-14 % slower
// at the DiT's shape.
// The head widths 40, 64, 72, 80, 128, 160 and 256 are instantiated (128 for
// FLUX.1's heads, which ran zero-filled on 160 before); a narrower width runs
// on the next one up with the extra dimensions zero-filled.
// Token counts that are not a multiple of the tiles are masked. The
// wrapper is sonar_tpu_torch/kernels/attention.py.

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// TF32 on Hopper: warpgroup products (wgmma m64nNk8) fed by a producer
// warpgroup through a ring of mbarrier-guarded stages
// ---------------------------------------------------------------------------

template <int D_>
struct Sm90 {
  static constexpr int D = D_;
  static constexpr int BN = 64;         // keys a tile
  static constexpr int BM = 128;        // query rows a block: 64 a consumer warpgroup
  static constexpr int THREADS = 384;   // the producer warpgroup, then two consumers
  static constexpr int ROUNDERS = 96;   // the producer's warps 1-3
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // 128·56 + 256·224 ≤ 65536
  static constexpr int STAGES = D > 96 ? 2 : 3;  // of k, vᵀ and v as TMA lands it
  static constexpr int KS = D / 8, VS = BN / 8;  // k-steps of the score and the value product
  static constexpr int TILE = BN * D * 4;        // bytes of a tile of k, vᵀ or v
  static constexpr int LBO_K = BN * 16;          // from one 4-dimension chunk of k to the next
  static constexpr int SBO_V = BN / 4 * 128;     // from one 8-dimension group of vᵀ to the next
  static constexpr int SMEM = 3 * STAGES * TILE + 8 * 6 * STAGES;
  static_assert(D % 8 == 0 && D <= 256, "tile shape");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A shared-memory matrix descriptor without swizzle: core matrices of 8 rows
// × 16 bytes (128 bytes each, contiguous), `lbo` bytes apart along k, `sbo`
// along m or n.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulators across an
// asynchronous product's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D += A·B, m64nNk8 (mma_first: D = A·B): A a TF32 fragment in registers (a
// warp's 16 rows as mma.sync's m16n8k8 holds them), B K-major in shared
// memory by descriptor, D float32 in registers (a warp's 16 rows as
// mma.sync's accumulators, n8 tile by n8 tile).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void mma_first(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
};

template <>
struct Wgmma<72> {
  static __device__ __forceinline__ void mma(float (&d)[36], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35"
        "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ float4 round4(float4 x) {
  return make_float4(__uint_as_float(tf32_bits(x.x)), __uint_as_float(tf32_bits(x.y)),
                     __uint_as_float(tf32_bits(x.z)), __uint_as_float(tf32_bits(x.w)));
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// A TMA copy of one box of `map` at coordinates (c0, c1, c2, c3) into shared
// memory, its bytes counted on `bar`; out of bounds it lands as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The products' B operands in shared memory, K-major core matrices of 8 rows
// × 16 bytes (128 contiguous bytes):
// - k (n: keys, k: dimensions) as TMA lands it, one box of 4 dimensions × BN
//   keys a chunk: core matrix (keys 8g..8g+7, dimensions 4c..4c+3) at
//   c·LBO_K + g·128. The rounders round it in place.
// - v transposed (n: dimensions, k: keys), written by the rounders from v as
//   TMA lands it (BN rows of D): core matrix (dimensions 8g..8g+7, k-indices
//   4q..4q+3) at g·SBO_V + q·128. The keys of k-step j stand in the order
//   8j + 0, 2, 4, 6, 1, 3, 5, 7: the probability fragment reads a lane's keys
//   2t, 2t+1 as the k-indices t, t+4. A warp reads 32 neighbouring dimensions
//   of a row and writes 16-byte rows of 8-row core matrices: no bank conflict.
template <class C>
__device__ __forceinline__ void sm90_round_k(unsigned char* ks, int rt) {
#pragma unroll 4
  for (int i = rt; i < C::TILE / 16; i += C::ROUNDERS) {
    float4* p = reinterpret_cast<float4*>(ks) + i;
    *p = round4(*p);
  }
}

template <class C>
__device__ __forceinline__ void sm90_transpose_v(const float* raw, unsigned char* vs, int rt) {
#pragma unroll 4
  for (int e = rt; e < C::BN / 4 * C::D; e += C::ROUNDERS) {
    const int n = e % C::D, q = e / C::D;
    const float* col = raw + ((q >> 1) * 8 + (q & 1)) * C::D + n;  // keys +0, +2, +4, +6
    *reinterpret_cast<float4*>(vs + (n >> 3) * C::SBO_V + q * 128 + (n & 7) * 16) =
        round4(make_float4(col[0], col[2 * C::D], col[4 * C::D], col[6 * C::D]));
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    attention_tf32_kernel_sm90(const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ks = smem;                                         // STAGES tiles of k,
  unsigned char* Vs = Ks + C::STAGES * C::TILE;                     // of vᵀ,
  float* raw = reinterpret_cast<float*>(Vs + C::STAGES * C::TILE);  // of v as it lands
  uint64_t* k_tma = reinterpret_cast<uint64_t*>(raw + C::STAGES * C::TILE / 4);  // k landed
  uint64_t* full_k = k_tma + C::STAGES;   // k rounded (the rounders arrive)
  uint64_t* full_v = full_k + C::STAGES;  // vᵀ written (the rounders)
  uint64_t* empty = full_v + C::STAGES;   // a stage read (the consumers' 256 threads)
  uint64_t* v_tma = empty + C::STAGES;    // v landed
  uint64_t* raw_free = v_tma + C::STAGES;  // v read (the rounders)

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.x * C::BM;
  const float* head = a.qkv + b * a.sb + h * a.sh;
  const int tiles = (a.n + C::BN - 1) / C::BN;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      bar_init(k_tma + s, 1);
      bar_init(full_k + s, C::ROUNDERS);
      bar_init(full_v + s, C::ROUNDERS);
      bar_init(empty + s, 256);
      bar_init(v_tma + s, 1);
      bar_init(raw_free + s, C::ROUNDERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // the producer: TMA copies from one lane, TF32 rounding on warps 1-3
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (tid == 0) {
      for (int it = 0; it < tiles; ++it) {
        const int st = it % C::STAGES, ph = it / C::STAGES & 1;
        bar_wait(raw_free + st, ph ^ 1);
        bar_expect_tx(v_tma + st, C::TILE);
        tma_load(raw + st * (C::TILE / 4), &tv, v_tma + st, 0, h, it * C::BN, b);
        bar_wait(empty + st, ph ^ 1);
        bar_expect_tx(k_tma + st, C::TILE);
#pragma unroll 1
        for (int c = 0; c < C::D / 4; ++c)
          tma_load(Ks + st * C::TILE + c * C::LBO_K, &tk, k_tma + st, 4 * c, h, it * C::BN, b);
      }
    } else if (tid >= 32) {
      const int rt = tid - 32;
      for (int it = 0; it < tiles; ++it) {
        const int st = it % C::STAGES, ph = it / C::STAGES & 1;
        bar_wait(k_tma + st, ph);
        sm90_round_k<C>(Ks + st * C::TILE, rt);
        fence_proxy_async();  // the stores, seen by the products' (async) reads
        bar_arrive(full_k + st);
        bar_wait(v_tma + st, ph);
        sm90_transpose_v<C>(raw + st * (C::TILE / 4), Vs + st * C::TILE, rt);
        fence_proxy_async();
        bar_arrive(raw_free + st);
        bar_arrive(full_v + st);
      }
    }
  } else {  // a consumer: 64 query rows, both products and the softmax
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int warp = tid >> 5 & 3, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int row0 = q0 + 64 * ((tid >> 7) - 1) + 16 * warp + g;  // and row0 + 8

    // q as the score product's A fragments, rounded once: k-step ks holds
    // rows row0, row0 + 8 at dimensions 8ks + t4, 8ks + t4 + 4
    uint32_t qa[C::KS][4];
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 8 * (i & 1), dim = 8 * ks + t4 + 4 * (i >> 1);
        qa[ks][i] = row < a.n && dim < a.d ? tf32_bits(head[(long long)row * a.sn + dim]) : 0u;
      }

    // o: n8 tile nd holds rows row0 (2 values), row0 + 8 (2) at columns
    // 8nd + 2t4, +1; s likewise over a tile's keys; m: the running row
    // maximum times c
    float o[C::D / 2], s[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < C::D / 2; ++i) o[i] = 0.f;
    const uint32_t k_smem = smem_u32(Ks), v_smem = smem_u32(Vs);

    for (int it = 0; it < tiles; ++it) {
      const int st = it % C::STAGES, ph = it / C::STAGES & 1;
      bar_wait(full_k + st, ph);
      wg_fence();
      const uint32_t kst = k_smem + st * C::TILE;
      Wgmma<C::BN>::mma_first(s, qa[0], smem_desc(kst, C::LBO_K, 128));
#pragma unroll
      for (int ks = 1; ks < C::KS; ++ks)
        Wgmma<C::BN>::mma(s, qa[ks], smem_desc(kst + 2 * C::LBO_K * ks, C::LBO_K, 128));
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      const int kt0 = it * C::BN;
      if (kt0 + C::BN > a.n) {
#pragma unroll
        for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (kt0 + 8 * j + 2 * t4 + (i & 1) >= a.n) s[4 * j + i] = -INFINITY;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = s[2 * hf];
#pragma unroll
        for (int j = 0; j < C::BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
        const float mn = fmaxf(m[hf], quad_max(mx) * a.c);
        const float alpha = ex2(m[hf] - mn);
        m[hf] = mn;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C::BN / 8; ++j)
#pragma unroll
          for (int i = 2 * hf; i < 2 * hf + 2; ++i) {
            const float p = ex2(fmaf(s[4 * j + i], a.c, -mn));
            s[4 * j + i] = p;
            sum += p;
          }
        l[hf] = fmaf(l[hf], alpha, sum);
#pragma unroll
        for (int nd = 0; nd < C::D / 8; ++nd) {
          o[4 * nd + 2 * hf] *= alpha;
          o[4 * nd + 2 * hf + 1] *= alpha;
        }
      }
      // the probability fragment of k-step j: a lane's keys 8j + 2t4, +1 read
      // as k-indices t4, t4 + 4 (v's stage holds its keys in that order)
      uint32_t pa[C::VS][4];
#pragma unroll
      for (int j = 0; j < C::VS; ++j) {
        pa[j][0] = tf32_bits(s[4 * j]);
        pa[j][1] = tf32_bits(s[4 * j + 2]);
        pa[j][2] = tf32_bits(s[4 * j + 1]);
        pa[j][3] = tf32_bits(s[4 * j + 3]);
      }

      bar_wait(full_v + st, ph);
      wg_fence();
#pragma unroll
      for (int j = 0; j < C::VS; ++j)
        Wgmma<C::D>::mma(o, pa[j], smem_desc(v_smem + st * C::TILE + 256 * j, 128, C::SBO_V));
      wg_commit();
      wg_wait_all();
      fence_regs(o);
      fence_regs(pa);  // read by the product until here
      bar_arrive(empty + st);
    }

    float* ob = a.out + b * a.ob + h * a.oh;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float inv = 1.f / quad_sum(l[hf]);
      const int row = row0 + 8 * hf;
      if (row >= a.n) continue;
      float* orow = ob + (long long)row * a.on;
#pragma unroll
      for (int nd = 0; nd < C::D / 8; ++nd) {
        const int col = nd * 8 + 2 * t4;  // d is a multiple of 4: col + 1 < d too
        if (col < a.d)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[4 * nd + 2 * hf] * inv, o[4 * nd + 2 * hf + 1] * inv);
      }
    }
  }
}

// Raises `kernel`'s shared-memory limit to C::SMEM, once a device.
template <class C, class K>
int smem_limit(K kernel) {
  static unsigned long long ready = 0;  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && !(ready >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready |= 1ull << dev;
  }
  return 0;
}

// One launch of instantiation C.
template <class C>
int run(void (*kernel)(Args), const Args& a, int batch, cudaStream_t stream) {
  const int err = smem_limit<C>(kernel);
  if (err != 0) return err;
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

// cuTensorMapEncodeTiled, looked up through the runtime (no link to
// libcuda); null where it is not found.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A TMA map of k or v (`base`: the first element of q, k or v) as a 4-D
// tensor (dimension, head, token, batch), strides rising, boxes of `width`
// dimensions × BN tokens of one head.
bool tensor_map(CUtensorMap* map, const float* base, const Args& a, int batch, int width, int bn) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.d), static_cast<cuuint64_t>(a.heads),
                              static_cast<cuuint64_t>(a.n), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(a.sh) * 4,
                                 static_cast<cuuint64_t>(a.sn) * 4,
                                 static_cast<cuuint64_t>(a.sb) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(width), 1, static_cast<cuuint32_t>(bn), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <class C>
int run_sm90(const Args& a, int batch, cudaStream_t s) {
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, a.qkv + a.sw, a, batch, 4, C::BN) ||
      !tensor_map(&tv, a.qkv + 2 * a.sw, a, batch, C::D, C::BN))
    return static_cast<int>(cudaErrorNotSupported);
  const int err = smem_limit<C>(attention_tf32_kernel_sm90<C>);
  if (err != 0) return err;
  const dim3 grid((a.n + C::BM - 1) / C::BM, batch * a.heads);
  attention_tf32_kernel_sm90<C><<<grid, C::THREADS, C::SMEM, s>>>(tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// softmax(q·kᵀ·scale)·v for every (batch, head) of a packed qkv: element
// (b, token, head, which, dim) at qkv[b·sb + token·sn + head·sh + which·sw
// + dim], the output's at out[b·ob + token·on + head·oh + dim]. `width` is
// the instantiated head width (one of 40, 64, 72, 80, 128, 160, 256, at least
// d); `tile` the tile the wrapper chose: 0 FFMA, 1 TF32 mma.sync, 2 TF32
// wgmma (widths 72 and 128, 16-byte copies only). The wrapper checks every
// argument. Returns the launch's CUDA error.
int sonar_attention(const float* qkv, long long sb, long long sn, long long sh, long long sw,
                    int batch, int n, int heads, int d, int width, float* out, long long ob,
                    long long on, long long oh, float scale, int tile, void* stream) {
  const bool vec = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 && sb % 4 == 0 && sn % 4 == 0 &&
                   sh % 4 == 0 && sw % 4 == 0 && d % 4 == 0;
  Args a{qkv, sb, sn, sh, sw, out, ob, on, oh, n, heads, d, scale * kLog2e, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 2 && vec) {
    switch (width) {
      case 72: return run_sm90<Sm90<72>>(a, batch, s);
      case 128: return run_sm90<Sm90<128>>(a, batch, s);
    }
  } else if (tile == 1) {
    switch (width) {
      case 40: return run_tf32<Tf32<40, 2>>(a, batch, s);
      case 64: return run_tf32<Tf32<64, 2>>(a, batch, s);
      case 72: return run_tf32<Tf32<72, 2>>(a, batch, s);
      case 80: return run_tf32<Tf32<80, 2>>(a, batch, s);
      case 128: return run_tf32<Tf32<128, 2>>(a, batch, s);
      case 160: return run_tf32<Tf32<160, 1>>(a, batch, s);
      case 256: return run_tf32<Tf32<256, 1>>(a, batch, s);
    }
  } else if (tile == 0) {
    switch (width) {
      case 40: return run_ffma<Ffma<40, 64, 32, 8>>(a, batch, s);
      case 64: return run_ffma<Ffma<64, 32, 32, 4>>(a, batch, s);
      case 72: return run_ffma<Ffma<72, 32, 32, 4>>(a, batch, s);
      case 80: return run_ffma<Ffma<80, 32, 32, 4>>(a, batch, s);
      case 128: return run_ffma<Ffma<128, 16, 32, 4>>(a, batch, s);
      case 160: return run_ffma<Ffma<160, 16, 32, 4>>(a, batch, s);
      case 256: return run_ffma<Ffma<256, 16, 32, 4>>(a, batch, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
