// brpc_mla_attn_fwd / brpc_mla_attn_bwd: causal softmax attention for
// multi-head latent attention (MLA) in fp32, query-key width 192 and value
// width 128, forward and backward, on the tensor cores in 3xTF32.
//
//   o   = softmax(q.k^T * scale, causal) . v          [b, h, s, 128]
//   lse = log(sum_k exp(q.k^T * scale))  (natural)     [b, h, s]
//
//   backward, with p = exp(q.k^T * scale - lse) recomputed:
//   D   = rowsum(do * o)
//   dv  = p^T . do
//   ds  = p * (do.v^T - D) * scale
//   dk  = ds^T . q,   dq = ds . k
//
// Replaces no TPU kernel: the JAX package has no MLA model. It takes the
// place of scaled_dot_product_attention's memory-efficient fp32 pair
// (fmha_cutlassF/B_f32, CUDA-core products) on the MLA + MoE stack's
// attention core (models/mla_moe.py), the one caller.
//
// Bound on an H100: at the stack's layer (b 2, h 16, s 8192, causal) the
// forward does 640 FLOP a (query, legal key) pair and head (q.k^T at 192,
// p.v at 128), the backward 1664 (q.k^T, do.v^T, p^T.do, ds^T.q, ds.k):
// 0.687e12 and 1.786e12 FLOP, against ~0.1 GB of operands each way, so
// arithmetic bounds both. In 3xTF32 (three TF32 products for each fp32
// one) at the dense TF32 peak of 495 TFLOP/s that is 4.2 ms and 10.8 ms;
// mma.sync's own TF32 rate on this card (~318 TFLOP/s,
// tools/mma_tf32_rate.py) makes it 6.5 ms and 16.8 ms.
//
// Arithmetic, as flash_attention.cu's flash_tf32x3_kernel takes it: every
// product is mma.sync m16n8k8 tf32 with each operand x split in registers
// into big = x rounded to TF32 (cvt.rna.tf32.f32's rule, on the bits) and
// small = x - big; a product is small.big + big.small + big.big into an
// fp32 accumulator. Softmax, exp, the log-sum-exp and every sum stay fp32.
// The tensor core truncates the sum it accumulates into at every step. A
// short sum (a score over the 192 of the width) keeps its cross terms in
// an accumulator of their own, as K3's q.k^T does; a long one (o over up
// to 8192 keys, dk and dv over up to 8192 rows, ~1000 steps, which would
// shrink by ~1e-4) is summed in parts of 8 to 64 keys or rows in a fresh
// accumulator, each part added to it outside the tensor core, rounded to
// nearest.
//
// Design.
// - mla_fwd_kernel: one block of 8 warps owns 128 q rows of one (b, h), 16
//   a warp, with the scores and the output in registers, and walks the
//   live 64-key tiles (the causal diagonal's and those before it). Q is
//   copied to shared memory once; K and V tiles go through one buffer
//   each by cp.async, K's next tile copied under this tile's softmax and
//   p.v, V's next under the next q.k^T. A tile's p.v is summed apart and
//   folded into o with its correction, o = o * corr + p.v. q tiles are
//   issued heaviest first.
// - mla_bwd_prep_kernel: D = rowsum(do * o), one warp a row, and dq's rows
//   set to 0 for the main kernel's sums.
// - mla_bwd_kernel: one block of 8 warps owns 64 keys of one (b, h) and
//   walks the q rows from the diagonal down, 64 at a time. Two warps share
//   each 16 keys: each computes s^T = k.q^T and dp^T = v.do^T for its 32
//   of the step's rows, with the keys as the mma's rows, and p^T and ds^T
//   go to shared memory; each then adds the step's 64 rows to its half of
//   the columns of dv += p^T.do and dk += ds^T.q, which it holds in
//   registers (80 floats a thread) from the first row to the last, a
//   step's part summed apart (rows 2t, 2t+1 of each 8 as the k indices t,
//   t+4, p^T and ds^T read as float2). The block then computes its part of
//   dq for the step's rows, ds.k over its 64 keys, and adds it to dq with
//   fp32 atomics (so dq's sum over key tiles runs in no fixed order),
//   while the next rows of q and do are copied in. A warp whose keys all
//   lie after its rows writes zeros and skips its products; dq's sum stops
//   at the last key some row sees. Key tiles are issued heaviest (the
//   first) first.
// - Shared-memory strides are 4 mod 32 floats for the operands read as
//   scalars at (row g, column t) and (row 2t, column g), conflict-free for
//   both, and 8 mod 32 where float2 reads at (row g, column 2t) are used
//   (the forward's Q and K, the backward's p^T and ds^T).
// - Rows past s are read as zeros and never stored; keys past s lie after
//   every row that is stored, so the causal mask removes them.
//
// q, k, v, o and do are [b, h, s, width] views with unit stride along the
// width and 16-byte aligned rows; the outputs (o, lse, D, dq, dk, dv) are
// contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kDqk = 192;  // query-key width: 128 nope + 64 rope
constexpr int kDv = 128;   // value width
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// A [b, h, s, width] fp32 view: element strides of b, h and s.
struct View {
  const float* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const float* at(int b, int h) const {
    return p + b * sb + h * sh;
  }
};

struct FwdParams {
  View q, k, v;
  float* o;    // [b*h, s, 128]
  float* lse;  // [b*h, s]
  int h, s;
  float scale;
};

struct BwdParams {
  View q, k, v, o, dout;
  const float* lse;  // [b*h, s]
  float* delta;      // [b*h, s]
  float* dq;         // [b*h, s, 192], summed into
  float* dk;         // [b*h, s, 192]
  float* dv;         // [b*h, s, 128]
  int h, s;
  float scale;
};

// ---- the tensor-core helpers of flash_attention.cu, as they are there

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 2^x on the special function unit (ex2.approx.ftz: relative error
// about 2^-22, results below 2^-126 flushed to 0; 2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // bytes 0: the 16 bytes at dst are zero-filled and nothing is read.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small for 3xTF32. big is x rounded to TF32 (10 mantissa
// bits), to nearest with ties away from zero: cvt.rna.tf32.f32's rule,
// done on the bits (add half an ulp to the magnitude, drop 13 bits),
// which keeps it on the integer pipe. small = x - big is exact in fp32;
// the tensor core reads its top 19 bits (truncation).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a . b, a 16x8 (row), b 8x8 (col), tf32 in, fp32 accumulate.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32: the two cross terms, then big . big, into the
// same fp32 accumulator (small . small, ~2^-22 relative, is dropped).
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_big,
                                           const uint32_t* a_small,
                                           const uint32_t* b_big,
                                           const uint32_t* b_small) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// ---- copies

// Rows [r0, r0 + ROWS) of a [n, W] fp32 matrix (row stride ss floats, 16-
// byte aligned rows) into shared memory at row stride LD, in 16-byte
// copies; rows past n read as zeros.
template <int ROWS, int W, int LD, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src,
                                          long long ss, int r0, int n) {
  constexpr int kChunks = W / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * kChunks; e += THREADS) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r0 + r < n;
    cp_async16(dst + 4 * (r * LD + 4 * c), ok ? src + (r0 + r) * ss + 4 * c
                                              : src,
               ok ? 16 : 0);
  }
}

// A 4-byte split from a 3xTF32 operand pair read as scalars.
struct Frag4 {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ void split4(float a0, float a1, float a2,
                                       float a3, Frag4& f) {
  split_tf32(a0, f.big[0], f.small[0]);
  split_tf32(a1, f.big[1], f.small[1]);
  split_tf32(a2, f.big[2], f.small[2]);
  split_tf32(a3, f.big[3], f.small[3]);
}

// ------------------------------------------------------------ forward

struct Fwd {
  static constexpr int kThreads = 256;  // 8 warps
  static constexpr int kBM = 128;         // q rows a block, 16 a warp
  static constexpr int kBN = 64;          // keys a tile
  static constexpr int kLdQK = kDqk + 8;  // 200: float2 at (row g, col 2t)
  static constexpr int kLdV = kDv + 4;    // 132: scalars at (key 2t, col g)
  static constexpr int kQFloats = kBM * kLdQK;
  static constexpr int kKFloats = kBN * kLdQK;
  static constexpr int kVFloats = kBN * kLdV;
  static constexpr int kSmem = 4 * (kQFloats + kKFloats + kVFloats);
};

__global__ void __launch_bounds__(Fwd::kThreads, 1)
    mla_fwd_kernel(FwdParams p) {
  constexpr int kBM = Fwd::kBM, kBN = Fwd::kBN, kThreads = Fwd::kThreads;
  constexpr int kLdQK = Fwd::kLdQK, kLdV = Fwd::kLdV;
  extern __shared__ float4 smem_f4[];
  float* const sQ = reinterpret_cast<float*>(smem_f4);
  float* const sK = sQ + Fwd::kQFloats;
  float* const sV = sK + Fwd::kKFloats;

  // Heaviest q tiles first (the last rows see the most keys).
  const int n_qt = (p.s + kBM - 1) / kBM;
  const int n_bh = gridDim.x / n_qt;
  const int rank = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int m0 = (n_qt - 1 - rank) * kBM;
  const int b = bh / p.h, hh = bh % p.h;
  const float* const Q = p.q.at(b, hh);
  const float* const K = p.k.at(b, hh);
  const float* const V = p.v.at(b, hh);
  const int last_row = (m0 + kBM < p.s ? m0 + kBM : p.s) - 1;
  const int n_tiles = last_row / kBN + 1;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_w = m0 + 16 * warp;  // the warp's first row
  const int r_lo = r_w + g;        // this thread's rows: +0, +8

  const uint32_t q_s = smem_u32(sQ), k_s = smem_u32(sK), v_s = smem_u32(sV);
  load_rows<kBM, kDqk, kLdQK, kThreads>(q_s, Q, p.q.ss, m0, p.s);
  load_rows<kBN, kDqk, kLdQK, kThreads>(k_s, K, p.k.ss, 0, p.s);
  cp_async_commit();
  load_rows<kBN, kDv, kLdV, kThreads>(v_s, V, p.v.ss, 0, p.s);
  cp_async_commit();

  constexpr int kNO = kDv / 2;  // o floats a thread: 16 blocks of 4
  float m_row[2] = {kNeg, kNeg}, l_row[2] = {0.f, 0.f}, o[kNO];
#pragma unroll
  for (int i = 0; i < kNO; ++i) o[i] = 0.f;
  const float* const q_lo = sQ + (16 * warp + g) * kLdQK + 2 * t;
  const float* const q_hi = q_lo + 8 * kLdQK;
  const float* const k_t = sK + g * kLdQK + 2 * t;
  const float* const v_t = sV + 2 * t * kLdV + g;
  const float c = p.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBN;
    cp_async_wait<1>();  // K tile j (and Q) landed, for this thread ...
    __syncthreads();     // ... and for every thread
    // s = q . k^T, 8 of the width at a time: big.big into s, the two
    // cross terms into s2, added once at the end.
    float s[kBN / 2], s2[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] = s2[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDqk / 8; ++kk) {
      const float2 lo = *reinterpret_cast<const float2*>(q_lo + 8 * kk);
      const float2 hi = *reinterpret_cast<const float2*>(q_hi + 8 * kk);
      Frag4 a;
      split4(lo.x, hi.x, lo.y, hi.y, a);
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
        const float2 kv = *reinterpret_cast<const float2*>(
            k_t + nb * 8 * kLdQK + 8 * kk);
        uint32_t bb[2], bs[2];
        split_tf32(kv.x, bb[0], bs[0]);
        split_tf32(kv.y, bb[1], bs[1]);
        mma_tf32(s2 + 4 * nb, a.small, bb);
        mma_tf32(s2 + 4 * nb, a.big, bs);
        mma_tf32(s + 4 * nb, a.big, bb);
      }
    }
    __syncthreads();  // every warp is done with K tile j
    if (j + 1 < n_tiles) {
      load_rows<kBN, kDqk, kLdQK, kThreads>(k_s, K, p.k.ss, k0 + kBN, p.s);
    }
    cp_async_commit();  // possibly empty: the count stays uniform

    // Online softmax of the warp's 16 rows (element i of a thread: row
    // r_lo + 8*((i>>1)&1), key k0 + 8*(i>>2) + 2t + (i&1)); keys after a
    // row are masked on the tiles that hold some.
    const bool mask = r_w < k0 + kBN - 1;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      s[i] += s2[i];
      if (mask) {
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const int row = r_lo + ((i >> 1) & 1) * 8;
        if (col > row) s[i] = -INFINITY;
      }
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float corr[2], mc[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // max(s * scale) == max(s) * scale: a positive scale keeps the order;
      // a row that sees no key of the tile keeps its max.
      const float m_new = fmaxf(fmaxf(m_row[r], mx[r] * p.scale), kNeg);
      corr[r] = ex2((m_row[r] - m_new) * kLog2e);
      m_row[r] = m_new;
      mc[r] = m_new * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      // exp(s*scale - m) as one FFMA and ex2; a masked lane (-inf) gives 0.
      s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
      rsum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_row[r] = l_row[r] * corr[r] + rsum[r];
    }
    cp_async_wait<1>();  // V tile j landed
    __syncthreads();
    // o = o * corr + p . v, the tile's p . v summed apart from o: the
    // tensor core truncates the sum it accumulates into, which over a
    // row's ~1000 steps would shrink o by ~1e-4; here o takes each tile's
    // part rounded to nearest. p's A fragment is its own accumulator
    // fragment with keys 2t, 2t+1 of each 8 as k indices t, t+4.
    float pv[kNO];
#pragma unroll
    for (int i = 0; i < kNO; ++i) pv[i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kBN / 8; ++kb) {
      Frag4 a;
      split4(s[4 * kb + 0], s[4 * kb + 2], s[4 * kb + 1], s[4 * kb + 3], a);
      const float* const v_k = v_t + kb * 8 * kLdV;
#pragma unroll
      for (int nd = 0; nd < kDv / 8; ++nd) {
        uint32_t bb[2], bs[2];
        split_tf32(v_k[8 * nd], bb[0], bs[0]);
        split_tf32(v_k[kLdV + 8 * nd], bb[1], bs[1]);
        mma_3xtf32(pv + 4 * nd, a.big, a.small, bb, bs);
      }
    }
#pragma unroll
    for (int i = 0; i < kNO; ++i) {
      o[i] = fmaf(o[i], corr[(i >> 1) & 1], pv[i]);
    }
    __syncthreads();  // every warp is done with V tile j
    if (j + 1 < n_tiles) {
      load_rows<kBN, kDv, kLdV, kThreads>(v_s, V, p.v.ss, k0 + kBN, p.s);
    }
    cp_async_commit();
  }

  const size_t row_base = static_cast<size_t>(bh) * p.s;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= p.s) continue;
    const float inv = 1.f / l_row[i];
    if (t == 0) p.lse[row_base + r] = m_row[i] + logf(l_row[i]);
    float* const out = p.o + (row_base + r) * kDv + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kDv / 8; ++nb) {
      *reinterpret_cast<float2*>(out + 8 * nb) =
          make_float2(o[4 * nb + 2 * i] * inv, o[4 * nb + 2 * i + 1] * inv);
    }
  }
}

// ------------------------------------------------------------ backward

// D = rowsum(do * o) for one row a warp; dq's row set to 0.
constexpr int kPrepWarps = 8;

__global__ void __launch_bounds__(32 * kPrepWarps)
    mla_bwd_prep_kernel(BwdParams p, int rows) {
  const int row = blockIdx.x * kPrepWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = row / p.s, r = row % p.s;
  const int b = bh / p.h, hh = bh % p.h;
  const float4 o = *reinterpret_cast<const float4*>(
      p.o.at(b, hh) + r * p.o.ss + 4 * lane);
  const float4 d = *reinterpret_cast<const float4*>(
      p.dout.at(b, hh) + r * p.dout.ss + 4 * lane);
  float acc = o.x * d.x + o.y * d.y + o.z * d.z + o.w * d.w;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) p.delta[row] = acc;
  float4* const dq = reinterpret_cast<float4*>(
      p.dq + static_cast<size_t>(row) * kDqk);
  for (int c = lane; c < kDqk / 4; c += 32) {
    dq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

struct Bwd {
  static constexpr int kThreads = 256;    // 8 warps: 4 key groups x 2
  static constexpr int kBN = 64;          // keys a block, 16 a key group
  static constexpr int kBM = 64;          // q rows a step
  static constexpr int kLdQK = kDqk + 4;  // 196 = 4 mod 32
  static constexpr int kLdV = kDv + 4;    // 132 = 4 mod 32
  static constexpr int kLdP = kBM + 8;    // 72 = 8 mod 32: p^T, ds^T [key][q]
  static constexpr int kKFloats = kBN * kLdQK;
  static constexpr int kVFloats = kBN * kLdV;
  static constexpr int kQFloats = kBM * kLdQK;
  static constexpr int kOFloats = kBM * kLdV;
  static constexpr int kPFloats = kBN * kLdP;
  static constexpr int kSmem =
      4 * (kKFloats + kVFloats + kQFloats + kOFloats + 2 * kPFloats + 2 * kBM);
  static constexpr int kDkCols = kDqk / 2;  // a warp's half of dk's width
  static constexpr int kDvCols = kDv / 2;   // and of dv's
  static constexpr int kDqCols = kDqk / 2;  // and of dq's, in ds.k
};

// The step's q rows [q0, q0 + 64), do rows, and their lse and D, into
// shared memory (rows past s: zeros).
__device__ __forceinline__ void load_q_step(const BwdParams& p,
                                            const float* Q, const float* dO,
                                            size_t row_base, int q0,
                                            uint32_t q_s, uint32_t o_s,
                                            uint32_t l_s, uint32_t d_s) {
  load_rows<Bwd::kBM, kDqk, Bwd::kLdQK, Bwd::kThreads>(q_s, Q, p.q.ss, q0,
                                                       p.s);
  load_rows<Bwd::kBM, kDv, Bwd::kLdV, Bwd::kThreads>(o_s, dO, p.dout.ss, q0,
                                                     p.s);
  const int e = threadIdx.x;
  if (e < 2 * Bwd::kBM) {
    const int r = e % Bwd::kBM;
    const bool ok = q0 + r < p.s;
    const float* const src = e < Bwd::kBM ? p.lse : p.delta;
    cp_async4((e < Bwd::kBM ? l_s : d_s) + 4 * r,
              ok ? src + row_base + q0 + r : src, ok ? 4 : 0);
  }
}

// acc[0..N) += a's 16 rows x (N / 4) blocks of 8 columns of b, over k
// steps of 8: a from shared memory at (row g, columns 2t, 2t+1) as k
// indices t, t+4 (row stride LDA), b at (rows 2t, 2t+1, column g) (row
// stride LDB). Each block of 8 columns sums its KS steps in a fresh
// accumulator, added to acc outside the tensor core (rounded to nearest):
// acc carries a sum over thousands of steps, which the tensor core's
// truncating accumulation would shrink by ~1e-4.
template <int N, int KS, int LDA, int LDB>
__device__ __forceinline__ void mma_rows_add(float (&acc)[N], const float* a,
                                             const float* b) {
  Frag4 fa[KS];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float2 lo = *reinterpret_cast<const float2*>(a + 8 * ks);
    const float2 hi = *reinterpret_cast<const float2*>(a + 8 * LDA + 8 * ks);
    split4(lo.x, hi.x, lo.y, hi.y, fa[ks]);
  }
#pragma unroll
  for (int nd = 0; nd < N / 4; ++nd) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* const bk = b + ks * 8 * LDB + 8 * nd;
      uint32_t bb[2], bs[2];
      split_tf32(bk[0], bb[0], bs[0]);
      split_tf32(bk[LDB], bb[1], bs[1]);
      mma_3xtf32(d, fa[ks].big, fa[ks].small, bb, bs);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[4 * nd + i] += d[i];
  }
}

// out[16 x 32] = a . b^T for a warp: a's 16 rows from shared memory at
// (row g, columns t, t+4) (row stride LDA), b's 32 rows at (row g,
// columns t, t+4) (row stride LDB), over KK steps of 8; big.big and the
// cross terms in two accumulators, added at the end (as the forward's
// q.k^T).
template <int KK, int LDA, int LDB>
__device__ __forceinline__ void mma_nt(float (&out)[16], const float* a,
                                       const float* b) {
  float cross[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = cross[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const float* const ak = a + 8 * kk;
    Frag4 fa;
    split4(ak[0], ak[8 * LDA], ak[4], ak[8 * LDA + 4], fa);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const float* const bk = b + nb * 8 * LDB + 8 * kk;
      uint32_t bb[2], bs[2];
      split_tf32(bk[0], bb[0], bs[0]);
      split_tf32(bk[4], bb[1], bs[1]);
      mma_tf32(cross + 4 * nb, fa.small, bb);
      mma_tf32(cross + 4 * nb, fa.big, bs);
      mma_tf32(out + 4 * nb, fa.big, bb);
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] += cross[i];
}

__global__ void __launch_bounds__(Bwd::kThreads, 1)
    mla_bwd_kernel(BwdParams p) {
  constexpr int kBM = Bwd::kBM, kBN = Bwd::kBN, kThreads = Bwd::kThreads;
  constexpr int kLdQK = Bwd::kLdQK, kLdV = Bwd::kLdV, kLdP = Bwd::kLdP;
  extern __shared__ float4 smem_f4[];
  float* const sK = reinterpret_cast<float*>(smem_f4);
  float* const sV = sK + Bwd::kKFloats;
  float* const sQ = sV + Bwd::kVFloats;
  float* const sO = sQ + Bwd::kQFloats;  // do
  float* const sP = sO + Bwd::kOFloats;  // p^T
  float* const sS = sP + Bwd::kPFloats;  // ds^T * scale
  float* const sL = sS + Bwd::kPFloats;  // lse, then D
  float* const sD = sL + kBM;

  // Heaviest key tiles first (the first keys are seen by the most rows).
  const int n_kt = (p.s + kBN - 1) / kBN;
  const int n_bh = gridDim.x / n_kt;
  const int kt = blockIdx.x / n_bh, bh = blockIdx.x % n_bh;
  const int k0 = kt * kBN;
  const int b = bh / p.h, hh = bh % p.h;
  const float* const Q = p.q.at(b, hh);
  const float* const K = p.k.at(b, hh);
  const float* const V = p.v.at(b, hh);
  const float* const dO = p.dout.at(b, hh);
  const size_t row_base = static_cast<size_t>(bh) * p.s;
  const int n_steps = (p.s + kBM - 1) / kBM;
  const int first = k0 / kBM;  // the step holding row k0

  // Warp w: key group kg (16 keys), half hf: the step's rows [32 hf, 32 hf
  // + 32) in p^T and dp^T, and the columns of its half of dk and dv.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp & 3, hf = warp >> 2;
  const int key_w = k0 + 16 * kg;  // the group's first key

  const uint32_t k_s = smem_u32(sK), v_s = smem_u32(sV), q_s = smem_u32(sQ),
                 o_s = smem_u32(sO), l_s = smem_u32(sL), d_s = smem_u32(sD);
  load_rows<kBN, kDqk, kLdQK, kThreads>(k_s, K, p.k.ss, k0, p.s);
  load_rows<kBN, kDv, kLdV, kThreads>(v_s, V, p.v.ss, k0, p.s);
  load_q_step(p, Q, dO, row_base, first * kBM, q_s, o_s, l_s, d_s);
  cp_async_commit();

  float dk[Bwd::kDkCols / 2], dv[Bwd::kDvCols / 2];  // m16n8 layout
#pragma unroll
  for (int i = 0; i < Bwd::kDkCols / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < Bwd::kDvCols / 2; ++i) dv[i] = 0.f;
  const float c = p.scale * kLog2e;
  // The group's rows of p^T and ds^T in shared memory.
  float* const p_row = sP + (16 * kg + g) * kLdP + 32 * hf + 2 * t;
  float* const s_row = sS + (16 * kg + g) * kLdP + 32 * hf + 2 * t;

  for (int step = first; step < n_steps; ++step) {
    const int q0 = step * kBM;
    const int r_w = q0 + 32 * hf;  // the warp's first row in p^T
    cp_async_wait<0>();
    __syncthreads();  // the step's q, do, lse and D landed
    if (key_w <= r_w + 31) {  // some row of the warp's 32 sees a key
      // s^T = k . q^T and dp^T = v . do^T: 16 keys x 32 rows.
      float st[16], dp[16];
      mma_nt<kDqk / 8, kLdQK, kLdQK>(st, sK + (16 * kg + g) * kLdQK + t,
                                     sQ + (32 * hf + g) * kLdQK + t);
      mma_nt<kDv / 8, kLdV, kLdV>(dp, sV + (16 * kg + g) * kLdV + t,
                                  sO + (32 * hf + g) * kLdV + t);
      // p^T = exp(s^T * scale - lse), 0 where the key lies after the row
      // (element i: key key_w + g + 8*((i>>1)&1), row r_w + 8*(i>>2) +
      // 2t + (i&1)); ds^T = p^T * (dp^T - D) * scale.
      const bool mask = r_w < key_w + 15;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int col = 32 * hf + 8 * nb + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(sL + col);
        const float2 d2 = *reinterpret_cast<const float2*>(sD + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * nb + e;
          float pv = ex2(fmaf(st[i], c, -(e & 1 ? l2.y : l2.x) * kLog2e));
          if (mask && key_w + g + 8 * (e >> 1) > r_w + 8 * nb + 2 * t +
                                                     (e & 1)) {
            pv = 0.f;
          }
          st[i] = pv;
          dp[i] = pv * (dp[i] - (e & 1 ? d2.y : d2.x)) * p.scale;
        }
        *reinterpret_cast<float2*>(p_row + 8 * nb) =
            make_float2(st[4 * nb], st[4 * nb + 1]);
        *reinterpret_cast<float2*>(p_row + 8 * kLdP + 8 * nb) =
            make_float2(st[4 * nb + 2], st[4 * nb + 3]);
        *reinterpret_cast<float2*>(s_row + 8 * nb) =
            make_float2(dp[4 * nb], dp[4 * nb + 1]);
        *reinterpret_cast<float2*>(s_row + 8 * kLdP + 8 * nb) =
            make_float2(dp[4 * nb + 2], dp[4 * nb + 3]);
      }
    } else {  // every key after every row: p^T and ds^T are 0
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const float2 z = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(p_row + 8 * nb) = z;
        *reinterpret_cast<float2*>(p_row + 8 * kLdP + 8 * nb) = z;
        *reinterpret_cast<float2*>(s_row + 8 * nb) = z;
        *reinterpret_cast<float2*>(s_row + 8 * kLdP + 8 * nb) = z;
      }
    }
    __syncthreads();  // p^T and ds^T complete
    // dv += p^T . do and dk += ds^T . q over the step's 64 rows, in two
    // halves of 32 (rows 2t, 2t+1 of each 8 as the k indices t, t+4).
    if (key_w <= q0 + kBM - 1) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 32 * half;
        mma_rows_add<Bwd::kDvCols / 2, 4, kLdP, kLdV>(
            dv, sP + (16 * kg + g) * kLdP + r + 2 * t,
            sO + (r + 2 * t) * kLdV + Bwd::kDvCols * hf + g);
        mma_rows_add<Bwd::kDkCols / 2, 4, kLdP, kLdQK>(
            dk, sS + (16 * kg + g) * kLdP + r + 2 * t,
            sQ + (r + 2 * t) * kLdQK + Bwd::kDkCols * hf + g);
      }
    }
    __syncthreads();  // q, do, lse and D are free
    if (step + 1 < n_steps) {
      load_q_step(p, Q, dO, row_base, q0 + kBM, q_s, o_s, l_s, d_s);
    }
    cp_async_commit();

    // dq[q0 + 16*mb + ..] += ds . k over the block's keys that some row
    // sees, the warp's half of the columns; keys 2t, 2t+1 of each 8 as the
    // k indices t, t+4 (ds^T's rows and k's rows read so).
    const int mb = warp & 3, col0 = (warp >> 2) * Bwd::kDqCols;
    const int last_key = q0 + 16 * mb + 15 - k0;  // keys past it add 0
    if (last_key >= 0) {
      const int n_ks = last_key / 8 + 1 < kBN / 8 ? last_key / 8 + 1
                                                  : kBN / 8;
      float acc[Bwd::kDqCols / 2];
#pragma unroll
      for (int i = 0; i < Bwd::kDqCols / 2; ++i) acc[i] = 0.f;
      const float* const s_a = sS + 2 * t * kLdP + 16 * mb + g;
      const float* const k_b = sK + 2 * t * kLdQK + col0 + g;
      for (int ks = 0; ks < n_ks; ++ks) {
        const float* const sa = s_a + ks * 8 * kLdP;
        Frag4 a;
        split4(sa[0], sa[8], sa[kLdP], sa[kLdP + 8], a);
        const float* const kb = k_b + ks * 8 * kLdQK;
#pragma unroll
        for (int nd = 0; nd < Bwd::kDqCols / 8; ++nd) {
          uint32_t bb[2], bs[2];
          split_tf32(kb[8 * nd], bb[0], bs[0]);
          split_tf32(kb[kLdQK + 8 * nd], bb[1], bs[1]);
          mma_3xtf32(acc + 4 * nd, a.big, a.small, bb, bs);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = q0 + 16 * mb + g + 8 * i;
        if (r >= p.s) continue;
        float* const dq = p.dq + (row_base + r) * kDqk + col0 + 2 * t;
#pragma unroll
        for (int nd = 0; nd < Bwd::kDqCols / 8; ++nd) {
          atomicAdd(reinterpret_cast<float2*>(dq + 8 * nd),
                    make_float2(acc[4 * nd + 2 * i],
                                acc[4 * nd + 2 * i + 1]));
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_w + g + 8 * i;
    if (key >= p.s) continue;
    float* const dk_row =
        p.dk + (row_base + key) * kDqk + Bwd::kDkCols * hf + 2 * t;
    float* const dv_row =
        p.dv + (row_base + key) * kDv + Bwd::kDvCols * hf + 2 * t;
#pragma unroll
    for (int nd = 0; nd < Bwd::kDkCols / 8; ++nd) {
      *reinterpret_cast<float2*>(dk_row + 8 * nd) =
          make_float2(dk[4 * nd + 2 * i], dk[4 * nd + 2 * i + 1]);
    }
#pragma unroll
    for (int nd = 0; nd < Bwd::kDvCols / 8; ++nd) {
      *reinterpret_cast<float2*>(dv_row + 8 * nd) =
          make_float2(dv[4 * nd + 2 * i], dv[4 * nd + 2 * i + 1]);
    }
  }
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// A view the kernels take: 16-byte aligned base, strides in whole 16-byte
// units (the width's stride is 1 by the caller's check).
bool fits(const float* ptr, const long long* st) {
  return aligned(ptr) && st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0;
}

View view(const float* ptr, const long long* st) {
  return View{ptr, st[0], st[1], st[2]};
}

}  // namespace

// q, k [b, h, s, 192] and v [b, h, s, 128], fp32 views with unit stride
// along the width; strides: b, h and s strides of q, k, v in that order (9
// values, in elements). Writes o [b, h, s, 128] and lse [b, h, s], both
// contiguous. Returns cudaGetLastError().
extern "C" int brpc_mla_attn_fwd(const float* q, const float* k,
                                 const float* v, const long long* strides,
                                 float* o, float* lse, int b, int h, int s,
                                 float scale, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || s <= 0) return 0;
  if (!fits(q, strides) || !fits(k, strides + 3) || !fits(v, strides + 6) ||
      !aligned(o)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      static_cast<long long>(b) * h * ((s + Fwd::kBM - 1) / Fwd::kBM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{view(q, strides), view(k, strides + 3), view(v, strides + 6),
              o, lse, h, s, scale};
  cudaError_t err = cudaFuncSetAttribute(
      mla_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Fwd::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_fwd_kernel<<<static_cast<int>(blocks), Fwd::kThreads, Fwd::kSmem,
                   stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The forward's q, k, v (strides as there) and its o and lse, do [b, h,
// s, 128] (its b, h and s strides after the forward's 9 in strides: 15
// values, o's taken as contiguous); delta [b, h, s] is scratch. Writes
// dq, dk [b, h, s, 192] and dv [b, h, s, 128], contiguous. Returns
// cudaGetLastError().
extern "C" int brpc_mla_attn_bwd(const float* q, const float* k,
                                 const float* v, const float* o,
                                 const float* dout, const float* lse,
                                 const long long* strides, float* delta,
                                 float* dq, float* dk, float* dv, int b,
                                 int h, int s, float scale,
                                 cudaStream_t stream) {
  if (b <= 0 || h <= 0 || s <= 0) return 0;
  const long long o_st[3] = {static_cast<long long>(h) * s * kDv,
                             static_cast<long long>(s) * kDv, kDv};
  if (!fits(q, strides) || !fits(k, strides + 3) || !fits(v, strides + 6) ||
      !fits(dout, strides + 9) || !aligned(o) || !aligned(dq) ||
      !aligned(dk) || !aligned(dv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(b) * h * s;
  const long long blocks =
      static_cast<long long>(b) * h * ((s + Bwd::kBN - 1) / Bwd::kBN);
  if (rows > 0x7fffffffLL || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p{view(q, strides),      view(k, strides + 3),
              view(v, strides + 6),  view(o, o_st),
              view(dout, strides + 9), lse, delta, dq, dk, dv, h, s, scale};
  const int n = static_cast<int>(rows);
  mla_bwd_prep_kernel<<<(n + kPrepWarps - 1) / kPrepWarps, 32 * kPrepWarps,
                        0, stream>>>(p, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mla_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Bwd::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_bwd_kernel<<<static_cast<int>(blocks), Bwd::kThreads, Bwd::kSmem,
                   stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
