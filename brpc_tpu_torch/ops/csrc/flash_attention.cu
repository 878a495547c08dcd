// brpc_flash_carry: one online-softmax attention pass that folds k/v into
// fp32 carries (m, l, acc) for the queries q.
//
//   s   = (q . k^T) * scale            fp32, scale = 1/sqrt(d) after the product
//   s   = causal ? (q_pos >= k_pos ? s : -1e30) : s
//   m'  = max(m, rowmax(s))
//   p   = exp(s - m'), forced to 0 on masked lanes
//   l'  = l * exp(m - m') + rowsum(p)
//   acc'= acc * exp(m - m') + round_to_input_type(p) . v
//
// applied k tile after k tile. Replaces the Pallas kernel _carry_kernel
// (brpc_tpu/ops/flash_attention.py:47, pallas_call at :139), which the ring
// of brpc_tpu/ops/ring_attention.py folds once per hop.
//
// Bound on an H100: at the main path's shapes (Llama 3 8B attention,
// b=1 h=32 hkv=8 s=8192 d=128 causal; bench.py's b=8 h=8 s=4096 d=128
// non-causal) the work is 5.50e11 FLOP either way, 0.556 ms at the card's
// 989 TFLOP/s dense bf16, against 0.11-0.14 ms for the bytes: arithmetic
// bounds it, so the products belong on the tensor cores.
//
// Design. The TPU kernel walks k blocks as a sequential grid dimension and
// revisits its output block; here one thread block owns one (q tile, b*h)
// pair and loops over the k tiles itself, reading the carries once and
// writing them once. Two kernels:
//
// - flash_tc_kernel<D> (bf16, d = 64 or 128, 16-byte aligned operands): a
//   64-row q tile over 4 warps, 64-key tiles double-buffered in shared
//   memory with cp.async, q.k^T and p.v on the tensor cores with
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate) fed by ldmatrix, rows
//   padded by 8 elements so ldmatrix is free of bank conflicts. The score
//   tile and the carries live in registers; p is rounded to bf16 when it
//   is packed into the A operand of p.v, as the TPU kernel rounds it with
//   p.astype(v.dtype). The causal skip trims the k loop to the tiles whose
//   first key is not after the tile's last query, and q tiles are issued
//   heaviest first so the diagonal's tail does not idle the card.
// - flash_simt_kernel<T> (fp32 or bf16, any d <= 256): the same algorithm
//   on plain fp32 arithmetic, 16 q rows by 32-key tiles in shared memory,
//   for the shapes the tensor-core kernel does not take.
//
// Global positions are q_off + row and kv_off + col, with the two offsets
// read from a device int32[2] (as the TPU kernel reads them from SMEM) or
// passed by value. Keys past sk are masked like causal ones; rows past sq
// are computed on zeros and never stored. exp is expf, not __expf.
// A wgmma/TMA design (FA3-style) is the way to the bound; this kernel is
// the first, right one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the TPU kernel's finite "never attended"

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
  const int* offsets;  // int32[2] on the device, or null: use q_off/kv_off
  int q_off, kv_off;
  int h, hkv, sq, sk, d;
  int causal;
  float scale;
};

__device__ __forceinline__ void read_offsets(const Params& p, int* q_off,
                                             int* kv_off) {
  if (p.offsets != nullptr) {
    *q_off = p.offsets[0];
    *kv_off = p.offsets[1];
  } else {
    *q_off = p.q_off;
    *kv_off = p.kv_off;
  }
}

// k tiles of width bn that hold a key some row of [m0, m0 + bm) attends.
__device__ __forceinline__ int live_tiles(const Params& p, int q_off,
                                          int kv_off, int m0, int bm,
                                          int bn) {
  int n = (p.sk + bn - 1) / bn;
  if (p.causal) {
    const int last_row = (m0 + bm < p.sq ? m0 + bm : p.sq) - 1;
    const long long span = static_cast<long long>(q_off) + last_row - kv_off;
    const long long need = span < 0 ? 0 : span / bn + 1;
    if (need < n) n = static_cast<int>(need);
  }
  return n;
}

__device__ __forceinline__ bool legal(const Params& p, int q_off, int kv_off,
                                      int row, int col) {
  if (col >= p.sk) return false;
  return !p.causal || q_off + row >= kv_off + col;
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a . b for a 16x16 bf16 A (row major), a 16x8 bf16 B, fp32 c.
__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<unsigned*>(&v);
}

template <int D>
struct TcShape {
  static constexpr int kBM = 64;      // q rows per block: 4 warps x 16
  static constexpr int kBN = 64;      // keys per tile
  static constexpr int kThreads = 128;
  static constexpr int kLd = D + 8;   // padded smem row (elements)
  // q tile + 2 stages of (k tile, v tile), bf16.
  static constexpr int kSmem = (kBM + 4 * kBN) * kLd * 2;
};

// rows x D bf16 rows [row0, row0 + rows) of a [n_rows, D] matrix into smem;
// rows at or past n_rows read as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLd = TcShape<D>::kLd;
  for (int c = tid; c < ROWS * kChunks; c += TcShape<D>::kThreads) {
    const int r = c / kChunks;
    const int cc = c % kChunks;
    const int gr = row0 + r;
    const bool ok = gr < n_rows;
    cp_async16(sm + r * kLd + cc * 8,
               g + static_cast<size_t>(ok ? gr : 0) * D + cc * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_tc_kernel(Params p) {
  using S = TcShape<D>;
  constexpr int kBM = S::kBM, kBN = S::kBN, kLd = S::kLd;
  constexpr int kKD = D / 16;   // k16 steps of q.k^T
  constexpr int kND = D / 8;    // n8 blocks of the output
  constexpr int kNN = kBN / 8;  // n8 blocks of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBM * kLd;      // 2 stages
  __nv_bfloat16* sV = sK + 2 * kBN * kLd;  // 2 stages

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.h, hh = bh % p.h;
  const int kvh = hh / (p.h / p.hkv);
  int q_off, kv_off;
  read_offsets(p, &q_off, &kv_off);

  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(p.q) + static_cast<size_t>(bh) * p.sq * D;
  const size_t kv_base = static_cast<size_t>(b * p.hkv + kvh) * p.sk * D;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) + kv_base;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) + kv_base;

  // Carries of this thread's two rows: r_lo and r_lo + 8.
  const int r_lo = m0 + warp * 16 + g;
  const size_t row_base = static_cast<size_t>(bh) * p.sq;
  float m_row[2], l_row[2];
  float o[kND][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    const bool ok = r < p.sq;
    m_row[i] = ok ? p.m_in[row_base + r] : kNeg;
    l_row[i] = ok ? p.l_in[row_base + r] : 0.f;
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      float2 a = make_float2(0.f, 0.f);
      if (ok) {
        a = *reinterpret_cast<const float2*>(
            p.acc_in + (row_base + r) * D + 8 * j + 2 * t);
      }
      o[j][2 * i] = a.x;
      o[j][2 * i + 1] = a.y;
    }
  }

  const int n_tiles = live_tiles(p, q_off, kv_off, m0, kBM, kBN);
  if (n_tiles > 0) {
    load_tile<D, kBM>(sQ, Q, m0, p.sq, tid);
    load_tile<D, kBN>(sK, K, 0, p.sk, tid);
    load_tile<D, kBN>(sV, V, 0, p.sk, tid);
  }
  cp_async_commit();

  unsigned qf[kKD][4];
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int st = jt & 1;
    if (jt + 1 < n_tiles) {
      load_tile<D, kBN>(sK + (st ^ 1) * kBN * kLd, K, (jt + 1) * kBN, p.sk,
                        tid);
      load_tile<D, kBN>(sV + (st ^ 1) * kBN * kLd, V, (jt + 1) * kBN, p.sk,
                        tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the prefetch just issued
    __syncthreads();

    if (jt == 0) {
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                            (lane >> 4) * 8);
      }
    }

    // s = q . k^T for this warp's 16 rows and the tile's 64 keys.
    float s[kNN][4];
#pragma unroll
    for (int nb = 0; nb < kNN; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    }
    const __nv_bfloat16* sKs = sK + st * kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kNN; nb += 2) {
        unsigned bfrag[4];
        ldsm_x4(bfrag, sKs + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[nb], qf[kk], bfrag[0], bfrag[1]);
        mma16816(s[nb + 1], qf[kk], bfrag[2], bfrag[3]);
      }
    }

    // Scale, mask, and the new running max.
    const int k0 = jt * kBN;
    unsigned mask = 0;  // bit nb*4+e: lane (nb, e) is legal
    float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
    for (int nb = 0; nb < kNN; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + 2 * t + (e & 1);
        const int row = r_lo + (e >> 1) * 8;
        const float x = s[nb][e] * p.scale;
        const bool ok = legal(p, q_off, kv_off, row, col);
        mask |= (ok ? 1u : 0u) << (nb * 4 + e);
        s[nb][e] = ok ? x : kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) corr[i] = expf(m_row[i] - mx[i]);
#pragma unroll
    for (int nb = 0; nb < kNN; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = ((mask >> (nb * 4 + e)) & 1u)
                             ? expf(s[nb][e] - mx[e >> 1])
                             : 0.f;
        s[nb][e] = pv;
        rsum[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l_row[i] = l_row[i] * corr[i] + rsum[i];
      m_row[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // acc += bf16(p) . v
    const __nv_bfloat16* sVs = sV + st * kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < kND; nd += 2) {
        unsigned bfrag[4];
        ldsm_x4_t(bfrag,
                  sVs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                      nd * 8 + (lane >> 4) * 8);
        mma16816(o[nd], a, bfrag[0], bfrag[1]);
        mma16816(o[nd + 1], a, bfrag[2], bfrag[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= p.sq) continue;
    if (t == 0) {
      p.m_out[row_base + r] = m_row[i];
      p.l_out[row_base + r] = l_row[i];
    }
#pragma unroll
    for (int j = 0; j < kND; ++j) {
      *reinterpret_cast<float2*>(p.acc_out + (row_base + r) * D + 8 * j +
                                 2 * t) =
          make_float2(o[j][2 * i], o[j][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------ plain fp32

constexpr int kSimtBM = 16;
constexpr int kSimtBN = 32;  // one key per lane in the softmax step
constexpr int kSimtThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// p as the input type rounds it (p.astype(v.dtype) in the TPU kernel).
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

size_t simt_smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) * (static_cast<size_t>(kSimtBM + kSimtBN) * ld +
                          static_cast<size_t>(kSimtBN + kSimtBM) * d +
                          kSimtBM * kSimtBN + 3 * kSimtBM);
}

template <typename T>
__global__ void __launch_bounds__(kSimtThreads) flash_simt_kernel(Params p) {
  extern __shared__ float smf[];
  const int d = p.d, ld = d + 1;
  float* sQ = smf;                    // [BM][ld]
  float* sK = sQ + kSimtBM * ld;      // [BN][ld]
  float* sV = sK + kSimtBN * ld;      // [BN][d]
  float* sAcc = sV + kSimtBN * d;     // [BM][d]
  float* sP = sAcc + kSimtBM * d;     // [BM][BN]
  float* sM = sP + kSimtBM * kSimtBN;
  float* sL = sM + kSimtBM;
  float* sC = sL + kSimtBM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kSimtBM;
  const int bh = blockIdx.y;
  const int b = bh / p.h, hh = bh % p.h;
  const int kvh = hh / (p.h / p.hkv);
  int q_off, kv_off;
  read_offsets(p, &q_off, &kv_off);
  const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(bh) * p.sq * d;
  const size_t kv_base = static_cast<size_t>(b * p.hkv + kvh) * p.sk * d;
  const T* K = static_cast<const T*>(p.k) + kv_base;
  const T* V = static_cast<const T*>(p.v) + kv_base;
  const size_t row_base = static_cast<size_t>(bh) * p.sq;

  for (int e = tid; e < kSimtBM * d; e += kSimtThreads) {
    const int r = e / d, c = e % d;
    const bool ok = m0 + r < p.sq;
    sQ[r * ld + c] = ok ? to_float(Q[static_cast<size_t>(m0 + r) * d + c]) : 0.f;
    sAcc[e] = ok ? p.acc_in[(row_base + m0 + r) * d + c] : 0.f;
  }
  for (int r = tid; r < kSimtBM; r += kSimtThreads) {
    const bool ok = m0 + r < p.sq;
    sM[r] = ok ? p.m_in[row_base + m0 + r] : kNeg;
    sL[r] = ok ? p.l_in[row_base + m0 + r] : 0.f;
  }

  const int n_tiles = live_tiles(p, q_off, kv_off, m0, kSimtBM, kSimtBN);
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kSimtBN;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kSimtBN * d; e += kSimtThreads) {
      const int r = e / d, c = e % d;
      const bool ok = k0 + r < p.sk;
      const size_t at = static_cast<size_t>(k0 + r) * d + c;
      sK[r * ld + c] = ok ? to_float(K[at]) : 0.f;
      sV[e] = ok ? to_float(V[at]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kSimtBM * kSimtBN; e += kSimtThreads) {
      const int r = e / kSimtBN, c = e % kSimtBN;
      float dot = 0.f;
      for (int i = 0; i < d; ++i) dot += sQ[r * ld + i] * sK[c * ld + i];
      sP[e] = legal(p, q_off, kv_off, m0 + r, k0 + c) ? dot * p.scale : kNeg;
    }
    __syncthreads();
    for (int r = warp; r < kSimtBM; r += kSimtThreads / 32) {
      const float x = sP[r * kSimtBN + lane];
      float mx = x;
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pv =
          legal(p, q_off, kv_off, m0 + r, k0 + lane) ? expf(x - m_new) : 0.f;
      float sum = pv;
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      sP[r * kSimtBN + lane] = round_as(pv, static_cast<const T*>(nullptr));
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();
    for (int e = tid; e < kSimtBM * d; e += kSimtThreads) {
      const int r = e / d, c = e % d;
      float pv = 0.f;
      for (int kk = 0; kk < kSimtBN; ++kk) {
        pv += sP[r * kSimtBN + kk] * sV[kk * d + c];
      }
      sAcc[e] = sAcc[e] * sC[r] + pv;
    }
  }
  __syncthreads();
  for (int e = tid; e < kSimtBM * d; e += kSimtThreads) {
    const int r = e / d;
    if (m0 + r < p.sq) p.acc_out[(row_base + m0) * d + e] = sAcc[e];
  }
  for (int r = tid; r < kSimtBM; r += kSimtThreads) {
    if (m0 + r < p.sq) {
      p.m_out[row_base + m0 + r] = sM[r];
      p.l_out[row_base + m0 + r] = sL[r];
    }
  }
}

bool aligned(const void* ptr, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(ptr) & (n - 1)) == 0;
}

template <int D>
cudaError_t launch_tc(const Params& p, int bh, cudaStream_t stream) {
  using S = TcShape<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + S::kBM - 1) / S::kBM, bh);
  flash_tc_kernel<D><<<grid, S::kThreads, S::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt(const Params& p, int bh, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + kSimtBM - 1) / kSimtBM, bh);
  flash_simt_kernel<T><<<grid, kSimtThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core kernel takes bf16 at d 64 or 128 with 16-byte aligned
// q, k, v and 8-byte aligned accumulators; everything else goes to the
// SIMT kernel. The one place that rule lives (brpc_flash_tile_k reads it).
bool takes_tc(const void* q, const void* k, const void* v,
              const float* acc_in, const float* acc_out, int d,
              int is_bf16) {
  return is_bf16 && (d == 64 || d == 128) && aligned(q, 16) &&
         aligned(k, 16) && aligned(v, 16) && aligned(acc_in, 8) &&
         aligned(acc_out, 8);
}

}  // namespace

// Keys per tile that brpc_flash_carry walks for these operands: where the
// running max steps and p is rounded, which a plain version must match.
extern "C" int brpc_flash_tile_k(const void* q, const void* k, const void* v,
                                 const float* acc_in, const float* acc_out,
                                 int d, int is_bf16) {
  if (!takes_tc(q, k, v, acc_in, acc_out, d, is_bf16)) return kSimtBN;
  return d == 128 ? TcShape<128>::kBN : TcShape<64>::kBN;
}

// q [b,h,sq,d], k and v [b,hkv,sk,d] (bf16 when is_bf16, else fp32), the
// fp32 carries m, l [b,h,sq] and acc [b,h,sq,d], all contiguous; fresh
// m_out, l_out, acc_out of the same shapes. Returns cudaGetLastError().
extern "C" int brpc_flash_carry(const void* q, const void* k, const void* v,
                                const float* m_in, const float* l_in,
                                const float* acc_in, float* m_out,
                                float* l_out, float* acc_out,
                                const int* offsets, int q_off, int kv_off,
                                int b, int h, int hkv, int sq, int sk, int d,
                                int is_bf16, int causal, float scale,
                                cudaStream_t stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || h % hkv != 0 || d <= 0 || d > 256 || b * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,     k,      v,      m_in,   l_in, acc_in, m_out,  l_out,
           acc_out, offsets, q_off, kv_off, h,    hkv,    sq,     sk,
           d,     causal, scale};
  cudaError_t err;
  if (takes_tc(q, k, v, acc_in, acc_out, d, is_bf16)) {
    err = d == 128 ? launch_tc<128>(p, b * h, stream)
                   : launch_tc<64>(p, b * h, stream);
  } else if (is_bf16) {
    err = launch_simt<__nv_bfloat16>(p, b * h, stream);
  } else {
    err = launch_simt<float>(p, b * h, stream);
  }
  return static_cast<int>(err);
}
