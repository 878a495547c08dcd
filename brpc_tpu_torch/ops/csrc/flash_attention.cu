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
// bounds it, so the products belong on the tensor cores. In fp32 the same
// layer is 8.21 ms at 67 TFLOP/s on the CUDA cores, and 3.33 ms as 3xTF32
// (three TF32 products for each fp32 one) at 495 TFLOP/s dense TF32: fp32
// belongs on the tensor cores too, split so it keeps fp32's accuracy
// (plain TF32, 10 mantissa bits, puts ~4e-4 into m at d = 128).
//
// Design. The TPU kernel walks k blocks as a sequential grid dimension and
// revisits its output block; here one thread block owns one (q tile, b*h)
// pair and loops over the k tiles itself, reading the carries once and
// writing them once. Three kernels:
//
// - flash_ws_kernel<D> (bf16, d = 64 or 128, 16-byte aligned operands):
//   warp-specialised for Hopper. 384 threads in 3 warpgroups own a 128-row
//   q tile. Warpgroup 0 is the producer: one thread issues TMA loads
//   (cp.async.bulk.tensor over 3-D tensor maps [b*h, s, d] with 128-byte
//   swizzle, so rows past sq or sk read as zeros) of Q once and of 128-key
//   K/V tiles into a ring of stages, each stage with a full mbarrier (the
//   transaction bytes) and an empty one (the consumers' release); it gives
//   its registers away with setmaxnreg.dec. Warpgroups 1 and 2 take them
//   (setmaxnreg.inc) and own 64 q rows each: s = q.k^T is one
//   wgmma.mma_async m64n128k16 per 16 of d, both operands in shared
//   memory; acc += p.v takes p from registers, rounded to bf16 exactly
//   where the TPU kernel's p.astype(v.dtype) rounds it, and V from shared
//   memory (MN-major), in fp32 registers that hold the acc carry from load
//   to store. Within a warpgroup the next tile's q.k^T is issued before
//   this tile's softmax and waited for with wgmma.wait_group; between the
//   two warpgroups named barriers take turns at issuing, so one
//   warpgroup's exponentials run under the other's products. The mask is
//   tested per element only on tiles that need it (a causal diagonal, the
//   ragged last tile of sk). p = 2^(s*c - m*c) with c = scale*log2(e), one
//   FFMA and ex2; m stays max(s*scale), the same bits as scaling first.
//   Both warpgroups walk the block's live tiles (a tile wholly masked for
//   one of them changes nothing: p = 0, the correction is exactly 1).
// - flash_tf32x3_kernel<D> (fp32, d % 4 == 0, 16-byte aligned operands;
//   D the width class 8..256 that holds d): replaces flash_simt_kernel on
//   the fp32 path, which ran every product on the CUDA cores with one
//   output element a thread and both FMA operands read from shared memory
//   (8% of the FMA bound at the Llama layer). Here the products are
//   mma.sync m16n8k8 on the tensor cores in 3xTF32: each operand x is
//   split in registers into big = x rounded to TF32 and small = x - big,
//   and a product is small.big + big.small + big.big into an fp32
//   accumulator (CUTLASS's fast-fp32 scheme), ~2^-21 relative error. Each
//   warp owns 16 q rows and holds its scores and acc carry in registers;
//   a block of 8 warps (4 at D = 256) owns 128 rows (64), so each K/V
//   element is fetched once for 128 queries, and walks 64-key tiles (32 at
//   D = 256) that cp.async streams through two shared-memory stages under
//   the products. p stays in fp32 (p.astype(v.dtype) is the identity) and
//   enters p.v split like the other operands; the scores' accumulator
//   layout serves as p.v's A fragment with the keys of each 8 permuted,
//   V's fragment read in the same order. Softmax and masking as in
//   flash_ws_kernel (a tile wholly masked for a warp changes nothing).
//   What bounds it: mma.sync's own TF32 rate, which on an H100 SXM is
//   ~64% of the dense peak (tools/mma_tf32_rate.py), and the splits and
//   fragment loads issued beside the products. wgmma is not used: for tf32
//   it takes only K-major operands from shared memory, so V (keys x d, d
//   contiguous, MN-major for p.v) would need a transposing pass over
//   every tile, and every small part would be staged in shared memory
//   beside its big part, which doubles what each product reads there.
// - flash_simt_kernel<T> (fp32 or bf16, any d <= 256): the same algorithm
//   on plain fp32 arithmetic, 16 q rows by 32-key tiles in shared memory,
//   for the shapes the tensor-core kernels do not take (fp32 with d % 4
//   != 0 or a misaligned view; bf16 at other widths).
//
// q tiles are issued heaviest first, and the q heads of one GQA group go
// to neighbouring blocks so their K/V tiles are read from L2. Global
// positions are q_off + row and kv_off + col, with the two offsets read
// from a device int32[2] (as the TPU kernel reads them from SMEM) or
// passed by value. Keys past sk are masked like causal ones; rows past sq
// are computed on zeros and never stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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
  // flash_simt_kernel only: the scores' column chunk of d, and the
  // columns [c0, c0 + dc) of acc this launch owns (set by launch_simt).
  int dk, dc, c0;
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

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct WsShape {
  static constexpr int kBM = 128;      // q rows per block: 2 consumers x 64
  static constexpr int kBN = 128;      // keys per tile
  static constexpr int kThreads = 384; // producer + 2 consumer warpgroups
  static constexpr int kStages = 2;    // tiles in each of the K and V rings
  static constexpr int kPanels = D / 64;          // 64-column (128-byte) panels
  static constexpr int kPanelBytes = 128 * 128;   // 128 rows x 128 bytes
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // Q, K or V tile
  static constexpr int kBarOff = (1 + 2 * kStages) * kTileBytes;
  // + the barriers (q; full and empty of each K and V stage) + slack to
  // align the base to 1024.
  static constexpr int kSmem = kBarOff + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Named barriers 1 and 2 over the 256 consumer threads: the two consumer
// warpgroups' turns at issuing their products.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define BRPC_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define BRPC_F16(i) BRPC_F4(i), BRPC_F4(i + 4), BRPC_F4(i + 8), BRPC_F4(i + 12)

// d (+)= a . b^T, a 64x16 and b 128x16 bf16 in shared memory (K-major),
// d 64x128 fp32 in the accumulator layout; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : BRPC_F16(0), BRPC_F16(16), BRPC_F16(32), BRPC_F16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[OFF..OFF+31] += a . b, a 64x16 bf16 in registers (4 x bf16x2 a
// thread), b 16x64 bf16 in shared memory, MN-major (transposed).
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[N],
                                             const unsigned* a, uint64_t db) {
  static_assert(OFF + 32 <= N, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BRPC_F16(OFF), BRPC_F16(OFF + 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef BRPC_F16
#undef BRPC_F4

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x on the special function unit (ex2.approx.ftz: relative error
// about 2^-22, results below 2^-126 flushed to 0; 2^-inf is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of a warp's 16 rows of one score tile in the mma
// accumulator layout, N/4 blocks of 8 keys (element i of a thread: row
// r_lo + 8*((i>>1)&1), column k0 + 8*(i>>2) + 2t + (i&1)). s holds q.k^T
// unscaled on entry and p (fp32) on exit; the carries m, l step, and corr
// is the factor acc must take. MASK tests every element (a causal
// diagonal or the ragged last tile of sk).
template <bool MASK, int N>
__device__ __forceinline__ void online_softmax(
    float (&s)[N], float (&m_row)[2], float (&l_row)[2], float (&corr)[2],
    const Params& p, int q_off, int kv_off, int r_lo, int k0, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (MASK) {
      const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const int row = r_lo + ((i >> 1) & 1) * 8;
      if (!legal(p, q_off, kv_off, row, col)) s[i] = -INFINITY;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float mc[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // max(s * scale) == max(s) * scale: a positive scale keeps the order.
    float m_new = fmaxf(m_row[r], mx[r] * p.scale);
    if (MASK) m_new = fmaxf(m_new, kNeg);  // a masked lane scores kNeg
    corr[r] = ex2((m_row[r] - m_new) * kLog2e);
    m_row[r] = m_new;
    mc[r] = m_new * kLog2e;
  }
  const float c = p.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < N; ++i) {
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
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_ws_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, Params p) {
  using S = WsShape<D>;
  constexpr int kBM = S::kBM, kBN = S::kBN, kStages = S::kStages;
  constexpr int kPanels = S::kPanels, kPanelBytes = S::kPanelBytes;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment (the swizzle atom).
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + S::kTileBytes;          // K ring
  const uint32_t sV = sK + kStages * S::kTileBytes;  // V ring
  // Barriers: q, then for each ring a full (TMA bytes) and an empty (one
  // arrival per consumer warp) barrier per stage.
  const uint32_t bar_q = sQ + S::kBarOff;
  const uint32_t full_k = bar_q + 8, full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  // Causal: heaviest q tiles first, and within one the heads of a GQA
  // group side by side, so their K/V tiles come from L2. Not causal (all
  // tiles equally heavy): every q tile of one head, then the next head of
  // its group, so the blocks in flight share K/V tiles.
  const int n_qt = (p.sq + kBM - 1) / kBM;
  const int n_bh = gridDim.x / n_qt;
  const int idx = blockIdx.x;
  const int rank = p.causal ? idx / n_bh : idx % n_qt;
  const int bh = p.causal ? idx % n_bh : idx / n_qt;
  const int m0 = (n_qt - 1 - rank) * kBM;
  const int b = bh / p.h, hh = bh % p.h;
  const int kv_bh = b * p.hkv + hh / (p.h / p.hkv);
  int q_off, kv_off;
  read_offsets(p, &q_off, &kv_off);
  const int n_tiles = live_tiles(p, q_off, kv_off, m0, kBM, kBN);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < 2 * kStages; ++i) {
      mbar_init(full_k + 8 * i, 1);
      mbar_init(empty_k + 8 * i, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, S::kTileBytes);
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load_3d(sQ + pn * kPanelBytes, &tm_q, bar_q, pn * 64, m0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        // K_j, then V_j, each once its stage is released; rows past sk are
        // zero-filled and still counted in the bytes.
        for (int kv = 0; kv < 2; ++kv) {
          const uint32_t off = 8 * (kv * kStages + st);
          if (j >= kStages) mbar_wait(empty_k + off, (j / kStages - 1) & 1);
          mbar_expect_tx(full_k + off, S::kTileBytes);
          const uint32_t dst = (kv ? sV : sK) + st * S::kTileBytes;
          for (int pn = 0; pn < kPanels; ++pn) {
            tma_load_3d(dst + pn * kPanelBytes, kv ? &tm_v : &tm_k,
                        full_k + off, pn * 64, j * kBN, kv_bh);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_wg = m0 + (wg - 1) * 64;     // first row of this warpgroup
    const int r_lo = r_wg + warp * 16 + g;   // this thread's rows: +0, +8
    const size_t row_base = static_cast<size_t>(bh) * p.sq;
    constexpr int kNO = D / 2;  // acc floats a thread (m64nD layout)
    float m_row[2], l_row[2], o[kNO];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      const bool ok = r < p.sq;
      m_row[i] = ok ? p.m_in[row_base + r] : kNeg;
      l_row[i] = ok ? p.l_in[row_base + r] : 0.f;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        float2 a = make_float2(0.f, 0.f);
        if (ok) {
          a = *reinterpret_cast<const float2*>(
              p.acc_in + (row_base + r) * D + 8 * nb + 2 * t);
        }
        o[4 * nb + 2 * i] = a.x;
        o[4 * nb + 2 * i + 1] = a.y;
      }
    }

    if (n_tiles > 0) {
      const int mine = wg, other = 3 - wg;
      const uint32_t q_addr = sQ + (wg - 1) * 64 * 128;
      float s[64];
      unsigned pf[32];  // bf16 p: the A operand of p.v, 4 per 16 keys
      float corr[2];

      auto issue_s = [&](int j) {  // s = q . k^T of tile j
        const int st = j % kStages;
        mbar_wait(full_k + 8 * st, (j / kStages) & 1);
        wgmma_fence();
        const uint32_t k_addr = sK + st * S::kTileBytes;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
          wgmma_ss_n128(s, desc_sw128(q_addr + off, 1, 64),
                        desc_sw128(k_addr + off, 1, 64), kk > 0 ? 1 : 0);
        }
        wgmma_commit();
      };
      auto issue_pv = [&](int j) {  // acc += bf16(p) . v of tile j
        const int st = j % kStages;
        mbar_wait(full_v + 8 * st, (j / kStages) & 1);
        const uint32_t v_addr = sV + st * S::kTileBytes;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          // 16 keys of 128 bytes a row, 8-key groups 1024 bytes apart;
          // one 64-column panel is one swizzle atom wide.
          const uint32_t at = v_addr + kk * 16 * 128;
          wgmma_rs_n64<0>(o, pf + 4 * kk, desc_sw128(at, 64, 64));
          if constexpr (kPanels == 2) {
            wgmma_rs_n64<32>(
                o, pf + 4 * kk, desc_sw128(at + kPanelBytes, 64, 64));
          }
        }
        wgmma_commit();
      };
      auto softmax = [&](int j) {
        const long long k0 = static_cast<long long>(j) * kBN;
        const bool need = k0 + kBN > p.sk ||
                          (p.causal && static_cast<long long>(q_off) + r_wg <
                                           kv_off + k0 + kBN - 1);
        if (need) {
          online_softmax<true>(s, m_row, l_row, corr, p, q_off, kv_off, r_lo,
                               static_cast<int>(k0), t);
        } else {
          online_softmax<false>(s, m_row, l_row, corr, p, q_off, kv_off,
                                r_lo, static_cast<int>(k0), t);
        }
      };
      auto rescale_and_pack = [&]() {
#pragma unroll
        for (int i = 0; i < kNO; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          pf[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
          pf[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          pf[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          pf[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
      };
      auto release = [&](uint32_t empty, int j) {  // tile j's stage
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * (j % kStages));
      };

      // Turns: warpgroup 1 issues first; each passes the turn on once its
      // products are issued, then runs its softmax under the other's.
      if (wg == 2) named_arrive(1);
      mbar_wait(bar_q, 0);

      named_sync(mine);
      issue_s(0);
      named_arrive(other);
      wgmma_wait<0>();
      fence_regs(s);
      release(empty_k, 0);
      softmax(0);
      rescale_and_pack();

      for (int j = 1; j < n_tiles; ++j) {
        named_sync(mine);
        issue_s(j);       // the next tile's scores ...
        issue_pv(j - 1);  // ... and this tile's p.v behind them
        named_arrive(other);
        wgmma_wait<1>();  // the scores are in: K_j is free
        fence_regs(s);
        release(empty_k, j);
        softmax(j);
        wgmma_wait<0>();  // p.v is in: V_{j-1} and p are free
        fence_regs(o);
        fence_regs(pf);
        release(empty_v, j - 1);
        rescale_and_pack();
      }

      named_sync(mine);
      wgmma_fence();
      issue_pv(n_tiles - 1);
      named_arrive(other);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      release(empty_v, n_tiles - 1);
      if (wg == 1) named_sync(1);  // takes warpgroup 2's last turn back
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_lo + 8 * i;
      if (r >= p.sq) continue;
      if (t == 0) {
        p.m_out[row_base + r] = m_row[i];
        p.l_out[row_base + r] = l_row[i];
      }
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        *reinterpret_cast<float2*>(p.acc_out + (row_base + r) * D + 8 * nb +
                                   2 * t) =
            make_float2(o[4 * nb + 2 * i], o[4 * nb + 2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ fp32, 3xTF32

// Tiles of flash_tf32x3_kernel<D> (D: the width class, 8 to 256, that
// holds d; columns past d are zero-filled and never stored).
template <int D>
struct Tf32Shape {
  static constexpr int kWarps = D == 256 ? 4 : 8;  // 16 q rows a warp
  static constexpr int kBM = 16 * kWarps;
  static constexpr int kBN = D == 256 ? 32 : 64;   // keys per tile
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStages = 2;                // K/V tiles in flight
  // Row strides in floats. Q and K are read as float2 at (row g, column
  // 2t): a stride of 8 or 24 mod 32 puts each half-warp's reads on 32
  // distinct banks. V is read as scalars at (key 2t or 2t+1, column g):
  // a stride of 4 mod 8 does the same for each warp.
  static constexpr int kLdQK = D == 8 ? 8 : D + 8;
  static constexpr int kLdV = D + 4;
  static constexpr int kQFloats = kBM * kLdQK;
  static constexpr int kKFloats = kBN * kLdQK;
  static constexpr int kVFloats = kBN * kLdV;
  static constexpr int kSmem =
      4 * (kQFloats + kStages * (kKFloats + kVFloats));
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // bytes 0: the 16 bytes at dst are zero-filled and nothing is read.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

// Rows [r0, r0 + ROWS) of a [n_rows, d] fp32 matrix into shared memory
// (row stride LD floats) in 16-byte copies; rows past n_rows and columns
// past d (d % 4 == 0) read as zeros.
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src,
                                          int r0, int n_rows, int d) {
  constexpr int kChunks = D / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * kChunks; e += THREADS) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r0 + r < n_rows && 4 * c < d;
    cp_async16(dst + 4 * (r * LD + 4 * c),
               ok ? src + static_cast<size_t>(r0 + r) * d + 4 * c : src,
               ok ? 16 : 0);
  }
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
// same fp32 accumulator (small . small, ~2^-22 relative, is dropped). For
// p.v; q.k^T keeps the cross terms in an accumulator of their own.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_big,
                                           const uint32_t* a_small,
                                           const uint32_t* b_big,
                                           const uint32_t* b_small) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// The fp32 carry on the tensor cores. One block owns kBM q rows of one
// (b, h), 16 a warp, and walks the live k tiles of kBN keys: K and V tiles
// stream through two shared-memory stages by cp.async (the next tile's
// copy runs under this tile's products), Q is copied once. A warp keeps
// its scores and its acc carry in registers in the m16n8 accumulator
// layout: s = q.k^T and acc += p.v are m16n8k8 mma.sync in 3xTF32, each
// operand split in registers as it is read from shared memory. q.k^T
// keeps its cross terms apart from big.big; acc has no room for that (64
// registers more at d = 128). Q and K
// fragments take columns 2t and 2t+1 of each 8 of d as the mma's k
// indices t and t+4 (one float2 read); p leaves the scores' layout with
// keys 2t and 2t+1 of each 8 in those places, so V's fragment reads keys
// 2t and 2t+1 too (a sum over k does not depend on its order).
template <int D>
__global__ void __launch_bounds__(Tf32Shape<D>::kThreads, 1)
    flash_tf32x3_kernel(Params p) {
  using S = Tf32Shape<D>;
  constexpr int kBM = S::kBM, kBN = S::kBN, kThreads = S::kThreads;
  constexpr int kLdQK = S::kLdQK, kLdV = S::kLdV;
  extern __shared__ float4 smem_f4[];
  float* const sQ = reinterpret_cast<float*>(smem_f4);
  float* const sK = sQ + S::kQFloats;                // stage st: + st*kKFloats
  float* const sV = sK + S::kStages * S::kKFloats;   // stage st: + st*kVFloats

  // Block order as flash_ws_kernel's: causal, heaviest q tiles first and
  // the heads of a GQA group side by side; else one head's tiles together.
  const int n_qt = (p.sq + kBM - 1) / kBM;
  const int n_bh = gridDim.x / n_qt;
  const int idx = blockIdx.x;
  const int rank = p.causal ? idx / n_bh : idx % n_qt;
  const int bh = p.causal ? idx % n_bh : idx / n_qt;
  const int m0 = (n_qt - 1 - rank) * kBM;
  const int b = bh / p.h, hh = bh % p.h;
  const int kv_bh = b * p.hkv + hh / (p.h / p.hkv);
  int q_off, kv_off;
  read_offsets(p, &q_off, &kv_off);
  const int n_tiles = live_tiles(p, q_off, kv_off, m0, kBM, kBN);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r_w = m0 + 16 * warp;  // the warp's first row
  const int r_lo = r_w + g;        // this thread's rows: +0, +8
  const int d = p.d;
  const size_t row_base = static_cast<size_t>(bh) * p.sq;
  const float* const Q =
      static_cast<const float*>(p.q) + row_base * d;
  const size_t kv_base = static_cast<size_t>(kv_bh) * p.sk * d;
  const float* const K = static_cast<const float*>(p.k) + kv_base;
  const float* const V = static_cast<const float*>(p.v) + kv_base;

  constexpr int kNO = D / 2;  // acc floats a thread: D/8 blocks of 4
  float m_row[2], l_row[2], o[kNO];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    const bool ok = r < p.sq;
    m_row[i] = ok ? p.m_in[row_base + r] : kNeg;
    l_row[i] = ok ? p.l_in[row_base + r] : 0.f;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int col = 8 * nb + 2 * t;
      float2 a = make_float2(0.f, 0.f);
      if (ok && col < d) {
        a = *reinterpret_cast<const float2*>(p.acc_in + (row_base + r) * d +
                                             col);
      }
      o[4 * nb + 2 * i] = a.x;
      o[4 * nb + 2 * i + 1] = a.y;
    }
  }

  if (n_tiles > 0) {
    const uint32_t q_s = smem_u32(sQ), k_s = smem_u32(sK), v_s = smem_u32(sV);
    load_rows<D, kBM, kLdQK, kThreads>(q_s, Q, m0, p.sq, d);
    load_rows<D, kBN, kLdQK, kThreads>(k_s, K, 0, p.sk, d);
    load_rows<D, kBN, kLdV, kThreads>(v_s, V, 0, p.sk, d);
    cp_async_commit();
    const float* const q_lo = sQ + (16 * warp + g) * kLdQK + 2 * t;
    const float* const q_hi = q_lo + 8 * kLdQK;

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j & 1;
      if (j + 1 < n_tiles) {  // tile j+1 into the other stage
        const int nx = (j + 1) * kBN;
        load_rows<D, kBN, kLdQK, kThreads>(
            k_s + 4 * (st ^ 1) * S::kKFloats, K, nx, p.sk, d);
        load_rows<D, kBN, kLdV, kThreads>(
            v_s + 4 * (st ^ 1) * S::kVFloats, V, nx, p.sk, d);
      }
      cp_async_commit();  // possibly empty: the count stays uniform
      cp_async_wait<1>();  // tile j (and Q) landed, for this thread ...
      __syncthreads();     // ... and for every thread

      const long long k0 = static_cast<long long>(j) * kBN;
      const float* const k_t = sK + st * S::kKFloats + g * kLdQK + 2 * t;
      const float* const v_t = sV + st * S::kVFloats + 2 * t * kLdV + g;
      // s = q . k^T, 8 of d at a time: big.big into s and the two cross
      // terms into s2, added once at the end. The tensor core truncates
      // the fp32 sum it accumulates into at every step; kept apart, the
      // cross terms' steps truncate a sum ~2^-11 the size of s's, which
      // cuts the error in m at d = 128 by ~40% against one accumulator.
      float s[kBN / 2], s2[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) s[i] = s2[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const float2 lo = *reinterpret_cast<const float2*>(q_lo + 8 * kk);
        const float2 hi = *reinterpret_cast<const float2*>(q_hi + 8 * kk);
        uint32_t ab[4], as[4];
        split_tf32(lo.x, ab[0], as[0]);
        split_tf32(hi.x, ab[1], as[1]);
        split_tf32(lo.y, ab[2], as[2]);
        split_tf32(hi.y, ab[3], as[3]);
#pragma unroll
        for (int nb = 0; nb < kBN / 8; ++nb) {
          const float2 kv = *reinterpret_cast<const float2*>(
              k_t + nb * 8 * kLdQK + 8 * kk);
          uint32_t bb[2], bs[2];
          split_tf32(kv.x, bb[0], bs[0]);
          split_tf32(kv.y, bb[1], bs[1]);
          mma_tf32(s2 + 4 * nb, as, bb);
          mma_tf32(s2 + 4 * nb, ab, bs);
          mma_tf32(s + 4 * nb, ab, bb);
        }
      }
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) s[i] += s2[i];
      float corr[2];
      const bool need =
          k0 + kBN > p.sk ||
          (p.causal && static_cast<long long>(q_off) + r_w <
                           kv_off + k0 + kBN - 1);
      if (need) {
        online_softmax<true>(s, m_row, l_row, corr, p, q_off, kv_off,
                             r_lo, static_cast<int>(k0), t);
      } else {
        online_softmax<false>(s, m_row, l_row, corr, p, q_off, kv_off,
                              r_lo, static_cast<int>(k0), t);
      }
#pragma unroll
      for (int i = 0; i < kNO; ++i) o[i] *= corr[(i >> 1) & 1];
      // acc += p . v, 8 keys at a time: p's A fragment is its own
      // accumulator fragment with keys 2t, 2t+1 as k indices t, t+4.
#pragma unroll
      for (int kb = 0; kb < kBN / 8; ++kb) {
        uint32_t ab[4], as[4];
        split_tf32(s[4 * kb + 0], ab[0], as[0]);
        split_tf32(s[4 * kb + 2], ab[1], as[1]);
        split_tf32(s[4 * kb + 1], ab[2], as[2]);
        split_tf32(s[4 * kb + 3], ab[3], as[3]);
        const float* const v_k = v_t + kb * 8 * kLdV;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          uint32_t bb[2], bs[2];
          split_tf32(v_k[8 * nd], bb[0], bs[0]);
          split_tf32(v_k[kLdV + 8 * nd], bb[1], bs[1]);
          mma_3xtf32(o + 4 * nd, ab, as, bb, bs);
        }
      }
      __syncthreads();  // stage st is free for tile j+2
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= p.sq) continue;
    if (t == 0) {
      p.m_out[row_base + r] = m_row[i];
      p.l_out[row_base + r] = l_row[i];
    }
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int col = 8 * nb + 2 * t;
      if (col < d) {
        *reinterpret_cast<float2*>(p.acc_out + (row_base + r) * d + col) =
            make_float2(o[4 * nb + 2 * i], o[4 * nb + 2 * i + 1]);
      }
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

// Shared memory of a SIMT block that takes the scores over dk columns of
// d at a time and owns dc columns of acc.
size_t simt_smem_bytes(int dk, int dc) {
  return sizeof(float) * (static_cast<size_t>(kSimtBM + kSimtBN) * (dk + 1) +
                          static_cast<size_t>(kSimtBN + kSimtBM) * dc +
                          kSimtBM * kSimtBN + 3 * kSimtBM);
}

// Each block owns one (q tile, b*h) pair of a 1-D grid, heaviest q tiles
// first as in the tensor-core kernels, and columns [c0, c0 + dc) of acc:
// every launch of a column-chunked fold computes the full q.k^T scores
// and the same (m, l), and the chunk at c0 == 0 stores them. The scores
// are summed over d in chunks of dk columns staged in shared memory (Q
// stays resident when dk == d); each thread keeps its dot products in
// registers across the chunks, so the sum runs over d in one order
// whatever dk is.
template <typename T>
__global__ void __launch_bounds__(kSimtThreads) flash_simt_kernel(Params p) {
  constexpr int kPer = kSimtBM * kSimtBN / kSimtThreads;  // scores a thread
  extern __shared__ float smf[];
  const int d = p.d, dk = p.dk, dc = p.dc, c0 = p.c0, ld = dk + 1;
  float* sQ = smf;                    // [BM][ld]
  float* sK = sQ + kSimtBM * ld;      // [BN][ld]
  float* sV = sK + kSimtBN * ld;      // [BN][dc]
  float* sAcc = sV + kSimtBN * dc;    // [BM][dc]
  float* sP = sAcc + kSimtBM * dc;    // [BM][BN]
  float* sM = sP + kSimtBM * kSimtBN;
  float* sL = sM + kSimtBM;
  float* sC = sL + kSimtBM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (p.sq + kSimtBM - 1) / kSimtBM;
  const int n_bh = gridDim.x / n_qt;
  const int idx = blockIdx.x;
  const int rank = p.causal ? idx / n_bh : idx % n_qt;
  const int bh = p.causal ? idx % n_bh : idx / n_qt;
  const int m0 = (n_qt - 1 - rank) * kSimtBM;
  const int b = bh / p.h, hh = bh % p.h;
  const int kvh = hh / (p.h / p.hkv);
  int q_off, kv_off;
  read_offsets(p, &q_off, &kv_off);
  const size_t row_base = static_cast<size_t>(bh) * p.sq;
  const T* Q = static_cast<const T*>(p.q) + row_base * d;
  const size_t kv_base = (static_cast<size_t>(b) * p.hkv + kvh) * p.sk * d;
  const T* K = static_cast<const T*>(p.k) + kv_base;
  const T* V = static_cast<const T*>(p.v) + kv_base;
  const bool q_resident = dk == d;

  auto load_q = [&](int i0, int w) {
    for (int e = tid; e < kSimtBM * w; e += kSimtThreads) {
      const int r = e / w, c = e % w;
      sQ[r * ld + c] = m0 + r < p.sq
          ? to_float(Q[static_cast<size_t>(m0 + r) * d + i0 + c]) : 0.f;
    }
  };
  if (q_resident) load_q(0, d);
  for (int e = tid; e < kSimtBM * dc; e += kSimtThreads) {
    const int r = e / dc, c = e % dc;
    sAcc[e] = m0 + r < p.sq ? p.acc_in[(row_base + m0 + r) * d + c0 + c]
                            : 0.f;
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
    for (int e = tid; e < kSimtBN * dc; e += kSimtThreads) {
      const int r = e / dc, c = e % dc;
      sV[e] = k0 + r < p.sk
          ? to_float(V[static_cast<size_t>(k0 + r) * d + c0 + c]) : 0.f;
    }
    float dot[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) dot[u] = 0.f;
    for (int i0 = 0; i0 < d; i0 += dk) {
      const int w = d - i0 < dk ? d - i0 : dk;
      if (i0 > 0) __syncthreads();  // the last chunk's readers are done
      if (!q_resident) load_q(i0, w);
      for (int e = tid; e < kSimtBN * w; e += kSimtThreads) {
        const int r = e / w, c = e % w;
        sK[r * ld + c] = k0 + r < p.sk
            ? to_float(K[static_cast<size_t>(k0 + r) * d + i0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int e = tid + u * kSimtThreads;
        const int r = e / kSimtBN, c = e % kSimtBN;
        for (int i = 0; i < w; ++i) dot[u] += sQ[r * ld + i] * sK[c * ld + i];
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kSimtThreads;
      const int r = e / kSimtBN, c = e % kSimtBN;
      sP[e] = legal(p, q_off, kv_off, m0 + r, k0 + c) ? dot[u] * p.scale
                                                        : kNeg;
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
    for (int e = tid; e < kSimtBM * dc; e += kSimtThreads) {
      const int r = e / dc, c = e % dc;
      float pv = 0.f;
      for (int kk = 0; kk < kSimtBN; ++kk) {
        pv += sP[r * kSimtBN + kk] * sV[kk * dc + c];
      }
      sAcc[e] = sAcc[e] * sC[r] + pv;
    }
  }
  __syncthreads();
  for (int e = tid; e < kSimtBM * dc; e += kSimtThreads) {
    const int r = e / dc, c = e % dc;
    if (m0 + r < p.sq) p.acc_out[(row_base + m0 + r) * d + c0 + c] = sAcc[e];
  }
  if (c0 != 0) return;
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

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A bf16 [n_bh, rows, d] tensor as a 3-D map read in boxes of 64 columns
// (128 bytes, one swizzle row) x 128 rows x 1 head, 128-byte swizzled.
// Rows past `rows` read as zeros and never reach the next head.
bool encode_map(CUtensorMap* map, const void* base, int d, int rows,
                int n_bh) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n_bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map that cannot be encoded returns cudaErrorNotSupported.
template <int D>
cudaError_t launch_ws(const Params& p, int b, cudaStream_t stream) {
  using S = WsShape<D>;
  CUtensorMap tq, tk, tv;
  const int kv_rows = p.sk > 0 ? p.sk : 1;  // sk == 0: no tile is read
  if (!encode_map(&tq, p.q, D, p.sq, b * p.h) ||
      !encode_map(&tk, p.k, D, kv_rows, b * p.hkv) ||
      !encode_map(&tv, p.v, D, kv_rows, b * p.hkv)) {
    return cudaErrorNotSupported;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_ws_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.sq + S::kBM - 1) / S::kBM;
  flash_ws_kernel<D><<<n_qt * b * p.h, S::kThreads, S::kSmem, stream>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

// How flash_simt_kernel splits width d under `optin` bytes of shared
// memory a block: dk columns of the scores at a time and dc columns of acc
// a launch. Whole d in one launch while it fits (d <= 599 on an H100);
// else the scores over all of d at once where a 32-column acc chunk fits
// beside them (d <= 1166), else 128 columns at a time, and acc in the
// fewest launches of equal width that fit.
struct SimtSplit {
  int dk, dc;
};

SimtSplit simt_split(int d, size_t optin) {
  if (simt_smem_bytes(d, d) <= optin) return {d, d};
  const int dk = simt_smem_bytes(d, 32) <= optin ? d : 128;
  const size_t per_col = sizeof(float) * (kSimtBN + kSimtBM);
  const int dc_max =
      static_cast<int>((optin - simt_smem_bytes(dk, 0)) / per_col);
  const int launches = (d + dc_max - 1) / dc_max;
  return {dk, (d + launches - 1) / launches};
}

size_t smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 48 * 1024;  // what every CUDA device grants without opting in
  }
  return static_cast<size_t>(bytes);
}

template <typename T>
cudaError_t launch_simt(Params p, int n_blocks, cudaStream_t stream) {
  const SimtSplit split = simt_split(p.d, smem_optin());
  const size_t smem = simt_smem_bytes(split.dk, split.dc);
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  p.dk = split.dk;
  for (p.c0 = 0; p.c0 < p.d; p.c0 += split.dc) {
    p.dc = p.d - p.c0 < split.dc ? p.d - p.c0 : split.dc;
    flash_simt_kernel<T><<<n_blocks, kSimtThreads, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_tf32x3(const Params& p, int b, cudaStream_t stream) {
  using S = Tf32Shape<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.sq + S::kBM - 1) / S::kBM;
  flash_tf32x3_kernel<D><<<n_qt * b * p.h, S::kThreads, S::kSmem, stream>>>(
      p);
  return cudaGetLastError();
}

// The width class of flash_tf32x3_kernel that holds d (<= 256).
int tf32_width(int d) {
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64
         : d <= 128 ? 128 : 256;
}

enum Route { kRouteSimt = 0, kRouteWs = 1, kRouteTf32x3 = 2 };

// Which kernel takes these operands; the one place that rule lives
// (brpc_flash_tile_k and brpc_flash_route read it). bf16 at d 64 or 128
// with 16-byte aligned q, k, v and 8-byte aligned accumulators: the
// warp-specialised kernel. fp32 with d % 4 == 0 (16-byte rows for
// cp.async), d <= 256 and the same alignment: the 3xTF32 kernel.
// Everything else, any d: the SIMT kernel.
Route route(const void* q, const void* k, const void* v, const float* acc_in,
            const float* acc_out, int d, int is_bf16) {
  const bool fits = aligned(q, 16) && aligned(k, 16) && aligned(v, 16) &&
                    aligned(acc_in, 8) && aligned(acc_out, 8);
  if (is_bf16) return fits && (d == 64 || d == 128) ? kRouteWs : kRouteSimt;
  return fits && d % 4 == 0 && d <= 256 ? kRouteTf32x3 : kRouteSimt;
}

}  // namespace

// Keys per tile that brpc_flash_carry walks for these operands: where the
// running max steps and p is rounded, which a plain version must match.
extern "C" int brpc_flash_tile_k(const void* q, const void* k, const void* v,
                                 const float* acc_in, const float* acc_out,
                                 int d, int is_bf16) {
  switch (route(q, k, v, acc_in, acc_out, d, is_bf16)) {
    case kRouteWs:
      return d == 128 ? WsShape<128>::kBN : WsShape<64>::kBN;
    case kRouteTf32x3:
      return tf32_width(d) == 256 ? Tf32Shape<256>::kBN : Tf32Shape<8>::kBN;
    default:
      return kSimtBN;
  }
}

// The kernel brpc_flash_carry launches for these operands: 0
// flash_simt_kernel, 1 flash_ws_kernel, 2 flash_tf32x3_kernel.
extern "C" int brpc_flash_route(const void* q, const void* k, const void* v,
                                const float* acc_in, const float* acc_out,
                                int d, int is_bf16) {
  return route(q, k, v, acc_in, acc_out, d, is_bf16);
}

// Dynamic shared memory a block of the warp-specialised kernel asks for at
// width d (64 or 128; else 0).
extern "C" int brpc_flash_ws_smem(int d) {
  return d == 128 ? WsShape<128>::kSmem : d == 64 ? WsShape<64>::kSmem : 0;
}

// Dynamic shared memory a block of the 3xTF32 kernel asks for at width d
// (<= 256).
extern "C" int brpc_flash_tf32x3_smem(int d) {
  switch (tf32_width(d)) {
    case 8: return Tf32Shape<8>::kSmem;
    case 16: return Tf32Shape<16>::kSmem;
    case 32: return Tf32Shape<32>::kSmem;
    case 64: return Tf32Shape<64>::kSmem;
    case 128: return Tf32Shape<128>::kSmem;
    default: return Tf32Shape<256>::kSmem;
  }
}

// Launches of flash_simt_kernel a fold at width d takes on this device:
// 1 while a block's shared memory holds all of d, else one a column chunk
// of acc.
extern "C" int brpc_flash_simt_launches(int d) {
  const int dc = simt_split(d, smem_optin()).dc;
  return (d + dc - 1) / dc;
}

// q [b,h,sq,d], k and v [b,hkv,sk,d] (bf16 when is_bf16, else fp32), the
// fp32 carries m, l [b,h,sq] and acc [b,h,sq,d], all contiguous; fresh
// m_out, l_out, acc_out of the same shapes. Any d and b*h up to the grid's
// 2^31 - 1 blocks of 16 q rows. Returns cudaGetLastError().
extern "C" int brpc_flash_carry(const void* q, const void* k, const void* v,
                                const float* m_in, const float* l_in,
                                const float* acc_in, float* m_out,
                                float* l_out, float* acc_out,
                                const int* offsets, int q_off, int kv_off,
                                int b, int h, int hkv, int sq, int sk, int d,
                                int is_bf16, int causal, float scale,
                                cudaStream_t stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  const long long blocks = static_cast<long long>(b) * h *
                           ((sq + kSimtBM - 1) / kSimtBM);
  if (hkv <= 0 || h % hkv != 0 || d <= 0 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q,     k,      v,      m_in,   l_in, acc_in, m_out,  l_out,
           acc_out, offsets, q_off, kv_off, h,    hkv,    sq,     sk,
           d,     causal, scale};
  cudaError_t err;
  switch (route(q, k, v, acc_in, acc_out, d, is_bf16)) {
    case kRouteWs:
      err = d == 128 ? launch_ws<128>(p, b, stream)
                     : launch_ws<64>(p, b, stream);
      break;
    case kRouteTf32x3:
      switch (tf32_width(d)) {
        case 8: err = launch_tf32x3<8>(p, b, stream); break;
        case 16: err = launch_tf32x3<16>(p, b, stream); break;
        case 32: err = launch_tf32x3<32>(p, b, stream); break;
        case 64: err = launch_tf32x3<64>(p, b, stream); break;
        case 128: err = launch_tf32x3<128>(p, b, stream); break;
        default: err = launch_tf32x3<256>(p, b, stream); break;
      }
      break;
    default:
      err = is_bf16 ? launch_simt<__nv_bfloat16>(p, static_cast<int>(blocks),
                                                 stream)
                    : launch_simt<float>(p, static_cast<int>(blocks),
                                         stream);
  }
  return static_cast<int>(err);
}
