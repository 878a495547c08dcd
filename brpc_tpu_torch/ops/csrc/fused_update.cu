// brpc_fused_momentum: SGD with momentum in one pass over (p, m, g).
//
//   m' = beta * m + g
//   p' = p - lr * m'
//
// Replaces the Pallas kernel _momentum_kernel (brpc_tpu/ops/fused_update.py:23,
// pallas_call at :62), which the parameter server runs on every Push.
//
// Bound on an H100: pure streaming, 20 bytes per element (read p, m, g;
// write p', m'), no reuse, 3 flops per element — far below the card's
// ~20 flop/byte balance point, so device-memory bandwidth is the limit:
// at wte (n = 38.6M) 772 MB, about 0.23 ms at 3.35 TB/s (SXM).
//
// Design: one flat pass over n elements, any shape, no padding (the
// (8,128) tile padding of the TPU kernel is a VPU artifact). Each thread
// moves 4 consecutive elements as one 16-byte load/store per stream when
// all five pointers are 16-byte aligned (the wrapper's fresh outputs and
// the allocator's tensors are), so a warp touches 512 contiguous bytes per
// stream; the ragged tail and unaligned inputs take the scalar path.
// The arithmetic is written with __fmul_rn/__fadd_rn/__fsub_rn so nvcc
// cannot contract it into FMAs: the result is bit-identical to the plain
// two-op PyTorch version (momentum_update_reference).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ void momentum_one(float p, float m, float g,
                                             float lr, float beta,
                                             float* p_out, float* m_out) {
  const float m2 = __fadd_rn(__fmul_rn(beta, m), g);
  *m_out = m2;
  *p_out = __fsub_rn(p, __fmul_rn(lr, m2));
}

__global__ void momentum_kernel(const float* __restrict__ p,
                                const float* __restrict__ m,
                                const float* __restrict__ g,
                                float* __restrict__ p_out,
                                float* __restrict__ m_out, int64_t n,
                                float lr, float beta, bool aligned) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t * kVec < n; t += stride) {
    const int64_t i = t * kVec;
    if (aligned && i + kVec <= n) {
      const float4 pv = reinterpret_cast<const float4*>(p)[t];
      const float4 mv = reinterpret_cast<const float4*>(m)[t];
      const float4 gv = reinterpret_cast<const float4*>(g)[t];
      float4 po, mo;
      momentum_one(pv.x, mv.x, gv.x, lr, beta, &po.x, &mo.x);
      momentum_one(pv.y, mv.y, gv.y, lr, beta, &po.y, &mo.y);
      momentum_one(pv.z, mv.z, gv.z, lr, beta, &po.z, &mo.z);
      momentum_one(pv.w, mv.w, gv.w, lr, beta, &po.w, &mo.w);
      reinterpret_cast<float4*>(p_out)[t] = po;
      reinterpret_cast<float4*>(m_out)[t] = mo;
    } else {
      const int64_t end = i + kVec < n ? i + kVec : n;
      for (int64_t j = i; j < end; ++j) {
        momentum_one(p[j], m[j], g[j], lr, beta, &p_out[j], &m_out[j]);
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" int brpc_fused_momentum(const float* p, const float* m,
                                   const float* g, float* p_out,
                                   float* m_out, int64_t n, float lr,
                                   float beta, cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool aligned = aligned16(p) && aligned16(m) && aligned16(g) &&
                       aligned16(p_out) && aligned16(m_out);
  const int64_t items = (n + kVec - 1) / kVec;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (1ll << 30)) blocks = 1ll << 30;  // grid-stride covers the rest
  momentum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      p, m, g, p_out, m_out, n, lr, beta, aligned);
  return static_cast<int>(cudaGetLastError());
}
