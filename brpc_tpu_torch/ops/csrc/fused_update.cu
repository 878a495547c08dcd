// brpc_fused_momentum{,_f16,_bf16}: SGD with momentum in one pass over
// (p, m, g), for fp32, fp16 and bf16 tensors.
//
//   m' = beta * m + g
//   p' = p - lr * m'
//
// Replaces the Pallas kernel _momentum_kernel (brpc_tpu/ops/fused_update.py:23,
// pallas_call at :62), which the parameter server runs on every Push; the
// Pallas kernel takes any float dtype (its outputs keep the inputs' dtype).
//
// Bound on an H100: pure streaming, no reuse, 3 flops per element — far
// below the card's ~20 flop/byte balance point, so device-memory bandwidth
// is the limit: 5 tensors of the element size each (read p, m, g; write p',
// m'). At wte (n = 38.6M) that is 772 MB in fp32 (0.23 ms at 3.35 TB/s) and
// 386 MB in fp16/bf16 (0.12 ms).
//
// Design: one flat pass over n elements, any shape, no padding (the (8,128)
// tile padding of the TPU kernel is a VPU artifact). Each thread moves one
// 16-byte pack per stream (4 fp32 or 8 halves) when all five pointers are
// 16-byte aligned (the wrapper's fresh outputs and the allocator's tensors
// are), so a warp touches 512 contiguous bytes per stream; the ragged tail
// and unaligned inputs take the scalar path.
//
// Rounding: the constants arrive already rounded to the element type (the
// wrapper rounds them as the plain version does), and every operation runs
// in fp32 with __fmul_rn/__fadd_rn/__fsub_rn — never contracted into an FMA
// — and is rounded to the element type before the next one. For fp32 that
// is the plain two-op PyTorch version; for fp16 and bf16 it is the plain
// version's four rounded ops (momentum_update_reference), since an fp32 op
// on two operands of p <= 11 significand bits is exact before its one
// rounding (24 >= 2p + 2), so rounding it to the element type is the
// correctly rounded half-precision op. The result is bit-identical to the
// plain version in all three types.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float widen(float x) { return x; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ float widen(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half narrow(float x) {
    return __float2half_rn(x);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float x) {
    return __float2bfloat16_rn(x);
  }
};

// x rounded to T and back: the value an op of T would have produced.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Elem<T>::widen(Elem<T>::narrow(x));
}

template <typename T>
__device__ __forceinline__ void momentum_one(T p, T m, T g, float lr,
                                             float beta, T* p_out,
                                             T* m_out) {
  const float bm = round_to<T>(__fmul_rn(beta, Elem<T>::widen(m)));
  const float m2 = round_to<T>(__fadd_rn(bm, Elem<T>::widen(g)));
  const float lm = round_to<T>(__fmul_rn(lr, m2));
  *m_out = Elem<T>::narrow(m2);
  *p_out = Elem<T>::narrow(__fsub_rn(Elem<T>::widen(p), lm));
}

// One 16-byte pack of elements: 4 fp32 or 8 halves.
template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__global__ void momentum_kernel(const T* __restrict__ p,
                                const T* __restrict__ m,
                                const T* __restrict__ g, T* __restrict__ p_out,
                                T* __restrict__ m_out, int64_t n, float lr,
                                float beta, bool aligned) {
  constexpr int kVec = Pack<T>::kN;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t * kVec < n; t += stride) {
    const int64_t i = t * kVec;
    if (aligned && i + kVec <= n) {
      const Pack<T> pv = reinterpret_cast<const Pack<T>*>(p)[t];
      const Pack<T> mv = reinterpret_cast<const Pack<T>*>(m)[t];
      const Pack<T> gv = reinterpret_cast<const Pack<T>*>(g)[t];
      Pack<T> po, mo;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        momentum_one(pv.v[j], mv.v[j], gv.v[j], lr, beta, &po.v[j],
                     &mo.v[j]);
      }
      reinterpret_cast<Pack<T>*>(p_out)[t] = po;
      reinterpret_cast<Pack<T>*>(m_out)[t] = mo;
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

template <typename T>
int launch(const void* p, const void* m, const void* g, void* p_out,
           void* m_out, int64_t n, float lr, float beta,
           cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool aligned = aligned16(p) && aligned16(m) && aligned16(g) &&
                       aligned16(p_out) && aligned16(m_out);
  const int64_t items = (n + Pack<T>::kN - 1) / Pack<T>::kN;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (1ll << 30)) blocks = 1ll << 30;  // grid-stride covers the rest
  momentum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(m),
      static_cast<const T*>(g), static_cast<T*>(p_out),
      static_cast<T*>(m_out), n, lr, beta, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int brpc_fused_momentum(const void* p, const void* m,
                                   const void* g, void* p_out, void* m_out,
                                   int64_t n, float lr, float beta,
                                   cudaStream_t stream) {
  return launch<float>(p, m, g, p_out, m_out, n, lr, beta, stream);
}

extern "C" int brpc_fused_momentum_f16(const void* p, const void* m,
                                       const void* g, void* p_out,
                                       void* m_out, int64_t n, float lr,
                                       float beta, cudaStream_t stream) {
  return launch<__half>(p, m, g, p_out, m_out, n, lr, beta, stream);
}

extern "C" int brpc_fused_momentum_bf16(const void* p, const void* m,
                                        const void* g, void* p_out,
                                        void* m_out, int64_t n, float lr,
                                        float beta, cudaStream_t stream) {
  return launch<__nv_bfloat16>(p, m, g, p_out, m_out, n, lr, beta, stream);
}
