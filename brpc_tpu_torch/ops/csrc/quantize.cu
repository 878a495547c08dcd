// brpc_dequant_int8 / brpc_dequant_fp8e4m3: block-quantized codes + per-block
// fp32 scales -> the logical fp32 tensor.
//
//   out[i] = float(q[i]) * scales[i / block]
//
// Replaces the Pallas kernel _dequant_kernel (brpc_tpu/ops/quantize.py:32,
// pallas_call at :60): the receive side of the quantized tensor wire, run on
// every quantized Push on the server and every quantized Pull/PullQ on the
// client.
//
// Bound on an H100: pure streaming, ~5.02 bytes per element (1 code read,
// 4 bytes written, 4/block for the scale), one multiply per element —
// device-memory bandwidth is the limit: at wte (n = 38.6M, block 256)
// about 194 MB, 0.058 ms at 3.35 TB/s (SXM).
//
// Design: one flat pass, no padding (the 32-row sublane tiling of the TPU
// kernel is a VPU artifact). Each thread widens 4 consecutive codes: one
// 4-byte code load and one 16-byte store when the codes are 4-byte and the
// output 16-byte aligned, the scalar path for the ragged tail. The scale of
// each element is scales[i / block], so a partial tail block needs nothing
// special; consecutive threads share a scale, which the L1 serves. A 64-bit
// division costs tens of integer instructions, so when block is a multiple
// of 4 (the codec's 256 and 128 are) the 4 elements of a vector share one
// division. int8
// widens exactly; e4m3 widens exactly through cuda_fp8.h. One __fmul_rn per
// element is the only rounding, so the output is bit-identical to the plain
// PyTorch version (dequantize_reference).

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

struct WidenInt8 {
  __device__ __forceinline__ float operator()(uint8_t b) const {
    return static_cast<float>(static_cast<int8_t>(b));
  }
};

struct WidenE4M3 {
  __device__ __forceinline__ float operator()(uint8_t b) const {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  }
};

template <typename Widen>
__global__ void dequant_kernel(const uint8_t* __restrict__ q,
                               const float* __restrict__ scales,
                               float* __restrict__ out, int64_t n,
                               int64_t block, bool aligned,
                               bool shared_scale) {
  const Widen widen{};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t * kVec < n; t += stride) {
    const int64_t i = t * kVec;
    if (aligned && i + kVec <= n) {
      const uint32_t word = reinterpret_cast<const uint32_t*>(q)[t];
      float s0, s1, s2, s3;
      if (shared_scale) {
        s0 = s1 = s2 = s3 = scales[i / block];
      } else {
        s0 = scales[i / block];
        s1 = scales[(i + 1) / block];
        s2 = scales[(i + 2) / block];
        s3 = scales[(i + 3) / block];
      }
      float4 o;
      o.x = __fmul_rn(widen(static_cast<uint8_t>(word)), s0);
      o.y = __fmul_rn(widen(static_cast<uint8_t>(word >> 8)), s1);
      o.z = __fmul_rn(widen(static_cast<uint8_t>(word >> 16)), s2);
      o.w = __fmul_rn(widen(static_cast<uint8_t>(word >> 24)), s3);
      reinterpret_cast<float4*>(out)[t] = o;
    } else {
      const int64_t end = i + kVec < n ? i + kVec : n;
      for (int64_t j = i; j < end; ++j) {
        out[j] = __fmul_rn(widen(q[j]), scales[j / block]);
      }
    }
  }
}

template <typename Widen>
int launch(const void* q, const float* scales, float* out, int64_t n,
           int64_t block, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) & 3u) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  const int64_t items = (n + kVec - 1) / kVec;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (1ll << 30)) blocks = 1ll << 30;  // grid-stride covers the rest
  dequant_kernel<Widen><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(static_cast<const uint8_t*>(q), scales,
                                    out, n, block, aligned,
                                    block % kVec == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int brpc_dequant_int8(const void* q, const float* scales,
                                 float* out, int64_t n, int64_t block,
                                 cudaStream_t stream) {
  return launch<WidenInt8>(q, scales, out, n, block, stream);
}

extern "C" int brpc_dequant_fp8e4m3(const void* q, const float* scales,
                                    float* out, int64_t n, int64_t block,
                                    cudaStream_t stream) {
  return launch<WidenE4M3>(q, scales, out, n, block, stream);
}
