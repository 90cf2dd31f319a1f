// Shared helpers for the port's hand-written Hopper kernels.
//
// Each kernel source is compiled on its own by nvcc into a shared library
// with a plain C interface (repro_torch.kernels.build) and loaded through
// ctypes. Element types are float and __nv_bfloat16; all arithmetic is in
// float, as in the JAX package's Pallas kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// A finite "minus infinity": masked lanes stay finite, so a fully masked
// tile is an exact no-op of the online softmax (corr = exp(m - m) = 1,
// p = 0) and nothing ever turns into NaN.
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrappers.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Raise a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB; a launch above the limit would be refused.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
