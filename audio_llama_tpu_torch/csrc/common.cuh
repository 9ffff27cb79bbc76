// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream and returns cudaGetLastError(); the Python wrappers load
// the library with ctypes (audio_llama_tpu_torch/ops/_cuda.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define AL_EXPORT extern "C" __attribute__((visibility("default")))

namespace al {

// dtype codes shared with ops/_cuda.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// The masked-logit value of the TPU kernels (NEG = -1e9 in
// ops/enc_attention.py and ops/causal_attention.py): finite, so a row whose
// every key is masked stays finite instead of turning into NaN.
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; `red` holds at least 32 floats of shared memory.
// Every thread of the block must call it; all receive the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarp ? red[lane] : 0.f;
  return warp_sum(v);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarp ? red[lane] : -INFINITY;
  return warp_max(v);
}

// Raise the dynamic shared-memory limit of `kernel` when `bytes` exceeds the
// default 48 KB; returns the error of the attribute call.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The last block to arrive (of `expected`) gets true, after a fence that
// publishes this block's global writes; counter is reset by that block.
__device__ __forceinline__ bool last_to_arrive(int* counter, int expected, int* flag_smem) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(counter, 1);
    *flag_smem = prev == expected - 1;
  }
  __syncthreads();
  const bool last = *flag_smem != 0;
  if (last) __threadfence();
  return last;
}

}  // namespace al
