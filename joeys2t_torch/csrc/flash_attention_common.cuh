// Device helpers of the flash attention kernels, shared by flash_attention.cu,
// flash_attention_wgmma.cu and flash_attention_bwd_wgmma.cu: the dropout
// bits, which every forward and backward kernel must draw alike (see
// flash_attention.cu), the backward's delta kernel, which every backward
// launches first, and small register and shared-memory helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ dropout bits
struct Dropout {
  const uint32_t* seed;  // one word in device memory; null without dropout
  uint32_t threshold;    // keep where bits >= threshold
  float scale;           // 1 / (1 - rate)
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t row_key(uint32_t seed, int b, int h, int q) {
  return mix32(mix32(mix32(mix32(seed ^ 0x9e3779b9u) ^ (uint32_t)b) ^ (uint32_t)h) ^
               (uint32_t)q);
}
__device__ __forceinline__ bool keep(uint32_t key, int k, uint32_t threshold) {
  return mix32(key ^ (uint32_t)k) >= threshold;
}

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------- backward's delta
constexpr int kDeltaThreads = 256;  // 8 rows a block

// delta[r] = sum_d dO[r, d] * out[r, d] over the (B*Sq*H) rows of D values
// (row r = (b*Sq + q)*H + h starts at r*D because E = H*D); one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ d_out, const T* __restrict__ out,
                       float* __restrict__ delta, size_t rows) {
  const size_t r = (size_t)blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    s = fmaf(to_float(d_out[r * D + d]), to_float(out[r * D + d]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[r] = s;
}

template <typename T, int D>
cudaError_t launch_delta(const T* d_out, const void* out, float* delta, size_t rows,
                         cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32));
  flash_bwd_delta_kernel<T, D><<<blocks, kDeltaThreads, 0, stream>>>(
      d_out, static_cast<const T*>(out), delta, rows);
  return cudaGetLastError();
}

}  // namespace
