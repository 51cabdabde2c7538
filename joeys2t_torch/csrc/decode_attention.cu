// Single-query (autoregressive decode) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of joeys2t_tpu/ops/decode_attention.py
// (:42, launched by `decode_attention` at :185). Per (batch row b, head h):
//   scores = (q * sm_scale) . K[b, h]^T + bias[b, :]      f32
//   p      = softmax(scores)                             f32
//   ctx    = p . V[b, h]                                 f32 accumulate
// over (B, H, S, D) caches in f32, bf16 or int8. int8 caches carry scales that
// fold exactly as the Pallas kernel folds them (:61-90):
//   layout 1 "channel"  (B, H, D): into q before the scores (K) and into ctx
//                                  after the sum (V) -- the cross-attention cache;
//   layout 2 "position" (B, H, S): into the scores (K) and into p (V) -- the
//                                  self-attention ring buffer.
// Unlike the Pallas kernel (:64), the scaled q is NOT rounded to bf16: the
// scores are full f32 products, as in the JAX einsum path.
//
// What bounds it on this card: each cache element is read once and used for
// one multiply-add, so the kernel is bound by memory bytes (K and V), far
// below the H100's flop/byte ridge. Design: one block per (b, h); each warp
// takes every 8th cache row and its 32 lanes read that row's D contiguous
// elements (D/32 each), so a warp's read of a row is one coalesced run. The
// scores stay in shared memory for the softmax. Split-K across blocks
// (flash-decoding) for small B*H is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChannel = 1;
constexpr int kPosition = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide reduction; `scratch` holds kWarps floats. Every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();  // scratch may be reused right after
  return r;
}

// One block per (b, h); dynamic shared memory: q (D) + scores (S) + partial
// contexts (kWarps x D) floats.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, TQ* __restrict__ out,
                        int num_heads, int s_len, float sm_scale, int layout) {
  constexpr int DL = D / 32;  // contiguous elements per lane
  extern __shared__ float smem[];
  float* q_s = smem;             // D
  float* p_s = q_s + D;          // S
  float* part = p_s + s_len;     // kWarps x D
  __shared__ float scratch[kWarps];

  const int bh = blockIdx.x, b = bh / num_heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t cache_base = (size_t)bh * s_len * D;

  for (int d = threadIdx.x; d < D; d += kThreads) {
    float x = to_float(q[(size_t)bh * D + d]) * sm_scale;
    if (layout == kChannel) x *= k_scale[(size_t)bh * D + d];
    q_s[d] = x;
  }
  __syncthreads();
  float qr[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) qr[i] = q_s[lane * DL + i];

  for (int s = warp; s < s_len; s += kWarps) {
    const TKV* kr = k + cache_base + (size_t)s * D + lane * DL;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) dot = fmaf(qr[i], to_float(kr[i]), dot);
    dot = warp_sum(dot);
    if (lane == 0) {
      if (layout == kPosition) dot *= k_scale[(size_t)bh * s_len + s];
      p_s[s] = dot + bias[(size_t)b * s_len + s];
    }
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int s = threadIdx.x; s < s_len; s += kThreads) mx = fmaxf(mx, p_s[s]);
  mx = block_reduce<true>(mx, scratch);
  float sum = 0.f;
  for (int s = threadIdx.x; s < s_len; s += kThreads) {
    const float ex = expf(p_s[s] - mx);
    p_s[s] = ex;
    sum += ex;
  }
  const float inv = 1.f / block_reduce<false>(sum, scratch);  // also syncs p_s

  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  for (int s = warp; s < s_len; s += kWarps) {
    float p = p_s[s] * inv;
    if (layout == kPosition) p *= v_scale[(size_t)bh * s_len + s];
    const TKV* vr = v + cache_base + (size_t)s * D + lane * DL;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] = fmaf(p, to_float(vr[i]), acc[i]);
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) part[warp * D + lane * DL + i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += kThreads) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += part[w * D + d];
    if (layout == kChannel) c *= v_scale[(size_t)bh * D + d];
    store(out + (size_t)bh * D + d, c);
  }
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const float* k_scale,
                   const float* v_scale, void* out, int batch, int num_heads,
                   int s_len, float sm_scale, int layout, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TKV, D>;
  const size_t bytes = sizeof(float) * ((size_t)D + s_len + (size_t)kWarps * D);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch * num_heads, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), bias, k_scale, v_scale, static_cast<TQ*>(out),
      num_heads, s_len, sm_scale, layout);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* bias, const float* k_scale,
                     const float* v_scale, void* out, int batch, int num_heads,
                     int s_len, int head_dim, float sm_scale, int layout,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, bias, k_scale, v_scale, out, batch,
                                 num_heads, s_len, sm_scale, layout, stream);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, bias, k_scale, v_scale, out, batch,
                                  num_heads, s_len, sm_scale, layout, stream);
    case 192:
      return launch<TQ, TKV, 192>(q, k, v, bias, k_scale, v_scale, out, batch,
                                  num_heads, s_len, sm_scale, layout, stream);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, bias, k_scale, v_scale, out, batch,
                                  num_heads, s_len, sm_scale, layout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D); k/v (B, H, S, D); bias (B, S) f32; k_scale/v_scale f32 of
// (B, H, D) for layout 1, (B, H, S) for layout 2, unused (may be null) for 0.
// out (B, H, D) in q's type. q_dtype: 0 = float32, 1 = bfloat16; kv_int8: 1
// when the caches are int8 (then layout must be 1 or 2), else 0 and the caches
// have q's type. Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const float* bias, const float* k_scale,
                                    const float* v_scale, void* out, int batch,
                                    int num_heads, int s_len, int head_dim,
                                    int q_dtype, int kv_int8, int layout,
                                    float sm_scale, void* stream) {
  if (batch <= 0 || num_heads <= 0 || s_len <= 0 || layout < 0 || layout > 2 ||
      (kv_int8 != 0) != (layout != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && !kv_int8)
    return (int)dispatch<float, float>(q, k, v, bias, k_scale, v_scale, out,
                                       batch, num_heads, s_len, head_dim,
                                       sm_scale, layout, st);
  if (q_dtype == 0 && kv_int8)
    return (int)dispatch<float, int8_t>(q, k, v, bias, k_scale, v_scale, out,
                                        batch, num_heads, s_len, head_dim,
                                        sm_scale, layout, st);
  if (q_dtype == 1 && !kv_int8)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, bias, k_scale, v_scale, out, batch, num_heads, s_len,
        head_dim, sm_scale, layout, st);
  if (q_dtype == 1 && kv_int8)
    return (int)dispatch<__nv_bfloat16, int8_t>(q, k, v, bias, k_scale,
                                                v_scale, out, batch, num_heads,
                                                s_len, head_dim, sm_scale,
                                                layout, st);
  return (int)cudaErrorInvalidValue;
}
