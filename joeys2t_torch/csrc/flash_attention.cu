// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the two Pallas TPU forward kernels of
// joeys2t_tpu/ops/flash_attention.py: `_fwd_kernel` (:69, launched by
// `_flash_fwd` at :492 for Sk <= 512) and `_fwd_kernel_bhsd` (:174, launched
// by `_flash_fwd_bhsd` at :262 for longer keys). The TPU split existed only
// because a whole K/V slab had to fit VMEM; here one kernel streams K/V in
// tiles through shared memory and takes any Sk, masking the ragged edge.
//
// Math (per batch row b, head h; heads are column bands of E = H * D):
//   s   = (q * sm_scale) . k^T + bias[b, :]        (bias added before the max)
//   out = softmax(s) . v,  lse = m + log(l)       (lse kept for the backward)
// with the online softmax: one pass over K tiles, running max m and sum l per
// query row, f32 accumulation for f32 and bf16 inputs alike. The additive
// bias is the finite -1e9 of the model, so a row whose keys are all masked
// gets the uniform average over its keys, as the Pallas kernel gives.
//
// What bounds it on this card: with Sq = Sk = S the work is 4*S*S*E flops
// over 4*S*E elements read or written once, i.e. S flops per element. In bf16
// that is S/2 flop/byte against the H100 SXM's ridge of 989 TF / 3.35 TB/s
// ~ 295 flop/byte: bytes bound the 10 s utterances (S = 250, 125 flop/byte)
// and operations the 30 s ones (S = 750, 375 flop/byte). In f32 it is S/4
// flop/byte against a ridge of 67 TF / 3.35 TB/s ~ 20: operations at both.
// This first version is far from either bound: it does the products on the
// CUDA cores in f32 (SIMT FMA from shared memory, 16x16 threads, register
// micro-tiles); tensor cores (mma/wgmma) and TMA are later work.
// Shared-memory rows are padded by one float to keep the K reads free of bank
// conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Reduces over the 16 lanes that share one query row (same ty, half a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int BQ, int BK>
struct Tile {
  static constexpr int RQ = BQ / 16;  // query rows per thread
  static constexpr int RK = BK / 16;  // key columns per thread
  static constexpr int DC = D / 16;   // output columns per thread
  static constexpr int LD = D + 1;    // padded q/k row stride in shared memory
  static constexpr int LP = BK + 1;   // padded p row stride
  static constexpr int kFloats = BQ * LD + BK * LD + BK * D + BQ * LP + BK;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// One block per (q-tile, head, batch row).
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                 int num_heads, float sm_scale) {
  using C = Tile<D, BQ, BK>;
  extern __shared__ float smem[];
  float* q_s = smem;                // BQ x LD, pre-scaled by sm_scale
  float* k_s = q_s + BQ * C::LD;    // BK x LD
  float* v_s = k_s + BK * C::LD;    // BK x D
  float* p_s = v_s + BK * D;        // BQ x LP, probabilities of the tile
  float* b_s = p_s + BQ * C::LP;    // BK, bias of the tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int e = num_heads * D;
  const size_t q_base = (size_t)b * sq * e + (size_t)h * D;
  const size_t k_base = (size_t)b * sk * e + (size_t)h * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D, s = q0 + r;
    q_s[r * C::LD + c] =
        s < sq ? to_float(q[q_base + (size_t)s * e + c]) * sm_scale : 0.f;
  }

  float m[C::RQ], l[C::RQ], acc[C::RQ][C::DC];
#pragma unroll
  for (int i = 0; i < C::RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // the previous tile's k_s/v_s/p_s are consumed
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D, s = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (s < sk) {
        const size_t off = k_base + (size_t)s * e + c;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      k_s[r * C::LD + c] = kv;
      v_s[r * D + c] = vv;
    }
    for (int i = tid; i < BK; i += kThreads) {
      const int s = k0 + i;
      b_s[i] = s < sk ? bias[(size_t)b * sk + s] : 0.f;
    }
    __syncthreads();

    float sc[C::RQ][C::RK];
#pragma unroll
    for (int i = 0; i < C::RQ; ++i)
#pragma unroll
      for (int j = 0; j < C::RK; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[C::RQ], kv[C::RK];
#pragma unroll
      for (int i = 0; i < C::RQ; ++i) qv[i] = q_s[(ty + 16 * i) * C::LD + d];
#pragma unroll
      for (int j = 0; j < C::RK; ++j) kv[j] = k_s[(tx + 16 * j) * C::LD + d];
#pragma unroll
      for (int i = 0; i < C::RQ; ++i)
#pragma unroll
        for (int j = 0; j < C::RK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < C::RQ; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::RK; ++j) {
        const int c = tx + 16 * j;
        // keys past Sk do not exist: -inf drops them from max and sum
        const float s = k0 + c < sk ? sc[i][j] + b_s[c] : -INFINITY;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // tile 0 always holds key 0, so m_new is finite from the first tile on
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < C::RK; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty + 16 * i) * C::LP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // p_s complete

    for (int kk = 0; kk < BK; ++kk) {
      float vv[C::DC];
#pragma unroll
      for (int c = 0; c < C::DC; ++c) vv[c] = v_s[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < C::RQ; ++i) {
        const float p = p_s[(ty + 16 * i) * C::LP + kk];
#pragma unroll
        for (int c = 0; c < C::DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;  // padded query rows are never written
    const float inv = 1.f / l[i];
    T* o = out + q_base + (size_t)row * e;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) store(o + tx + 16 * c, acc[i][c] * inv);
    if (tx == 0) lse[((size_t)b * sq + row) * num_heads + h] = m[i] + logf(l[i]);
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, float* lse, int batch, int sq,
                   int sk, int num_heads, float sm_scale, cudaStream_t stream) {
  using C = Tile<D, BQ, BK>;
  auto kernel = flash_fwd_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, num_heads, batch);
  kernel<<<grid, kThreads, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, sq, sk,
      num_heads, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* bias, void* out, float* lse, int batch,
                     int sq, int sk, int num_heads, int head_dim,
                     float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64, 64, 64>(q, k, v, bias, out, lse, batch, sq, sk,
                                   num_heads, sm_scale, stream);
    case 128:
      return launch<T, 128, 64, 32>(q, k, v, bias, out, lse, batch, sq, sk,
                                    num_heads, sm_scale, stream);
    case 192:
      return launch<T, 192, 32, 32>(q, k, v, bias, out, lse, batch, sq, sk,
                                    num_heads, sm_scale, stream);
    case 256:
      return launch<T, 256, 32, 32>(q, k, v, bias, out, lse, batch, sq, sk,
                                    num_heads, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H*D), k/v (B, Sk, H*D), bias (B, Sk) f32, all contiguous;
// out like q, lse (B, Sq, H) f32. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const float* bias, void* out, float* lse,
                                   int batch, int sq, int sk, int num_heads,
                                   int head_dim, int dtype, float sm_scale,
                                   void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || batch > 65535 ||
      num_heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, bias, out, lse, batch, sq, sk,
                                num_heads, head_dim, sm_scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, bias, out, lse, batch, sq, sk,
                                        num_heads, head_dim, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
