// Flash attention for Hopper (sm_90a): forward with optional in-kernel
// dropout, and the backward.
//
// Replaces the four Pallas TPU kernels of joeys2t_tpu/ops/flash_attention.py:
//   forward  `_fwd_kernel` (:69, launched by `_flash_fwd` at :492, Sk <= 512)
//            and `_fwd_kernel_bhsd` (:174, launched by `_flash_fwd_bhsd` at
//            :262, longer keys);
//   backward `_bwd_kernel` (:104, launched by `_flash_bwd` at :562) and
//            `_bwd_kernel_bhsd` (:203, launched by `_flash_bwd_bhsd` at :306).
// The TPU split by key length existed only because a whole K/V slab had to
// fit VMEM; here every kernel streams K/V (or Q/dO) in tiles through shared
// memory and takes any Sk, masking the ragged edge itself.
//
// Forward math (per batch row b, head h; heads are column bands of E = H*D):
//   s   = (q * sm_scale) . k^T + bias[b, :]        (bias added before the max)
//   p   = softmax(s),  lse = m + log(l)            (lse kept for the backward)
//   out = dropout(p) . v,  dropout(p) = keep ? p / (1 - rate) : 0
// with the online softmax: one pass over K tiles, running max m and sum l per
// query row (of the undropped p), f32 accumulation for f32 and bf16 inputs
// alike. The additive bias is the finite -1e9 of the model, so a row whose
// keys are all masked gets the uniform average over its keys, as the Pallas
// kernel gives. Dropout is a template flag: the dropout-free instantiation
// (serving) keeps the code it had before dropout existed.
//
// Backward math (the Pallas `_bwd_kernel`, :104-161), from the forward's out
// and lse:
//   delta = rowsum(dO * out)                  (out is the dropped output)
//   p  = exp(s - lse),  dp = dO . v^T
//   dp_eff = keep ? dp / (1 - rate) : 0,  p_drop = keep ? p / (1 - rate) : 0
//   ds = p * (dp_eff - delta)
//   dq = ds . k * sm_scale,  dk = ds^T . (q * sm_scale),  dv = p_drop^T . dO
// dK and dV are accumulated in f32 and cast once, as :595-602 does. At a row
// whose keys are all masked, f32 rounds lse = -1e9 + log(Sk) to -1e9, so p is
// 1 for every key of that row (Sk times the forward's 1/Sk): the kernel keeps
// this Pallas behaviour so that it, the plain version and JAX agree.
//
// The TPU accumulates dK/dV across a q-block grid dimension that runs in
// order on one core. Blocks here run in parallel and in no order, so the
// backward is three kernels, none with atomics, all deterministic:
//   1. delta: one warp per (b, q, h) row;
//   2. dK/dV: one block per (k-tile, head, b) looping over the q-tiles, dK
//      and dV in registers;
//   3. dQ: one block per (q-tile, head, b) looping over the k-tiles.
// Kernels 2 and 3 both recompute p and ds (7 tile products where one kernel
// with atomic dQ would do 5): the price of determinism in this first version.
//
// Dropout bits: a counter-based hash of the ABSOLUTE (batch row, head, query,
// key) and a per-call seed read from device memory, so forward and backward
// regenerate the same mask whatever their tiling (what `_row_seed` :52-59
// does on the TPU). The mixer is "lowbias32" (x ^= x>>16; x *= 0x7feb352d;
// x ^= x>>15; x *= 0x846ca68b; x ^= x>>16), absorbed one index at a time:
//   row = mix(mix(mix(mix(seed ^ 0x9e3779b9) ^ b) ^ h) ^ q),  bits = mix(row ^ k),
//   keep = bits >= threshold,  threshold = rate * 2^32 (host-rounded).
// joeys2t_torch/ops/flash_attention.py computes the same bits in plain
// PyTorch. They are not the TPU's bits, which cannot be reproduced.
//
// What bounds it on this card: with Sq = Sk = S the forward does 4*S*S*E
// flops over 4*S*E elements read or written once (S flops per element) and
// the backward 10*S*S*E flops over 8*S*E elements. In bf16 that is S/2
// (forward) and 5*S/8 (backward) flop/byte against the H100 SXM's ridge of
// 989 TF / 3.35 TB/s ~ 295 flop/byte: bytes bound the 10 s utterances
// (S = 250) and operations the 30 s ones (S = 750). In f32 the ridge is
// 67 TF / 3.35 TB/s ~ 20: operations at both. This first version is far from
// either bound: it does the products on the CUDA cores in f32 (SIMT FMA from
// shared memory, 16x16 threads, register micro-tiles); tensor cores
// (mma/wgmma) and TMA are later work. Shared-memory rows are padded by one
// float to keep the column reads free of bank conflicts.
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

// ------------------------------------------------------------------ forward
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
template <typename T, int D, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                 int num_heads, float sm_scale, Dropout drop) {
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

  uint32_t key[C::RQ];
  if (DROP) {
    const uint32_t seed = *drop.seed;
#pragma unroll
    for (int i = 0; i < C::RQ; ++i) key[i] = row_key(seed, b, h, q0 + ty + 16 * i);
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
        rs += p;  // the normalizer sums the undropped probabilities
        float pv = p;
        if (DROP) pv = keep(key[i], k0 + tx + 16 * j, drop.threshold) ? p * drop.scale : 0.f;
        p_s[(ty + 16 * i) * C::LP + tx + 16 * j] = pv;
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

// ----------------------------------------------------------------- backward
// delta[r] = sum_d dO[r, d] * out[r, d] over the (B*Sq*H) rows of D values
// (row r = (b*Sq + q)*H + h starts at r*D because E = H*D); one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ d_out, const T* __restrict__ out,
                       float* __restrict__ delta, size_t rows) {
  const size_t r = (size_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
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

template <int D, int BQ, int BK>
struct BwdTile {
  static constexpr int RQ = BQ / 16;  // query rows per thread (score tile)
  static constexpr int RK = BK / 16;  // key columns per thread (score tile)
  static constexpr int DC = D / 16;   // head columns per thread (dQ/dK/dV)
  static constexpr int LD = D + 1;
  static constexpr int LP = BK + 1;
  // q_s, do_s (BQ x LD); k_s, v_s (BK x LD); p_s, ds_s (BQ x LP);
  // b_s (BK); lse_s, dl_s (BQ)
  static constexpr int kFloats =
      2 * BQ * LD + 2 * BK * LD + 2 * BQ * LP + BK + 2 * BQ;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Loads rows [r0, r0 + R) of a (B, S, E) tensor's head band into a padded
// shared tile, times `scale`; rows past S are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          size_t base, int r0, int s, int e,
                                          float scale) {
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * (D + 1) + c] =
        row < s ? to_float(src[base + (size_t)row * e + c]) * scale : 0.f;
  }
}

// One (q-tile, k-tile) pair: the dropped probabilities p_drop (when WRITE_P)
// and ds of the tile into shared memory. Query rows past Sq and keys past Sk
// get 0 in both.
template <int D, int BQ, int BK, bool DROP, bool WRITE_P>
__device__ __forceinline__ void score_grads(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* b_s, const float* lse_s, const float* dl_s, float* p_s,
    float* ds_s, int q0, int k0, int sq, int sk, const uint32_t* key,
    const Dropout& drop) {
  using C = BwdTile<D, BQ, BK>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[C::RQ][C::RK], dp[C::RQ][C::RK];
#pragma unroll
  for (int i = 0; i < C::RQ; ++i)
#pragma unroll
    for (int j = 0; j < C::RK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[C::RQ], ov[C::RQ], kv[C::RK], vv[C::RK];
#pragma unroll
    for (int i = 0; i < C::RQ; ++i) {
      qv[i] = q_s[(ty + 16 * i) * C::LD + d];
      ov[i] = do_s[(ty + 16 * i) * C::LD + d];
    }
#pragma unroll
    for (int j = 0; j < C::RK; ++j) {
      kv[j] = k_s[(tx + 16 * j) * C::LD + d];
      vv[j] = v_s[(tx + 16 * j) * C::LD + d];
    }
#pragma unroll
    for (int i = 0; i < C::RQ; ++i)
#pragma unroll
      for (int j = 0; j < C::RK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < C::RQ; ++i) {
    const int r = ty + 16 * i;
    const bool row_ok = q0 + r < sq;
#pragma unroll
    for (int j = 0; j < C::RK; ++j) {
      const int c = tx + 16 * j;
      const float sc = s[i][j] + b_s[c];
      const float p = row_ok && k0 + c < sk ? expf(sc - lse_s[r]) : 0.f;
      float dpe = dp[i][j], pd = p;
      if (DROP) {
        const bool kp = keep(key[i], k0 + c, drop.threshold);
        dpe = kp ? dpe * drop.scale : 0.f;
        pd = kp ? p * drop.scale : 0.f;
      }
      if (WRITE_P) p_s[r * C::LP + c] = pd;
      ds_s[r * C::LP + c] = p * (dpe - dl_s[r]);
    }
  }
}

template <int BQ>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dl_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int b, int h, int q0, int sq,
                                               int num_heads) {
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const int row = q0 + i;
    const size_t off = ((size_t)b * sq + row) * num_heads + h;
    lse_s[i] = row < sq ? lse[off] : 0.f;
    dl_s[i] = row < sq ? delta[off] : 0.f;
  }
}

// dK, dV: one block per (k-tile, head, batch row), looping over the q-tiles.
template <typename T, int D, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const T* __restrict__ d_out, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int num_heads,
                      float sm_scale, Dropout drop) {
  using C = BwdTile<D, BQ, BK>;
  constexpr int RK = BK / 16;  // dK/dV rows per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * C::LD;
  float* k_s = do_s + BQ * C::LD;
  float* v_s = k_s + BK * C::LD;
  float* p_s = v_s + BK * C::LD;
  float* ds_s = p_s + BQ * C::LP;
  float* b_s = ds_s + BQ * C::LP;
  float* lse_s = b_s + BK;
  float* dl_s = lse_s + BQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int e = num_heads * D;
  const size_t q_base = (size_t)b * sq * e + (size_t)h * D;
  const size_t k_base = (size_t)b * sk * e + (size_t)h * D;

  load_rows<T, D, BK>(k_s, k, k_base, k0, sk, e, 1.f);
  load_rows<T, D, BK>(v_s, v, k_base, k0, sk, e, 1.f);
  for (int i = threadIdx.x; i < BK; i += kThreads)
    b_s[i] = k0 + i < sk ? bias[(size_t)b * sk + k0 + i] : 0.f;
  const uint32_t seed = DROP ? *drop.seed : 0u;

  float acc_k[RK][C::DC], acc_v[RK][C::DC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < C::DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous q-tile's shared tiles are consumed
    load_rows<T, D, BQ>(q_s, q, q_base, q0, sq, e, sm_scale);
    load_rows<T, D, BQ>(do_s, d_out, q_base, q0, sq, e, 1.f);
    load_row_stats<BQ>(lse_s, dl_s, lse, delta, b, h, q0, sq, num_heads);
    uint32_t key[C::RQ];
    if (DROP) {
#pragma unroll
      for (int i = 0; i < C::RQ; ++i) key[i] = row_key(seed, b, h, q0 + ty + 16 * i);
    }
    __syncthreads();
    score_grads<D, BQ, BK, DROP, true>(q_s, do_s, k_s, v_s, b_s, lse_s, dl_s,
                                       p_s, ds_s, q0, k0, sq, sk, key, drop);
    __syncthreads();  // p_s, ds_s complete
#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      float ov[C::DC], qv[C::DC];
#pragma unroll
      for (int c = 0; c < C::DC; ++c) {
        ov[c] = do_s[qq * C::LD + tx + 16 * c];
        qv[c] = q_s[qq * C::LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const float pv = p_s[qq * C::LP + ty + 16 * i];
        const float dsv = ds_s[qq * C::LP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < C::DC; ++c) {
          acc_v[i][c] = fmaf(pv, ov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv, qv[c], acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
    const size_t off = k_base + (size_t)row * e + tx;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) {
      store(dk + off + 16 * c, acc_k[i][c]);
      store(dv + off + 16 * c, acc_v[i][c]);
    }
  }
}

// dQ: one block per (q-tile, head, batch row), looping over the k-tiles.
template <typename T, int D, int BQ, int BK, bool DROP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const T* __restrict__ d_out, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int num_heads, float sm_scale, Dropout drop) {
  using C = BwdTile<D, BQ, BK>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * C::LD;
  float* k_s = do_s + BQ * C::LD;
  float* v_s = k_s + BK * C::LD;
  float* ds_s = v_s + BK * C::LD;  // (p_s is not needed for dQ)
  float* b_s = ds_s + 2 * BQ * C::LP;
  float* lse_s = b_s + BK;
  float* dl_s = lse_s + BQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int e = num_heads * D;
  const size_t q_base = (size_t)b * sq * e + (size_t)h * D;
  const size_t k_base = (size_t)b * sk * e + (size_t)h * D;

  load_rows<T, D, BQ>(q_s, q, q_base, q0, sq, e, sm_scale);
  load_rows<T, D, BQ>(do_s, d_out, q_base, q0, sq, e, 1.f);
  load_row_stats<BQ>(lse_s, dl_s, lse, delta, b, h, q0, sq, num_heads);
  uint32_t key[C::RQ];
  if (DROP) {
    const uint32_t seed = *drop.seed;
#pragma unroll
    for (int i = 0; i < C::RQ; ++i) key[i] = row_key(seed, b, h, q0 + ty + 16 * i);
  }

  float acc[C::RQ][C::DC];
#pragma unroll
  for (int i = 0; i < C::RQ; ++i)
#pragma unroll
    for (int c = 0; c < C::DC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // the previous k-tile's shared tiles are consumed
    load_rows<T, D, BK>(k_s, k, k_base, k0, sk, e, 1.f);
    load_rows<T, D, BK>(v_s, v, k_base, k0, sk, e, 1.f);
    for (int i = threadIdx.x; i < BK; i += kThreads)
      b_s[i] = k0 + i < sk ? bias[(size_t)b * sk + k0 + i] : 0.f;
    __syncthreads();
    score_grads<D, BQ, BK, DROP, false>(q_s, do_s, k_s, v_s, b_s, lse_s, dl_s,
                                        nullptr, ds_s, q0, k0, sq, sk, key, drop);
    __syncthreads();  // ds_s complete
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float kv[C::DC];
#pragma unroll
      for (int c = 0; c < C::DC; ++c) kv[c] = k_s[kk * C::LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < C::RQ; ++i) {
        const float dsv = ds_s[(ty + 16 * i) * C::LP + kk];
#pragma unroll
        for (int c = 0; c < C::DC; ++c) acc[i][c] = fmaf(dsv, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    T* o = dq + q_base + (size_t)row * e + tx;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) store(o + 16 * c, acc[i][c] * sm_scale);
  }
}

// ----------------------------------------------------------------- launches
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D, int BQ, int BK, bool DROP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const float* bias, void* out, float* lse, int batch,
                       int sq, int sk, int num_heads, float sm_scale,
                       Dropout drop, cudaStream_t stream) {
  using C = Tile<D, BQ, BK>;
  auto kernel = flash_fwd_kernel<T, D, BQ, BK, DROP>;
  cudaError_t err = set_smem(kernel, C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, num_heads, batch);
  kernel<<<grid, kThreads, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), lse, sq, sk,
      num_heads, sm_scale, drop);
  return cudaGetLastError();
}

template <typename T, int D, int BQ, int BK, bool DROP>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const float* bias, const void* out, const float* lse,
                       const void* d_out, float* delta, void* dq, void* dk,
                       void* dv, int batch, int sq, int sk, int num_heads,
                       float sm_scale, Dropout drop, cudaStream_t stream) {
  using C = BwdTile<D, BQ, BK>;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(d_out);
  const size_t rows = (size_t)batch * sq * num_heads;
  const unsigned delta_blocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_delta_kernel<T, D><<<delta_blocks, kThreads, 0, stream>>>(
      do_, static_cast<const T*>(out), delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, D, BQ, BK, DROP>;
  if ((err = set_smem(dkdv, C::kBytes)) != cudaSuccess) return err;
  dkdv<<<dim3((sk + BK - 1) / BK, num_heads, batch), kThreads, C::kBytes, stream>>>(
      q_, k_, v_, bias, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, num_heads, sm_scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, D, BQ, BK, DROP>;
  if ((err = set_smem(dqk, C::kBytes)) != cudaSuccess) return err;
  dqk<<<dim3((sq + BQ - 1) / BQ, num_heads, batch), kThreads, C::kBytes, stream>>>(
      q_, k_, v_, bias, do_, lse, delta, static_cast<T*>(dq), sq, sk, num_heads,
      sm_scale, drop);
  return cudaGetLastError();
}

// Tile sizes per head size: (BQ, BK) of the forward and of the backward.
template <typename T, bool DROP>
cudaError_t dispatch_fwd(const void* q, const void* k, const void* v,
                         const float* bias, void* out, float* lse, int batch,
                         int sq, int sk, int num_heads, int head_dim,
                         float sm_scale, Dropout drop, cudaStream_t st) {
  switch (head_dim) {
    case 64:
      return launch_fwd<T, 64, 64, 64, DROP>(q, k, v, bias, out, lse, batch, sq, sk,
                                             num_heads, sm_scale, drop, st);
    case 128:
      return launch_fwd<T, 128, 64, 32, DROP>(q, k, v, bias, out, lse, batch, sq, sk,
                                              num_heads, sm_scale, drop, st);
    case 192:
      return launch_fwd<T, 192, 32, 32, DROP>(q, k, v, bias, out, lse, batch, sq, sk,
                                              num_heads, sm_scale, drop, st);
    case 256:
      return launch_fwd<T, 256, 32, 32, DROP>(q, k, v, bias, out, lse, batch, sq, sk,
                                              num_heads, sm_scale, drop, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, bool DROP>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const float* bias, const void* out, const float* lse,
                         const void* d_out, float* delta, void* dq, void* dk,
                         void* dv, int batch, int sq, int sk, int num_heads,
                         int head_dim, float sm_scale, Dropout drop,
                         cudaStream_t st) {
  switch (head_dim) {
    case 64:
      return launch_bwd<T, 64, 64, 64, DROP>(q, k, v, bias, out, lse, d_out, delta, dq,
                                             dk, dv, batch, sq, sk, num_heads,
                                             sm_scale, drop, st);
    case 128:
      return launch_bwd<T, 128, 64, 64, DROP>(q, k, v, bias, out, lse, d_out, delta, dq,
                                              dk, dv, batch, sq, sk, num_heads,
                                              sm_scale, drop, st);
    case 192:
      return launch_bwd<T, 192, 32, 32, DROP>(q, k, v, bias, out, lse, d_out, delta, dq,
                                              dk, dv, batch, sq, sk, num_heads,
                                              sm_scale, drop, st);
    case 256:
      return launch_bwd<T, 256, 32, 32, DROP>(q, k, v, bias, out, lse, d_out, delta, dq,
                                              dk, dv, batch, sq, sk, num_heads,
                                              sm_scale, drop, st);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_dims(int batch, int sq, int sk, int num_heads) {
  return batch <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || batch > 65535 ||
         num_heads > 65535;
}

}  // namespace

// q (B, Sq, H*D), k/v (B, Sk, H*D), bias (B, Sk) f32, all contiguous;
// out like q, lse (B, Sq, H) f32. dtype: 0 = float32, 1 = bfloat16.
// seed: one uint32 in device memory, read only when dropout != 0; keep where
// the hash bits >= threshold, kept probabilities scaled by keep_scale.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const float* bias, void* out, float* lse,
                                   int batch, int sq, int sk, int num_heads,
                                   int head_dim, int dtype, float sm_scale,
                                   int dropout, const void* seed,
                                   unsigned threshold, float keep_scale,
                                   void* stream) {
  if (bad_dims(batch, sq, sk, num_heads) || (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{static_cast<const uint32_t*>(seed), threshold, keep_scale};
  if (dtype == 0)
    return (int)(dropout ? dispatch_fwd<float, true>(q, k, v, bias, out, lse, batch, sq,
                                                    sk, num_heads, head_dim, sm_scale,
                                                    drop, st)
                         : dispatch_fwd<float, false>(q, k, v, bias, out, lse, batch,
                                                      sq, sk, num_heads, head_dim,
                                                      sm_scale, drop, st));
  if (dtype == 1)
    return (int)(dropout ? dispatch_fwd<__nv_bfloat16, true>(q, k, v, bias, out, lse,
                                                            batch, sq, sk, num_heads,
                                                            head_dim, sm_scale, drop, st)
                         : dispatch_fwd<__nv_bfloat16, false>(q, k, v, bias, out, lse,
                                                              batch, sq, sk, num_heads,
                                                              head_dim, sm_scale, drop,
                                                              st));
  return (int)cudaErrorInvalidValue;
}

// The backward from the forward's out and lse: d_out like q; dq like q, dk and
// dv like k (accumulated in f32, cast once); delta (B, Sq, H) f32 scratch.
// dtype, dropout, seed, threshold and keep_scale as in flash_attention_fwd,
// and must be those of the forward call. Three kernels on `stream`.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const float* bias, const void* out,
                                   const float* lse, const void* d_out,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int batch, int sq, int sk, int num_heads,
                                   int head_dim, int dtype, float sm_scale,
                                   int dropout, const void* seed,
                                   unsigned threshold, float keep_scale,
                                   void* stream) {
  if (bad_dims(batch, sq, sk, num_heads) || (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{static_cast<const uint32_t*>(seed), threshold, keep_scale};
  if (dtype == 0)
    return (int)(dropout
                     ? dispatch_bwd<float, true>(q, k, v, bias, out, lse, d_out, delta,
                                                 dq, dk, dv, batch, sq, sk, num_heads,
                                                 head_dim, sm_scale, drop, st)
                     : dispatch_bwd<float, false>(q, k, v, bias, out, lse, d_out, delta,
                                                  dq, dk, dv, batch, sq, sk, num_heads,
                                                  head_dim, sm_scale, drop, st));
  if (dtype == 1)
    return (int)(dropout
                     ? dispatch_bwd<__nv_bfloat16, true>(q, k, v, bias, out, lse, d_out,
                                                         delta, dq, dk, dv, batch, sq,
                                                         sk, num_heads, head_dim,
                                                         sm_scale, drop, st)
                     : dispatch_bwd<__nv_bfloat16, false>(q, k, v, bias, out, lse,
                                                          d_out, delta, dq, dk, dv,
                                                          batch, sq, sk, num_heads,
                                                          head_dim, sm_scale, drop, st));
  return (int)cudaErrorInvalidValue;
}
