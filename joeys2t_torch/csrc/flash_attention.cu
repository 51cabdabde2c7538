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
//   s   = sm_scale * q . k^T + bias[b, :]          (bias added before the max)
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
//   dq = sm_scale * ds . k,  dk = sm_scale * ds^T . q,  dv = p_drop^T . dO
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
// with atomic dQ would do 5): the price of determinism. Two calls with the
// same inputs give bit-identical dQ, dK and dV.
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
// 67 TF / 3.35 TB/s ~ 20: operations at both.
//
// Two routes, chosen by dtype and head size (dispatch_fwd / dispatch_bwd;
// flash_attention_info reports the route):
//
// bf16, D in 16/64/128/192/256: tensor cores (the *_mma kernels below). Every
// product is mma.sync.m16n8k16 bf16 x bf16 -> f32. Tiles stay bf16 in shared
// memory, in 16-byte chunks stored at chunk ^ (row % 8), so the 8 row
// addresses of an ldmatrix hit 8 different bank groups. Operands reach the
// tensor cores through ldmatrix (.trans where the product wants the stored
// tile transposed: V in P.V, P/dS/dO/Q/K in the backward's transposed
// products). Tiles are copied with 16-byte cp.async.cg into a two-stage
// ring (the next tile loads while the current one multiplies); rows past Sq
// or Sk are zero-filled (src-size 0), and their keys get a -inf score.
//   forward: 4 warps, BQ = 64 query rows (16 a warp), BK = 64 keys (32 at
//     D >= 192); FlashAttention-2 shape: S = Q.K^T and the online softmax in
//     registers (an m16n8 accumulator gives lane l rows l/4 and l/4 + 8,
//     columns 2*(l%4) + {0,1}; row max and sum over the 4 lanes of a quad),
//     P rounded to bf16 and fed from the accumulator registers as the A
//     operand of P.V (the Pallas kernel's p.astype(v.dtype), :99), O in
//     registers normalised once at the end. Q sits in registers for D <= 128
//     (its shared tile is then reused as the second K/V stage), in shared
//     memory above. At D = 128 ptxas gives it 228-242 registers, so 2 blocks
//     (8 warps) share an SM; tighter bounds (3 blocks), BQ = 128 and BK = 32
//     were each slower on the card.
//   backward: 8 warps, BQ = BK = 64, the same split as the SIMT path. Each
//     warp computes a 16 x 32 piece of S and dP = dO.V^T (score_grads_mma),
//     writes P_drop and dS to shared memory as bf16, and then owns 16 rows x
//     D/2 columns of dK and dV (dK/dV kernel: dV += P_drop^T.dO,
//     dK += dS^T.Q) or of dQ (dQ kernel: dQ += dS.K). dK/dV holds both
//     accumulators (234-238 registers at D = 128: 1 block an SM); dQ is
//     bounded to 2 blocks an SM.
//   D = 16 (the 64-wide MT models, 4 heads): one k16 step makes S = Q.K^T,
//     one x4 ldmatrix of V gives P.V's two n8 tiles, and 32-byte tile rows
//     take their own swizzle (swz); in the backward each warp keeps the n8
//     half of the 16 head columns that its D/2 band names.
//   sm_scale is applied in f32 to the scores after the product and to dK and
//   dQ at the end; folding it into bf16 Q would round Q a second time
//   (128^-1/2 is not a power of two). Dropout keeps are hashed at each
//   accumulator element's absolute (q, k), so all three kernels regenerate
//   the SIMT path's mask bit for bit.
//   Numerics: products see bf16 operands exactly and sum in f32, like the
//   SIMT path; P (forward) and P_drop, dS (backward) are rounded to bf16
//   before their second product, where Pallas keeps its backward in f32
//   (:119-159). Each output is within 2e-2 of the largest value of the
//   plain f32 version (tests/test_torch_cuda.py, chip_smoke.py).
//
// f32, D in 16/64/128/192/256: the SIMT kernels (before the mma section), the
// exact path. They do the products on the CUDA cores in f32 (FMA from shared
// memory, 16x16 threads, register micro-tiles; rows padded by one float
// against bank conflicts). Tensor-core TF32 would round inputs to 10 mantissa
// bits and break the 1e-4 / 1e-5 agreement that the f32 checks, the
// card-vs-CPU runs and the CPU tests hold the kernels to.
//
// Spills (ptxas -v under nvcc --split-compile, printed by chip_smoke.py):
// the SIMT kernels spill in two instantiations, the dQ kernel at D = 64
// with dropout (8 bytes stored, 32 loaded) and the dK/dV kernel at D = 16
// without (24 / 48). The mma dQ kernel, bounded to 128 registers, spills
// 8-56 bytes at D = 128 and 116-260 bytes at D = 192 and 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------------- tensor cores (bf16 only)
using bf16 = __nv_bfloat16;
constexpr int kMmaRows = 64;  // BQ of every mma kernel, BK of the backward

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, bypassing L1; zero-filled (nothing read) if !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>  // wait until at most N of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds (row l/4, columns 2(l%4), +1) of matrix i,
// or with .trans (rows 2(l%4), +1, column l/4).
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d (16x8 f32) += a (16x16 bf16, row-major) . b (16x8 bf16, column-major)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Element offset of (row, col) in a bf16 tile W columns wide: 16-byte chunk
// c of a row is stored at c ^ (row % 8), so the 8 rows that one ldmatrix
// matrix reads at one logical chunk fall on 8 different bank groups. A
// 16-wide tile (head dim 16) has 2 chunks a row, 32 bytes: chunk c is
// stored at c ^ ((row / 4) % 2), so rows r and r + 4, which share a bank
// group at the same chunk, take different ones.
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(W == 16 || W % 64 == 0, "a tile row must be 2 or a multiple of 8 chunks");
  const int flip = W == 16 ? (row >> 2) & 1 : row & 7;
  return row * W + (((col >> 3) ^ flip) << 3) + (col & 7);
}

// A lane's row address for an ldmatrix.x4 of the 16x16 block at (row0,
// col0) of a swizzled tile W columns wide, row0 % 8 == 0, col0 % 16 == 0.
// Pattern "a" (lane row (l % 8) + 8 ((l / 8) % 2), column 8 (l / 16)) gives
// an m16n8k16 A operand from a row-major tile (registers a0..a3) and, with
// .trans, two n8 B operands from a K x N row-major tile (b0, b1 of columns
// 0-7, then of 8-15). Pattern "b" (row (l % 8) + 8 (l / 16), column
// 8 ((l / 8) % 2)) gives two n8 B operands from an N x K row-major tile (b0,
// b1 of rows 0-7, then 8-15) and, with .trans, an A operand from the
// transposed (K x M row-major) tile. The block's chunk swizzle is an XOR of
// the lane's own offset (row % 8 is the lane's), so the address is the
// lane's base register XOR and plus constants, not one register per block.
template <int W>
struct Lane {
  int a, b;  // swz<W> of the lane's row and column in patterns a and b
  __device__ __forceinline__ explicit Lane(int l)
      : a(swz<W>((l & 7) + ((l >> 3) & 1) * 8, (l >> 4) * 8)),
        b(swz<W>((l & 7) + (l >> 4) * 8, ((l >> 3) & 1) * 8)) {}
  __device__ __forceinline__ static int at(int base, int row0, int col0) {
    return row0 * W + ((col0 >> 6) << 6) + (base ^ (((col0 >> 3) & 7) << 3));
  }
};

// Starts the copy of rows [r0, r0 + R) of one head band (D columns at
// `base`) of a (B, S, E) tensor into a swizzled R x D tile, 16 bytes a
// thread; rows past S are zero-filled. At D = 16 a tile of the 8-warp
// backward has fewer chunks than threads: the rest sit out.
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          size_t base, int r0, int s, int e) {
  constexpr int kChunks = D / 8;
  static_assert((R * kChunks) % NT == 0 || R * kChunks < NT, "whole chunks per thread");
  const uint32_t d0 = smem_addr(dst);
#pragma unroll
  for (int j = 0; j < (R * kChunks + NT - 1) / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    if (R * kChunks < NT && i >= R * kChunks) break;
    const int r = i / kChunks, c = i % kChunks, row = r0 + r;
    const bool ok = row < s;
    cp_async16(d0 + 2 * swz<D>(r, 8 * c), src + base + (size_t)(ok ? row : 0) * e + 8 * c,
               ok);
  }
}

template <int D, int BK>
struct FwdMma {
  static constexpr int kThreads = 128;  // 4 warps of 16 query rows
  static constexpr bool kQRegs = D <= 128;  // Q fragments held in registers
  static_assert(!kQRegs || 2 * BK >= kMmaRows, "Q's tile must fit a K/V stage");
  // 2 stages of (K, V); Q: its own tile unless it borrows stage 1
  static constexpr size_t kBytes =
      sizeof(bf16) * (4 * BK * D + (kQRegs ? 0 : kMmaRows * D));
};

// One block per (64-row q-tile, head, batch row).
template <int D, int BK, bool DROP>
__global__ void __launch_bounds__(128)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ lse, int sq, int sk,
                     int num_heads, float sm_scale, Dropout drop) {
  using C = FwdMma<D, BK>;
  constexpr int BQ = kMmaRows, NT = C::kThreads, DK = D / 16, NS = BK / 8;
  extern __shared__ uint4 smem_mma[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem_mma);  // [2][K, V: BK x D each]
  bf16* q_s = kv_s + (C::kQRegs ? 2 : 4) * BK * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  using L = Lane<D>;
  const L lo(lane);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int e = num_heads * D, wr = warp * 16;
  const size_t q_base = (size_t)b * sq * e + (size_t)h * D;
  const size_t k_base = (size_t)b * sk * e + (size_t)h * D;
  const float* bias_b = bias + (size_t)b * sk;
  const int n_tiles = (sk + BK - 1) / BK;

  load_tile<BQ, D, NT>(q_s, q, q_base, q0, sq, e);
  load_tile<BK, D, NT>(kv_s, k, k_base, 0, sk, e);
  load_tile<BK, D, NT>(kv_s + BK * D, v, k_base, 0, sk, e);
  cp_async_commit();

  uint32_t qf[C::kQRegs ? DK : 1][4];
  if constexpr (C::kQRegs) {
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) ldsm(qf[kk], smem_addr(q_s + L::at(lo.a, wr, 16 * kk)));
  }

  uint32_t key[2] = {0u, 0u};  // dropout row keys of rows g and g + 8
  if (DROP) {
    const uint32_t seed = *drop.seed;
    key[0] = row_key(seed, b, h, q0 + wr + g);
    key[1] = row_key(seed, b, h, q0 + wr + g + 8);
  }
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's part

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the stage (and Q tile) reloaded next
    if (t + 1 < n_tiles) {
      bf16* nxt = kv_s + ((t + 1) & 1) * 2 * BK * D;
      load_tile<BK, D, NT>(nxt, k, k_base, k0 + BK, sk, e);
      load_tile<BK, D, NT>(nxt + BK * D, v, k_base, k0 + BK, sk, e);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const bf16* ks = kv_s + (t & 1) * 2 * BK * D;
    const bf16* vs = ks + BK * D;

    // keys past Sk do not exist: a -inf bias drops them from max and sum
    float bz[NS][2];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kk = k0 + 8 * j + 2 * t4 + c;
        bz[j][c] = kk < sk ? __ldg(bias_b + kk) : -INFINITY;
      }

    float s[NS][4] = {};
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t a[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldsm(a, smem_addr(q_s + L::at(lo.a, wr, 16 * kk)));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldsm(bk, smem_addr(ks + L::at(lo.b, 16 * np, 16 * kk)));
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = fmaf(s[j][c], sm_scale, bz[j][c & 1]);
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // key k0 < Sk has a finite score, so the new max is finite
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = __expf(s[j][c] - m[c >> 1]);
        l[c >> 1] += p;  // the normalizer sums the undropped probabilities
        if (DROP)
          p = keep(key[c >> 1], k0 + 8 * j + 2 * t4 + (c & 1), drop.threshold) ? p * drop.scale
                                                                              : 0.f;
        s[j][c] = p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P.V: P's accumulator layout is the A operand's, two n8 tiles a k16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        ldsm_t(bv, smem_addr(vs + L::at(lo.a, 16 * kk, 16 * np)));
        mma(o[2 * np], a, bv[0], bv[1]);
        mma(o[2 * np + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int row = q0 + wr + g + 8 * r;
    if (row >= sq) continue;  // padded query rows are never written
    const float inv = 1.f / l_row;
    bf16* o_row = out + q_base + (size_t)row * e + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(o_row + 8 * n, o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t4 == 0) lse[((size_t)b * sq + row) * num_heads + h] = m[r] + logf(l_row);
  }
}

template <int D>
struct BwdMma {
  static constexpr int kThreads = 256;  // 8 warps
  static constexpr int T = kMmaRows;    // BQ = BK
  // dK/dV: K, V; Q and dO in 2 stages; P_drop and dS
  static constexpr size_t kDkdvBytes = sizeof(bf16) * (6 * T * D + 2 * T * T);
  // dQ: Q, dO; K and V in 2 stages; dS
  static constexpr size_t kDqBytes = sizeof(bf16) * (6 * T * D + T * T);
};

// One 64 x 64 (q-tile, k-tile) pair, warp w computing rows 16 (w % 4) .. +15
// and keys 32 (w / 4) .. +31: S = Q.K^T and dP = dO.V^T on the tensor cores,
// then p = exp(s - lse), the dropout keep at each element's absolute (q, k),
// and ds = p * (dp_eff - delta), written to shared memory as bf16 (p_drop
// too when WRITE_P). Padded query rows (lse = +inf) and keys (bias = -inf)
// get p = 0 and ds = 0. `key` holds the dropout row keys of rows
// q0 + 16 (w % 4) + lane / 4 and 8 rows further.
template <int D, bool DROP, bool WRITE_P>
__device__ __forceinline__ void score_grads_mma(
    const bf16* q_s, const bf16* do_s, const bf16* k_s, const bf16* v_s,
    const float* __restrict__ bias_b, const float* __restrict__ lse,
    const float* __restrict__ delta, size_t stats, bf16* p_s, bf16* ds_s, int q0, int k0,
    int sq, int sk, int num_heads, const uint32_t (&key)[2], const Dropout& drop,
    float sm_scale) {
  constexpr int T = kMmaRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  using L = Lane<D>;
  const L lo(lane);
  const int wr = (warp & 3) * 16, wc = (warp >> 2) * 32;

  float lse_r[2], dl_r[2], bz[4][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    const size_t off = stats + (size_t)row * num_heads;
    lse_r[r] = row < sq ? __ldg(lse + off) : INFINITY;
    dl_r[r] = row < sq ? __ldg(delta + off) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kk = k0 + wc + 8 * j + 2 * t4 + c;
      bz[j][c] = kk < sk ? __ldg(bias_b + kk) : -INFINITY;
    }

  float s[4][4] = {}, dp[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t aq[4], ado[4];
    ldsm(aq, smem_addr(q_s + L::at(lo.a, wr, 16 * kk)));
    ldsm(ado, smem_addr(do_s + L::at(lo.a, wr, 16 * kk)));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bk[4], bv[4];
      ldsm(bk, smem_addr(k_s + L::at(lo.b, wc + 16 * np, 16 * kk)));
      mma(s[2 * np], aq, bk[0], bk[1]);
      mma(s[2 * np + 1], aq, bk[2], bk[3]);
      ldsm(bv, smem_addr(v_s + L::at(lo.b, wc + 16 * np, 16 * kk)));
      mma(dp[2 * np], ado, bv[0], bv[1]);
      mma(dp[2 * np + 1], ado, bv[2], bv[3]);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float pd[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = __expf(fmaf(s[j][2 * r + c], sm_scale, bz[j][c]) - lse_r[r]);
        float dpe = dp[j][2 * r + c];
        pd[c] = p;
        if (DROP) {
          const bool kp = keep(key[r], k0 + wc + 8 * j + 2 * t4 + c, drop.threshold);
          dpe = kp ? dpe * drop.scale : 0.f;
          pd[c] = kp ? p * drop.scale : 0.f;
        }
        ds[c] = p * (dpe - dl_r[r]);
      }
      const int off = swz<T>(wr + g + 8 * r, wc + 8 * j + 2 * t4);
      if (WRITE_P) *reinterpret_cast<uint32_t*>(p_s + off) = pack_bf16(pd[0], pd[1]);
      *reinterpret_cast<uint32_t*>(ds_s + off) = pack_bf16(ds[0], ds[1]);
    }
}

// dK, dV: one block per (64-key tile, head, batch row), looping over the
// q-tiles; warp w owns key rows 16 (w % 4) .. +15 and head columns
// D/2 (w / 4) .. + D/2 - 1 of dK and dV.
template <int D, bool DROP>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ d_out, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int sq, int sk, int num_heads,
                          float sm_scale, Dropout drop) {
  constexpr int T = kMmaRows, NT = BwdMma<D>::kThreads, NH = D / 16;
  extern __shared__ uint4 smem_mma[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_mma);  // T x D
  bf16* v_s = k_s + T * D;                        // T x D
  bf16* q_s = v_s + T * D;                        // [2][T x D]
  bf16* do_s = q_s + 2 * T * D;                   // [2][T x D]
  bf16* p_s = do_s + 2 * T * D;                   // T x T
  bf16* ds_s = p_s + T * T;                       // T x T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  using L = Lane<D>;
  using LT = Lane<T>;
  const L lo(lane);
  const LT lt(lane);
  const int k0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int e = num_heads * D;
  const size_t q_base = (size_t)b * sq * e + (size_t)h * D;
  const size_t k_base = (size_t)b * sk * e + (size_t)h * D;
  const size_t stats = (size_t)b * sq * num_heads + h;
  const int kr = (warp & 3) * 16, dc = (warp >> 2) * (D / 2);
  const int n_tiles = (sq + T - 1) / T;

  load_tile<T, D, NT>(k_s, k, k_base, k0, sk, e);
  load_tile<T, D, NT>(v_s, v, k_base, k0, sk, e);
  load_tile<T, D, NT>(q_s, q, q_base, 0, sq, e);
  load_tile<T, D, NT>(do_s, d_out, q_base, 0, sq, e);
  cp_async_commit();
  const uint32_t seed = DROP ? *drop.seed : 0u;

  float acc_k[NH][4] = {}, acc_v[NH][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * T;
    __syncthreads();  // the stage reloaded next, p_s and ds_s are consumed
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      load_tile<T, D, NT>(q_s + nxt * T * D, q, q_base, q0 + T, sq, e);
      load_tile<T, D, NT>(do_s + nxt * T * D, d_out, q_base, q0 + T, sq, e);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = q_s + (t & 1) * T * D;
    const bf16* dos = do_s + (t & 1) * T * D;
    uint32_t key[2] = {0u, 0u};
    if (DROP) {
      key[0] = row_key(seed, b, h, q0 + (warp & 3) * 16 + g);
      key[1] = row_key(seed, b, h, q0 + (warp & 3) * 16 + g + 8);
    }
    score_grads_mma<D, DROP, true>(qs, dos, k_s, v_s, bias + (size_t)b * sk, lse, delta,
                                   stats, p_s, ds_s, q0, k0, sq, sk, num_heads, key, drop,
                                   sm_scale);
    __syncthreads();  // p_s, ds_s complete
    // dV += P_drop^T . dO and dK += dS^T . Q over this tile's 64 queries
#pragma unroll
    for (int qq = 0; qq < T / 16; ++qq) {
      uint32_t ap[4], ads[4];
      ldsm_t(ap, smem_addr(p_s + LT::at(lt.b, 16 * qq, kr)));
      ldsm_t(ads, smem_addr(ds_s + LT::at(lt.b, 16 * qq, kr)));
      if constexpr (NH == 1) {  // D = 16: this warp's n8 half of one x4 load
        uint32_t bo[4], bq[4];
        const int hi = dc ? 2 : 0;
        ldsm_t(bo, smem_addr(dos + L::at(lo.a, 16 * qq, 0)));
        mma(acc_v[0], ap, hi ? bo[2] : bo[0], hi ? bo[3] : bo[1]);
        ldsm_t(bq, smem_addr(qs + L::at(lo.a, 16 * qq, 0)));
        mma(acc_k[0], ads, hi ? bq[2] : bq[0], hi ? bq[3] : bq[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NH / 2; ++np) {
          uint32_t bo[4], bq[4];
          ldsm_t(bo, smem_addr(dos + L::at(lo.a, 16 * qq, dc + 16 * np)));
          mma(acc_v[2 * np], ap, bo[0], bo[1]);
          mma(acc_v[2 * np + 1], ap, bo[2], bo[3]);
          ldsm_t(bq, smem_addr(qs + L::at(lo.a, 16 * qq, dc + 16 * np)));
          mma(acc_k[2 * np], ads, bq[0], bq[1]);
          mma(acc_k[2 * np + 1], ads, bq[2], bq[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + kr + g + 8 * r;
    if (row >= sk) continue;
    const size_t off = k_base + (size_t)row * e + dc + 2 * t4;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      store2(dk + off + 8 * n, acc_k[n][2 * r] * sm_scale, acc_k[n][2 * r + 1] * sm_scale);
      store2(dv + off + 8 * n, acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

// dQ: one block per (64-row q-tile, head, batch row), looping over the
// k-tiles; warp w owns query rows 16 (w % 4) .. +15 and head columns
// D/2 (w / 4) .. + D/2 - 1 of dQ. Bounded to 2 blocks an SM (128 registers,
// a small spill at D = 128), which beat 1 block at 164 registers at the
// training shapes; the larger spills at D >= 192 are not measured.
template <int D, bool DROP>
__global__ void __launch_bounds__(256, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ d_out, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, int sq,
                        int sk, int num_heads, float sm_scale, Dropout drop) {
  constexpr int T = kMmaRows, NT = BwdMma<D>::kThreads, NH = D / 16;
  extern __shared__ uint4 smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);  // T x D
  bf16* do_s = q_s + T * D;                       // T x D
  bf16* k_s = do_s + T * D;                       // [2][T x D]
  bf16* v_s = k_s + 2 * T * D;                    // [2][T x D]
  bf16* ds_s = v_s + 2 * T * D;                   // T x T

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  using L = Lane<D>;
  using LT = Lane<T>;
  const L lo(lane);
  const LT lt(lane);
  const int q0 = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int e = num_heads * D;
  const size_t q_base = (size_t)b * sq * e + (size_t)h * D;
  const size_t k_base = (size_t)b * sk * e + (size_t)h * D;
  const size_t stats = (size_t)b * sq * num_heads + h;
  const int qr = (warp & 3) * 16, dc = (warp >> 2) * (D / 2);
  const int n_tiles = (sk + T - 1) / T;

  load_tile<T, D, NT>(q_s, q, q_base, q0, sq, e);
  load_tile<T, D, NT>(do_s, d_out, q_base, q0, sq, e);
  load_tile<T, D, NT>(k_s, k, k_base, 0, sk, e);
  load_tile<T, D, NT>(v_s, v, k_base, 0, sk, e);
  cp_async_commit();
  uint32_t key[2] = {0u, 0u};
  if (DROP) {
    const uint32_t seed = *drop.seed;
    key[0] = row_key(seed, b, h, q0 + qr + g);
    key[1] = row_key(seed, b, h, q0 + qr + g + 8);
  }

  float acc[NH][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * T;
    __syncthreads();  // the stage reloaded next and ds_s are consumed
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      load_tile<T, D, NT>(k_s + nxt * T * D, k, k_base, k0 + T, sk, e);
      load_tile<T, D, NT>(v_s + nxt * T * D, v, k_base, k0 + T, sk, e);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_s + (t & 1) * T * D;
    const bf16* vs = v_s + (t & 1) * T * D;
    score_grads_mma<D, DROP, false>(q_s, do_s, ks, vs, bias + (size_t)b * sk, lse, delta,
                                    stats, nullptr, ds_s, q0, k0, sq, sk, num_heads, key,
                                    drop, sm_scale);
    __syncthreads();  // ds_s complete
    // dQ += dS . K over this tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t a[4];
      ldsm(a, smem_addr(ds_s + LT::at(lt.a, qr, 16 * kk)));
      if constexpr (NH == 1) {  // D = 16: this warp's n8 half of one x4 load
        uint32_t bk[4];
        ldsm_t(bk, smem_addr(ks + L::at(lo.a, 16 * kk, 0)));
        mma(acc[0], a, dc ? bk[2] : bk[0], dc ? bk[3] : bk[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NH / 2; ++np) {
          uint32_t bk[4];
          ldsm_t(bk, smem_addr(ks + L::at(lo.a, 16 * kk, dc + 16 * np)));
          mma(acc[2 * np], a, bk[0], bk[1]);
          mma(acc[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    if (row >= sq) continue;
    bf16* o = dq + q_base + (size_t)row * e + dc + 2 * t4;
#pragma unroll
    for (int n = 0; n < NH; ++n)
      store2(o + 8 * n, acc[n][2 * r] * sm_scale, acc[n][2 * r + 1] * sm_scale);
  }
}

// ----------------------------------------------------------------- launches
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D, int BK, bool DROP>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           const float* bias, void* out, float* lse, int batch, int sq,
                           int sk, int num_heads, float sm_scale, Dropout drop,
                           cudaStream_t stream) {
  using C = FwdMma<D, BK>;
  auto kernel = flash_fwd_mma_kernel<D, BK, DROP>;
  cudaError_t err = set_smem(kernel, C::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kMmaRows - 1) / kMmaRows, num_heads, batch);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(out), lse, sq, sk,
      num_heads, sm_scale, drop);
  return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const float* bias, const void* out, const float* lse,
                           const void* d_out, float* delta, void* dq, void* dk, void* dv,
                           int batch, int sq, int sk, int num_heads, float sm_scale,
                           Dropout drop, cudaStream_t stream) {
  using C = BwdMma<D>;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(d_out);
  const size_t rows = (size_t)batch * sq * num_heads;
  const unsigned delta_blocks = (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_delta_kernel<bf16, D><<<delta_blocks, kThreads, 0, stream>>>(
      do_, static_cast<const bf16*>(out), delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_mma_kernel<D, DROP>;
  if ((err = set_smem(dkdv, C::kDkdvBytes)) != cudaSuccess) return err;
  dkdv<<<dim3((sk + C::T - 1) / C::T, num_heads, batch), C::kThreads, C::kDkdvBytes,
         stream>>>(q_, k_, v_, bias, do_, lse, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), sq, sk, num_heads, sm_scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_mma_kernel<D, DROP>;
  if ((err = set_smem(dqk, C::kDqBytes)) != cudaSuccess) return err;
  dqk<<<dim3((sq + C::T - 1) / C::T, num_heads, batch), C::kThreads, C::kDqBytes,
        stream>>>(q_, k_, v_, bias, do_, lse, delta, static_cast<bf16*>(dq), sq, sk,
                  num_heads, sm_scale, drop);
  return cudaGetLastError();
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

// Tile sizes of the SIMT kernels per head size: (BQ, BK) of the forward and
// of the backward.
template <int D>
struct SimtTiles {
  static constexpr int FQ = D <= 128 ? 64 : 32, FK = D <= 64 ? 64 : 32;
  static constexpr int BQ = D <= 128 ? 64 : 32, BK = BQ;
};
// BK of the tensor-core forward: 64 keys a tile, 32 where the wider O needs
// the registers
template <int D>
constexpr int kMmaFwdBK = D <= 128 ? 64 : 32;

// Calls f(std::integral_constant<int, D>) for a head size the kernels take.
template <typename F>
cudaError_t with_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

// The route: bf16 on the tensor cores, f32 on the SIMT kernels.
template <typename T, bool DROP>
cudaError_t dispatch_fwd(const void* q, const void* k, const void* v,
                         const float* bias, void* out, float* lse, int batch,
                         int sq, int sk, int num_heads, int head_dim,
                         float sm_scale, Dropout drop, cudaStream_t st) {
  return with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if constexpr (std::is_same_v<T, bf16>)
      return launch_fwd_mma<D, kMmaFwdBK<D>, DROP>(
          q, k, v, bias, out, lse, batch, sq, sk, num_heads, sm_scale, drop, st);
    else
      return launch_fwd<T, D, SimtTiles<D>::FQ, SimtTiles<D>::FK, DROP>(
          q, k, v, bias, out, lse, batch, sq, sk, num_heads, sm_scale, drop, st);
  });
}

template <typename T, bool DROP>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const float* bias, const void* out, const float* lse,
                         const void* d_out, float* delta, void* dq, void* dk,
                         void* dv, int batch, int sq, int sk, int num_heads,
                         int head_dim, float sm_scale, Dropout drop,
                         cudaStream_t st) {
  return with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if constexpr (std::is_same_v<T, bf16>)
      return launch_bwd_mma<D, DROP>(q, k, v, bias, out, lse, d_out, delta, dq, dk, dv,
                                     batch, sq, sk, num_heads, sm_scale, drop, st);
    else
      return launch_bwd<T, D, SimtTiles<D>::BQ, SimtTiles<D>::BK, DROP>(
          q, k, v, bias, out, lse, d_out, delta, dq, dk, dv, batch, sq, sk, num_heads,
          sm_scale, drop, st);
  });
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

// The route of (head_dim, dtype) and its kernels' dynamic shared memory:
// info[0] = 1 for the tensor cores (mma.sync), 0 for the SIMT kernels;
// info[1], info[2], info[3] = bytes of the forward, dK/dV and dQ kernels.
// Returns cudaErrorInvalidValue for a pair the kernels do not take.
extern "C" int flash_attention_info(int head_dim, int dtype, int* info) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    using S = SimtTiles<D>;
    const bool mma_route = dtype == 1;
    info[0] = mma_route;
    info[1] = (int)(mma_route ? FwdMma<D, kMmaFwdBK<D>>::kBytes : Tile<D, S::FQ, S::FK>::kBytes);
    info[2] = (int)(mma_route ? BwdMma<D>::kDkdvBytes : BwdTile<D, S::BQ, S::BK>::kBytes);
    info[3] = (int)(mma_route ? BwdMma<D>::kDqBytes : BwdTile<D, S::BQ, S::BK>::kBytes);
    return cudaSuccess;
  });
}
