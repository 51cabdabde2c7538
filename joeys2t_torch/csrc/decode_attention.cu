// Single-query (autoregressive decode) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of joeys2t_tpu/ops/decode_attention.py
// (:42, launched by `decode_attention` at :185). Per (query row r, head h),
// with b = r / group the cache row it reads:
//   scores = (q[r, h] * sm_scale) . K[b, h]^T + bias[b, :]   f32
//   p      = softmax(scores)                                 f32
//   ctx    = p . V[b, h]                                     f32 accumulate
// `group` queries share one cache row: beam search keeps the cross-attention
// cache at B rows and asks it K queries a row (the JAX einsum
// "bkhd,bhsd->bkhs" of models/modules.py `step_cross`). Each query is one
// (b, h) problem of the kernel below with its own blocks; the G blocks of a
// cache row run close together in time, so the repeat reads of the row
// mostly hit L2. With group = 1 the kernel is the one-query-per-row kernel,
// index for index.
// over (B, H, S, D) caches in f32, bf16 or int8. int8 caches carry scales that
// fold exactly as the Pallas kernel folds them (:61-90):
//   layout 1 "channel"  (B, H, D): into q before the scores (K) and into ctx
//                                  after the sum (V) -- the cross-attention cache;
//   layout 2 "position" (B, H, S): into the scores (K) and into p (V) -- the
//                                  self-attention ring buffer.
// Unlike the Pallas kernel (:64), the scaled q is NOT rounded to bf16: the
// scores are full f32 products, as in the JAX einsum path.
//
// What bounds it: each cache element is read once and used for one
// multiply-add, about 1 flop per byte against the H100's ridge of ~295, so
// the kernel is bound by the bytes of K and V. Tensor cores would not help:
// one query per (b, h) against a per-head cache is a matrix-vector product.
// With group > 1 the G queries of a cache row could share one read of it
// (G queries a block); here each reads it on its own, through L2.
//
// Design: one launch, grid (splits, H, B * group), 4 warps a block. The blocks
// of one (query row, h) split S into `splits` ranges of `split_rows` rows and
// form one thread-block cluster; the kernel takes any such plan (the card tests sweep
// them all at small S). The plan comes from ops/decode_attention.decode_plan,
// with `split_rows` a multiple of 16: 1 split (and no cluster) once B*H fills
// the card's SMs (132 on the H100 SXM), as at B=64 H=4; below that up to 16
// splits of at least 96 rows, for about 2 blocks an SM (B*H = 4-8 at S = 750:
// 8 splits of 96 rows, 32-64 blocks; S = 3000: 16 splits).
//  - One pass: each warp streams its rows of K and V together, with a running
//    max, sum and accumulator in f32 registers (online softmax). Nothing of
//    size S lives in shared memory, so S has no shared-memory limit.
//  - Bytes in flight: 16-byte loads (8-byte where a lane's share of a row is
//    24 bytes); a row is `kLanes` lanes, so one warp load covers 32 / kLanes
//    rows (bf16 D=128: 16 lanes, 2 rows). A warp step is U such row groups
//    (U = 8 for f32 and bf16 where a lane holds 16 bytes of a row, 4 for
//    int8, 2 where a lane holds 24-32 bytes), and the K and V loads of the
//    next step are requested before the current one is used, with the bias of
//    the step after that: up to 2 x 256 bytes a lane, 16 KB a warp, 64 KB a
//    block at bf16 D=128, so up to ~128 KB an SM at B=64 H=4 (256 blocks on
//    132 SMs); at B=1-2 S=750 (32-64 blocks, 96 rows each) a block's rows
//    are all in flight at once. (250 registers a thread at bf16 D=128, no spills.)
//  - Head dim 16 (the 64-wide MT models): a 32-byte bf16 row is 2 lanes of
//    16 bytes, so one warp load covers 16 rows (f32: 4 lanes, 8 rows; int8:
//    1 lane, 32 rows) and every lane of the warp loads.
//  - Masked rows are not read: a row whose bias is at or below NEG_INF / 2 is
//    skipped (its K, V and "position" scales are not loaded); its
//    exp(score - max) is exactly 0 in f32 once the row has a valid key, so
//    skipping it changes only the order of the sums. If no block of the
//    cluster read a row (every key masked), a second pass reads every row:
//    the softmax over the (nearly equal) masked scores is the plain version's.
//  - Merge inside the kernel, in a fixed order, with no atomics and no
//    global scratch, so two calls give the same bits: lanes merge across row
//    slots by shuffles, warps through shared memory, and the blocks of a
//    cluster through distributed shared memory: after cluster.sync(), rank 0
//    reads every rank's (max, sum, acc) in rank order, rescales, divides and
//    writes the output; a second cluster.sync() keeps the other blocks'
//    shared memory alive until it is read.
//
// Ancestry-map mode (lazy beam reorder; the JAX einsum of models/modules.py
// `step_self_ancestry`, :320-412, which has no Pallas kernel). Beam search
// keeps one self-attention ring buffer per beam row (B*K rows) and, instead
// of permuting the buffers after every selection, a (B, K, S) int32 map:
// query row r = b*K + k reads, at position s, cache row b*K + anc[b, k, s]
// (K, V and the "position" scales through the same index). The kernel is
// the one above with one change: a row's K/V (and scale) address is offset
// by (anc - k) cache rows. Each position's D-vector stays contiguous, so a
// row's loads stay coalesced 16-byte loads; the map entry of a row is read
// with the row's bias, two steps ahead, and held in registers. Entries are
// clamped into [0, K), so no utterance reads another's rows. What bounds it:
// the bytes of the used slots of the B*K rows plus the map, where the
// physical reorder writes the whole buffers and reads them again.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 16;
constexpr int kPortableSplits = 8;
constexpr int kChannel = 1;
constexpr int kPosition = 2;
constexpr float kMaskedAtOrBelow = -5e8f;  // NEG_INF / 2

// Lanes that share one cache row: as many as keep 16 bytes or more each and
// split D evenly, at most 32.
constexpr int lanes_per_row(int row_bytes, int d) {
  int lanes = 32;
  while (lanes > 1 && (row_bytes / lanes < 16 || d % lanes != 0)) lanes /= 2;
  return lanes;
}

template <typename T, int D>
struct Geometry {
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kLanes = lanes_per_row(kRowBytes, D);  // lanes a row
  static constexpr int kRows = 32 / kLanes;          // rows a warp load
  static constexpr int kElems = D / kLanes;          // elements a lane
  static constexpr int kWords = kRowBytes / kLanes / 4;  // 32-bit words a lane
  // row groups a step: 8 where a lane holds 16 bytes of f32 or bf16, 4 for
  // int8 (its unpacking needs the registers), 2 where it holds 24-32 bytes
  static constexpr int kUnroll = kWords <= 4 ? (sizeof(T) > 1 ? 8 : 4) : 2;
  static_assert(kWords == 4 || kWords == 6 || kWords == 8, "lane share of a row");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element i of a lane's share of a row, held as 32-bit words.
template <typename T>
__device__ __forceinline__ float element(const uint32_t* w, int i);
template <>
__device__ __forceinline__ float element<float>(const uint32_t* w, int i) {
  return __uint_as_float(w[i]);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const uint32_t* w, int i) {
  const uint32_t x = w[i >> 1];
  return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
}
template <>
__device__ __forceinline__ float element<int8_t>(const uint32_t* w, int i) {
  return (float)((int32_t)(w[i >> 2] << (24 - 8 * (i & 3))) >> 24);
}

template <int NW>
__device__ __forceinline__ void load_words(uint32_t (&w)[NW], const void* p) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NW / 4; ++j) {
      const uint4 x = __ldg(static_cast<const uint4*>(p) + j);
      w[4 * j] = x.x, w[4 * j + 1] = x.y, w[4 * j + 2] = x.z, w[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) {
      const uint2 x = __ldg(static_cast<const uint2*>(p) + j);
      w[2 * j] = x.x, w[2 * j + 1] = x.y;
    }
  }
}

// The reference max of an online softmax: finite, so that exp(m - ref) is 0
// for a state that has seen no row (m = -inf) and never NaN.
__device__ __forceinline__ float finite_or_zero(float m) {
  return m == -INFINITY ? 0.f : m;
}

// (m, l, acc) <- merge of two online-softmax states
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* acc, float m2,
                                      float l2, const float* acc2) {
  const float mn = fmaxf(m, m2), ref = finite_or_zero(mn);
  const float a = expf(m - ref), a2 = expf(m2 - ref);
  l = l * a + l2 * a2;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * a + acc2[i] * a2;
  m = mn;
}

// The loads of one step of a warp: U row groups of R rows (one row a slot).
template <int NW, int U>
struct Step {
  uint32_t kw[U][NW], vw[U][NW];
  float bias[U], ks[U], vs[U];
  bool take[U];
};

template <typename TQ, typename TKV, int D, bool kAnc>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ anc, int beam_k,
                        TQ* __restrict__ out, int s_len, int split_rows, int group,
                        float sm_scale, int layout) {
  using G = Geometry<TKV, D>;
  constexpr int L = G::kLanes, R = G::kRows, E = G::kElems, NW = G::kWords,
                U = G::kUnroll, kStride = kWarps * U * R;
  __shared__ float warp_part[kWarps][D + 2];  // acc (D), max, sum
  __shared__ float block_part[D + 2];

  // query row blockIdx.z reads cache row b; the q and out offset of the
  // (query row, head) is recomputed where it is used, so that it holds no
  // register through the main loop
  const int split = blockIdx.x, b = blockIdx.z / group;
  const size_t bh = (size_t)b * gridDim.y + blockIdx.y;  // caches and scales
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
  const int slot = lane / L, col = (lane % L) * E;
  const int s0 = split * split_rows, s1 = min(s_len, s0 + split_rows);
  const float* bias_row = bias + (size_t)b * s_len;
  const char* kb = reinterpret_cast<const char*>(k + bh * s_len * D) + col * sizeof(TKV);
  const char* vb = reinterpret_cast<const char*>(v + bh * s_len * D) + col * sizeof(TKV);
  const float* ks_row = k_scale + bh * s_len;  // layout 2 only
  const float* vs_row = v_scale + bh * s_len;
  // ancestry mode (group 1, so b is the query row): this row's map, its own
  // beam index, and the distance between two beam rows' buffers
  const int* anc_row = kAnc ? anc + (size_t)b * s_len : nullptr;
  const int own = kAnc ? b % beam_k : 0;
  const size_t row_elems = (size_t)gridDim.y * s_len;  // one row's (H, S)

  // q for this lane's columns, scaled (and the channel K scales folded in)
  // exactly as the plain version scales it
  float qr[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float x = __fmul_rn(
        to_float(q[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * D + col + i]), sm_scale);
    if (layout == kChannel) x = __fmul_rn(x, __ldg(k_scale + bh * D + col + i));
    qr[i] = x;
  }

  // the bias of a step's rows and, in ancestry mode, their row offsets
  // (anc - own, in cache rows)
  auto load_bias = [&](float (&bs)[U], int (&dr)[U], int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * R + slot;
      bs[u] = r < s1 ? __ldg(bias_row + r) : -INFINITY;
      if constexpr (kAnc)
        dr[u] = r < s1 ? min(max(__ldg(anc_row + r), 0), beam_k - 1) - own : 0;
    }
  };
  auto fetch = [&](Step<NW, U>& st, const float (&bs)[U], const int (&dr)[U], int base,
                   bool skip) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * R + slot;
      st.bias[u] = bs[u];
      st.take[u] = r < s1 && (!skip || bs[u] > kMaskedAtOrBelow);
      st.ks[u] = st.vs[u] = 1.f;
      if (st.take[u]) {
        // element offset of row r of this (query row, h) in the caches
        long long e = (long long)r;
        if constexpr (kAnc) e += (long long)dr[u] * (long long)row_elems;
        load_words(st.kw[u], kb + e * G::kRowBytes);
        load_words(st.vw[u], vb + e * G::kRowBytes);
        if (layout == kPosition) st.ks[u] = __ldg(ks_row + e), st.vs[u] = __ldg(vs_row + e);
      } else {
#pragma unroll
        for (int j = 0; j < NW; ++j) st.kw[u][j] = st.vw[u][j] = 0u;
      }
    }
  };
  float m = -INFINITY, l = 0.f, acc[E];  // the running state, reset by each pass
  auto consume = [&](const Step<NW, U>& st) {
    float sc[U], mn = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < E; ++i) dot = fmaf(qr[i], element<TKV>(st.kw[u], i), dot);
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (layout == kPosition) dot = __fmul_rn(dot, st.ks[u]);
      sc[u] = st.take[u] ? __fadd_rn(dot, st.bias[u]) : -INFINITY;
      mn = fmaxf(mn, sc[u]);
    }
    const float ref = finite_or_zero(mn), alpha = expf(m - ref);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float p = expf(sc[u] - ref);
      l += p;
      if (layout == kPosition) p = __fmul_rn(p, st.vs[u]);
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = fmaf(p, element<TKV>(st.vw[u], i), acc[i]);
    }
    m = mn;
  };

  cg::cluster_group cluster = cg::this_cluster();
  // First pass: masked rows skipped. If no block of the cluster read a row
  // (every key masked), a second pass reads them all.
  for (bool skip = true;; skip = false) {
    m = -INFINITY, l = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = 0.f;
    // steps of the warp: rows base .. base+U*R-1, every kStride rows; the
    // loads of the next step are requested before this one is consumed, and
    // the bias of the step after that before those
    Step<NW, U> st_a, st_b;
    float bias_next[U];
    int dr_next[U];
    int base = s0 + warp * U * R;
    load_bias(bias_next, dr_next, base);
    if (base < s1)
      fetch(st_a, bias_next, dr_next, base, skip),
          load_bias(bias_next, dr_next, base + kStride);
    while (base < s1) {
      if (base + kStride < s1)
        fetch(st_b, bias_next, dr_next, base + kStride, skip),
            load_bias(bias_next, dr_next, base + 2 * kStride);
      consume(st_a);
      if ((base += kStride) >= s1) break;
      if (base + kStride < s1)
        fetch(st_a, bias_next, dr_next, base + kStride, skip),
            load_bias(bias_next, dr_next, base + 2 * kStride);
      consume(st_b);
      base += kStride;
    }

    // lanes of one column range merge across row slots, then warps, then blocks
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
      float acc2[E];
#pragma unroll
      for (int i = 0; i < E; ++i) acc2[i] = __shfl_xor_sync(0xffffffffu, acc[i], o);
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      merge<E>(m, l, acc, m2, l2, acc2);
    }
    if (slot == 0) {
#pragma unroll
      for (int i = 0; i < E; ++i) warp_part[warp][col + i] = acc[i];
      if (lane == 0) warp_part[warp][D] = m, warp_part[warp][D + 1] = l;
    }
    __syncthreads();
    for (int c = t; c < D; c += kThreads) {
      float bm = -INFINITY, bl = 0.f, ba = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        merge<1>(bm, bl, &ba, warp_part[w][D], warp_part[w][D + 1], &warp_part[w][c]);
      block_part[c] = ba;
      if (c == 0) block_part[D] = bm, block_part[D + 1] = bl;
    }
    cluster.sync();
    if (!skip) break;
    float read = 0.f;  // a block's sum is >= 1 once it read a row
    for (int rank = 0; rank < (int)gridDim.x; ++rank)
      read += cluster.map_shared_rank(&block_part[0], rank)[D + 1];
    if (read > 0.f) break;
    cluster.sync();  // every block has read block_part before it is rewritten
  }
  for (int c = t; split == 0 && c < D; c += kThreads) {
    float cm = -INFINITY, cl = 0.f, ca = 0.f;
    for (int rank = 0; rank < (int)gridDim.x; ++rank) {
      const float* part = cluster.map_shared_rank(&block_part[0], rank);
      merge<1>(cm, cl, &ca, part[D], part[D + 1], &part[c]);
    }
    float x = ca / cl;
    if (layout == kChannel) x *= __ldg(v_scale + bh * D + c);
    store(out + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * D + c, x);
  }
  cluster.sync();  // rank 0 has read every block's shared memory
}

template <typename TQ, typename TKV, int D, bool kAnc>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, const float* k_scale,
                   const float* v_scale, const int* anc, int beam_k, void* out,
                   int batch, int group, int num_heads, int s_len, int splits,
                   int split_rows, float sm_scale, int layout, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TKV, D, kAnc>;
  if (splits > kPortableSplits) {  // per launch: the attribute is per device
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, num_heads, batch * group);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;  // one split: no cluster, which launches faster
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), bias, k_scale, v_scale, anc, beam_k,
      static_cast<TQ*>(out), s_len, split_rows, group, sm_scale, layout);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* bias, const float* k_scale,
                     const float* v_scale, const int* anc, int beam_k, void* out,
                     int batch, int group, int num_heads, int s_len, int head_dim,
                     int splits, int split_rows, float sm_scale, int layout,
                     cudaStream_t stream) {
#define DECODE_LAUNCH(D, ANC)                                                   \
  launch<TQ, TKV, D, ANC>(q, k, v, bias, k_scale, v_scale, anc, beam_k, out,   \
                          batch, group, num_heads, s_len, splits, split_rows,  \
                          sm_scale, layout, stream)
  const bool a = anc != nullptr;
  switch (head_dim) {
    case 16: return a ? DECODE_LAUNCH(16, true) : DECODE_LAUNCH(16, false);
    case 64: return a ? DECODE_LAUNCH(64, true) : DECODE_LAUNCH(64, false);
    case 128: return a ? DECODE_LAUNCH(128, true) : DECODE_LAUNCH(128, false);
    case 192: return a ? DECODE_LAUNCH(192, true) : DECODE_LAUNCH(192, false);
    case 256: return a ? DECODE_LAUNCH(256, true) : DECODE_LAUNCH(256, false);
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_LAUNCH
}

}  // namespace

// q (B * group, H, D), query row r reading cache row r / group; k/v (B, H,
// S, D); bias (B, S) f32; k_scale/v_scale f32 of (B, H, D) for layout 1,
// (B, H, S) for layout 2, unused (may be null) for 0. anc: null, or the
// (B / beam_k, beam_k, S) int32 ancestry map (group 1, layout 0 or 2):
// query row r reads, at position s, cache row
// r - r % beam_k + anc[r, s]. out (B * group, H, D)
// in q's type. q_dtype: 0 = float32, 1 = bfloat16; kv_int8: 1
// when the caches are int8 (then layout must be 1 or 2), else 0 and the caches
// have q's type. S is cut into `splits` (1-16) ranges of `split_rows` rows,
// none of them empty. Every pointer is 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const float* bias, const float* k_scale,
                                    const float* v_scale, const int* anc,
                                    int beam_k, void* out, int batch,
                                    int group, int num_heads, int s_len, int head_dim,
                                    int q_dtype, int kv_int8, int layout,
                                    int splits, int split_rows, float sm_scale,
                                    void* stream) {
  if (batch <= 0 || group <= 0 || (long long)batch * group > 65535 ||
      num_heads <= 0 || s_len <= 0 || layout < 0 || layout > 2 ||
      (kv_int8 != 0) != (layout != 0) || splits < 1 || splits > kMaxSplits ||
      split_rows < 1 || (long long)splits * split_rows < s_len ||
      (long long)(splits - 1) * split_rows >= s_len ||
      (anc != nullptr &&
       (group != 1 || layout == 1 || beam_k < 1 || batch % beam_k != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && !kv_int8)
    return (int)dispatch<float, float>(q, k, v, bias, k_scale, v_scale, anc,
                                       beam_k, out, batch, group, num_heads, s_len, head_dim,
                                       splits, split_rows, sm_scale, layout, st);
  if (q_dtype == 0 && kv_int8)
    return (int)dispatch<float, int8_t>(q, k, v, bias, k_scale, v_scale, anc,
                                        beam_k, out, batch, group, num_heads, s_len, head_dim,
                                        splits, split_rows, sm_scale, layout, st);
  if (q_dtype == 1 && !kv_int8)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, bias, k_scale, v_scale, anc, beam_k, out, batch, group, num_heads, s_len,
        head_dim, splits, split_rows, sm_scale, layout, st);
  if (q_dtype == 1 && kv_int8)
    return (int)dispatch<__nv_bfloat16, int8_t>(
        q, k, v, bias, k_scale, v_scale, anc, beam_k, out, batch, group, num_heads, s_len,
        head_dim, splits, split_rows, sm_scale, layout, st);
  return (int)cudaErrorInvalidValue;
}
