// Decode attention for Hopper (sm_90a): one new query position per query row
// against K/V caches, in two kernels.
//
// Both replace the Pallas TPU kernel `_kernel` of
// joeys2t_tpu/ops/decode_attention.py (:42, launched by `decode_attention` at
// :185). Per (query row r, head h), over the cache vectors (cache row, slot s)
// that the query reads:
//   scores = (q[r, h] * sm_scale) . K[row(r, s), h, s]^T + bias[r, s]   f32
//   p      = softmax(scores)                                           f32
//   ctx    = p . V[row(r, s), h, s]                                    f32 accumulate
// over (B, H, S, D) caches in f32, bf16 or int8. int8 caches carry scales that
// fold exactly as the Pallas kernel folds them (:61-90):
//   layout 1 "channel"  (B, H, D): into q before the scores (K) and into ctx
//                                  after the sum (V) -- the cross-attention cache;
//   layout 2 "position" (B, H, S): into the scores (K) and into p (V) -- the
//                                  self-attention ring buffer.
// Unlike the Pallas kernel (:64), the scaled q is NOT rounded to bf16: the
// scores are full f32 products, as in the JAX einsum path.
//
// Masked slots are not read: a slot whose bias is at or below NEG_INF / 2 is
// skipped (its K, V and "position" scales are not loaded); its
// exp(score - max) is exactly 0 in f32 once the query has a valid key, so
// skipping it changes only the order of the sums. If no block of the cluster
// read a slot for a query (every key masked), a second pass reads every slot
// for that query: the softmax over the (nearly equal) masked scores is the
// plain version's. Both kernels merge inside the kernel, in a fixed order,
// with no atomics and no global scratch, so two calls give the same bits:
// lanes merge across slot groups by shuffles, warps through shared memory,
// and the blocks of a cluster through distributed shared memory: after
// cluster.sync(), rank 0 reads every rank's (max, sum, acc) in rank order,
// rescales, divides and writes the output; a later cluster.sync() keeps the
// other blocks' shared memory alive until it is read.
//
// 1. One query a cache row (`decode_attention_kernel`): greedy decoding, the
//    physically reordered beam caches, `test -a`'s layers. Query row r reads
//    cache row r. Each cache element is read once and used for one
//    multiply-add, about 1 flop per byte against the H100's ridge of ~295, so
//    the kernel is bound by the bytes of K and V; a matrix-vector product has
//    no use for tensor cores. Grid (splits, H, B), 4 warps a block; the blocks
//    of one (b, h) split S into `splits` ranges of `split_rows` rows and form
//    one thread-block cluster (ops/decode_attention.decode_plan: 1 split once
//    B*H fills the card's 132 SMs, below that up to 16 splits of at least 96
//    rows, for about 2 blocks an SM). Each warp streams its rows of K and V
//    with 16-byte loads (8-byte where a lane's share of a row is 24 bytes),
//    U row groups a step, the next step's loads requested before the current
//    one is used, with the bias of the step after that, and keeps a running
//    max, sum and accumulator in f32 registers (online softmax); nothing of
//    size S lives in shared memory. (250 registers a thread at bf16 D=128, no
//    spills.) Head dim 16: a 32-byte bf16 row is 2 lanes of 16 bytes, so one
//    warp load covers 16 rows.
//
// 2. Several queries over shared cache vectors (`multi_query_kernel`): G query
//    rows j = 0..G-1 of utterance u read, at slot s, cache row
//      group mode     u                                  (G = `group`)
//      ancestry mode  u*G + clamp(anc[u, j, s], 0, G-1)  (G = the beam size K)
//    Group mode is beam search's cross attention: the B-row cache that the K
//    beams of an utterance share (the JAX einsum "bkhd,bhsd->bkhs" of
//    joeys2t_tpu/models/modules.py `step_cross`, :449-455), channel scales or
//    none. Ancestry mode is lazy beam search's self attention: the B*K beam
//    rows' own ring buffers, never permuted, read through the (B, K, S) map of
//    which beam row wrote each slot of a beam's history (`step_self_ancestry`,
//    :320-412, an einsum with no Pallas kernel), position scales or none;
//    the physical beam reorder reads its reordered buffers through the map
//    of each row's own rows, so both reorders run this arithmetic. Group
//    mode is the ancestry mode on a row set of stride 0; one template with a
//    compile-time row source serves both.
//    What bounds it: the bytes of the distinct (cache row, slot) vectors the
//    queries need -- in group mode the B-row cache once, in ancestry mode
//    each slot's distinct rows (before the beams diverge, one row a slot) --
//    at about G flops a byte, still far under the ridge: SIMT products, no
//    tensor cores. With the reads shared, the G queries' arithmetic is what
//    is left to make cheap: per (slot, query) a D-long dot product, a softmax
//    step and a D-long multiply-add.
//    Design: grid (splits, H, B * chunks) over utterances, not query rows;
//    one block, or one split-S cluster (splits of 96 slots from slot 0, over
//    the slots the step can use: a slot's split and tile depend on its index
//    alone and masked slots add exact zeros, so an utterance's bits do not
//    depend on its batch or its padding), serves all G queries of (u, h)
//    (chunks of up to 8 queries; beam sizes above 8 read the rows once a
//    chunk). A split is cut into tiles of T slots (T * row bytes <= 1.5 KB),
//    tile i to warp i % 4; each warp
//    streams its tiles through its own ring of shared-memory stages (4 in
//    group mode, 2-3 in ancestry mode, whose stages hold up to G vectors a
//    slot) with 16-byte `cp.async`, so loads land in shared memory and not in
//    registers. For a tile, lane (slot, j) reads the map entry and the bias
//    (in registers, three tiles ahead), and the vector (row, slot) is loaded
//    once: by the first query j that names that row and takes the slot (group
//    mode: the tile's slots are one run of K and of V). Each query then reads
//    its row's vector from shared memory by index. A tile is one batch of the
//    online softmax, scores kept in base 2 (ex2):
//     - scores: lane (slot, part of D) forms the 8 queries' partial dot
//       products (q, scaled, in shared memory); a reduce-scatter over the
//       parts leaves each lane one (slot, query) score: 7 shuffles for all
//       queries, not log2(32) for each;
//     - softmax: lane (slot, query) takes its query's max and sum over the
//       tile's slots by shuffles: one instruction stream for every query;
//     - context: lane-per-column, each query's context rescaled once a tile
//       and each (slot, query) probability broadcast to the lanes.
//    Warps, blocks and ranks merge weighted by 2^(their max - the merged max),
//    each rank writing a share of the outputs. No step of the arithmetic
//    depends on the row source or on where a vector lies in shared memory, so
//    group G over a B-row cache gives the bits of the ancestry mode over the
//    cache repeated G times with each query's own row, and the ancestry mode
//    over a map gives the bits of the ancestry mode over the caches
//    reordered as the map says.
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
constexpr float kNegInf = -1e9f;           // NEG_INF: the bias of a slot past s_used

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

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        TQ* __restrict__ out, int s_len, int split_rows,
                        float sm_scale, int layout) {
  using G = Geometry<TKV, D>;
  constexpr int L = G::kLanes, R = G::kRows, E = G::kElems, NW = G::kWords,
                U = G::kUnroll, kStride = kWarps * U * R;
  __shared__ float warp_part[kWarps][D + 2];  // acc (D), max, sum
  __shared__ float block_part[D + 2];

  // query row b reads cache row b; the q and out offset of the (b, h) is
  // recomputed where it is used, so that it holds no register through the
  // main loop
  const int split = blockIdx.x, b = blockIdx.z;
  const size_t bh = (size_t)b * gridDim.y + blockIdx.y;  // caches and scales
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
  const int slot = lane / L, col = (lane % L) * E;
  const int s0 = split * split_rows, s1 = min(s_len, s0 + split_rows);
  const float* bias_row = bias + (size_t)b * s_len;
  const char* kb = reinterpret_cast<const char*>(k + bh * s_len * D) + col * sizeof(TKV);
  const char* vb = reinterpret_cast<const char*>(v + bh * s_len * D) + col * sizeof(TKV);
  const float* ks_row = k_scale + bh * s_len;  // layout 2 only
  const float* vs_row = v_scale + bh * s_len;

  // q for this lane's columns, scaled (and the channel K scales folded in)
  // exactly as the plain version scales it
  float qr[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float x = __fmul_rn(to_float(q[bh * D + col + i]), sm_scale);
    if (layout == kChannel) x = __fmul_rn(x, __ldg(k_scale + bh * D + col + i));
    qr[i] = x;
  }

  // the bias of a step's rows
  auto load_bias = [&](float (&bs)[U], int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * R + slot;
      bs[u] = r < s1 ? __ldg(bias_row + r) : -INFINITY;
    }
  };
  auto fetch = [&](Step<NW, U>& st, const float (&bs)[U], int base, bool skip) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * R + slot;
      st.bias[u] = bs[u];
      st.take[u] = r < s1 && (!skip || bs[u] > kMaskedAtOrBelow);
      st.ks[u] = st.vs[u] = 1.f;
      if (st.take[u]) {
        load_words(st.kw[u], kb + (size_t)r * G::kRowBytes);
        load_words(st.vw[u], vb + (size_t)r * G::kRowBytes);
        if (layout == kPosition) st.ks[u] = __ldg(ks_row + r), st.vs[u] = __ldg(vs_row + r);
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
    int base = s0 + warp * U * R;
    load_bias(bias_next, base);
    if (base < s1) fetch(st_a, bias_next, base, skip), load_bias(bias_next, base + kStride);
    while (base < s1) {
      if (base + kStride < s1)
        fetch(st_b, bias_next, base + kStride, skip),
            load_bias(bias_next, base + 2 * kStride);
      consume(st_a);
      if ((base += kStride) >= s1) break;
      if (base + kStride < s1)
        fetch(st_a, bias_next, base + kStride, skip),
            load_bias(bias_next, base + 2 * kStride);
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
    store(out + bh * D + c, x);
  }
  cluster.sync();  // rank 0 has read every block's shared memory
}

// ---------------------------------------------------------------------------
// The multi-query kernel (2. above).

constexpr int kMaxQueries = 8;  // queries a block serves (a chunk)

// Slots a tile of a warp's ring, which is one batch of the online softmax
// (one rescale a tile and query): 4, fewer where rows are long (a stage of
// ancestry mode holds up to 8 vectors a slot).
__host__ __device__ constexpr int tile_slots(int row_bytes) {
  return row_bytes <= 384 ? 4 : row_bytes <= 768 ? 2 : 1;
}

template <typename T, int D, bool kAnc>
struct Multi {
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kPieces = kRowBytes / 16;        // 16-byte copies a vector
  static constexpr int kTile = tile_slots(kRowBytes);  // T: slots a batch and tile
  // scores: lane (slot c, part k) of P = 32 / T parts sums chunks k, k + P, ...
  // of CE elements
  static constexpr int kParts = 32 / kTile;
  static constexpr int kChunk = (D / kParts) % 8 == 0 ? 8 : (D / kParts) % 4 == 0 ? 4 : 2;
  static constexpr int kChunks = D / kParts / kChunk;  // chunks a lane
  // context: lane group g of LV lanes holds columns of EV elements, of the
  // batch's slots g, g + RV, ...
  static constexpr int kVElems = D / 32 < 2 ? 2 : D / 32;  // EV
  static constexpr int kVLanes = D / kVElems;              // LV
  static constexpr int kVGroups = 32 / kVLanes;            // RV
  // stages of a warp's ring: ancestry mode's hold up to 8 vectors a slot, 3
  // stages where rows are short (int8), else 2
  static constexpr int kStages = !kAnc ? 4 : kRowBytes <= 128 ? 3 : 2;
  static_assert(kRowBytes % 16 == 0 && kTile * kMaxQueries <= 32 && kTile % kVGroups == 0 &&
                    kChunks * kChunk * kParts == D,
                "vector shape");
};

// Bytes of one stage: K and V vectors (T * nv), their "position" scales, the
// tile's (slot, query) table of vector index and bias, and its busy slots.
__host__ __device__ inline int stage_bytes(int tile, int nv, int row_bytes) {
  return (2 * tile * nv * row_bytes + 8 * tile * nv + 8 * tile * kMaxQueries + 4 + 15) & ~15;
}

// Dynamic shared memory of a block: the warps' rings (reused for the warps'
// partial states once the slots are done), the block's partial states, the
// parts' weights in a merge, the scaled queries, the cluster ranks' max and
// sum, and the queries' second-pass flags.
__host__ __device__ inline int ring_bytes(int stages, int tile, int nv, int row_bytes,
                                          int d) {
  const int rings = kWarps * stages * stage_bytes(tile, nv, row_bytes);
  const int warp_parts = kWarps * kMaxQueries * (d + 2) * 4;
  return ((rings > warp_parts ? rings : warp_parts) + 15) & ~15;
}
__host__ __device__ inline int multi_smem_bytes(int stages, int tile, int nv, int row_bytes,
                                                int d) {
  return ring_bytes(stages, tile, nv, row_bytes, d) + kMaxQueries * (d + 2) * 4 +
         kMaxQueries * 16 * 4 + kMaxQueries * d * 4 + kMaxQueries * 32 * 4 + kMaxQueries * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x + the x of lane ^ o
__device__ __forceinline__ float add_xor(float x, int o) {
  return x + __shfl_xor_sync(0xffffffffu, x, o);
}

// 8 consecutive elements of global memory (16-byte aligned), as f32
template <typename T, int E>
__device__ __forceinline__ void read_global(float (&x)[E], const T* p) {
  static_assert(E * sizeof(T) % 16 == 0, "16-byte loads");
  uint32_t w[E * sizeof(T) / 4];
#pragma unroll
  for (int i = 0; i < (int)(E * sizeof(T) / 16); ++i) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
    w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z, w[4 * i + 3] = u.w;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) x[i] = element<T>(w, i);
}

// 2^x (ex2.approx: 2 ulp; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A lane's E elements of a vector in shared memory, as f32.
template <typename T, int E>
__device__ __forceinline__ void read_elems(float (&x)[E], const T* p) {
  constexpr int kBytes = E * (int)sizeof(T);
  if constexpr (kBytes % 4 != 0) {  // int8, 2 or 6 elements: 2-byte words
    static_assert(sizeof(T) == 1 && E % 2 == 0, "lane share of a vector");
#pragma unroll
    for (int i = 0; i < E / 2; ++i) {
      const uint32_t hw = reinterpret_cast<const uint16_t*>(p)[i];
      x[2 * i] = (float)((int32_t)(hw << 24) >> 24);
      x[2 * i + 1] = (float)((int32_t)(hw << 16) >> 24);
    }
  } else {
    uint32_t w[kBytes / 4];
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i) {
        const uint4 u = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z, w[4 * i + 3] = u.w;
      }
    } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 8; ++i) {
        const uint2 u = reinterpret_cast<const uint2*>(p)[i];
        w[2 * i] = u.x, w[2 * i + 1] = u.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = element<T>(w, i);
  }
}

template <typename TQ, typename TKV, int D, bool kAnc>
__global__ void __launch_bounds__(kThreads, !kAnc && D <= 128 ? 4 : 1)
multi_query_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                   const TKV* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                   const int* __restrict__ anc, TQ* __restrict__ out, int queries,
                   int chunks, int s_len, int s_used, int split_rows, float sm_scale,
                   int layout) {
  using M = Multi<TKV, D, kAnc>;
  constexpr int T = M::kTile, P = M::kParts, CE = M::kChunk, NCH = M::kChunks,
                EV = M::kVElems, LV = M::kVLanes, RV = M::kVGroups, RB = M::kRowBytes,
                Q = kMaxQueries, NS = M::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, h = blockIdx.y, H = gridDim.y, splits = gridDim.x;
  const int u = blockIdx.z / chunks, q0 = (blockIdx.z % chunks) * Q;
  const int nq = min(Q, queries - q0);  // this block's queries
  const int nv = kAnc ? nq : 1;         // vectors a slot of a stage holds
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
  const int slot_c = lane / P, part = lane % P;  // scores: slot and part of D
  // where element e of the queries (row j * D + column) lies in qs
  auto q_at = [&](int e) {
    return CE == 8 ? e / D * D + e % 8 / 4 * (D / 2) + e % D / 8 * 4 + e % 4 : e;
  };
  const int vgrp = lane / LV, vcol = (lane % LV) * EV;  // context: slot group, columns
  const int sbytes = stage_bytes(T, nv, RB);
  unsigned char* ring = smem + (size_t)warp * NS * sbytes;
  float* warp_part = reinterpret_cast<float*>(smem);  // [kWarps][Q][D + 2], after the slots
  float* block_part =
      reinterpret_cast<float*>(smem + ring_bytes(NS, T, nv, RB, D));  // [Q][D + 2]
  float* weight = block_part + Q * (D + 2);  // [Q][16]: a part's weight in a merge
  float* qs = weight + Q * 16;               // [Q][D]: q, scaled
  float* rank_ml = qs + Q * D;               // [Q][16][2]: each rank's max and sum
  int* need_s = reinterpret_cast<int*>(rank_ml + Q * 32);  // [Q]

  // query j's row of q, out, the bias and the map
  auto query_row = [&](int j) { return (size_t)u * queries + q0 + j; };
  auto bias_row = [&](int j) { return bias + (kAnc ? query_row(j) : (size_t)u) * s_len; };

  float mq, lq, acc[Q][EV];  // the online softmax: lane (slot, j)'s max and sum of
                             // query j (the same in every slot), the context
  unsigned need = 0;         // the queries that read no slot in the first pass
  cg::cluster_group cluster = cg::this_cluster();
  for (int pass = 0;; ++pass) {
    const int span = pass == 0 ? split_rows : (s_len + splits - 1) / splits;
    const int lo = split * span, hi = min(pass == 0 ? s_used : s_len, lo + span);
    // tile i of the split is slots lo + T i .. lo + T i + T - 1, warp i % 4's,
    // in every mode
    const int tiles = hi > lo ? (hi - lo + T - 1) / T : 0;
    const int nt = tiles > warp ? (tiles - warp + kWarps - 1) / kWarps : 0;
    auto slot_of = [&](int tt, int c) { return lo + (tt * kWarps + warp) * T + c; };

    // a tile's (slot, query) pair (c, j) = (lane / Q, lane % Q)
    struct Meta {
      float bias;  // -inf: no such pair
      int anc;
    };
    auto load_meta = [&](int tt) {
      Meta mt;
      const int c = lane / Q, j = lane % Q, s = slot_of(tt, c);
      const bool ok = tt < nt && c < T && j < nq && s < hi;
      mt.bias = !ok ? -INFINITY : s < s_used ? __ldg(bias_row(j) + s) : kNegInf;
      mt.anc = kAnc && ok ? __ldg(anc + query_row(j) * s_len + s) : 0;
      return mt;
    };
    // the tables of the first tiles are requested before anything else
    Meta ma = load_meta(0), mb = load_meta(1), mc = load_meta(2);
    if (pass == 0) {
      // Scores are kept in base 2: q carries sm_scale * log2(e) (and the
      // channel K scales), the bias log2(e). In shared memory a query's
      // 8-element chunks lie in two planes of their 16-byte halves, which
      // lanes then read conflict-free.
      for (int x = t * 8; x < nq * D; x += kThreads * 8) {
        const int j = x / D, c = x % D;
        float y[8], ks[8];
        read_global<TQ, 8>(y, q + (query_row(j) * H + h) * D + c);
        if (layout == kChannel) read_global<float, 8>(ks, k_scale + ((size_t)u * H + h) * D + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float z = __fmul_rn(y[i], sm_scale);
          if (layout == kChannel) z = __fmul_rn(z, ks[i]);
          qs[q_at(x + i)] = __fmul_rn(z, kLog2e);
        }
      }
    }
    mq = -INFINITY, lq = 0.f;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
#pragma unroll
      for (int i = 0; i < EV; ++i) acc[j][i] = 0.f;
    }
    // zero the ring: a vector no query takes is read (and multiplied by 0)
    for (int x = lane; x < NS * sbytes / 16; x += 32)
      reinterpret_cast<uint4*>(ring)[x] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();  // the ring is zeroed, q is in shared memory

    // the table of a tile, and copies of the vectors it needs, into its stage
    auto issue = [&](int tt, const Meta& mt) {
      unsigned char* st = ring + (tt % NS) * sbytes;
      unsigned char* kd = st;
      unsigned char* vd = st + T * nv * RB;
      float* ksd = reinterpret_cast<float*>(st + 2 * T * nv * RB);
      float* vsd = ksd + T * nv;
      int* vidx = reinterpret_cast<int*>(vsd + T * nv);
      float* bsd = reinterpret_cast<float*>(vidx + T * Q);
      int* busy = reinterpret_cast<int*>(bsd + T * Q);  // bit c: a query takes slot c
      const int c = lane / Q, j = lane % Q;
      const bool ok = mt.bias != -INFINITY;
      const bool take = ok && (pass == 0 ? mt.bias > kMaskedAtOrBelow : (need >> j) & 1);
      const int rel = kAnc ? min(max(mt.anc, 0), queries - 1) : 0;
      int first = kAnc ? j : 0;  // the first query of the slot that takes this row
      if constexpr (kAnc) {
        const int key = take ? rel : -1;
#pragma unroll
        for (int jj = Q - 1; jj >= 0; --jj) {
          const int other = __shfl_sync(0xffffffffu, key, (lane & ~(Q - 1)) | jj);
          if (jj < j && other == key) first = jj;
        }
      }
      if (c < T) vidx[lane] = take ? c * nv + first : -1, bsd[lane] = mt.bias * kLog2e;
      const unsigned takes = __ballot_sync(0xffffffffu, take);
      if (lane == 0) {
        int slots = 0;
#pragma unroll
        for (int cc = 0; cc < T; ++cc) slots |= ((takes >> (cc * Q)) & 0xffu) ? 1 << cc : 0;
        *busy = slots;
      }
      const size_t head = (size_t)u * queries * H + h;  // (u's first row, h) in rows of H
      if constexpr (!kAnc) {
        // group mode: the tile's slots are one run of K (and V) of (u, h)
        const size_t run = ((size_t)u * H + h) * s_len + slot_of(tt, 0);
        const unsigned char* kg = reinterpret_cast<const unsigned char*>(k + run * D);
        const unsigned char* vg = reinterpret_cast<const unsigned char*>(v + run * D);
#pragma unroll
        for (int pc = lane; pc < 2 * T * M::kPieces; pc += 32) {
          const int which = pc / (T * M::kPieces), rest = pc % (T * M::kPieces);
          const int cc = rest / M::kPieces;
          if ((takes >> (cc * Q)) & 1)
            cp_async16((which ? vd : kd) + rest * 16, (which ? vg : kg) + rest * 16);
        }
        if (layout == kPosition && c < T && j == 0 && take)
          cp_async4(ksd + c, k_scale + run + c), cp_async4(vsd + c, v_scale + run + c);
      } else {
        // ancestry mode: one vector for each first query of a row, its
        // offset (in vectors) handed to the warp
        const long long vec =
            (long long)((head + (size_t)rel * H) * s_len + slot_of(tt, c));  // (row, h, slot)
        unsigned loads = __ballot_sync(0xffffffffu, take && first == j);
        while (loads) {
          const int src = __ffs(loads) - 1;
          loads &= loads - 1;
          const long long sv = __shfl_sync(0xffffffffu, vec, src);
          const int at = (src / Q) * nv + src % Q;
          const unsigned char* kg = reinterpret_cast<const unsigned char*>(k + sv * D);
          const unsigned char* vg = reinterpret_cast<const unsigned char*>(v + sv * D);
#pragma unroll
          for (int pc = lane; pc < 2 * M::kPieces; pc += 32) {
            if (pc < M::kPieces)
              cp_async16(kd + at * RB + pc * 16, kg + pc * 16);
            else
              cp_async16(vd + at * RB + (pc - M::kPieces) * 16, vg + (pc - M::kPieces) * 16);
          }
        }
        if (layout == kPosition && take && first == j)
          cp_async4(ksd + c * nv + j, k_scale + vec), cp_async4(vsd + c * nv + j, v_scale + vec);
      }
      cp_async_commit();
    };
    // One batch (the tile's T slots) for every query. Scores: lane (slot c,
    // part k) forms the 8 queries' dot products over its part of D; a
    // reduce-scatter over the parts leaves query k % 8's score of slot c in
    // lane (c, k). Softmax: lane (c, j) takes the batch's max and sum over its
    // query's slots. Context: lane group g of LV lanes, columns of EV, adds
    // slots g, g + RV, ... for every query (a slot a query does not take adds
    // p = 0).
    auto compute = [&](int tt) {
      const unsigned char* st = ring + (tt % NS) * sbytes;
      const TKV* kd = reinterpret_cast<const TKV*>(st);
      const TKV* vd = reinterpret_cast<const TKV*>(st + T * nv * RB);
      const float* ksd = reinterpret_cast<const float*>(st + 2 * T * nv * RB);
      const float* vsd = ksd + T * nv;
      const int* vidx = reinterpret_cast<const int*>(vsd + T * nv);
      const float* bsd = reinterpret_cast<const float*>(vidx + T * Q);
      if (!__any_sync(0xffffffffu, *reinterpret_cast<const int*>(bsd + T * Q)))
        return;  // no slot taken
      float dot[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) dot[j] = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int x = i * P + part;  // the chunk
        float kx[CE];
        if constexpr (!kAnc) read_elems<TKV, CE>(kx, kd + slot_c * D + x * CE);
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          if (j >= nq) break;
          if constexpr (kAnc) {
            const int vi = vidx[slot_c * Q + j];
            read_elems<TKV, CE>(kx, kd + (vi < 0 ? slot_c * nv : vi) * D + x * CE);
          }
          float qx[CE];
          if constexpr (CE == 8) {
            float lo4[4], hi4[4];
            read_elems<float, 4>(lo4, qs + j * D + x * 4);
            read_elems<float, 4>(hi4, qs + j * D + D / 2 + x * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) qx[e] = lo4[e], qx[e + 4] = hi4[e];
          } else {
            read_elems<float, CE>(qx, qs + j * D + x * CE);
          }
#pragma unroll
          for (int e = 0; e < CE; ++e) dot[j] = fmaf(qx[e], kx[e], dot[j]);
        }
      }
      // reduce-scatter over part bits 2, 1, 0: a lane keeps the half of the
      // queries its bit names and adds its partner's; then the part bits above
      float w4[4], w2[2];
      const bool b2 = part & 4, b1 = part & 2, b0 = part & 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w4[i] = (b2 ? dot[i + 4] : dot[i]) +
                __shfl_xor_sync(0xffffffffu, b2 ? dot[i] : dot[i + 4], 4);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w2[i] = (b1 ? w4[i + 2] : w4[i]) +
                __shfl_xor_sync(0xffffffffu, b1 ? w4[i] : w4[i + 2], 2);
      float score = (b0 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, b0 ? w2[0] : w2[1], 1);
#pragma unroll
      for (int o = 8; o < P; o <<= 1) score = add_xor(score, o);

      // the softmax step of lane (slot c, query j)
      const int jq = part & 7, vi = vidx[slot_c * Q + jq];
      const bool take = vi >= 0;
      if (layout == kPosition) score = __fmul_rn(score, ksd[take ? vi : 0]);
      const float sc = take ? __fadd_rn(score, bsd[slot_c * Q + jq]) : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int o = P; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(mq, mx), ref = finite_or_zero(mn);
      const float alpha = ex2(mq - ref);  // 1 where the max stays, 0 for a fresh state
      mq = mn;
      const float p = ex2(sc - ref);
      float ps = p;  // the batch's sum over the query's slots
#pragma unroll
      for (int o = P; o < 32; o <<= 1) ps = add_xor(ps, o);
      lq = fmaf(lq, alpha, ps);
      const float pv = layout == kPosition ? __fmul_rn(p, vsd[take ? vi : 0]) : p;

      float vx[T / RV][EV];  // group mode: the slots' V columns, for every query
      if constexpr (!kAnc) {
#pragma unroll
        for (int cc = 0; cc < T / RV; ++cc)
          read_elems<TKV, EV>(vx[cc], vd + (cc * RV + vgrp) * D + vcol);
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (j >= nq) break;
        const float a = __shfl_sync(0xffffffffu, alpha, j);  // lane j: slot 0, query j
#pragma unroll
        for (int i = 0; i < EV; ++i) acc[j][i] *= a;
#pragma unroll
        for (int cc = 0; cc < T / RV; ++cc) {
          const int c = cc * RV + vgrp;
          const float pc = __shfl_sync(0xffffffffu, pv, c * P + j);
          if constexpr (kAnc) {
            const int va = vidx[c * Q + j];
            float vy[EV];
            read_elems<TKV, EV>(vy, vd + (va < 0 ? c * nv : va) * D + vcol);
#pragma unroll
            for (int i = 0; i < EV; ++i) acc[j][i] = fmaf(pc, vy[i], acc[j][i]);
          } else {
#pragma unroll
            for (int i = 0; i < EV; ++i) acc[j][i] = fmaf(pc, vx[cc][i], acc[j][i]);
          }
        }
      }
    };

    // the warp's tiles: issued NS - 1 ahead, their tables three ahead of that
#pragma unroll
    for (int p = 0; p < NS - 1; ++p) issue(p, ma), ma = mb, mb = mc, mc = load_meta(p + 3);
    for (int tt = 0; tt < nt; ++tt) {
      issue(tt + NS - 1, ma);
      ma = mb, mb = mc, mc = load_meta(tt + NS + 2);
      cp_async_wait<NS - 1>();
      __syncwarp();
      compute(tt);
      __syncwarp();  // the stage is read before it is refilled
    }
    cp_async_wait<0>();

    // the slot groups of the context merge (same max), then warps, then
    // blocks, each part weighted by 2^(its max - the merged max)
#pragma unroll
    for (int o = LV; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (j >= nq) break;
#pragma unroll
        for (int i = 0; i < EV; ++i) acc[j][i] = add_xor(acc[j][i], o);
      }
    }
    __syncthreads();  // every warp is done with its ring, which holds warp_part now
    if (vgrp == 0) {
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (j >= nq) break;
        float* wp = warp_part + (warp * Q + j) * (D + 2);
#pragma unroll
        for (int i = 0; i < EV; ++i) wp[vcol + i] = acc[j][i];
      }
    }
    if (lane < nq) {  // lane j: slot 0, query j
      float* wp = warp_part + (warp * Q + lane) * (D + 2);
      wp[D] = mq, wp[D + 1] = lq;
    }
    __syncthreads();
    const unsigned mine_q = pass == 0 ? (1u << nq) - 1 : need;  // the queries of this pass
    if (t < nq && ((mine_q >> t) & 1)) {
      float mx = -INFINITY, sum = 0.f;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, warp_part[(w * Q + t) * (D + 2) + D]);
      const float ref = finite_or_zero(mx);
      for (int w = 0; w < kWarps; ++w) {
        const float* wp = warp_part + (w * Q + t) * (D + 2);
        const float a = ex2(wp[D] - ref);
        weight[t * 16 + w] = a;
        sum += a * wp[D + 1];
      }
      block_part[t * (D + 2) + D] = mx, block_part[t * (D + 2) + D + 1] = sum;
    }
    __syncthreads();
    for (int x = t; x < nq * D; x += kThreads) {
      const int j = x / D, c = x % D;
      if (!((mine_q >> j) & 1)) continue;
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        y = fmaf(weight[j * 16 + w], warp_part[(w * Q + j) * (D + 2) + c], y);
      block_part[j * (D + 2) + c] = y;
    }
    cluster.sync();
    // every block: the queries no block read a slot for; rank 0: each rank's
    // weight in the output (the ranks' max and sum read in parallel)
    for (int x = t; x < nq * splits; x += kThreads) {
      const int j = x / splits, rank = x % splits;
      const float* bp = cluster.map_shared_rank(block_part, rank) + j * (D + 2);
      rank_ml[2 * (j * 16 + rank)] = bp[D], rank_ml[2 * (j * 16 + rank) + 1] = bp[D + 1];
    }
    __syncthreads();
    if (t < nq && ((mine_q >> t) & 1)) {
      float mx = -INFINITY, sum = 0.f;
      for (int rank = 0; rank < splits; ++rank) mx = fmaxf(mx, rank_ml[2 * (t * 16 + rank)]);
      const float ref = finite_or_zero(mx);
      for (int rank = 0; rank < splits; ++rank) {
        const float a = ex2(rank_ml[2 * (t * 16 + rank)] - ref);
        weight[t * 16 + rank] = a;
        sum += a * rank_ml[2 * (t * 16 + rank) + 1];
      }
      if (pass == 0) need_s[t] = sum == 0.f;  // a block's sum is >= 1 once it read a slot
      for (int rank = 0; rank < splits; ++rank) weight[t * 16 + rank] /= sum;
    }
    __syncthreads();
    if (pass == 0)
      for (int j = 0; j < nq; ++j) need |= (unsigned)need_s[j] << j;
    // the ranks write the queries this pass finished, an equal share each
    const unsigned done = pass == 0 ? ((1u << nq) - 1) & ~need : need;
    for (int x = split * kThreads + t; x < nq * D; x += splits * kThreads) {
      const int j = x / D, c = x % D;
      if (!((done >> j) & 1)) continue;
      float y = 0.f;
#pragma unroll 4
      for (int rank = 0; rank < splits; ++rank)
        y = fmaf(weight[j * 16 + rank], cluster.map_shared_rank(block_part, rank)[j * (D + 2) + c],
                 y);
      if (layout == kChannel) y *= __ldg(v_scale + ((size_t)u * H + h) * D + c);
      store(out + (query_row(j) * H + h) * D + c, y);
    }
    if (pass == 1 || need == 0) break;
    cluster.sync();  // every block has read block_part before the second pass rewrites it
  }
  cluster.sync();  // every rank has read the others' shared memory
}

template <typename TQ, typename TKV, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* k_scale, const float* v_scale, void* out, int batch,
                   int num_heads, int s_len, int splits, int split_rows, float sm_scale,
                   int layout, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, TKV, D>;
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
  cfg.gridDim = dim3(splits, num_heads, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;  // one split: no cluster, which launches faster
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), bias, k_scale, v_scale, static_cast<TQ*>(out), s_len,
      split_rows, sm_scale, layout);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TQ, typename TKV, int D, bool kAnc>
cudaError_t launch_multi(const void* q, const void* k, const void* v, const float* bias,
                         const float* k_scale, const float* v_scale, const int* anc,
                         void* out, int utterances, int queries, int num_heads, int s_len,
                         int s_used, int splits, int split_rows, float sm_scale, int layout,
                         cudaStream_t stream) {
  using M = Multi<TKV, D, kAnc>;
  auto kernel = multi_query_kernel<TQ, TKV, D, kAnc>;
  const int chunks = (queries + kMaxQueries - 1) / kMaxQueries;
  const int nv = kAnc ? (queries < kMaxQueries ? queries : kMaxQueries) : 1;
  const int smem = multi_smem_bytes(M::kStages, M::kTile, nv, M::kRowBytes, D);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // per launch: the attribute is per device
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && splits > kPortableSplits)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, num_heads, utterances * chunks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(q),
                           static_cast<const TKV*>(k), static_cast<const TKV*>(v), bias,
                           k_scale, v_scale, anc, static_cast<TQ*>(out), queries, chunks,
                           s_len, s_used, split_rows, sm_scale, layout);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias,
                     const float* k_scale, const float* v_scale, const int* anc,
                     int beam_k, void* out, int batch, int group, int num_heads, int s_len,
                     int s_used, int head_dim, int splits, int split_rows, float sm_scale,
                     int layout, cudaStream_t stream) {
#define DECODE_LAUNCH(D)                                                           \
  launch<TQ, TKV, D>(q, k, v, bias, k_scale, v_scale, out, batch, num_heads, s_len, \
                     splits, split_rows, sm_scale, layout, stream)
#define MULTI_LAUNCH(D, ANC)                                                      \
  launch_multi<TQ, TKV, D, ANC>(q, k, v, bias, k_scale, v_scale, anc, out,        \
                                ANC ? batch / beam_k : batch, ANC ? beam_k : group, \
                                num_heads, s_len, s_used, splits, split_rows,     \
                                sm_scale, layout, stream)
#define DECODE_CASE(D)                                                             \
  case D:                                                                          \
    return anc != nullptr ? MULTI_LAUNCH(D, true)                                  \
           : group > 1    ? MULTI_LAUNCH(D, false)                                 \
                          : DECODE_LAUNCH(D);
  switch (head_dim) {
    DECODE_CASE(16)
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(192)
    DECODE_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
#undef MULTI_LAUNCH
#undef DECODE_LAUNCH
}

}  // namespace

// q (B * group, H, D), query row r reading cache row r / group; k/v (B, H,
// S, D); bias (B, S) f32 (with a map: (B, S), one row a query row); k_scale/v_scale f32 of (B, H, D) for layout 1,
// (B, H, S) for layout 2, unused (may be null) for 0. anc: null, or the
// (B / beam_k, beam_k, S) int32 ancestry map (group 1, layout 0 or 2):
// query row r reads, at position s, cache row r - r % beam_k + anc[r, s].
// out (B * group, H, D) in q's type. q_dtype: 0 = float32, 1 = bfloat16;
// kv_int8: 1 when the caches are int8 (then layout must be 1 or 2), else 0
// and the caches have q's type. With one query a cache row (group 1, no
// map) the one-query kernel runs and s_used must be S; else the
// multi-query kernel, over (cache row or utterance, head), reads slots
// 0..s_used-1 (later slots count as masked; 1 <= s_used <= S) and needs
// B (utterances: B / beam_k with a map) * ceil(queries / 8) <= 65535. S (or
// s_used) is cut into `splits` (1-16) ranges of `split_rows` rows, none of
// them empty. Every pointer is 16-byte aligned. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const float* bias, const float* k_scale,
                                    const float* v_scale, const int* anc,
                                    int beam_k, void* out, int batch,
                                    int group, int num_heads, int s_len, int s_used,
                                    int head_dim, int q_dtype, int kv_int8, int layout,
                                    int splits, int split_rows, float sm_scale,
                                    void* stream) {
  const bool multi = anc != nullptr || group > 1;
  const long long queries = anc != nullptr ? beam_k : group;
  const long long blocks_z =
      multi ? (anc != nullptr ? batch / (beam_k > 0 ? beam_k : 1) : batch) *
                  ((queries + kMaxQueries - 1) / kMaxQueries)
            : batch;
  if (batch <= 0 || group <= 0 || blocks_z > 65535 || num_heads <= 0 || s_len <= 0 ||
      s_used < 1 || s_used > s_len || (!multi && s_used != s_len) || layout < 0 ||
      layout > 2 || (kv_int8 != 0) != (layout != 0) || splits < 1 ||
      splits > kMaxSplits || split_rows < 1 || (long long)splits * split_rows < s_used ||
      (long long)(splits - 1) * split_rows >= s_used ||
      (anc != nullptr &&
       (group != 1 || layout == 1 || beam_k < 1 || batch % beam_k != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_DISPATCH(TQ, TKV)                                                       \
  (int)dispatch<TQ, TKV>(q, k, v, bias, k_scale, v_scale, anc, beam_k, out, batch, group, \
                         num_heads, s_len, s_used, head_dim, splits, split_rows,       \
                         sm_scale, layout, st)
  if (q_dtype == 0 && !kv_int8) return DECODE_DISPATCH(float, float);
  if (q_dtype == 0 && kv_int8) return DECODE_DISPATCH(float, int8_t);
  if (q_dtype == 1 && !kv_int8) return DECODE_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == 1 && kv_int8) return DECODE_DISPATCH(__nv_bfloat16, int8_t);
#undef DECODE_DISPATCH
  return (int)cudaErrorInvalidValue;
}
