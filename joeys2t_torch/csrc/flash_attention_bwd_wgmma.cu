// Flash attention backward for Hopper on its own machinery (sm_90a): wgmma,
// TMA and mbarriers. bf16, head dims 64 and 128.
//
// Replaces, for those head dims in bf16, the backward of the Pallas TPU
// kernels of joeys2t_tpu/ops/flash_attention.py: `_bwd_kernel` (:104,
// launched by `_flash_bwd` at :562) and `_bwd_kernel_bhsd` (:203, launched
// by `_flash_bwd_bhsd` at :306). Other head dims keep the mma.sync backward
// of flash_attention.cu, f32 its SIMT backward. Which head dims come here is
// the wrapper's choice alone (ops/flash_attention.py `bwd_route`); this
// library builds these two.
//
// Contract (as flash_attention.cu's flash_attention_bwd): q, d_out, out (B,
// Sq, H*D), k/v (B, Sk, H*D) bf16, bias (B, Sk) f32, lse (B, Sq, H) f32 from
// the forward; dq like q, dk/dv like k, delta (B, Sq, H) f32 scratch. The
// math is flash_attention.cu's (the Pallas `_bwd_kernel`, :104-161):
//   delta = rowsum(dO * out)
//   p = exp(s - lse), s = q.k^T sm_scale + bias; keys past Sk get -inf
//   dp_eff = keep ? dp / (1 - rate) : 0,  p_drop = keep ? p / (1 - rate) : 0
//   ds = p * (dp_eff - delta)
//   dq = sm_scale * ds . k,  dk = sm_scale * ds^T . q,  dv = p_drop^T . dO
// with the keep bits of the absolute (b, h, q, k) (row_key / keep of
// flash_attention_common.cuh), so the forward's mask is regenerated bit for
// bit; P_drop and dS are rounded to bf16 before their products and dQ, dK,
// dV summed in f32 and cast once. p is taken as 2^(fma(s, sm_scale log2 e,
// bias log2 e) - lse log2 e): one FFMA and one FADD before the EX2. At a row
// whose keys are all masked f32 rounds lse = -1e9 + log(Sk) to -1e9, and
// bias log2 e and lse log2 e then round alike while the score is far below
// their ulp, so p = 2^0 = 1 there: the Pallas rule.
//
// What bounds it on this card (H100 SXM, bf16): 10 B Sq Sk H D flops over
// (4 Sq + 4 Sk) H D bf16 elements read or written once; at Sq = Sk = S that
// is 5 S / 8 flop/byte against the 989 TF / 3.35 TB/s ~ 295 ridge: bytes at
// S = 250 (B=64, H=4, D=128: 0.0392 ms), operations at S = 750 (0.186 ms).
// The deterministic split below does 14 B Sq Sk H D flops (S and dP in both
// kernels) and takes exp and the dropout hash of every element twice, so
// the SIMT work between the products weighs as much as the products do.
//
// Design: three launches, no atomics, every output element one block's
// alone, so two calls give the same bits.
// - delta: flash_attention_common.cuh's warp-a-row kernel, unchanged.
// - A block is one warpgroup that owns 64 rows, two blocks an SM. It is its
//   own producer: lane 0 of warp 0 issues the TMA loads of a stage and warp
//   0 writes the stage's side data, a ring of kStages stages ahead of the
//   products. Eight warps an SM leave two warps a register-file quarter, so
//   a thread may hold 255 registers: dK and dV at D = 128 are 128 f32
//   registers a thread beside the 64 of S^T and dP^T. A producer warp or
//   warpgroup beside one or two consumer warpgroups (warp specialisation,
//   with or without setmaxnreg) puts three warps in a quarter; ptxas then
//   holds every thread to 168 registers, and the D = 128 dK/dV kernel
//   spilled 384-860 bytes and ran slower on the card (PERF.md).
// - dK/dV: one block per (64 keys, head, batch row), walking the q-tiles of
//   64 rows in the transposed orientation, wgmma's M on keys:
//     S^T = K.Q^T and dP^T = V.dO^T (m64n64k16, K, V, Q, dO all K-major
//     from the swizzled tiles), two wgmma groups; p and P_drop on S^T's
//     accumulator registers while dP^T runs, whose layout is the A
//     operand's: dV += P_drop^T.dO (m64nDk16, A from registers, dO read
//     MN-major through the transpose bit) runs while dS is formed; then
//     dK += dS^T.Q. No shared-memory round trip. lse, delta and the dropout
//     row keys are per column here: warp 0 writes the q-tile's 64 of each
//     into the stage (lse = +inf and delta = 0 past Sq, so padded queries
//     add exact zeros), loading them from device memory one tile ahead. dK
//     and dV stay in f32 registers across the q-tiles and are stored once.
// - dQ: one block per (64 queries, head, batch row) walking the key tiles
//   of 64 keys: S = Q.K^T, dP = dO.V^T, p while dP runs, ds on the
//   accumulator registers, dQ += dS.K with K read MN-major. Warp 0 writes
//   each key tile's 64 biases (-inf past Sk) into the stage.
// - The q-tiles and key tiles start at 0 and are 64 wide for every shape,
//   and masked or padded rows add exact zeros: a row's gradients do not
//   depend on the batch or the padding (an utterance alone equals its row
//   in a padded batch, bit for bit).
// - TMA: q, k, v and d_out are each a 4-D tensor map (D, S, H, B) over the
//   (B, S, H*D) buffer with boxes of 64 columns x 64 rows x 1 head x 1 batch
//   row and the 128-byte swizzle; a tile of 64 rows is D / 64 slabs of
//   8 KB. Rows past S are zero-filled without touching the next batch row.
//   The maps are encoded on the host (hopper_common.cuh) from the words the
//   wrapper plans (`wgmma_bwd_plan`).
// - Pipeline: the block's own tiles (K and V, or Q and dO) load once on
//   their own mbarrier; the streamed tiles (Q and dO, or K and V) fill a
//   ring of kStages stages, each with a full mbarrier on which lane 0 sets
//   the TMA bytes before its loads and warp 0's lanes arrive after their
//   side-data stores. A stage is filled again after a __syncthreads once
//   the warpgroup's last product of it has completed; a stuck wait traps
//   (hopper_common.cuh).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "hopper_common.cuh"

namespace {

// kRows is the rows of every box of the wrapper's tensor maps
// (ops/flash_attention.py WGMMA_BWD_ROWS); flash_attention_bwd_wgmma_info
// reports it and the wrapper checks its own against it when it loads this
// library.
constexpr int kRows = 64;  // a block's keys or queries (wgmma's M), a streamed tile
constexpr int kSlab = kRows * 128;  // a slab: 64 rows of one 128-byte swizzle row
constexpr int kThreads = 128;       // one warpgroup
constexpr int kMinBlocks = 2;       // two blocks an SM: 255 registers a thread
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory plan at head dim D. A tile is 64 rows x D columns: D /
// 64 slabs of 64 rows x 128 bytes. dK/dV: the block's K and V | Q stages |
// dO stages | per stage the q-tile's lse log2 e, delta and row keys (64
// each) | barriers. dQ: the block's Q and dO | K stages | V stages | per
// stage 64 biases log2 e | barriers.
template <int D>
struct BwdPlan {
  static_assert(D % kBoxCols == 0, "whole 64-column boxes");
  static constexpr int kLoads = D / kBoxCols;  // TMA boxes a tile
  static constexpr int kTile = kLoads * kSlab;
  static constexpr int kStages = 2;
  static constexpr int kStageOff = 2 * kTile;  // after the block's own two tiles
  static constexpr int kSideOff = kStageOff + 2 * kStages * kTile;
  static constexpr int kBars = 1 + kStages;  // own tiles; each stage
  static constexpr int kDkdvBarOff = kSideOff + kStages * 3 * kRows * 4;
  static constexpr int kDqBarOff = kSideOff + kStages * kRows * 4;
  static_assert(2 * kRows * (D + 8) * 2 <= 2 * kStages * kTile,
                "dK and dV leave through the stages");
  // 1024 bytes of slack: the 128-byte swizzle wants 1024-byte aligned tiles
  static constexpr size_t kDkdvBytes = kDkdvBarOff + kBars * 8 + 1024;
  static constexpr size_t kDqBytes = kDqBarOff + kBars * 8 + 1024;
};

// The 1024-byte aligned start of the dynamic shared memory.
__device__ __forceinline__ uint32_t aligned_base(uint8_t* raw_ptr, uint8_t*& smem) {
  const uint32_t raw = smem_addr(raw_ptr);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  smem = raw_ptr + pad;
  return raw + pad;
}

__device__ __forceinline__ void init_barriers(uint32_t own_full, uint32_t full, int stages) {
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < stages; ++s) mbar_init(full + 8 * s, 32);  // warp 0's lanes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The block's own tiles (rows r0 .. r0 + 63 of a and b) into the first two
// tiles of shared memory, completing on `bar`; lane 0 of warp 0.
template <int D>
__device__ __forceinline__ void load_own(uint32_t base, const CUtensorMap* a,
                                         const CUtensorMap* b, uint32_t bar, int r0, int h,
                                         int batch) {
  using P = BwdPlan<D>;
  mbar_arrive_tx(bar, 2 * P::kTile);
  for (int c = 0; c < P::kLoads; ++c) {
    tma_load(base + c * kSlab, a, bar, c * kBoxCols, r0, h, batch);
    tma_load(base + P::kTile + c * kSlab, b, bar, c * kBoxCols, r0, h, batch);
  }
}

// Sets the stage's TMA bytes and starts its loads (rows r0 .. r0 + 63 of a
// and b); lane 0 of warp 0, before the lanes' side-data stores, each lane
// then arriving on `bar` (finish_q_tile, fill_k_tile).
template <int D>
__device__ __forceinline__ void load_stage(uint32_t base, int stage, const CUtensorMap* a,
                                           const CUtensorMap* b, uint32_t bar, int r0,
                                           int h, int batch) {
  using P = BwdPlan<D>;
  mbar_expect_tx(bar, 2 * P::kTile);
  for (int c = 0; c < P::kLoads; ++c) {
    const uint32_t off = stage * P::kTile + c * kSlab;
    tma_load(base + P::kStageOff + off, a, bar, c * kBoxCols, r0, h, batch);
    tma_load(base + P::kStageOff + P::kStages * P::kTile + off, b, bar, c * kBoxCols, r0,
             h, batch);
  }
}

// 64 x 64 scores (+)= a (64 x D, K-major, this block's rows) . b^T (64 rows
// x D, K-major): D / 16 steps of 16 columns, 32 bytes within a 128-byte
// swizzle row, the next slab every 4 steps.
template <int D>
__device__ __forceinline__ void scores(float (&d)[32], uint64_t a, uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in = ((kk / 4) * kSlab + (kk % 4) * 32) >> 4;
    wgmma_ss_n64(d, a + in, b + in, kk > 0);
  }
}

// acc (64 x D) += x (64 x 64 in bf16 pairs: a scores call's accumulator
// registers rounded pair by pair, x[2 i] = (v[4 i], v[4 i + 1]), x[2 i + 1] =
// (v[4 i + 2], v[4 i + 3]), which is the A operand's layout) . b (64 rows x
// D, read MN-major: LBO the next slab, SBO 8 rows, a step of 16 rows 2048
// bytes).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&x)[16],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const uint32_t a[4] = {x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3]};
    wgmma_rs<D>(acc, a, b + ((kk * 16 * 128) >> 4));
  }
}

// ------------------------------------------------------------- dK and dV
// The side data of q-tile t that lane `lane` of warp 0 writes: lse log2 e
// and delta of queries q0 + lane and q0 + lane + 32, read from device
// memory a tile ahead of their stores (+inf and 0 past Sq: p = 0, ds = 0).
struct QSide {
  float lse[2], delta[2];
  __device__ __forceinline__ void load(const float* __restrict__ lse_g,
                                       const float* __restrict__ delta_g, size_t stats, int q0,
                                       int lane, int sq, int num_heads) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + lane + 32 * i;
      const bool ok = q < sq;
      lse[i] = ok ? __ldg(lse_g + stats + (size_t)q * num_heads) * kLog2e : INFINITY;
      delta[i] = ok ? __ldg(delta_g + stats + (size_t)q * num_heads) : 0.f;
    }
  }
};

// Warp 0 finishes filling `stage` with q-tile t, whose TMA lane 0 started
// (load_stage): the side data (lse log2 e, delta, dropout row keys) of its
// 64 queries, each lane then arriving on the stage's barrier.
template <bool DROP>
__device__ __forceinline__ void finish_q_tile(float* side, uint32_t full, int stage, int t,
                                              int lane, const QSide& qs, uint32_t seed, int b,
                                              int h) {
  float* st = side + stage * 3 * kRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = lane + 32 * i;
    st[j] = qs.lse[i];
    st[kRows + j] = qs.delta[i];
    reinterpret_cast<uint32_t*>(st)[2 * kRows + j] = DROP ? row_key(seed, b, h, t * kRows + j)
                                                         : 0u;
  }
  mbar_arrive(full + 8 * stage);  // release: this lane's stores are in shared memory
}

// dK and dV leave through the drained stages: each 64 x D tile of f32
// accumulator registers (times a scale) is written as bf16 rows padded by
// 16 bytes, so that a warp's pair stores fall on 32 banks (stage_rows),
// then copied out as whole rows in 16-byte stores (copy_rows), where 64 4-byte
// stores a thread straight from the registers made the kernel's epilogue a
// sixth of a block's life on the card; rows past `rows` are not written. The
// caller brackets the two with __syncthreads.
template <int D>
constexpr int kStagedLd = D + 8;  // bf16 a padded row

template <int D>
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[D / 2], float scale,
                                           int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = tile + (16 * warp + g + 8 * r) * kStagedLd<D> + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(row + 8 * n, acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
  }
}

template <int D>
__device__ __forceinline__ void copy_rows(const bf16* tile, bf16* out, int r0, int rows, int e) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * e + 8 * c) =
          *reinterpret_cast<const uint4*>(tile + r * kStagedLd<D> + 8 * c);
  }
}

// Block (x, h, b) owns keys 64 x .. 64 x + 63. In the accumulators a lane
// holds keys 16 warp + lane / 4 and 8 further (rows) at queries 8 j + 2
// (lane % 4) + {0, 1} (columns).
template <int D, bool DROP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ bias, const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int sq, int sk, int num_heads,
                            float sm_scale, Dropout drop) {
  using P = BwdPlan<D>;
  constexpr int S = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = aligned_base(smem_raw, smem);
  const uint32_t own_full = base + P::kDkdvBarOff, full = own_full + 8;
  // the warp taken through a shuffle, so the compiler sees it uniform over
  // the warp: a wgmma under a branch it cannot prove uniform is serialized
  // (ptxas C7520)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int q_tiles = (sq + kRows - 1) / kRows;
  const size_t stats = (size_t)b * sq * num_heads + h;
  const uint32_t seed = DROP ? *drop.seed : 0u;
  // per stage: lse log2 e (f32), delta (f32), dropout row keys (u32) of 64
  // queries
  float* side = reinterpret_cast<float*>(smem + P::kSideOff);
  init_barriers(own_full, full, S);
  QSide next;  // warp 0: the side data of the next q-tile it loads
  if (warp == 0) {  // every load of the first stages in flight at once
    if (lane == 0) {
      load_own<D>(base, &k_map, &v_map, own_full, k0, h, b);
      for (int t = 0; t < S && t < q_tiles; ++t)
        load_stage<D>(base, t, &q_map, &do_map, full + 8 * t, t * kRows, h, b);
    }
    __syncwarp();
    QSide first[S];
#pragma unroll
    for (int t = 0; t < S; ++t)
      if (t < q_tiles) first[t].load(lse, delta, stats, t * kRows, lane, sq, num_heads);
#pragma unroll
    for (int t = 0; t < S; ++t)
      if (t < q_tiles) finish_q_tile<DROP>(side, full, t, t, lane, first[t], seed, b, h);
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int krow = k0 + 16 * warp + g;  // this lane's keys: krow and krow + 8
  float bz[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)  // keys past Sk do not exist: -inf gives p = 0
    bz[r] = krow + 8 * r < sk ? __ldg(bias + (size_t)b * sk + krow + 8 * r) * kLog2e
                              : -INFINITY;
  const float scale_l2 = sm_scale * kLog2e;
  const uint32_t q_at = base + P::kStageOff, do_at = q_at + S * P::kTile;
  const uint64_t k_desc = sw128_desc(base, 16, 1024);
  const uint64_t v_desc = sw128_desc(base + P::kTile, 16, 1024);
  const uint64_t q_desc = sw128_desc(q_at, 16, 1024), do_desc = sw128_desc(do_at, 16, 1024);
  const uint64_t q_tdesc = sw128_desc(q_at, kSlab, 1024);
  const uint64_t do_tdesc = sw128_desc(do_at, kSlab, 1024);
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  mbar_wait(own_full, 0);

  for (int t = 0; t < q_tiles; ++t) {
    const int stage = t % S;
    const bool refill = t + S < q_tiles;  // uniform
    if (warp == 0 && refill) next.load(lse, delta, stats, (t + S) * kRows, lane, sq, num_heads);
    mbar_wait(full + 8 * stage, (t / S) & 1);
    const uint32_t st = (stage * P::kTile) >> 4;
    float s[32], dp[32];
    wgmma_fence();
    scores<D>(s, k_desc, q_desc + st);  // S^T = K.Q^T
    wgmma_commit();
    scores<D>(dp, v_desc, do_desc + st);  // dP^T = V.dO^T
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; dP^T runs on while p is computed
    fence_regs(s);
    const float* st_lse = side + stage * 3 * kRows;
    const float* st_dl = st_lse + kRows;
    const uint32_t* st_key = reinterpret_cast<const uint32_t*>(st_lse + 2 * kRows);
    uint32_t pa[16], kept = 0u;  // P_drop^T in bf16 pairs; the keep bits
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(st_lse + col);
      uint2 r2 = make_uint2(0u, 0u);
      if (DROP) r2 = *reinterpret_cast<const uint2*>(st_key + col);
      float pd[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, odd = c & 1;
        const float p = ex2(fmaf(s[4 * j + c], scale_l2, bz[r]) - (odd ? l2.y : l2.x));
        s[4 * j + c] = p;
        pd[c] = p;
        if (DROP) {
          const bool kp = keep(odd ? r2.y : r2.x, krow + 8 * r, drop.threshold);
          kept |= (uint32_t)kp << (4 * j + c);
          pd[c] = kp ? p * drop.scale : 0.f;
        }
      }
      pa[2 * j] = pack_bf16(pd[0], pd[1]);
      pa[2 * j + 1] = pack_bf16(pd[2], pd[3]);
    }
    wgmma_fence();
    accumulate<D>(acc_v, pa, do_tdesc + st);  // dV += P_drop^T.dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is in; dV runs on while dS is formed
    fence_regs(dp);
    uint32_t da[16];  // dS^T in bf16 pairs
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(st_dl + 8 * j + 2 * t4);
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float dpe = dp[4 * j + c];
        if (DROP) dpe = (kept >> (4 * j + c)) & 1u ? dpe * drop.scale : 0.f;
        ds[c] = s[4 * j + c] * (dpe - (c & 1 ? d2.y : d2.x));
      }
      da[2 * j] = pack_bf16(ds[0], ds[1]);
      da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
    accumulate<D>(acc_k, da, q_tdesc + st);  // dK += dS^T.Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
    if (refill) {
      __syncthreads();  // every warp is done with this stage: fill it again
      if (warp == 0) {
        if (lane == 0)
          load_stage<D>(base, stage, &q_map, &do_map, full + 8 * stage, (t + S) * kRows, h,
                        b);
        __syncwarp();
        finish_q_tile<DROP>(side, full, stage, t + S, lane, next, seed, b, h);
      }
    }
  }

  const int e = num_heads * D;
  const size_t at = (size_t)b * sk * e + (size_t)h * D;
  bf16* tile = reinterpret_cast<bf16*>(smem + P::kStageOff);
  __syncthreads();  // every warp's products of the last stage have completed
  stage_rows<D>(tile, acc_k, sm_scale, warp, lane);
  stage_rows<D>(tile + kRows * kStagedLd<D>, acc_v, 1.f, warp, lane);
  __syncthreads();
  copy_rows<D>(tile, dk + at, k0, sk, e);
  copy_rows<D>(tile + kRows * kStagedLd<D>, dv + at, k0, sk, e);
}

// -------------------------------------------------------------------- dQ
// Warp 0 fills `stage` with key tile t: TMA of K and V, then its 64 biases
// log2 e (-inf past Sk: p = 0), `bias2` read a tile ahead: keys k0 + lane
// and k0 + lane + 32; each lane then arrives.
template <int D>
__device__ __forceinline__ void fill_k_tile(uint32_t base, float* bias_s, uint32_t full,
                                            int stage, int t, int lane,
                                            const float (&bias2)[2], const CUtensorMap* k_map,
                                            const CUtensorMap* v_map, int b, int h) {
  const uint32_t bar = full + 8 * stage;
  if (lane == 0) load_stage<D>(base, stage, k_map, v_map, bar, t * kRows, h, b);
  __syncwarp();
  bias_s[stage * kRows + lane] = bias2[0];
  bias_s[stage * kRows + lane + 32] = bias2[1];
  mbar_arrive(bar);
}

__device__ __forceinline__ void load_bias2(float (&bias2)[2], const float* __restrict__ bias_b,
                                           int k0, int lane, int sk) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + lane + 32 * i;
    bias2[i] = k < sk ? __ldg(bias_b + k) * kLog2e : -INFINITY;
  }
}

// Block (x, h, b) owns queries 64 x .. 64 x + 63. A lane holds rows 16 warp
// + lane / 4 and 8 further at keys 8 j + 2 (lane % 4) + {0, 1} of the key
// tile.
template <int D, bool DROP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ bias, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int sq,
                          int sk, int num_heads, float sm_scale, Dropout drop) {
  using P = BwdPlan<D>;
  constexpr int S = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem;
  const uint32_t base = aligned_base(smem_raw, smem);
  const uint32_t own_full = base + P::kDqBarOff, full = own_full + 8;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int k_tiles = (sk + kRows - 1) / kRows;
  const float* bias_b = bias + (size_t)b * sk;
  float* bias_s = reinterpret_cast<float*>(smem + P::kSideOff);  // 64 a stage
  init_barriers(own_full, full, S);
  float next[2];  // warp 0: the biases of the next key tile it loads
  if (warp == 0) {
    if (lane == 0) load_own<D>(base, &q_map, &do_map, own_full, q0, h, b);
    for (int t = 0; t < S && t < k_tiles; ++t) {
      load_bias2(next, bias_b, t * kRows, lane, sk);
      fill_k_tile<D>(base, bias_s, full, t, t, lane, next, &k_map, &v_map, b, h);
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int row = q0 + 16 * warp + g;  // this lane's rows: row and row + 8
  const size_t stats = (size_t)b * sq * num_heads + h;
  float lse_r[2], dl_r[2];
  uint32_t key[2] = {0u, 0u};
  const uint32_t seed = DROP ? *drop.seed : 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    const bool ok = rr < sq;  // rows past Sq: p = 0, ds = 0
    lse_r[r] = ok ? __ldg(lse + stats + (size_t)rr * num_heads) * kLog2e : INFINITY;
    dl_r[r] = ok ? __ldg(delta + stats + (size_t)rr * num_heads) : 0.f;
    if (DROP) key[r] = row_key(seed, b, h, rr);
  }
  const float scale_l2 = sm_scale * kLog2e;
  const uint32_t k_at = base + P::kStageOff, v_at = k_at + S * P::kTile;
  const uint64_t q_desc = sw128_desc(base, 16, 1024);
  const uint64_t do_desc = sw128_desc(base + P::kTile, 16, 1024);
  const uint64_t k_desc = sw128_desc(k_at, 16, 1024), v_desc = sw128_desc(v_at, 16, 1024);
  const uint64_t k_tdesc = sw128_desc(k_at, kSlab, 1024);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(own_full, 0);

  for (int t = 0; t < k_tiles; ++t) {
    const int stage = t % S, k0 = t * kRows;
    const bool refill = t + S < k_tiles;  // uniform
    if (warp == 0 && refill) load_bias2(next, bias_b, (t + S) * kRows, lane, sk);
    mbar_wait(full + 8 * stage, (t / S) & 1);
    const uint32_t st = (stage * P::kTile) >> 4;
    float s[32], dp[32];
    wgmma_fence();
    scores<D>(s, q_desc, k_desc + st);  // S = Q.K^T
    wgmma_commit();
    scores<D>(dp, do_desc, v_desc + st);  // dP = dO.V^T
    wgmma_commit();
    wgmma_wait<1>();  // S is in; dP runs on while p is computed
    fence_regs(s);
    const float* bz = bias_s + stage * kRows + 2 * t4;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bz + 8 * j);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[4 * j + c] = ex2(fmaf(s[4 * j + c], scale_l2, c & 1 ? bj.y : bj.x) - lse_r[c >> 1]);
    }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[16];  // dS in bf16 pairs
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1, odd = c & 1;
        float dpe = dp[4 * j + c];
        if (DROP)
          dpe = keep(key[r], k0 + 8 * j + 2 * t4 + odd, drop.threshold) ? dpe * drop.scale
                                                                         : 0.f;
        ds[c] = s[4 * j + c] * (dpe - dl_r[r]);
      }
      da[2 * j] = pack_bf16(ds[0], ds[1]);
      da[2 * j + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
    accumulate<D>(acc, da, k_tdesc + st);  // dQ += dS.K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (refill) {
      __syncthreads();  // every warp is done with this stage: fill it again
      if (warp == 0)
        fill_k_tile<D>(base, bias_s, full, stage, t + S, lane, next, &k_map, &v_map, b, h);
    }
  }

  // dQ's rows straight from the registers: staged through shared memory as
  // dK and dV are, they were slower on the card where the last block holds
  // few rows (MT's 81 queries)
  const int e = num_heads * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= sq) continue;  // padded query rows are never written
    bf16* o = dq + ((size_t)b * sq + rr) * e + (size_t)h * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(o + 8 * n, acc[4 * n + 2 * r] * sm_scale, acc[4 * n + 2 * r + 1] * sm_scale);
  }
}

// ------------------------------------------------------------------- host
template <int D, bool DROP>
cudaError_t launch(const CUtensorMap (&m)[4], const float* bias, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int batch, int sq, int sk,
                   int num_heads, float sm_scale, Dropout drop, cudaStream_t stream) {
  using P = BwdPlan<D>;
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<D, DROP>;
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)P::kDkdvBytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((sk + kRows - 1) / kRows, num_heads, batch), kThreads, P::kDkdvBytes,
         stream>>>(m[0], m[1], m[2], m[3], bias, lse, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), sq, sk, num_heads, sm_scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_wgmma_kernel<D, DROP>;
  if ((err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)P::kDqBytes)) != cudaSuccess)
    return err;
  dqk<<<dim3((sq + kRows - 1) / kRows, num_heads, batch), kThreads, P::kDqBytes, stream>>>(
      m[0], m[1], m[2], m[3], bias, lse, delta, static_cast<bf16*>(dq), sq, sk, num_heads,
      sm_scale, drop);
  return cudaGetLastError();
}

// Calls f(integral_constant D) for a head dim this library is built for.
template <typename F>
cudaError_t with_head_dim(int head_dim, F&& f) {
  if (head_dim == 128) return f(std::integral_constant<int, 128>{});
  if (head_dim == 64) return f(std::integral_constant<int, 64>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// The bf16 backward on wgmma, from the forward's out and lse: q, d_out, out
// (B, Sq, H*D), k/v (B, Sk, H*D) bf16, bias (B, Sk) f32, lse (B, Sq, H)
// f32, all contiguous and 16-byte aligned; dq like q, dk and dv like k;
// delta (B, Sq, H) f32 scratch. `maps` holds the plan's four tensor maps
// (q, k, v, d_out; kMapWords values each, see encode_map), as the wrapper's
// plan gives them (its box is checked against this library's once, when
// the wrapper loads it). dropout, seed, threshold and keep_scale as in
// flash_attention.cu's flash_attention_bwd, and those of the forward call.
// Three kernels on `stream` (delta, dK/dV, dQ); returns the cudaError_t of
// the launches (0 on success).
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const float* bias, const void* out,
                                         const float* lse, const void* d_out, float* delta,
                                         void* dq, void* dk, void* dv, int batch, int sq,
                                         int sk, int num_heads, int head_dim,
                                         const unsigned long long* maps, float sm_scale,
                                         int dropout, const void* seed, unsigned threshold,
                                         float keep_scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || batch > 65535 ||
      num_heads > 65535 || (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{static_cast<const uint32_t*>(seed), threshold, keep_scale};
  return (int)with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    CUtensorMap m[4];
    const void* ptrs[4] = {q, k, v, d_out};
    for (int i = 0; i < 4; ++i) {
      const cudaError_t err = encode_map(&m[i], ptrs[i], maps + i * kMapWords);
      if (err != cudaSuccess) return err;
    }
    cudaError_t err = launch_delta<bf16, D>(static_cast<const bf16*>(d_out), out, delta,
                                            (size_t)batch * sq * num_heads, st);
    if (err != cudaSuccess) return err;
    return dropout ? launch<D, true>(m, bias, lse, delta, dq, dk, dv, batch, sq, sk,
                                     num_heads, sm_scale, drop, st)
                   : launch<D, false>(m, bias, lse, delta, dq, dk, dv, batch, sq, sk,
                                      num_heads, sm_scale, drop, st);
  });
}

// The kernels at a head dim: info[0], info[1] dynamic shared memory bytes
// of the dK/dV and dQ kernels, info[2] stages of the streamed ring, info[3]
// threads a block, info[4] columns and info[5] rows of a TMA box
// (kBoxCols, kRows). Returns cudaErrorInvalidValue for a head dim this
// library is not built for.
extern "C" int flash_attention_bwd_wgmma_info(int head_dim, int* info) {
  return (int)with_head_dim(head_dim, [&](auto d) {
    using P = BwdPlan<decltype(d)::value>;
    info[0] = (int)P::kDkdvBytes;
    info[1] = (int)P::kDqBytes;
    info[2] = P::kStages;
    info[3] = kThreads;
    info[4] = kBoxCols;
    info[5] = kRows;
    return cudaSuccess;
  });
}
