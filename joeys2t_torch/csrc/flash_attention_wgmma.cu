// Flash attention forward for Hopper on its own machinery (sm_90a): wgmma,
// TMA, mbarriers and warp specialisation. bf16, head dims 64 and 128.
//
// Replaces, for those head dims in bf16, the forward of the Pallas TPU
// kernels of joeys2t_tpu/ops/flash_attention.py: `_fwd_kernel` (:69,
// launched by `_flash_fwd` at :492) and `_fwd_kernel_bhsd` (:174, launched by
// `_flash_fwd_bhsd` at :262). Other head dims keep the mma.sync forward of
// flash_attention.cu, f32 its SIMT forward; the backward
// (flash_attention_bwd_wgmma.cu at these head dims) reads this kernel's out
// and lse. Which head dims come here is the wrapper's choice alone
// (ops/flash_attention.py `route`); this library builds these two. The
// Hopper helpers (mbarriers, TMA, wgmma, descriptors, the tensor maps'
// encode) live in hopper_common.cuh, shared with the backward.
//
// Contract (as flash_attention.cu's forward): q (B, Sq, H*D), k/v (B, Sk,
// H*D) bf16, bias (B, Sk) f32; out like q, lse (B, Sq, H) f32.
//   s = fmaf(q.k^T, sm_scale, bias)  (sm_scale in f32 after the product,
//       never folded into bf16 Q); keys past Sk get -inf
//   online softmax over key tiles: running max m and sum l of the
//   undropped p, O rescaled by alpha = exp(m_old - m_new) each tile, P
//   rounded to bf16 (with dropout: kept p / (1 - rate), else 0) before P.V,
//   O normalised once at the end, lse = m + log(l).
// Dropout keeps are the hash of the absolute (b, h, q, k) that every flash
// kernel draws (row_key / keep of flash_attention_common.cuh), so the
// backward regenerates the mask and the plain version's `dropout_keep`
// agrees bit for bit.
//
// What bounds it on this card (H100 SXM, bf16): 4 Sq Sk H D flops over
// (2 Sq + 2 Sk) H D bf16 elements; at Sq = Sk = S that is S / 2 flop/byte
// against the 989 TF / 3.35 TB/s ~ 295 flop/byte ridge: bytes at S = 250
// (the 10 s utterances, B=64: 0.0197 ms), operations at S = 750 (0.0746 ms
// at B=64). The mma.sync kernel reached 39 % and 24 % of those at D = 128:
// 4 warps of 16 rows issued every operand load (ldmatrix, cp.async)
// themselves, at 228-242 registers a thread, and re-read K and V once per
// 64-row q-tile. This kernel reaches 59 % and 48 % of them on an H100 SXM
// at 700 W (PERF.md).
//
// Design:
// - One persistent block an SM (grid = min(tiles, SMs)) walks the tiles
//   (q-tile, head group, batch row), q-tile fastest, so the q-tiles of one
//   (b, h) run side by side and the second reads K/V from L2.
// - Two tile shapes, chosen by the wrapper from (Sq, H) alone
//   (`wgmma_tile`): a one-head tile of kBQ = 128 query rows, the two
//   consumer warpgroups splitting its rows; and at D = 64 a two-head tile of
//   kPairRows = 64 query rows of two adjacent heads, a consumer warpgroup a
//   head, so a short Sq (61 tokens) keeps both warpgroups busy where the
//   one-head tile would leave the second idle. Either way a consumer owns 64
//   rows of one head and runs the same instructions on them.
// - Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   24 registers); one warp of it issues the TMA loads. Warpgroups 1 and 2
//   are consumers (setmaxnreg up to 240), each owning 64 query rows (wgmma's
//   M is 64). Each consumer runs S, softmax, P.V in turn; the two overlap
//   each other on the SM.
// - TMA: q, k and v are each a 4-D tensor map (D, S, H, B) over the
//   (B, S, H*D) buffer (byte strides H*D*2, D*2, S*H*D*2: not increasing,
//   which TMA takes), boxes of 64 columns (128 bytes) x rows x the tile's
//   heads x 1 batch row with the 128-byte swizzle. A tile is slabs of 64
//   columns x its rows in shared memory: D = 128 takes two column boxes,
//   the two-head tile one box whose heads land one slab each, so "box c"
//   at D = 128 is "head c" there and the consumers' descriptors read both
//   alike. Rows past S and a head past H are zero-filled without touching
//   the next batch row. The maps are encoded on the host
//   (cuTensorMapEncodeTiled, looked up through the CUDA runtime, nothing new
//   linked) from the dims, strides and boxes the Python wrapper computes,
//   checked against the kernel's own tile, and passed as __grid_constant__.
// - Pipeline: Q in two buffers (full / empty mbarriers each; a buffer is
//   released after its tile's last S product, so the next tile's Q loads
//   while this tile runs), K and V in a ring of kStages stages of BK = 128 keys
//   with full / empty mbarriers; the producer warp also writes the stage's
//   128 biases to shared memory (-inf past Sk), each lane arriving on the
//   full barrier after its stores, lane 0 with the expected TMA bytes.
// - S = Q.K^T: D / 16 wgmma.m64n128k16, Q and K both K-major from the
//   swizzled tiles (descriptor: SBO 1024 bytes, 8 rows of 128 bytes; a
//   k16 step advances the start address by 32 bytes within the swizzle row).
// - Online softmax on the accumulator registers: a warp holds 16 rows, a
//   lane rows lane/4 and lane/4 + 8 at columns 8j + 2(lane%4) + {0,1};
//   row max and sum over the 4 lanes of a quad; exp(s - m) is taken as
//   2^(s log2(e) - m log2(e)), one FFMA before the EX2.
// - O += P.V: BK / 16 wgmma.m64nDk16 with P from registers (the
//   accumulator layout is the A-operand layout, packed to bf16 pairs) and V
//   from shared memory MN-major through the transpose bit (LBO: the next 64
//   columns' box, SBO: 8 keys of 128 bytes).
// - The key tiles start at key 0 and are BK = 128 wide for every shape and
//   both tiles, so a row's arithmetic does not depend on the batch, the
//   padded Sq, the padded Sk or the tile that holds it: masked keys add
//   exact zeros and a tile of masked keys leaves alpha = 1. Each row is one
//   block's alone, no atomics: two calls give the same bits.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_common.cuh"
#include "hopper_common.cuh"

namespace {

// kBoxCols, kBQ, kPairRows and kBK are the boxes of the wrapper's tensor
// maps (ops/flash_attention.py: WGMMA_BOX_COLS, WGMMA_BQ, WGMMA_BQ_PAIR,
// WGMMA_BK); flash_attention_wgmma_info reports them and the wrapper checks
// its own against them when it loads this library.
constexpr int kWgRows = 64;   // query rows of a consumer warpgroup (wgmma's M)
constexpr int kConsumers = 2;
constexpr int kBQ = kConsumers * kWgRows;  // query rows of a one-head tile
constexpr int kPairRows = kWgRows;         // query rows of a two-head tile
constexpr int kBK = 128;                   // keys a tile, for every shape
constexpr int kStages = 2;
constexpr int kQBuffers = 2;  // the next tile's Q loads while this tile runs
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// The shared-memory plan of a tile of HEADS heads at head dim D. HEADS = 1:
// kBQ query rows of one head, the consumers splitting the rows. HEADS = 2
// (D = 64): kPairRows rows of two adjacent heads, a consumer a head. A tile
// is kSlabs slabs of 64 columns (128-byte rows, the swizzle's width) x its
// rows: D = 128's two column boxes, or the two-head tile's heads.
template <int D, int HEADS>
struct WgmmaTile {
  static_assert(D % kBoxCols == 0, "whole 64-column boxes");
  static_assert(HEADS == 1 || (HEADS == kConsumers && D == kBoxCols),
                "a two-head tile gives each consumer one 64-column head");
  static constexpr int kRows = HEADS == 1 ? kBQ : kPairRows;  // query rows a tile
  static constexpr int kLoads = D / kBoxCols;  // TMA boxes an operand a tile
  static constexpr int kSlabs = kLoads * HEADS;
  static constexpr int kQBytes = kRows * 128 * kSlabs;   // a tile's Q
  static constexpr int kKVBytes = kBK * 128 * kSlabs;    // one stage of K (or of V)
  static constexpr int kKOff = kQBuffers * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBiasOff = kVOff + kStages * kKVBytes;
  static constexpr int kBarOff = kBiasOff + kStages * kBK * 4;
  static constexpr int kBars = 2 * kQBuffers + 2 * kStages;  // full, empty of each
  // 1024 bytes of slack: the 128-byte swizzle wants 1024-byte aligned tiles
  static constexpr size_t kBytes = kBarOff + kBars * 8 + 1024;
};


// ------------------------------------------------------------------ kernel
// A persistent block walks tiles t = blockIdx.x, + gridDim.x, ... of the
// (q-tile, head group of HEADS heads, batch row) space, q-tile fastest.
template <int D, int HEADS, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       float* __restrict__ lse, int sq, int sk, int num_heads, int q_tiles,
                       int tiles, float sm_scale, Dropout drop) {
  using C = WgmmaTile<D, HEADS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t base = raw + pad;  // Q | K stages | V stages | biases | barriers
  // barriers: Q full and empty of each buffer, then K/V full and empty
  const uint32_t q_full = base + C::kBarOff, q_empty = q_full + 8 * kQBuffers;
  const uint32_t kv_full = q_empty + 8 * kQBuffers, kv_empty = kv_full + 8 * kStages;
  // warpgroup and warp taken through a shuffle, so the compiler sees them
  // uniform over the warp: a wgmma under a branch it cannot prove uniform is
  // serialized (ptxas C7520)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x / 32) % 4, 0);
  const int lane = threadIdx.x % 32;
  const int k_tiles = (sk + kBK - 1) / kBK;
  const int groups = (num_heads + HEADS - 1) / HEADS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBuffers; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 4 * kConsumers);  // one arrival a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + 8 * s, 32);  // the producer warp's lanes (lane 0 with the bytes)
      mbar_init(kv_empty + 8 * s, 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // ---------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != 0) return;
    float* bias_s = reinterpret_cast<float*>(smem + C::kBiasOff);
    int stage = 0, qb = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int qt = t % q_tiles, b = t / (q_tiles * groups);
      const int h0 = (t / q_tiles) % groups * HEADS;  // the tile's first head
      if (lane == 0) {  // the consumers are done with this buffer's earlier Q
        const uint32_t full = q_full + 8 * qb;
        mbar_wait(q_empty + 8 * qb, q_phase ^ 1);
        mbar_arrive_tx(full, C::kQBytes);
        for (int c = 0; c < C::kLoads; ++c)
          tma_load(base + qb * C::kQBytes + c * C::kRows * 128, &q_map, full, c * kBoxCols,
                   qt * C::kRows, h0, b);
      }
      __syncwarp();
      if (++qb == kQBuffers) {
        qb = 0;
        q_phase ^= 1;
      }
      const float* bias_b = bias + (size_t)b * sk;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int k0 = kt * kBK;
        const uint32_t full = kv_full + 8 * stage;
        mbar_wait(kv_empty + 8 * stage, phase ^ 1);
        // keys past Sk do not exist: a -inf bias drops them from max and sum
        for (int i = lane; i < kBK; i += 32)
          bias_s[stage * kBK + i] = k0 + i < sk ? __ldg(bias_b + k0 + i) : -INFINITY;
        if (lane == 0) {
          mbar_arrive_tx(full, 2 * C::kKVBytes);
          for (int c = 0; c < C::kLoads; ++c) {
            const uint32_t off = stage * C::kKVBytes + c * kBK * 128;
            tma_load(base + C::kKOff + off, &k_map, full, c * kBoxCols, k0, h0, b);
            tma_load(base + C::kVOff + off, &v_map, full, c * kBoxCols, k0, h0, b);
          }
        } else {
          mbar_arrive(full);  // release: this lane's biases are in shared memory
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // this warpgroup's rows: 64 cw .. 64 cw + 63 of a one-head tile's, or the
  // rows of head cw of a two-head tile; in shared memory either starts 64 cw
  // rows of 128 bytes into the Q tile
  const int cw = wg - 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int e = num_heads * D;
  const float* bias_s = reinterpret_cast<const float*>(smem + C::kBiasOff);
  // K-major operands (Q, K): 8-row groups 1024 bytes apart; V MN-major: its
  // second 64 columns one box (kBK rows of 128 bytes) on, 8 keys 1024 bytes.
  // In a two-head tile this consumer's K and V are its head's slab.
  const uint32_t own = HEADS == 1 ? 0u : cw * kBK * 128u;
  const uint64_t q_desc = sw128_desc(base + cw * kWgRows * 128, 16, 1024);
  const uint64_t k_desc = sw128_desc(base + C::kKOff + own, 16, 1024);
  const uint64_t v_desc = sw128_desc(base + C::kVOff + own, kBK * 128, 1024);
  int stage = 0, qb = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int qt = t % q_tiles, b = t / (q_tiles * groups);
    const int h = (t / q_tiles) % groups * HEADS + (HEADS == 1 ? 0 : cw);
    const int q0 = qt * C::kRows + (HEADS == 1 ? cw * kWgRows : 0);
    // uniform over the warpgroup: rows past Sq, or the second head of an odd
    // H's last pair, skip their products
    const bool active = q0 < sq && h < num_heads;
    const int row = q0 + 16 * warp + g;  // this lane's rows: row and row + 8
    uint32_t key[2] = {0u, 0u};
    if (DROP) {
      const uint32_t seed = *drop.seed;
      key[0] = row_key(seed, b, h, row);
      key[1] = row_key(seed, b, h, row + 8);
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's part
    mbar_wait(q_full + 8 * qb, q_phase);
    const uint64_t qb_desc = q_desc + ((qb * C::kQBytes) >> 4);

    for (int kt = 0; kt < k_tiles; ++kt) {
      const int k0 = kt * kBK;
      mbar_wait(kv_full + 8 * stage, phase);
      float s[kBK / 2];
      if (active) {  // S = Q.K^T
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t in_row = (kk % 4) * 32;  // 16 columns: 32 bytes
          wgmma_ss_n128(s, qb_desc + (((kk / 4) * C::kRows * 128 + in_row) >> 4),
                        k_desc + ((stage * C::kKVBytes + (kk / 4) * kBK * 128 + in_row) >> 4),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
      }
      if (kt == k_tiles - 1) {  // the tile's Q is read: the buffer may load again
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty + 8 * qb);
      }
      if (active) {
        const float* bz = bias_s + stage * kBK + 2 * t4;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const float2 bj = *reinterpret_cast<const float2*>(bz + 8 * j);
          s[4 * j] = fmaf(s[4 * j], sm_scale, bj.x);
          s[4 * j + 1] = fmaf(s[4 * j + 1], sm_scale, bj.y);
          s[4 * j + 2] = fmaf(s[4 * j + 2], sm_scale, bj.x);
          s[4 * j + 3] = fmaf(s[4 * j + 3], sm_scale, bj.y);
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        // exp(s - m) as 2^(s log2(e) - m log2(e)): one FFMA and the EX2
        constexpr float kLog2e = 1.4426950408889634f;
        float alpha[2], ml[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // key k0 < Sk has a finite score, so the new max is finite
          const float m_new = fmaxf(m[r], quad_max(mx[r]));
          alpha[r] = ex2((m[r] - m_new) * kLog2e);
          m[r] = m_new;
          ml[r] = m_new * kLog2e;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float p = ex2(fmaf(s[4 * j + c], kLog2e, -ml[c >> 1]));
            l[c >> 1] += p;  // the normalizer sums the undropped probabilities
            if (DROP)
              p = keep(key[c >> 1], k0 + 8 * j + 2 * t4 + (c & 1), drop.threshold)
                      ? p * drop.scale
                      : 0.f;
            s[4 * j + c] = p;
          }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n] *= alpha[0];
          o[4 * n + 1] *= alpha[0];
          o[4 * n + 2] *= alpha[1];
          o[4 * n + 3] *= alpha[1];
        }
        // O += P.V: P's accumulator layout is the A operand's, 16 keys a step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                                 pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                                 pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                                 pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
          wgmma_rs<D>(o, a, v_desc + ((stage * C::kKVBytes + kk * 16 * 128) >> 4));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * stage);  // this stage is read
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_row = quad_sum(l[r]);
        const int rr = row + 8 * r;
        if (rr >= sq) continue;  // padded query rows are never written
        const float inv = 1.f / l_row;
        bf16* o_row = out + ((size_t)b * sq + rr) * e + (size_t)h * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          store2(o_row + 8 * n, o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
        if (t4 == 0) lse[((size_t)b * sq + rr) * num_heads + h] = m[r] + logf(l_row);
      }
    }
    if (++qb == kQBuffers) {
      qb = 0;
      q_phase ^= 1;
    }
  }
}

// ------------------------------------------------------------------- host
template <int D, int HEADS, bool DROP>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const float* bias, void* out, float* lse, int sq, int sk, int num_heads,
                   int q_tiles, int tiles, int grid, float sm_scale, Dropout drop,
                   cudaStream_t stream) {
  using C = WgmmaTile<D, HEADS>;
  auto kernel = flash_fwd_wgmma_kernel<D, HEADS, DROP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, C::kBytes, stream>>>(qm, km, vm, bias, static_cast<bf16*>(out),
                                                lse, sq, sk, num_heads, q_tiles, tiles,
                                                sm_scale, drop);
  return cudaGetLastError();
}

// Calls f(integral_constant D, integral_constant HEADS) for a tile this
// library is built for: one head at head dims 64 and 128, two heads at 64
// (two heads of 128 would need 2 x 64 KB a K/V stage).
template <typename F>
cudaError_t with_tile(int head_dim, int heads, F&& f) {
  using std::integral_constant;
  if (head_dim == 128 && heads == 1)
    return f(integral_constant<int, 128>{}, integral_constant<int, 1>{});
  if (head_dim == 64 && heads == 1)
    return f(integral_constant<int, 64>{}, integral_constant<int, 1>{});
  if (head_dim == 64 && heads == 2)
    return f(integral_constant<int, 64>{}, integral_constant<int, 2>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// The bf16 forward on wgmma: q (B, Sq, H*D), k/v (B, Sk, H*D) bf16, bias
// (B, Sk) f32, all contiguous and 16-byte aligned; out like q, lse (B, Sq,
// H) f32. tile_heads is the tile's heads (1, or 2 at head dim 64), `maps`
// the plan's three tensor maps (q, k, v), kMapWords values each (see
// encode_map), q_tiles = ceil(Sq / the tile's rows), tiles = q_tiles *
// ceil(H / tile_heads) * B, grid the persistent blocks (1..tiles), all as
// the wrapper's plan gives them (its boxes are checked against this
// library's once, when the wrapper loads it). dropout, seed, threshold and
// keep_scale as in flash_attention.cu's flash_attention_fwd. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                                         const float* bias, void* out, float* lse,
                                         int batch, int sq, int sk, int num_heads,
                                         int head_dim, int tile_heads,
                                         const unsigned long long* maps, int q_tiles,
                                         int tiles, int grid, float sm_scale, int dropout,
                                         const void* seed, unsigned threshold,
                                         float keep_scale, void* stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || num_heads <= 0 || (dropout && seed == nullptr) ||
      grid < 1 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout drop{static_cast<const uint32_t*>(seed), threshold, keep_scale};
  return (int)with_tile(head_dim, tile_heads, [&](auto d, auto heads) {
    constexpr int D = decltype(d)::value, HEADS = decltype(heads)::value;
    CUtensorMap qm, km, vm;
    cudaError_t err;
    if ((err = encode_map(&qm, q, maps)) != cudaSuccess ||
        (err = encode_map(&km, k, maps + kMapWords)) != cudaSuccess ||
        (err = encode_map(&vm, v, maps + 2 * kMapWords)) != cudaSuccess)
      return err;
    return dropout ? launch<D, HEADS, true>(qm, km, vm, bias, out, lse, sq, sk, num_heads,
                                            q_tiles, tiles, grid, sm_scale, drop, st)
                   : launch<D, HEADS, false>(qm, km, vm, bias, out, lse, sq, sk, num_heads,
                                             q_tiles, tiles, grid, sm_scale, drop, st);
  });
}

// The kernel's tile of `tile_heads` heads at a head dim: info[0] dynamic
// shared memory bytes, info[1] K/V stages, info[2] threads a block, info[3]
// columns a TMA box (kBoxCols), info[4] query rows a tile (kBQ, or kPairRows
// for two heads), info[5] keys a tile (kBK). Returns cudaErrorInvalidValue
// for a tile this library is not built for.
extern "C" int flash_attention_wgmma_info(int head_dim, int tile_heads, int* info) {
  return (int)with_tile(head_dim, tile_heads, [&](auto d, auto heads) {
    using C = WgmmaTile<decltype(d)::value, decltype(heads)::value>;
    info[0] = (int)C::kBytes;
    info[1] = kStages;
    info[2] = kThreads;
    info[3] = kBoxCols;
    info[4] = C::kRows;
    info[5] = kBK;
    return cudaSuccess;
  });
}
