// Beam search's selection for Hopper (sm_90a): the k largest entries of each
// row of a (rows, n) float32 or float64 matrix, k <= 32, in descending order,
// equal values in ascending index order, every NaN above +inf and -0.0 equal
// to +0.0. That is the CPU's torch.sort(x, dim=-1, descending=True,
// stable=True)[..., :k] bit for bit: the values written are the entries' own
// bits, read back from x by their index. The card's own stable sort agrees but
// for a NaN with its sign bit set, which its radix sort ranks by its bits.
// jax.lax.top_k agrees but for the two zeros and that NaN: XLA ranks +0.0
// above -0.0 and a negative NaN below -inf.
//
// It replaces no Pallas kernel: JAX's beam loop calls jax.lax.top_k
// (joeys2t_tpu/search.py:531, :592), which XLA lowers itself. The port's plain
// version is a full stable sort of each row to keep its first k entries; at
// beam 5 over a 32,000-id table a row is 160,000 scores and 5 are kept.
//
// Bound: the bytes of the scores, each read once. The k outputs a row are
// nothing beside them, and there is about one compare per value loaded:
// 3,004 rows x 160,000 float32 are 1.92 GB, 0.574 ms at 3.35 TB/s.
//
// Design: the WarpSelect / BlockSelect shape of Johnson, Douze and Jegou,
// "Billion-scale similarity search with GPUs" (2017), cut down to what a beam
// needs. Every entry has a key that orders it strictly: (the value's place in
// the order above, ~index), so no two entries of a row tie and the k best
// keys are one set whatever order the entries are seen in.
//   - One block (up to 8 warps, ops/topk.topk_plan) scans a row. Each
//     thread streams 16-byte loads, 4 in flight, neighbouring lanes on
//     neighbouring addresses; a row whose start is not 16-byte aligned, or whose length is
//     not a multiple of the vector, takes a scalar head and tail (warp 0).
//   - Each warp keeps its best k keys so far, sorted, at the front of a
//     128-entry buffer in shared memory, and the k-th of them as a threshold
//     in registers. A loaded value is compared with the threshold's value
//     (one compare: !(v < t) also lets NaN through); only when some lane of
//     the warp holds a value that may pass are the exact keys built and
//     compared, and the passing ones appended by ballot. On random scores
//     about k ln(n / k) of n entries pass; on a plateau of equal values none
//     past the first k, since later indices rank lower.
//   - When the buffer is nearly full (and at the end) the warp selects its k
//     best keys from it by k rounds of a warp-wide arg-max (shuffles), writes
//     them back sorted and takes the new threshold.
//   - Warp 0 then merges the warps' lists the same way and writes k values
//     and int64 indices.
// Nothing of size n is written, no atomics are used, and the result does not
// depend on the number of warps: the k best keys are unique.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 32;          // the largest k
constexpr int kMaxWarps = 8;       // warps a block of the scan
constexpr int kUnroll = 4;         // 16-byte loads a thread has in flight
constexpr int kCap = 128;          // a warp's buffer: its list and what passed since

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  using Bits = unsigned int;
  using Vec = float4;
  static constexpr int kVec = 4;
  static __device__ Bits bits(float v) { return __float_as_uint(v); }
  static __device__ float value(Bits b) { return __uint_as_float(b); }
  static __device__ float elem(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};

template <>
struct Traits<double> {
  using Bits = unsigned long long;
  using Vec = double2;
  static constexpr int kVec = 2;
  static __device__ Bits bits(double v) {
    return static_cast<Bits>(__double_as_longlong(v));
  }
  static __device__ double value(Bits b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
  static __device__ double elem(const double2& v, int c) { return c == 0 ? v.x : v.y; }
};

// An entry's place in the row: the larger key ranks first. `ord` maps the
// value to an unsigned integer in the order of the values (NaN highest, the
// two zeros one), `nidx` is ~index, so of equal values the lower index ranks
// first. The empty key {0, 0} ranks below every entry (-inf maps above 0).
template <typename T>
struct Key {
  typename Traits<T>::Bits ord;
  unsigned int nidx;
};

template <typename T>
__device__ __forceinline__ Key<T> make_key(T v, unsigned int index) {
  using Bits = typename Traits<T>::Bits;
  constexpr Bits kSign = Bits(1) << (8 * sizeof(Bits) - 1);
  Bits b = Traits<T>::bits(v);
  Bits ord;
  if (v != v) {
    ord = ~Bits(0);
  } else {
    if ((b << 1) == 0) b = 0;  // -0.0 as +0.0
    ord = (b & kSign) ? ~b : (b | kSign);
  }
  return Key<T>{ord, ~index};
}

// The value of a key's `ord` (a NaN for the NaN key, +0.0 for the zeros):
// what the filter compares loaded values with.
template <typename T>
__device__ __forceinline__ T value_of(typename Traits<T>::Bits ord) {
  using Bits = typename Traits<T>::Bits;
  constexpr Bits kSign = Bits(1) << (8 * sizeof(Bits) - 1);
  return Traits<T>::value((ord & kSign) ? (ord & ~kSign) : ~ord);
}

template <typename T>
__device__ __forceinline__ bool better(const Key<T>& a, const Key<T>& b) {
  return a.ord > b.ord || (a.ord == b.ord && a.nidx > b.nidx);
}

template <typename T>
__device__ __forceinline__ Key<T> shfl_xor(Key<T> a, int m) {
  a.ord = __shfl_xor_sync(0xffffffffu, a.ord, m);
  a.nidx = __shfl_xor_sync(0xffffffffu, a.nidx, m);
  return a;
}

// The k best of the keys the warp's lanes hold in `regs`, best first, to
// out[0..k) (empty keys where there are fewer): k rounds of a warp-wide
// arg-max, the winner's entry emptied after each. Every lane calls it.
template <typename T, int R>
__device__ __forceinline__ void warp_select(Key<T> (&regs)[R], int k, Key<T>* out) {
  const unsigned int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    Key<T> best = regs[0];
    int slot = 0;
#pragma unroll
    for (int j = 1; j < R; ++j) {
      if (better(regs[j], best)) {
        best = regs[j];
        slot = j;
      }
    }
    Key<T> top = best;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const Key<T> other = shfl_xor(top, m);
      if (better(other, top)) top = other;
    }
    // keys are unique but for the empty one, and emptying an empty key is no
    // change, so only the winner's entry goes
    if (best.ord == top.ord && best.nidx == top.nidx) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j == slot) regs[j] = Key<T>{0, 0};
      }
    }
    if (lane == 0) out[r] = top;
  }
}

// A warp's running selection: its best `count` keys sorted at the front of
// `buf` (count <= k), then what passed the threshold since.
template <typename T>
struct WarpList {
  Key<T>* buf;
  int count;  // entries in buf, the same in every lane
  int k;
  Key<T> thr;  // the k-th best so far, the empty key until there are k
  T thr_value; // its value, -inf until there are k

  __device__ __forceinline__ void flush() {
    constexpr int R = kCap / 32;
    const int lane = threadIdx.x & 31;
    __syncwarp();
    Key<T> regs[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int e = lane + 32 * j;
      regs[j] = e < count ? buf[e] : Key<T>{0, 0};
    }
    __syncwarp();
    warp_select<T, R>(regs, k, buf);
    __syncwarp();
    count = min(count, k);
    if (count == k) {
      thr = buf[k - 1];
      thr_value = value_of<T>(thr.ord);
    }
  }

  // Every lane offers one key; those with `take` are appended.
  __device__ __forceinline__ void admit(bool take, const Key<T>& key) {
    const unsigned int lane = threadIdx.x & 31;
    const unsigned int mask = __ballot_sync(0xffffffffu, take);
    if (take) buf[count + __popc(mask & ((1u << lane) - 1u))] = key;
    count += __popc(mask);
    if (count > kCap - 32) flush();
  }
};

// One block a row, blockDim a multiple of 32 up to 256: writes row r's k
// values and indices. float32: 4 blocks an SM (64 registers a thread, no
// spills); float64, whose keys take twice the registers, 2.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, sizeof(T) == 4 ? 4 : 2)
    topk_kernel(const T* __restrict__ x, long long row_stride, int n, int k,
                T* __restrict__ out_values, long long* __restrict__ out_indices) {
  using Vec = typename Traits<T>::Vec;
  constexpr int kVec = Traits<T>::kVec;
  __shared__ Key<T> lists[kMaxWarps][kCap];
  __shared__ int counts[kMaxWarps];
  __shared__ Key<T> best[kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long long row = blockIdx.x;
  const T* xr = x + row * row_stride;
  // the 16-byte aligned body [a, b); [0, a) and [b, n) hold < kVec each
  const int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(xr) & 15)) & 15) / sizeof(T));
  const int a = min(n, head);
  const int nvec = (n - a) / kVec;
  const int b = a + nvec * kVec;

  WarpList<T> list{lists[warp], 0, k, Key<T>{0, 0}, static_cast<T>(-INFINITY)};
  if (warp == 0) {
    const int rest = a + (n - b);
    const bool take = lane < rest;
    const int i = lane < a ? lane : b + lane - a;
    const T v = take ? xr[i] : T(0);
    list.admit(take, make_key(v, static_cast<unsigned int>(i)));
  }
  const Vec* xv = reinterpret_cast<const Vec*>(xr + a);
  const int stride = kUnroll * blockDim.x;
  for (int base = 0; base < nvec; base += stride) {  // the same trips in every warp
    Vec v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * blockDim.x + threadIdx.x;
      if (j < nvec) v[u] = __ldcs(xv + j);  // read once: do not keep it in L1 or L2
    }
    bool maybe = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * blockDim.x + threadIdx.x;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        maybe |= j < nvec && !(Traits<T>::elem(v[u], c) < list.thr_value);
      }
    }
    if (!__any_sync(0xffffffffu, maybe)) continue;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * blockDim.x + threadIdx.x;
      const bool in = j < nvec;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const Key<T> key = make_key(in ? Traits<T>::elem(v[u], c) : T(0),
                                    static_cast<unsigned int>(a + j * kVec + c));
        list.admit(in && better(key, list.thr), key);
      }
    }
  }
  list.flush();
  if (lane == 0) counts[warp] = list.count;
  __syncthreads();
  if (warp != 0) return;
  constexpr int R = kMaxWarps * kMaxK / 32;
  static_assert(kMaxK == 32, "warp w's list is register j = w");
  Key<T> regs[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    regs[j] = j < warps && lane < counts[j] ? lists[j][lane] : Key<T>{0, 0};
  }
  warp_select<T, R>(regs, k, best);
  __syncwarp();
  if (lane >= k) return;
  const unsigned int index = ~best[lane].nidx;
  out_values[row * k + lane] = xr[index];
  out_indices[row * k + lane] = index;
}

template <typename T>
int launch(const T* x, long long rows, long long row_stride, int n, int k, int threads,
           T* values, long long* indices, cudaStream_t stream) {
  if (rows < 1 || rows > 0x7fffffffLL || n < 1 || k < 1 || k > kMaxK || k > n ||
      threads < 32 || threads > kMaxWarps * 32 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  topk_kernel<T><<<static_cast<unsigned int>(rows), threads, 0, stream>>>(
      x, row_stride, n, k, values, indices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The k best entries of each of `rows` rows of n entries, row r at
// x + r * row_stride (elements, the row itself contiguous); dtype 0 float32,
// 1 float64; one block of `threads` a row. values (rows, k) in x's dtype and
// indices (rows, k) int64 are written whole. Returns the launch's
// cudaError_t (0 on success); cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int beam_topk(const void* x, int dtype, long long rows, long long row_stride,
                         int n, int k, int threads, void* values, void* indices,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* idx = static_cast<long long*>(indices);
  if (dtype == 0) {
    return launch(static_cast<const float*>(x), rows, row_stride, n, k, threads,
                  static_cast<float*>(values), idx, s);
  }
  if (dtype == 1) {
    return launch(static_cast<const double*>(x), rows, row_stride, n, k, threads,
                  static_cast<double*>(values), idx, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
