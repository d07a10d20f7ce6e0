// Masked nearest-K neighbor selection for Hopper (sm_90a).
//
// Replaces prosim_tpu/ops/pallas_topk.py:neighbor_topk_pallas (_topk_kernel)
// and covers the whole prosim_tpu/ops/neighbors.py:neighbor_topk contract
// the six graph builds of the rollout need: radius cut, exclude_self and the
// width clamp eff_k = min(k, S).
//
// Semantics, bit for bit with the CPU path of neighbor_topk:
//   d2 = fma(dy, dy, dx * dx)       (the single-rounding form XLA:CPU emits for
//                                    sum((dst - src) ** 2, -1); no other
//                                    contraction is allowed: explicit _rn
//                                    intrinsics)
//   bad = !(src_mask & dst_mask) | (d2 > r2) | (exclude_self & s == q)
//   key = bad ? +inf : d2; ascending order, ties to the lower source index
//   (lax.top_k of -d2). Slots whose key is +inf are invalid; they still come
//   out in index order, as lax.top_k returns them.
// Each source becomes one 64-bit key (float bits of d2 << 32 | s); non-negative
// floats order like their bit patterns, so integer comparisons give the order
// above exactly, ties included. The [B, Q, S] distance matrix never reaches
// device memory.
//
// Bound on the H100: the bytes that must move are tiny (positions in, K
// indices out), so the kernel is bound by the selection's instructions and
// shared-memory traffic. Two designs, chosen by the launcher from K:
//
// Small K (K <= 128; a2a, s2s, p2p; also K = S <= 256, a2p): warp selection
// after Johnson, Douze and Jegou, "Billion-scale similarity search with
// GPUs" (2017), section 5. One warp per (b, q) row, 8 rows of one scene per
// block; the scene's source positions and mask are staged in shared memory
// once for the block's rows (the block's only barrier). The warp keeps a
// sorted list of L = max(32, next_pow2(K)) keys in registers, element
// i = slot * 32 + lane; it starts as the row's first L sources, sorted by a
// full bitonic network over registers and shuffles (when S <= L that is the
// whole selection: p2p, a2p). A lane's candidate enters the warp's queue only if
// it is below the list's K-th key; the queue is one slot per lane in shared
// memory, filled in lane order by a ballot (a warp-wide queue: it merges
// exactly 32 candidates at a time where per-lane queues merge when any one
// lane's queue fills). A full queue is sorted by a 32-key bitonic network of
// warp shuffles, folded into the list (min of the list's last 32 keys and
// the reversed queue leaves a bitonic sequence holding the L smallest keys)
// and the list is merged again (log2 L shuffle or in-register stages). No
// block barrier takes part in the selection.
//
// Large K (K > 128; s2p K = 512, m2p K = 768): one block per row. The row's
// S d2 bit patterns go to shared memory; a radix select (4 passes of 8 bits,
// 256-bin histograms in shared memory) finds the K-th key's d2 bits T and how
// many keys at T belong to the top K; an ordered block scan compacts the keys
// below T and the lowest-index keys at T (exactly K keys, placed without
// atomics); a bitonic network sorts next_pow2(K) keys, not next_pow2(S),
// its strides below 128 in registers and warp shuffles (chunks of 128 keys
// a warp), the larger ones in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr uint32_t kInfBits = 0x7f800000u;
constexpr u64 kNone = ~0ull;  // above every real key: empty list slot, padding
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;  // warps (rows) per block, small-K design
constexpr int kRadixThreads = 256;

__device__ __forceinline__ u64 make_key(float qx, float qy, bool q_ok, float sx, float sy,
                                        bool s_ok, int s, int q, float r2, int has_radius,
                                        int exclude_self) {
  const float dx = __fsub_rn(qx, sx);
  const float dy = __fsub_rn(qy, sy);
  const float d2 = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
  bool bad = !(q_ok && s_ok);
  if (has_radius) bad = bad || (d2 > r2);
  if (exclude_self) bad = bad || (s == q);
  const uint32_t bits = bad ? kInfBits : __float_as_uint(d2);
  return ((u64)bits << 32) | (uint32_t)s;
}

__device__ __forceinline__ u64 umin(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax(u64 a, u64 b) { return a < b ? b : a; }

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n >> 1); }

// One compare-exchange stage of a bitonic network over the warp's list of
// 32 * N keys (element i = a * 32 + lane) at stride j; element i ends up
// with the smaller key when `ascending(i)` says its pair sorts upward.
// Strides of whole slots stay in registers, smaller ones go across lanes.
template <int N, class Dir>
__device__ __forceinline__ void bitonic_stage(u64 (&list)[N], int j, int lane, Dir ascending) {
  if (j >= 32) {
    const int js = j >> 5;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      if ((a & js) == 0) {
        const bool up = ascending(a * 32 + lane);
        const u64 lo = umin(list[a], list[a + js]);
        const u64 hi = umax(list[a], list[a + js]);
        list[a] = up ? lo : hi;
        list[a + js] = up ? hi : lo;
      }
    }
  } else {
    const bool lower = (lane & j) == 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
      const u64 y = __shfl_xor_sync(kFull, list[a], j);
      list[a] = lower == ascending(a * 32 + lane) ? umin(list[a], y) : umax(list[a], y);
    }
  }
}

// Full bitonic sort of the list, ascending.
template <int N>
__device__ __forceinline__ void sort_list(u64 (&list)[N], int lane) {
  constexpr int LOG_L = 5 + log2_of(N);
#pragma unroll
  for (int lk = 1; lk <= LOG_L; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj)
      bitonic_stage<N>(list, 1 << lj, lane, [k](int i) { return (i & k) == 0; });
  }
}

// Fold 32 new keys (one per lane, any order) into the warp's sorted list of
// 32 * N keys, keeping the 32 * N smallest, ascending.
template <int N>
__device__ __forceinline__ void merge_queue(u64 (&list)[N], u64 x, int lane) {
  // 1. bitonic sort of the 32 new keys across the warp, ascending
  u64 one[1] = {x};
  sort_list<1>(one, lane);
  // 2. the list's last 32 keys against the new keys reversed: the list
  // becomes one bitonic sequence that holds the 32 * N smallest keys
  const u64 rev = __shfl_sync(kFull, one[0], 31 - lane);
  list[N - 1] = umin(list[N - 1], rev);
  // 3. bitonic merge of the whole list, strides 16 N .. 1
  constexpr int LOG_L = 5 + log2_of(N);
#pragma unroll
  for (int lj = LOG_L - 1; lj >= 0; --lj)
    bitonic_stage<N>(list, 1 << lj, lane, [](int) { return true; });
}

template <int N>
__device__ __forceinline__ u64 list_at(const u64 (&list)[N], int i) {
  u64 v = list[0];
#pragma unroll
  for (int a = 1; a < N; ++a)
    if ((i >> 5) == a) v = list[a];
  return __shfl_sync(kFull, v, i & 31);
}

template <int N>
__global__ void __launch_bounds__(32 * kRowsPerBlock) neighbor_topk_warp_kernel(
    const float* __restrict__ dst_pos, const float* __restrict__ src_pos,
    const unsigned char* __restrict__ dst_mask, const unsigned char* __restrict__ src_mask, int Q,
    int S, int K, float r2, int has_radius, int exclude_self, int* __restrict__ idx_out,
    unsigned char* __restrict__ valid_out) {
  extern __shared__ u64 smem_u64[];
  u64* queues = smem_u64;                                   // [kRowsPerBlock][32]
  float2* spos = reinterpret_cast<float2*>(queues + 32 * kRowsPerBlock);  // [S]
  unsigned char* smask = reinterpret_cast<unsigned char*>(spos + S);      // [S]

  const int b = blockIdx.y;
  const float* src = src_pos + (size_t)b * S * 2;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    spos[s] = make_float2(src[2 * s], src[2 * s + 1]);
    smask[s] = src_mask[(size_t)b * S + s];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kRowsPerBlock + warp;
  if (q >= Q) return;
  const size_t row = (size_t)b * Q + q;
  const float qx = dst_pos[2 * row];
  const float qy = dst_pos[2 * row + 1];
  const bool q_ok = dst_mask[row] != 0;
  u64* queue = queues + 32 * warp;
  auto key_of = [&](int s) {
    if (s >= S) return kNone;
    const float2 p = spos[s];
    return make_key(qx, qy, q_ok, p.x, p.y, smask[s] != 0, s, q, r2, has_radius, exclude_self);
  };

  // the list starts as the first 32 N sources, sorted (all of the row when
  // S <= 32 N)
  u64 list[N];
#pragma unroll
  for (int a = 0; a < N; ++a) list[a] = key_of(a * 32 + lane);
  sort_list<N>(list, lane);
  u64 kth = list_at<N>(list, K - 1);  // a candidate must be below the K-th key
  int count = 0;  // keys in the queue (warp-uniform)
  const unsigned below = (1u << lane) - 1u;

  for (int base = 32 * N; base < S; base += 32) {
    const u64 key = key_of(base + lane);
    const bool take = key < kth;
    const unsigned m = __ballot_sync(kFull, take);
    if (m == 0u) continue;
    const int pos = count + __popc(m & below);
    if (take && pos < 32) queue[pos] = key;
    count += __popc(m);
    if (count >= 32) {
      __syncwarp();
      merge_queue<N>(list, queue[lane], lane);
      __syncwarp();  // the queue is read before it is refilled
      count -= 32;
      if (take && pos >= 32) queue[pos - 32] = key;
      kth = list_at<N>(list, K - 1);
    }
  }
  if (count > 0) {
    __syncwarp();
    merge_queue<N>(list, lane < count ? queue[lane] : kNone, lane);
  }

#pragma unroll
  for (int a = 0; a < N; ++a) {
    const int j = a * 32 + lane;
    if (j < K) {
      idx_out[row * K + j] = (int)(uint32_t)(list[a] & 0xffffffffu);
      valid_out[row * K + j] = (uint32_t)(list[a] >> 32) != kInfBits;
    }
  }
}

constexpr int kChunk = 128;  // keys a warp sorts in registers, radix design

__device__ __forceinline__ void load_chunk(u64 (&list)[kChunk / 32], const u64* src, int lane) {
#pragma unroll
  for (int a = 0; a < kChunk / 32; ++a) list[a] = src[a * 32 + lane];
}
__device__ __forceinline__ void store_chunk(const u64 (&list)[kChunk / 32], u64* dst, int lane) {
#pragma unroll
  for (int a = 0; a < kChunk / 32; ++a) dst[a * 32 + lane] = list[a];
}

// inclusive sum over the block of one value per thread (kRadixThreads
// threads); `scratch` holds one int per warp
__device__ __forceinline__ uint32_t block_inclusive_sum(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  uint32_t off = 0;
  for (int w = 0; w < warp; ++w) off += scratch[w];
  return v + off;
}

__global__ void __launch_bounds__(kRadixThreads) neighbor_topk_radix_kernel(
    const float* __restrict__ dst_pos, const float* __restrict__ src_pos,
    const unsigned char* __restrict__ dst_mask, const unsigned char* __restrict__ src_mask, int Q,
    int S, int K, int P, float r2, int has_radius, int exclude_self, int* __restrict__ idx_out,
    unsigned char* __restrict__ valid_out) {
  extern __shared__ u64 smem_u64[];
  u64* keys = smem_u64;                                            // [P]
  uint32_t* bits = reinterpret_cast<uint32_t*>(keys + P);          // [S]
  __shared__ uint32_t hist[256];
  __shared__ uint32_t scratch[kRadixThreads / 32];
  __shared__ uint32_t sel_digit, sel_rank;

  const int row = blockIdx.x;  // b * Q + q
  const int b = row / Q;
  const int q = row - b * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float qx = dst_pos[2 * (size_t)row];
  const float qy = dst_pos[2 * (size_t)row + 1];
  const bool q_ok = dst_mask[row] != 0;
  const float* src = src_pos + (size_t)b * S * 2;
  const unsigned char* smask = src_mask + (size_t)b * S;
  for (int s = tid; s < S; s += kRadixThreads)
    bits[s] = (uint32_t)(make_key(qx, qy, q_ok, src[2 * s], src[2 * s + 1], smask[s] != 0, s, q,
                                  r2, has_radius, exclude_self) >> 32);

  // radix select: the K-th smallest bit pattern T, and `rank`, how many
  // keys with bits == T (the lowest indices) belong to the top K
  uint32_t prefix = 0, pmask = 0, rank = (uint32_t)K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;  // kRadixThreads == 256 bins
    __syncthreads();
    for (int s = tid; s < S; s += kRadixThreads) {
      const uint32_t v = bits[s];
      if ((v & pmask) == prefix) atomicAdd(&hist[(v >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) {  // lane holds bins 8 lane .. 8 lane + 7
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[8 * lane + i];
        sum += c[i];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      uint32_t excl = incl - sum;
      if (excl < rank && rank <= incl) {
        int i = 0;
        while (excl + c[i] < rank) excl += c[i++];
        sel_digit = 8u * lane + i;
        sel_rank = rank - excl;
      }
    }
    __syncthreads();
    prefix |= sel_digit << shift;
    pmask |= 255u << shift;
    rank = sel_rank;
  }
  const uint32_t T = prefix;
  const uint32_t n_less = (uint32_t)K - rank;

  // ordered compaction: thread t owns sources [t * seg, (t + 1) * seg); keys
  // below T go to [0, n_less), the first `rank` keys at T to [n_less, K)
  const int seg = (S + kRadixThreads - 1) / kRadixThreads;
  const int s0 = min(S, tid * seg), s1 = min(S, s0 + seg);
  uint32_t less = 0, tie = 0;
  for (int s = s0; s < s1; ++s) {
    less += bits[s] < T;
    tie += bits[s] == T;
  }
  const uint32_t packed = less | (tie << 16);  // S <= 16384: each count fits 16 bits
  const uint32_t excl = block_inclusive_sum(packed, scratch) - packed;
  uint32_t lpos = excl & 0xffffu, tpos = excl >> 16;
  for (int s = s0; s < s1; ++s) {
    const uint32_t v = bits[s];
    const u64 key = ((u64)v << 32) | (uint32_t)s;
    if (v < T) {
      keys[lpos++] = key;
    } else if (v == T) {
      if (tpos < rank) keys[n_less + tpos] = key;
      ++tpos;
    }
  }
  for (int i = K + tid; i < P; i += kRadixThreads) keys[i] = kNone;
  __syncthreads();

  // bitonic sort of the P = next_pow2(K) survivors, ascending. Strides
  // below kChunk run in registers and shuffles, each warp holding chunks of
  // kChunk consecutive keys; only the larger strides pass through shared
  // memory with a barrier (10 barriers for P = 1024, not 55).
  const int n_chunks = P / kChunk;
  for (int c = warp; c < n_chunks; c += kRadixThreads / 32) {
    u64 list[kChunk / 32];
    load_chunk(list, keys + c * kChunk, lane);
    const int base = c * kChunk;
#pragma unroll
    for (int lk = 1; (1 << lk) <= kChunk; ++lk) {
      const int k = 1 << lk;
#pragma unroll
      for (int lj = lk - 1; lj >= 0; --lj)
        bitonic_stage<kChunk / 32>(list, 1 << lj, lane,
                                   [k, base](int i) { return ((base + i) & k) == 0; });
    }
    store_chunk(list, keys + c * kChunk, lane);
  }
  __syncthreads();
  for (int k = 2 * kChunk; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= kChunk; j >>= 1) {
      for (int i = tid; i < (P >> 1); i += kRadixThreads) {
        const int i0 = 2 * i - (i & (j - 1));
        const u64 a = keys[i0], c = keys[i0 + j];
        if ((a > c) == ((i0 & k) == 0)) {
          keys[i0] = c;
          keys[i0 + j] = a;
        }
      }
      __syncthreads();
    }
    for (int c = warp; c < n_chunks; c += kRadixThreads / 32) {
      u64 list[kChunk / 32];
      load_chunk(list, keys + c * kChunk, lane);
      const bool up = ((c * kChunk) & k) == 0;  // one direction for the whole chunk
#pragma unroll
      for (int lj = log2_of(kChunk) - 1; lj >= 0; --lj)
        bitonic_stage<kChunk / 32>(list, 1 << lj, lane, [up](int) { return up; });
      store_chunk(list, keys + c * kChunk, lane);
    }
    __syncthreads();
  }

  for (int j = tid; j < K; j += kRadixThreads) {
    const u64 key = keys[j];
    idx_out[(size_t)row * K + j] = (int)(uint32_t)(key & 0xffffffffu);
    valid_out[(size_t)row * K + j] = (uint32_t)(key >> 32) != kInfBits;
  }
}

template <int N>
int launch_warp(const float* dst_pos, const float* src_pos, const unsigned char* dst_mask,
                const unsigned char* src_mask, int B, int Q, int S, int K, float r2,
                int has_radius, int exclude_self, int* idx_out, unsigned char* valid_out,
                cudaStream_t stream) {
  const size_t smem = sizeof(u64) * 32 * kRowsPerBlock + (sizeof(float2) + 1) * (size_t)S;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        neighbor_topk_warp_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Q + kRowsPerBlock - 1) / kRowsPerBlock, B);
  neighbor_topk_warp_kernel<N><<<grid, 32 * kRowsPerBlock, smem, stream>>>(
      dst_pos, src_pos, dst_mask, src_mask, Q, S, K, r2, has_radius, exclude_self, idx_out,
      valid_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int neighbor_topk_launch(const float* dst_pos, const float* src_pos,
                                    const unsigned char* dst_mask,
                                    const unsigned char* src_mask, int B, int Q,
                                    int S, int K, float r2, int has_radius,
                                    int exclude_self, int* idx_out,
                                    unsigned char* valid_out, void* stream) {
  if (K > S || S > (1 << 14) || B > 65535) return (int)cudaErrorInvalidValue;
  if (B < 1 || Q < 1 || K < 1) return (int)cudaSuccess;  // nothing to select
  const cudaStream_t st = (cudaStream_t)stream;
  if (K <= 32)
    return launch_warp<1>(dst_pos, src_pos, dst_mask, src_mask, B, Q, S, K, r2, has_radius,
                          exclude_self, idx_out, valid_out, st);
  if (K <= 64)
    return launch_warp<2>(dst_pos, src_pos, dst_mask, src_mask, B, Q, S, K, r2, has_radius,
                          exclude_self, idx_out, valid_out, st);
  if (K <= 128)
    return launch_warp<4>(dst_pos, src_pos, dst_mask, src_mask, B, Q, S, K, r2, has_radius,
                          exclude_self, idx_out, valid_out, st);
  if (K == S && S <= 256)  // the whole row is kept: the warp sorts it
    return launch_warp<8>(dst_pos, src_pos, dst_mask, src_mask, B, Q, S, K, r2, has_radius,
                          exclude_self, idx_out, valid_out, st);
  int P = 1;
  while (P < K) P <<= 1;
  const size_t smem = sizeof(u64) * (size_t)P + sizeof(uint32_t) * (size_t)S;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        neighbor_topk_radix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  neighbor_topk_radix_kernel<<<B * Q, kRadixThreads, smem, st>>>(
      dst_pos, src_pos, dst_mask, src_mask, Q, S, K, P, r2, has_radius, exclude_self, idx_out,
      valid_out);
  return (int)cudaGetLastError();
}
