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
//
// Design: one block per (b, q) row. Each source becomes one 64-bit key
// (float bits of d2 << 32 | s); non-negative floats order like their bit
// patterns, so integer compare-exchanges give the order above exactly, ties
// included. The row's P keys (S padded to a power of two; S = 2208 -> 4096
// keys, 32 KB of shared memory) are selected by a bitonic top-K network:
//   1. a bitonic sort of every chunk of C = next_pow2(eff_k) keys, chunks
//      alternately ascending and descending;
//   2. log2(P / C) halving rounds: each ascending/descending pair of chunks
//      is one bitonic sequence, whose half-cleaner keeps its C smallest keys
//      in the first chunk; a bitonic merge sorts that chunk again.
// The last chunk standing holds the row's C smallest keys in ascending order.
// With C = P this is the full bitonic sort. The [B, Q, S] distance matrix
// never reaches device memory.
//
// Bound on the H100: the bytes that must move are tiny (positions in, K
// indices out), so the kernel is bound by the network's shared-memory passes
// and barriers. Against the full sort, the chunked network cuts the
// compare-exchanges of the s2s site (S = 2208, K = 32) about 3.7x and its
// barriers from 78 to 57.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kInfBits = 0x7f800000u;

__global__ void neighbor_topk_kernel(const float* __restrict__ dst_pos,
                                     const float* __restrict__ src_pos,
                                     const unsigned char* __restrict__ dst_mask,
                                     const unsigned char* __restrict__ src_mask,
                                     int Q, int S, int P, int log_c, int K, float r2,
                                     int has_radius, int exclude_self,
                                     int* __restrict__ idx_out,
                                     unsigned char* __restrict__ valid_out) {
  extern __shared__ unsigned long long keys[];
  const int row = blockIdx.x;  // b * Q + q
  const int b = row / Q;
  const int q = row - b * Q;
  const float qx = dst_pos[2 * (size_t)row];
  const float qy = dst_pos[2 * (size_t)row + 1];
  const bool q_ok = dst_mask[row] != 0;
  const float* src = src_pos + (size_t)b * S * 2;
  const unsigned char* smask = src_mask + (size_t)b * S;

  for (int s = threadIdx.x; s < P; s += blockDim.x) {
    unsigned long long key = ~0ull;  // padding sorts last
    if (s < S) {
      const float dx = __fsub_rn(qx, src[2 * s]);
      const float dy = __fsub_rn(qy, src[2 * s + 1]);
      const float d2 = __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
      bool bad = !(q_ok && smask[s] != 0);
      if (has_radius) bad = bad || (d2 > r2);
      if (exclude_self) bad = bad || (s == q);
      const uint32_t bits = bad ? kInfBits : __float_as_uint(d2);
      key = ((unsigned long long)bits << 32) | (uint32_t)s;
    }
    keys[s] = key;
  }
  __syncthreads();

  // 1. sort every chunk of C keys; chunk c ascending when c is even
  const int C = 1 << log_c;
  for (int k = 2; k <= C; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i];
          const unsigned long long c = keys[ixj];
          const bool up = (i & k) == 0;
          if ((a > c) == up) {
            keys[i] = c;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // 2. halving rounds over the live chunks, which sit `stride` keys apart:
  // pair t is chunks 2t (ascending) and 2t + 1 (descending)
  const int half = C >> 1;
  for (int live = P >> log_c, stride = C; live > 1; live >>= 1, stride <<= 1) {
    const int pairs = live >> 1;
    for (int e = threadIdx.x; e < (pairs << log_c); e += blockDim.x) {
      unsigned long long* a = keys + (size_t)(2 * (e >> log_c)) * stride + (e & (C - 1));
      const unsigned long long b = a[stride];
      if (b < *a) *a = b;
    }
    __syncthreads();
    // survivor t (bitonic) is sorted ascending when t is even
    for (int j = half; j > 0; j >>= 1) {
      for (int e = threadIdx.x; e < pairs * half; e += blockDim.x) {
        const int t = e >> (log_c - 1);
        const int p = e & (half - 1);
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        unsigned long long* base = keys + (size_t)(2 * t) * stride;
        const unsigned long long a = base[i];
        const unsigned long long c = base[i + j];
        if ((a > c) == ((t & 1) == 0)) {
          base[i] = c;
          base[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const unsigned long long key = keys[j];
    idx_out[(size_t)row * K + j] = (int)(uint32_t)(key & 0xffffffffu);
    valid_out[(size_t)row * K + j] = (uint32_t)(key >> 32) != kInfBits;
  }
}

}  // namespace

extern "C" int neighbor_topk_launch(const float* dst_pos, const float* src_pos,
                                    const unsigned char* dst_mask,
                                    const unsigned char* src_mask, int B, int Q,
                                    int S, int K, float r2, int has_radius,
                                    int exclude_self, int* idx_out,
                                    unsigned char* valid_out, void* stream) {
  int P = 1;
  while (P < S) P <<= 1;
  int log_c = 0;
  while ((1 << log_c) < K && (1 << log_c) < P) ++log_c;
  const size_t smem = sizeof(unsigned long long) * (size_t)P;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        neighbor_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = P / 2 < 1024 ? (P / 2 < 32 ? 32 : P / 2) : 1024;
  neighbor_topk_kernel<<<B * Q, threads, smem, (cudaStream_t)stream>>>(
      dst_pos, src_pos, dst_mask, src_mask, Q, S, P, log_c, K, r2, has_radius,
      exclude_self, idx_out, valid_out);
  return (int)cudaGetLastError();
}
