// The normalised rel-PE table of one fixed-PE attention site, in one pass.
//
// For each edge (b, q, k) of a site's neighbour grid it writes the row the
// edge core (csrc/edge_attn.cu) reads as z_r:
//   g        = source pose at idx[b, q, k]  (position, orientation)
//   f        = (dist, rel_ori, rel_ori_vec) of g relative to destination q
//   e[c, j]  = round_T(sin(f[c] * inv_t[j] + phase[j]))   c < 3, j < npf
//   z[b,q,k] = round_T((e - mu) * rsqrt(var + 1e-5)), mu and var over the
//              `hidden` reference dims: e with its last hidden - 3 npf
//              values twice (hidden = 4 npf: the last block, c = 2)
// which is ops/attention.py's rel_pe_table_plain,
// normalize_rel_pe(RelPE(rel_pe_features(...)), hidden), op for op: the
// same gather, the same roundings in the same order (each product and sum
// rounded apart, no fused multiply-add; the accurate sinf, cosf, atan2f,
// fmodf; torch.remainder's sign rule; the dot product's sum starting from
// +0 as torch's reduction does, so atan2 sees the same signed zero), inv_t
// and phase as FourierEmbeddingFix computes them on the card, each sine
// rounded to the table's dtype T before the statistics. Only the order of
// the statistics' sums differs from the plain chain.
//
// It replaces no TPU kernel: on the TPU, XLA fuses this chain of
// elementwise ops and reductions into its consumers. Run eagerly it is ~35
// PyTorch ops, most of them full passes over the [B, Q, K, 3 npf] table.
//
// Bound on the H100: the table write, 3 npf values of 4 (f32) or 2 (bf16)
// bytes an edge; the reads are 4 bytes of idx an edge and the sources'
// poses, 12 bytes a slot, which stay in L2. The work is 3 npf accurate
// sines an edge and one set of features (a gather, a sqrt, an fmod, an
// atan2) an edge.
//
// Design:
//  * One warp per 32 edges of one destination row. Lane l computes the
//    features of edge e0 + l once (its idx is one coalesced load); the warp
//    then walks the 32 edges, each taking its three features by shuffle,
//    lane j owning dim j of each feature's block (npf <= 32).
//  * A row's sum and sum of squares go through a fixed xor-shuffle tree:
//    no atomics, so two launches are bitwise equal.
//  * Three coalesced stores an edge (128 bytes each in f32, 64 in bf16).
//  * Invalid edges are written too (their idx is in range, as the edge core
//    allows); the index is clamped to the row of sources all the same, so a
//    stray value cannot read outside the table.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// float32(pi) and float32(2 pi): utils/geometry.py wrap_angle's scalars as torch rounds them
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kEps = 1e-5f;

// A [B, N, 2] position and a [B, N] orientation, f32, with their batch and
// row strides in elements (the position's two coordinates adjacent).
struct Pose {
  const float* pos;
  long long pos_b, pos_n;
  const float* ori;
  long long ori_b, ori_n;
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T store_as(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __float2bfloat16_rn(x);
}

// -pi + torch.remainder(a + pi, 2 pi); torch.remainder is fmod moved into
// the divisor's sign
__device__ __forceinline__ float wrap_angle(float a) {
  float m = fmodf(__fadd_rn(a, kPi), kTwoPi);
  if (m < 0.f) m = __fadd_rn(m, kTwoPi);
  return __fadd_rn(m, -kPi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rel_pe_table_kernel(Pose dst, Pose src, const int* __restrict__ idx,
                        const float* __restrict__ freqs, T* __restrict__ z, int Q, int S, int K,
                        int npf, int hidden, int chunks, long long items, int dst_bf16) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= items) return;
  const long long row = item / chunks;  // b * Q + q
  const int e0 = (int)(item - row * chunks) * 32;
  const int n = min(32, K - e0);
  const long long b = row / Q, q = row - b * Q;

  // the destination's pose; cos and sin in its dtype (bf16 rounds them)
  const float* dp = dst.pos + b * dst.pos_b + q * dst.pos_n;
  const float px = dp[0], py = dp[1];
  const float po = dst.ori[b * dst.ori_b + q * dst.ori_n];
  float c = cosf(po), s = sinf(po);
  if (dst_bf16) {
    c = round_to<__nv_bfloat16>(c);
    s = round_to<__nv_bfloat16>(s);
  }

  // lane l: the three features of edge e0 + l (rel_pe_input)
  float dist = 0.f, rel_ori = 0.f, rel_vec = 0.f;
  if (lane < n) {
    const int j = min(max(idx[row * K + e0 + lane], 0), S - 1);
    const float* sp = src.pos + b * src.pos_b + j * src.pos_n;
    const float dx = __fsub_rn(sp[0], px), dy = __fsub_rn(sp[1], py);
    // vector_norm: the two squares, their sum, the square root
    dist = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    rel_ori = wrap_angle(__fsub_rn(src.ori[b * src.ori_b + j * src.ori_n], po));
    // angle_between_2d_vectors((cos, sin), (dx, dy))
    const float cross = __fsub_rn(__fmul_rn(c, dy), __fmul_rn(s, dx));
    const float dot = __fadd_rn(__fadd_rn(0.f, __fmul_rn(c, dx)), __fmul_rn(s, dy));
    rel_vec = atan2f(cross, dot);
  }

  const bool on = lane < npf;
  const float inv_t = on ? freqs[lane] : 0.f, phase = on ? freqs[npf + lane] : 0.f;
  // torch divides by the scalar `hidden` as a product with its f32 reciprocal
  const float inv_n = 1.f / (float)hidden;
  // the reference's duplicated tail: row positions c npf + lane from
  // 6 npf - hidden on count twice (exact products by 1 and 2)
  const int dup = 6 * npf - hidden;
  const float w0 = lane >= dup ? 2.f : 1.f, w1 = npf + lane >= dup ? 2.f : 1.f;
  const float w2 = 2 * npf + lane >= dup ? 2.f : 1.f;
  T* out = z + (row * K + e0) * (3 * npf) + lane;
  for (int k = 0; k < n; ++k) {
    const float f0 = __shfl_sync(kFull, dist, k);
    const float f1 = __shfl_sync(kFull, rel_ori, k);
    const float f2 = __shfl_sync(kFull, rel_vec, k);
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    if (on) {
      v0 = round_to<T>(sinf(__fadd_rn(__fmul_rn(f0, inv_t), phase)));
      v1 = round_to<T>(sinf(__fadd_rn(__fmul_rn(f1, inv_t), phase)));
      v2 = round_to<T>(sinf(__fadd_rn(__fmul_rn(f2, inv_t), phase)));
    }
    const float sum =
        warp_sum(__fadd_rn(__fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1)), __fmul_rn(w2, v2)));
    const float ss = warp_sum(__fadd_rn(
        __fadd_rn(__fmul_rn(w0, __fmul_rn(v0, v0)), __fmul_rn(w1, __fmul_rn(v1, v1))),
        __fmul_rn(w2, __fmul_rn(v2, v2))));
    const float mu = __fmul_rn(sum, inv_n);
    const float var = fmaxf(__fsub_rn(__fmul_rn(ss, inv_n), __fmul_rn(mu, mu)), 0.f);
    const float r = rsqrtf(__fadd_rn(var, kEps));
    if (on) {
      T* o = out + (long long)k * 3 * npf;
      o[0] = store_as<T>(__fmul_rn(__fsub_rn(v0, mu), r));
      o[npf] = store_as<T>(__fmul_rn(__fsub_rn(v1, mu), r));
      o[2 * npf] = store_as<T>(__fmul_rn(__fsub_rn(v2, mu), r));
    }
  }
}

template <typename T>
int launch(const float* dst_pos, long long dst_pos_b, long long dst_pos_n, const float* dst_ori,
           long long dst_ori_b, long long dst_ori_n, const float* src_pos, long long src_pos_b,
           long long src_pos_n, const float* src_ori, long long src_ori_b, long long src_ori_n,
           const int* idx, const float* freqs, T* z, int B, int Q, int S, int K, int npf,
           int hidden, int dst_bf16, void* stream) {
  if (npf < 1 || npf > 32 || hidden < 4 * npf || S < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (K + 31) / 32;
  const long long items = (long long)B * Q * chunks;
  if (items < 1) return (int)cudaSuccess;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Pose dst{dst_pos, dst_pos_b, dst_pos_n, dst_ori, dst_ori_b, dst_ori_n};
  const Pose src{src_pos, src_pos_b, src_pos_n, src_ori, src_ori_b, src_ori_n};
  rel_pe_table_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dst, src, idx, freqs, z, Q, S, K, npf, hidden, chunks, items, dst_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rel_pe_table_launch(const float* dst_pos, long long dst_pos_b,
                                   long long dst_pos_n, const float* dst_ori,
                                   long long dst_ori_b, long long dst_ori_n,
                                   const float* src_pos, long long src_pos_b,
                                   long long src_pos_n, const float* src_ori,
                                   long long src_ori_b, long long src_ori_n, const int* idx,
                                   const float* freqs, float* z, int B, int Q, int S, int K,
                                   int npf, int hidden, int dst_bf16, void* stream) {
  return launch<float>(dst_pos, dst_pos_b, dst_pos_n, dst_ori, dst_ori_b, dst_ori_n, src_pos,
                       src_pos_b, src_pos_n, src_ori, src_ori_b, src_ori_n, idx, freqs, z, B, Q,
                       S, K, npf, hidden, dst_bf16, stream);
}

extern "C" int rel_pe_table_launch_bf16(const float* dst_pos, long long dst_pos_b,
                                        long long dst_pos_n, const float* dst_ori,
                                        long long dst_ori_b, long long dst_ori_n,
                                        const float* src_pos, long long src_pos_b,
                                        long long src_pos_n, const float* src_ori,
                                        long long src_ori_b, long long src_ori_n,
                                        const int* idx, const float* freqs, __nv_bfloat16* z,
                                        int B, int Q, int S, int K, int npf, int hidden,
                                        int dst_bf16, void* stream) {
  return launch<__nv_bfloat16>(dst_pos, dst_pos_b, dst_pos_n, dst_ori, dst_ori_b, dst_ori_n,
                               src_pos, src_pos_b, src_pos_n, src_ori, src_ori_b, src_ori_n, idx,
                               freqs, z, B, Q, S, K, npf, hidden, dst_bf16, stream);
}
