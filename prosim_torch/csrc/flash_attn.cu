// Causal flash attention with a key-padding mask for Hopper (sm_90a).
//
// Replaces the library Pallas flash-attention kernel that
// prosim_tpu/models/llm/llama.py:_causal_attention calls on a TPU (key
// padding as segment ids). For batch b, query head h and query row t:
//   out[t, h] = sum_s softmax_s(q[t, h] . k[s, g] * scale) v[s, g]
// over the keys s <= t with mask[s], g = h / (Hq / Hkv) (grouped-query
// attention without repeating k/v). Pad query rows (mask[t] false) and rows
// with no valid key get zeros. Inputs and output bf16 [B, T, H, D] rows;
// products accumulate in f32 and the softmax statistics are f32.
//
// Bound on the H100: the work it must do depends on the mask. It writes
// every output row and reads q of the valid rows and k/v of the valid keys
// (bf16, once each); its products cover the valid (query, key) pairs at or
// below the diagonal. At the Llama3-8B text shape (B 16, T 384, Hq 32, Hkv 8,
// D 128) the bytes outweigh the products at 3.35 TB/s against the
// 989 TFLOP/s bf16 tensor peak for any mask, so the kernel is bound by
// device-memory bytes (chip_smoke.py computes the bound from each launch's
// mask).
//
// Design: one block of four warps per (query tile of 64 rows, head, batch);
// each warp owns 16 query rows and keeps their q fragments, the 16 x D f32
// output accumulator and the running max and sum in registers. A tile whose
// rows are all pads only writes zeros. The block walks the key tiles of 64
// up to the causal diagonal (later tiles are skipped), staging k and v rows
// in shared memory with masked keys written as zeros, and skips a tile
// whose keys are all masked. q.k^T and p.v run on
// the tensor cores as mma.sync m16n8k16 bf16 with f32 accumulation; the
// scores are masked by selection (never multiplied), so a non-finite value
// in a masked row cannot reach a valid row. An online softmax in the log2
// domain rescales the accumulator per tile. No atomics: results are bitwise
// reproducible.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // query rows per block; also keys per tile
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const unsigned char* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, int T, int Hq, int Hkv, float scale_log2) {
  constexpr int DP = D + 8;  // padded shared row: conflict-free fragment reads
  constexpr int KD = D / 16;  // k-steps of q.k^T
  constexpr int ND = D / 8;   // n-tiles of p.v
  constexpr int CH = D / 8;   // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 ks[kRows * DP];
  __shared__ __align__(16) __nv_bfloat16 vs[kRows * DP];
  __shared__ unsigned char ms[kRows];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (and key column group)
  const int t4 = lane & 3;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + (size_t)b * T * q_stride + (size_t)h * D;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)(h / (Hq / Hkv)) * D;
  const __nv_bfloat16* kb = k + kv_off;
  const __nv_bfloat16* vb = v + kv_off;
  const unsigned char* mb = mask + (size_t)b * T;

  const int r_lo = tile * kRows + warp * 16 + g;  // the two query rows of this thread
  const int r_hi = r_lo + 8;
  const bool ok_lo = r_lo < T && mb[r_lo];
  const bool ok_hi = r_hi < T && mb[r_hi];
  const bool warp_live = __any_sync(kFull, ok_lo || ok_hi);
  // a tile of pad rows reads nothing and walks no key tile: its output is zeros
  const int last_kt = __syncthreads_or(ok_lo || ok_hi) ? tile : -1;

  uint32_t qa[KD][4];  // q of pad rows is never read
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + t4 * 2;
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(qb + (size_t)r_lo * q_stride + c);
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(qb + (size_t)r_hi * q_stride + c);
    qa[kk][0] = ok_lo ? lo[0] : 0u;
    qa[kk][1] = ok_hi ? hi[0] : 0u;
    qa[kk][2] = ok_lo ? lo[4] : 0u;
    qa[kk][3] = ok_hi ? hi[4] : 0u;
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max (log2 domain)
  float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the running sum

  for (int kt = 0; kt <= last_kt; ++kt) {  // key tiles up to the causal diagonal
    const int key0 = kt * kRows;
    __syncthreads();  // the previous tile's reads are done
    bool any = false;
    if (threadIdx.x < kRows) {
      const int s = key0 + threadIdx.x;
      const unsigned char mv = s < T ? mb[s] : 0;
      ms[threadIdx.x] = mv;
      any = mv != 0;
    }
    for (int i = threadIdx.x; i < kRows * CH; i += kThreads) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const int s = key0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (s < T && mb[s]) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)s * kv_stride + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)s * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(ks + r * DP + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * DP + c) = vv;
    }
    if (!__syncthreads_or(any) || !warp_live) continue;  // block- and warp-uniform

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * DP + kk * 16 + t4 * 2;
        mma_bf16(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = n * 8 + t4 * 2 + j;
        const bool key_ok = ms[kc] != 0;
        s[n][j] = (key_ok && key0 + kc <= r_lo) ? s[n][j] * scale_log2 : -INFINITY;
        s[n][2 + j] = (key_ok && key0 + kc <= r_hi) ? s[n][2 + j] * scale_log2 : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[n][j]);
        mx_hi = fmaxf(mx_hi, s[n][2 + j]);
      }
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, w));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = mn_lo == -INFINITY ? 1.f : exp2f(m_lo - mn_lo);
    const float c_hi = mn_hi == -INFINITY ? 1.f : exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[n][j] = s[n][j] == -INFINITY ? 0.f : exp2f(s[n][j] - mn_lo);
        s[n][2 + j] = s[n][2 + j] == -INFINITY ? 0.f : exp2f(s[n][2 + j] - mn_hi);
        sum_lo += s[n][j];
        sum_hi += s[n][2 + j];
      }
    }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= c_lo;
      o[n][1] *= c_lo;
      o[n][2] *= c_hi;
      o[n][3] *= c_hi;
    }

#pragma unroll
    for (int kc = 0; kc < kRows / 16; ++kc) {  // 16 keys per mma
      const uint32_t pa[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                              pack_f32(s[2 * kc][2], s[2 * kc][3]),
                              pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const __nv_bfloat16* vr = vs + (kc * 16 + t4 * 2) * DP + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        mma_bf16(o[n], pa, pack_bf16(vc[0], vc[DP]), pack_bf16(vc[8 * DP], vc[9 * DP]));
      }
    }
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l_lo += __shfl_xor_sync(kFull, l_lo, w);
    l_hi += __shfl_xor_sync(kFull, l_hi, w);
  }
  const bool w_lo = ok_lo && l_lo > 0.f, w_hi = ok_hi && l_hi > 0.f;
  const float inv_lo = w_lo ? 1.f / l_lo : 0.f, inv_hi = w_hi ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r_lo < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)b * T * q_stride + (size_t)r_lo * q_stride +
                                   (size_t)h * D + c) =
          w_lo ? pack_f32(o[n][0] * inv_lo, o[n][1] * inv_lo) : 0u;
    if (r_hi < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)b * T * q_stride + (size_t)r_hi * q_stride +
                                   (size_t)h * D + c) =
          w_hi ? pack_f32(o[n][2] * inv_hi, o[n][3] * inv_hi) : 0u;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const unsigned char* mask, void* out,
            int B, int T, int Hq, int Hkv, float scale_log2, cudaStream_t stream) {
  const dim3 grid((T + kRows - 1) / kRows, Hq, B);
  flash_attn_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), T, Hq, Hkv,
      scale_log2);
}

}  // namespace

extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 const unsigned char* mask, void* out, int B, int T, int Hq,
                                 int Hkv, int D, float scale, void* stream) {
  if (Hkv < 1 || Hq < 1 || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B < 1 || T < 1) return (int)cudaSuccess;
  const float sl2 = scale * 1.4426950408889634f;  // softmax in the log2 domain
  const cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: launch<16>(q, k, v, mask, out, B, T, Hq, Hkv, sl2, st); break;
    case 32: launch<32>(q, k, v, mask, out, B, T, Hq, Hkv, sl2, st); break;
    case 48: launch<48>(q, k, v, mask, out, B, T, Hq, Hkv, sl2, st); break;
    case 64: launch<64>(q, k, v, mask, out, B, T, Hq, Hkv, sl2, st); break;
    case 80: launch<80>(q, k, v, mask, out, B, T, Hq, Hkv, sl2, st); break;
    case 96: launch<96>(q, k, v, mask, out, B, T, Hq, Hkv, sl2, st); break;
    case 112: launch<112>(q, k, v, mask, out, B, T, Hq, Hkv, sl2, st); break;
    case 128: launch<128>(q, k, v, mask, out, B, T, Hq, Hkv, sl2, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
