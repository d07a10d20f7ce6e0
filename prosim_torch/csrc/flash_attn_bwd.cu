// The backward of causal flash attention with a key-padding mask, for
// Hopper (sm_90a): dq, dk, dv of csrc/flash_attn.cu's forward.
//
// Replaces the backward kernels of the library Pallas flash attention that
// prosim_tpu/models/llm/llama.py:_causal_attention reaches on a TPU under
// jax.value_and_grad (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv at :941, its pallas_call at :1121, and
// _flash_attention_bwd_dq at :1287, its pallas_call at :1456). For batch b,
// query head h (key/value head g = h / (Hq / Hkv)), valid query row t and
// valid key s <= t, with the forward's per-row log-sum-exp lse[t]:
//   P[t, s]  = exp(q[t] . k[s] * scale - lse[t])
//   delta[t] = sum_d dO[t, d] O[t, d]                       (f32)
//   dv[s, g] = sum over the group's heads h and rows t of P[t, s] dO[t]
//   dS[t, s] = P[t, s] (dO[t] . v[s] - delta[t])
//   dq[t, h] = scale sum_s dS[t, s] k[s],  dk[s, g] = scale sum_{h, t} dS[t, s] q[t]
// Pad query rows (mask false) get dq = 0 and contribute nothing; masked keys
// get dk = dv = 0. Their rows are never read (a copy of source size 0 writes
// zeros in shared memory) and their P is selected to 0, never computed from
// them, so non-finite values in pad rows cannot reach a valid row's
// gradient. No atomics: every output element is summed in one thread in a
// fixed order, so two launches are bitwise equal.
//
// Three kernels (flash_bwd_*), launched in this order by
// flash_attn_bwd_launch:
//   delta - delta[b, h, t] (0 on pad rows), eight threads per row;
//   dkv   - one block per (key tile, kv head, batch): it walks the query
//           tiles at or after its keys for all Hq/Hkv query heads of the
//           group, so the group sum happens in registers;
//   dq    - one block per (query tile, query head, batch) over the key
//           tiles up to its diagonal.
// Key tiles with no valid key and query tiles with no valid row are not
// visited (their outputs are written as zeros).
//
// bf16 (the Llama3-8B text path; q/k/v/o/dO bf16, lse/delta f32): every
// product is mma.sync m16n8k16 with f32 accumulation, fragments read from
// shared memory with ldmatrix (.trans where the operand is stored k-major);
// P and dS are rounded to bf16 as product inputs, as the forward rounds P.
// 4 warps, each owns 16 rows (dkv: keys; dq: query rows) and holds its
// [16, D] f32 accumulators in registers (dk and dv: 2 x 64 registers at
// D = 128); q/dO (dkv) or k/v (dq) tiles go through a two-stage cp.async
// ring. Bound on the H100: at the Llama3-8B text shape (B 16, T 384, Hq 32,
// Hkv 8, D 128) the products (10 D per valid causal pair and query head)
// over 989 TFLOP/s exceed the bytes (q, k, v, o, dO, lse, mask read once;
// dq, dk, dv written once) over 3.35 TB/s for a mostly valid mask, and the
// bytes bound a mostly padded one. A first design: no wgmma, TMA or warp
// specialisation.
//
// f32 (LlamaConfig.tiny(), the shipped demo configuration): FMA on the CUDA
// cores, four lanes per row each holding D/4 of its dims (interleaved), dot
// products summed over the four by two shuffles, 32-row tiles staged in
// shared memory; as the forward's f32 kernel it is latency-bound at D = 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef __nv_bfloat16 bf16;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTile = 64;   // dkv: keys per block, 16 per warp
constexpr int kQTile = 32;     // dkv: query rows per step
constexpr int kQRows = 64;     // dq: query rows per block, 16 per warp
constexpr int kKTile = 64;     // dq: keys per step
constexpr int kF32Rows = 32;   // f32 kernels: rows per block and per step, four lanes per row
constexpr int kF32Threads = 4 * kF32Rows;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
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
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Fragment addresses (mma m16n8k16, row.col) into a row-major shared tile
// of row stride DP elements:
//   a_off: the A operand [16 rows][16 k] at (row 0, k 0), non-transposed;
//   b_off: two n-tiles of the B operand from a tile stored [n][k]
//          (regs 0/1: n 0-7, regs 2/3: n 8-15), non-transposed;
//   bt_off: two n-tiles of the B operand from a tile stored [k][n], read
//          with ldmatrix .trans.
__device__ __forceinline__ int a_off(int lane, int DP) {
  return (lane & 15) * DP + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int DP) {
  return (((lane >> 4) << 3) + (lane & 7)) * DP + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int DP) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * DP + (lane >> 4) * 8;
}

// C fragments of two adjacent n-tiles (16 columns) as one A fragment (k 16)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// ------------------------------------------------------------------ delta
template <typename T_>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const T_* __restrict__ o,
                                                    const T_* __restrict__ dout,
                                                    const unsigned char* __restrict__ mask,
                                                    float* __restrict__ delta, int B, int T,
                                                    int Hq, int D) {
  const long long rows = (long long)B * T * Hq;  // (b, t, h), in memory order
  const long long row = (long long)blockIdx.x * (blockDim.x / 8) + threadIdx.x / 8;
  const int part = threadIdx.x & 7;
  const long long bt = row / Hq;
  const bool ok = row < rows && mask[bt];  // a pad row is not read
  float acc = 0.f;
  if (ok)
    for (int d = part; d < D; d += 8)
      acc = fmaf(to_f32(o[row * D + d]), to_f32(dout[row * D + d]), acc);
  acc += __shfl_xor_sync(kFull, acc, 1);
  acc += __shfl_xor_sync(kFull, acc, 2);
  acc += __shfl_xor_sync(kFull, acc, 4);
  if (row < rows && part == 0) {
    const long long b = bt / T, t = bt - b * T, h = row - bt * Hq;
    delta[(b * Hq + h) * T + t] = ok ? acc : 0.f;
  }
}

// ------------------------------------------------------------ dk, dv (bf16)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mask,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hq, int Hkv, float scale,
    float scale_log2) {
  constexpr int DP = D + 8;  // 16 bytes of row padding: ldmatrix rows hit distinct banks
  constexpr int KD = D / 16, ND = D / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [kKeyTile][DP]
  bf16* vs = ks + kKeyTile * DP;              // [kKeyTile][DP]
  bf16* qs = vs + kKeyTile * DP;              // [2][kQTile][DP]
  bf16* dos = qs + 2 * kQTile * DP;           // [2][kQTile][DP]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kQTile * DP);  // [2][kQTile], log2 domain
  float* del_s = lse_s + 2 * kQTile;                               // [2][kQTile]
  unsigned* qbits = reinterpret_cast<unsigned*>(del_s + 2 * kQTile);  // [query tiles]
  __shared__ u64 kbits_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kKeyTile, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const unsigned char* mb = mask + (size_t)b * T;
  const int n_qt = (T + kQTile - 1) / kQTile;

  for (int qt = warp; qt < n_qt; qt += kWarps) {  // which rows of each query tile are valid
    const int t = qt * kQTile + lane;
    const unsigned bits = __ballot_sync(kFull, t < T && mb[t]);
    if (lane == 0) qbits[qt] = bits;
  }
  if (warp == 0) {
    const int s0 = k0 + lane, s1 = s0 + 32;
    const unsigned lo = __ballot_sync(kFull, s0 < T && mb[s0]);
    const unsigned hi = __ballot_sync(kFull, s1 < T && mb[s1]);
    if (lane == 0) kbits_s = (u64)lo | ((u64)hi << 32);
  }
  __syncthreads();
  const u64 kbits = kbits_s;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kvh * D;
  if (kbits == 0ull) {  // no valid key: zeros, in 16-byte stores
    const int rows = min(T, k0 + kKeyTile) - k0;
    for (int i = tid; i < rows * CH; i += kThreads) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const size_t off = kv_off + (size_t)(k0 + r) * kv_stride + c;
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  for (int i = tid; i < kKeyTile * CH; i += kThreads) {  // the key tile, masked keys as zeros
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = (kbits >> r) & 1ull;
    const size_t off = kv_off + (size_t)(k0 + r) * kv_stride + c;
    cp_async16(ks + r * DP + c, ok ? k + off : k, ok ? 16 : 0);
    cp_async16(vs + r * DP + c, ok ? v + off : v, ok ? 16 : 0);
  }
  cp_async_commit();

  // items: (query head of the group, query tile at or after the key tile)
  const int qt0 = k0 / kQTile;
  const int nq = n_qt - qt0;
  const int n_items = G * nq;
  auto next_item = [&](int it) {
    while (it < n_items && qbits[qt0 + it % nq] == 0u) ++it;
    return it;
  };
  auto load_q = [&](int it, int stage) {
    const int h = kvh * G + it / nq, q0 = (qt0 + it % nq) * kQTile;
    const unsigned bits = qbits[qt0 + it % nq];
    bf16* qd = qs + stage * kQTile * DP;
    bf16* dd = dos + stage * kQTile * DP;
    for (int i = tid; i < kQTile * CH; i += kThreads) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const bool ok = (bits >> r) & 1u;
      const size_t off = ((size_t)b * T + q0 + r) * q_stride + (size_t)h * D + c;
      cp_async16(qd + r * DP + c, ok ? q + off : q, ok ? 16 : 0);
      cp_async16(dd + r * DP + c, ok ? dout + off : dout, ok ? 16 : 0);
    }
    if (tid < kQTile) {
      const bool ok = (bits >> tid) & 1u;
      const size_t off = ((size_t)b * Hq + h) * T + q0 + tid;
      lse_s[stage * kQTile + tid] = ok ? lse[off] * kLog2e : 0.f;
      del_s[stage * kQTile + tid] = ok ? delta[off] : 0.f;
    }
  };

  const int kw0 = k0 + warp * 16;  // the warp's first key
  const int key_lo = kw0 + g, key_hi = key_lo + 8;
  const bool kok_lo = (kbits >> (warp * 16 + g)) & 1ull;
  const bool kok_hi = (kbits >> (warp * 16 + g + 8)) & 1ull;
  const bool warp_live = ((kbits >> (warp * 16)) & 0xffffull) != 0ull;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;
  const bf16* ka = ks + warp * 16 * DP + a_off(lane, DP);
  const bf16* va = vs + warp * 16 * DP + a_off(lane, DP);

  int it = next_item(0);
  if (it < n_items) load_q(it, 0);
  cp_async_commit();
  for (int stage = 0; it < n_items; stage ^= 1) {
    const int itn = next_item(it + 1);
    cp_async_wait_all();  // this thread's copies of item it (and of the key tile)
    __syncthreads();      // everyone's; and every warp is done with the other stage
    if (itn < n_items) load_q(itn, stage ^ 1);
    cp_async_commit();
    const int q0 = (qt0 + it % nq) * kQTile;
    const unsigned bits = qbits[qt0 + it % nq];
    if (warp_live && kw0 <= q0 + kQTile - 1) {  // warp-uniform: some pair at or below the diagonal
      const bf16* qst = qs + stage * kQTile * DP;
      const bf16* dst = dos + stage * kQTile * DP;
      const float* ls = lse_s + stage * kQTile;
      const float* dl = del_s + stage * kQTile;
      // S^T [16 keys, 32 queries] = K_w Q^T
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, ka + kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4];
          ldmatrix_x4(bq, qst + b_off(lane, DP) + np * 16 * DP + kk * 16);
          mma_bf16(s[2 * np], a, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
        }
      }
      // P^T, selected to 0 off the valid causal pairs
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qc = n * 8 + t4 * 2 + j;
          const bool qok = (bits >> qc) & 1u;
          const int t = q0 + qc;
          s[n][j] = (qok && kok_lo && key_lo <= t) ? exp2f(s[n][j] * scale_log2 - ls[qc]) : 0.f;
          s[n][2 + j] =
              (qok && kok_hi && key_hi <= t) ? exp2f(s[n][2 + j] * scale_log2 - ls[qc]) : 0.f;
        }
      }
      // dV += P^T dO
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bd[4];
          ldmatrix_x4_trans(bd, dst + bt_off(lane, DP) + kc * 16 * DP + np * 16);
          mma_bf16(dva[2 * np], pa, bd[0], bd[1]);
          mma_bf16(dva[2 * np + 1], pa, bd[2], bd[3]);
        }
      }
      // dP^T [16 keys, 32 queries] = V_w dO^T
      float dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, va + kk * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bd[4];
          ldmatrix_x4(bd, dst + b_off(lane, DP) + np * 16 * DP + kk * 16);
          mma_bf16(dp[2 * np], a, bd[0], bd[1]);
          mma_bf16(dp[2 * np + 1], a, bd[2], bd[3]);
        }
      }
      // dS^T = P^T (dP^T - delta); P^T is 0 off the valid pairs and dP^T
      // finite (pad rows were staged as zeros), so dS^T is 0 there too
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float d = dl[n * 8 + t4 * 2 + j];
          s[n][j] *= dp[n][j] - d;
          s[n][2 + j] *= dp[n][2 + j] - d;
        }
      }
      // dK += dS^T Q
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, qst + bt_off(lane, DP) + kc * 16 * DP + np * 16);
          mma_bf16(dka[2 * np], pa, bq[0], bq[1]);
          mma_bf16(dka[2 * np + 1], pa, bq[2], bq[3]);
        }
      }
    }
    it = itn;
  }
  cp_async_wait_all();  // nothing in flight at exit (a block whose items were all empty)

  bf16* dkb = dk + kv_off;
  bf16* dvb = dv + kv_off;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t4 * 2;
    if (key_lo < T) {
      const size_t off = (size_t)key_lo * kv_stride + c;
      *reinterpret_cast<uint32_t*>(dkb + off) =
          kok_lo ? pack_f32(dka[n][0] * scale, dka[n][1] * scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvb + off) = kok_lo ? pack_f32(dva[n][0], dva[n][1]) : 0u;
    }
    if (key_hi < T) {
      const size_t off = (size_t)key_hi * kv_stride + c;
      *reinterpret_cast<uint32_t*>(dkb + off) =
          kok_hi ? pack_f32(dka[n][2] * scale, dka[n][3] * scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvb + off) = kok_hi ? pack_f32(dva[n][2], dva[n][3]) : 0u;
    }
  }
}

// ------------------------------------------------------------------ dq (bf16)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mask,
    bf16* __restrict__ dq, int T, int Hq, int Hkv, float scale, float scale_log2) {
  constexpr int DP = D + 8;
  constexpr int KD = D / 16, ND = D / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kQRows][DP]
  bf16* dos = qs + kQRows * DP;              // [kQRows][DP]
  bf16* ks = dos + kQRows * DP;              // [2][kKTile][DP]
  bf16* vs = ks + 2 * kKTile * DP;           // [2][kKTile][DP]
  u64* kbits = reinterpret_cast<u64*>(vs + 2 * kKTile * DP);  // [key tiles]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQRows;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const unsigned char* mb = mask + (size_t)b * T;
  const int wq0 = q0 + warp * 16;
  const int r_lo = wq0 + g, r_hi = r_lo + 8;
  const bool ok_lo = r_lo < T && mb[r_lo];
  const bool ok_hi = r_hi < T && mb[r_hi];
  const size_t q_off = (size_t)b * T * q_stride + (size_t)h * D;
  if (!__syncthreads_or(ok_lo || ok_hi)) {  // a tile of pad rows: zeros
    const int rows = min(T, q0 + kQRows) - q0;
    for (int i = tid; i < rows * CH; i += kThreads) {
      const int r = i / CH, c = (i - r * CH) * 8;
      *reinterpret_cast<uint4*>(dq + q_off + (size_t)(q0 + r) * q_stride + c) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int last_kt = (min(T, q0 + kQRows) - 1) / kKTile;
  for (int kt = warp; kt <= last_kt; kt += kWarps) {  // which keys of each tile are valid
    const int s0 = kt * kKTile + lane, s1 = s0 + 32;
    const unsigned lo = __ballot_sync(kFull, s0 < T && mb[s0]);
    const unsigned hi = __ballot_sync(kFull, s1 < T && mb[s1]);
    if (lane == 0) kbits[kt] = (u64)lo | ((u64)hi << 32);
  }
  for (int i = tid; i < kQRows * CH; i += kThreads) {  // q and dO rows, pads as zeros
    const int r = i / CH, c = (i - r * CH) * 8;
    const int t = q0 + r;
    const bool ok = t < T && mb[t];
    const size_t off = q_off + (size_t)t * q_stride + c;
    cp_async16(qs + r * DP + c, ok ? q + off : q, ok ? 16 : 0);
    cp_async16(dos + r * DP + c, ok ? dout + off : dout, ok ? 16 : 0);
  }
  cp_async_commit();
  const size_t row_off = ((size_t)b * Hq + h) * T;
  const float l2_lo = ok_lo ? lse[row_off + r_lo] * kLog2e : 0.f;
  const float l2_hi = ok_hi ? lse[row_off + r_hi] * kLog2e : 0.f;
  const float d_lo = ok_lo ? delta[row_off + r_lo] : 0.f;
  const float d_hi = ok_hi ? delta[row_off + r_hi] : 0.f;
  const bool warp_live = __any_sync(kFull, ok_lo || ok_hi);
  const int warp_last = min(T - 1, wq0 + 15);
  __syncthreads();  // kbits

  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kvh * D;
  auto next_tile = [&](int kt) {
    while (kt <= last_kt && kbits[kt] == 0ull) ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int stage) {
    const u64 bits = kbits[kt];
    bf16* kd = ks + stage * kKTile * DP;
    bf16* vd = vs + stage * kKTile * DP;
    for (int i = tid; i < kKTile * CH; i += kThreads) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const bool ok = (bits >> r) & 1ull;
      const size_t off = kv_off + (size_t)(kt * kKTile + r) * kv_stride + c;
      cp_async16(kd + r * DP + c, ok ? k + off : k, ok ? 16 : 0);
      cp_async16(vd + r * DP + c, ok ? v + off : v, ok ? 16 : 0);
    }
  };

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  const bf16* qa = qs + warp * 16 * DP + a_off(lane, DP);
  const bf16* da = dos + warp * 16 * DP + a_off(lane, DP);

  int kt = next_tile(0);
  if (kt <= last_kt) load_kv(kt, 0);
  cp_async_commit();
  for (int stage = 0; kt <= last_kt; stage ^= 1) {
    const int kn = next_tile(kt + 1);
    cp_async_wait_all();
    __syncthreads();
    if (kn <= last_kt) load_kv(kn, stage ^ 1);
    cp_async_commit();
    const int key0 = kt * kKTile;
    if (warp_live && key0 <= warp_last) {  // warp-uniform
      const u64 bits = kbits[kt];
      const bf16* kst = ks + stage * kKTile * DP;
      const bf16* vst = vs + stage * kKTile * DP;
      // S [16 rows, 64 keys] = Q_w K^T
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qa + kk * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kst + b_off(lane, DP) + np * 16 * DP + kk * 16);
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kc = n * 8 + t4 * 2 + j;
          const bool kok = (bits >> kc) & 1ull;
          s[n][j] = (ok_lo && kok && key0 + kc <= r_lo) ? exp2f(s[n][j] * scale_log2 - l2_lo) : 0.f;
          s[n][2 + j] =
              (ok_hi && kok && key0 + kc <= r_hi) ? exp2f(s[n][2 + j] * scale_log2 - l2_hi) : 0.f;
        }
      }
      // dP [16 rows, 64 keys] = dO_w V^T
      float dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, da + kk * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bv[4];
          ldmatrix_x4(bv, vst + b_off(lane, DP) + np * 16 * DP + kk * 16);
          mma_bf16(dp[2 * np], a, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], a, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] *= dp[n][0] - d_lo;
        s[n][1] *= dp[n][1] - d_lo;
        s[n][2] *= dp[n][2] - d_hi;
        s[n][3] *= dp[n][3] - d_hi;
      }
      // dQ += dS K
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, kst + bt_off(lane, DP) + kc * 16 * DP + np * 16);
          mma_bf16(dqa[2 * np], pa, bk[0], bk[1]);
          mma_bf16(dqa[2 * np + 1], pa, bk[2], bk[3]);
        }
      }
    }
    kt = kn;
  }
  cp_async_wait_all();

  bf16* dqb = dq + q_off;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r_lo < T)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r_lo * q_stride + c) =
          ok_lo ? pack_f32(dqa[n][0] * scale, dqa[n][1] * scale) : 0u;
    if (r_hi < T)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r_hi * q_stride + c) =
          ok_hi ? pack_f32(dqa[n][2] * scale, dqa[n][3] * scale) : 0u;
  }
}

// ------------------------------------------------------------- f32 kernels
// dk, dv: a block per (32 keys, kv head, batch); four lanes per key
template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mask,
    float* __restrict__ dk, float* __restrict__ dv, int T, int Hq, int Hkv, float scale,
    float scale_log2) {
  constexpr int DL = D / 4;  // dims per lane: d = 4 i + part
  __shared__ float qs[kF32Rows][D];
  __shared__ float dos[kF32Rows][D];
  __shared__ float ls[kF32Rows], dl[kF32Rows];
  __shared__ unsigned tile_valid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, part = tid & 3;
  const int k0 = blockIdx.x * kF32Rows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int s = k0 + (tid >> 2);  // this thread's key
  const unsigned char* mb = mask + (size_t)b * T;
  const bool kok = s < T && mb[s];
  const int warp_first = k0 + warp * 8;  // the warp's 8 keys
  const size_t kv_stride = (size_t)Hkv * D, q_stride = (size_t)Hq * D;
  const size_t kv_row = ((size_t)b * T + (kok ? s : 0)) * kv_stride + (size_t)kvh * D;

  float kr[DL], vr[DL], dka[DL], dva[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    kr[i] = kok ? k[kv_row + 4 * i + part] : 0.f;  // a masked key's row is not read
    vr[i] = kok ? v[kv_row + 4 * i + part] : 0.f;
    dka[i] = dva[i] = 0.f;
  }
  const bool live = __syncthreads_or(kok);
  const int n_qt = (T + kF32Rows - 1) / kF32Rows;
  for (int hi = 0; live && hi < G; ++hi) {
    const int h = kvh * G + hi;
    for (int qt = k0 / kF32Rows; qt < n_qt; ++qt) {
      const int q0 = qt * kF32Rows;
      __syncthreads();  // the previous tile's reads are done
      if (warp == 0) {
        const bool ok = q0 + lane < T && mb[q0 + lane];
        const unsigned bits = __ballot_sync(kFull, ok);
        if (lane == 0) tile_valid = bits;
        const size_t off = ((size_t)b * Hq + h) * T + q0 + lane;
        ls[lane] = ok ? lse[off] * kLog2e : 0.f;
        dl[lane] = ok ? delta[off] : 0.f;
      }
      for (int i = tid; i < kF32Rows * D; i += kF32Threads) {
        const int r = i / D, c = i - r * D;
        const int t = q0 + r;
        const bool ok = t < T && mb[t];  // a pad row is not read
        const size_t off = ((size_t)b * T + t) * q_stride + (size_t)h * D + c;
        qs[r][c] = ok ? q[off] : 0.f;
        dos[r][c] = ok ? dout[off] : 0.f;
      }
      __syncthreads();
      const unsigned bits = tile_valid;
      for (int j = 0; j < kF32Rows; ++j) {
        const int t = q0 + j;
        if (!((bits >> j) & 1u)) continue;  // block-uniform: pad row
        if (t < warp_first) continue;       // warp-uniform: above the warp's diagonal
        float dot = 0.f, dpv = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          dot = fmaf(qs[j][4 * i + part], kr[i], dot);
          dpv = fmaf(dos[j][4 * i + part], vr[i], dpv);
        }
        dot += __shfl_xor_sync(kFull, dot, 1);
        dot += __shfl_xor_sync(kFull, dot, 2);
        dpv += __shfl_xor_sync(kFull, dpv, 1);
        dpv += __shfl_xor_sync(kFull, dpv, 2);
        if (kok && s <= t) {
          const float p = exp2f(dot * scale_log2 - ls[j]);
          const float ds = p * (dpv - dl[j]);
#pragma unroll
          for (int i = 0; i < DL; ++i) {
            dva[i] = fmaf(p, dos[j][4 * i + part], dva[i]);
            dka[i] = fmaf(ds, qs[j][4 * i + part], dka[i]);
          }
        }
      }
    }
  }
  if (s < T) {
    const size_t row = ((size_t)b * T + s) * kv_stride + (size_t)kvh * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      dk[row + 4 * i + part] = kok ? dka[i] * scale : 0.f;
      dv[row + 4 * i + part] = kok ? dva[i] : 0.f;
    }
  }
}

// dq: a block per (32 query rows, query head, batch); four lanes per row
template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const unsigned char* __restrict__ mask,
    float* __restrict__ dq, int T, int Hq, int Hkv, float scale, float scale_log2) {
  constexpr int DL = D / 4;
  __shared__ float ks[kF32Rows][D];
  __shared__ float vs[kF32Rows][D];
  __shared__ unsigned tile_valid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, part = tid & 3;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int t = row0 + (tid >> 2);
  const unsigned char* mb = mask + (size_t)b * T;
  const bool ok = t < T && mb[t];
  const int warp_last = min(T - 1, row0 + warp * 8 + 7);
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t q_row = ((size_t)b * T + (ok ? t : 0)) * q_stride + (size_t)h * D;
  const size_t stat = ((size_t)b * Hq + h) * T + (ok ? t : 0);
  const float l2 = ok ? lse[stat] * kLog2e : 0.f;
  const float dlt = ok ? delta[stat] : 0.f;

  float qr[DL], dor[DL], dqa[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qr[i] = ok ? q[q_row + 4 * i + part] : 0.f;  // a pad row is not read
    dor[i] = ok ? dout[q_row + 4 * i + part] : 0.f;
    dqa[i] = 0.f;
  }
  const int last_kt = __syncthreads_or(ok) ? (min(T, row0 + kF32Rows) - 1) / kF32Rows : -1;
  const float* kb = k + (size_t)b * T * kv_stride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * T * kv_stride + (size_t)kvh * D;
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int key0 = kt * kF32Rows;
    __syncthreads();  // the previous tile's reads are done
    if (warp == 0) {
      const unsigned bits = __ballot_sync(kFull, key0 + lane < T && mb[key0 + lane]);
      if (lane == 0) tile_valid = bits;
    }
    for (int i = tid; i < kF32Rows * D; i += kF32Threads) {
      const int r = i / D, c = i - r * D;
      const int s = key0 + r;
      const bool kv_ok = s < T && mb[s];  // a masked key's row is not read
      ks[r][c] = kv_ok ? kb[(size_t)s * kv_stride + c] : 0.f;
      vs[r][c] = kv_ok ? vb[(size_t)s * kv_stride + c] : 0.f;
    }
    __syncthreads();
    const unsigned bits = tile_valid;
    for (int j = 0; j < kF32Rows; ++j) {
      if (key0 + j > warp_last) break;    // warp-uniform: past the warp's diagonal
      if (!((bits >> j) & 1u)) continue;  // block-uniform: masked key
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        dot = fmaf(qr[i], ks[j][4 * i + part], dot);
        dpv = fmaf(dor[i], vs[j][4 * i + part], dpv);
      }
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      dpv += __shfl_xor_sync(kFull, dpv, 1);
      dpv += __shfl_xor_sync(kFull, dpv, 2);
      if (ok && key0 + j <= t) {
        const float ds = exp2f(dot * scale_log2 - l2) * (dpv - dlt);
#pragma unroll
        for (int i = 0; i < DL; ++i) dqa[i] = fmaf(ds, ks[j][4 * i + part], dqa[i]);
      }
    }
  }
  if (t < T) {
    float* out = dq + ((size_t)b * T + t) * q_stride + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) out[4 * i + part] = ok ? dqa[i] * scale : 0.f;
  }
}

int set_smem(const void* fn, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, const unsigned char* mask, void* dq, void* dk, void* dv,
                int B, int T, int Hq, int Hkv, float scale, float sl2, cudaStream_t st) {
  const int n_qt = (T + kQTile - 1) / kQTile, n_kt = (T + kKTile - 1) / kKTile;
  const size_t smem_kv = sizeof(bf16) * (D + 8) * (size_t)(2 * kKeyTile + 4 * kQTile) +
                         sizeof(float) * 4 * kQTile + sizeof(unsigned) * n_qt;
  const size_t smem_q = sizeof(bf16) * (D + 8) * (size_t)(2 * kQRows + 4 * kKTile) +
                        sizeof(u64) * n_kt;
  int err;
  if ((err = set_smem((const void*)flash_bwd_dkv_kernel<D>, smem_kv)) != 0) return err;
  if ((err = set_smem((const void*)flash_bwd_dq_kernel<D>, smem_q)) != 0) return err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  const dim3 grid_kv((T + kKeyTile - 1) / kKeyTile, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid_kv, kThreads, smem_kv, st>>>(
      qb, kb, vb, db, lse, delta, mask, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq,
      Hkv, scale, sl2);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 grid_q((T + kQRows - 1) / kQRows, Hq, B);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem_q, st>>>(
      qb, kb, vb, db, lse, delta, mask, static_cast<bf16*>(dq), T, Hq, Hkv, scale, sl2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const unsigned char* mask, void* dq, void* dk, void* dv,
               int B, int T, int Hq, int Hkv, float scale, float sl2, cudaStream_t st) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  const int tiles = (T + kF32Rows - 1) / kF32Rows;
  flash_bwd_dkv_f32_kernel<D><<<dim3(tiles, Hkv, B), kF32Threads, 0, st>>>(
      qf, kf, vf, df, lse, delta, mask, static_cast<float*>(dk), static_cast<float*>(dv), T, Hq,
      Hkv, scale, sl2);
  int err;
  if ((err = (int)cudaGetLastError()) != 0) return err;
  flash_bwd_dq_f32_kernel<D><<<dim3(tiles, Hq, B), kF32Threads, 0, st>>>(
      qf, kf, vf, df, lse, delta, mask, static_cast<float*>(dq), T, Hq, Hkv, scale, sl2);
  return (int)cudaGetLastError();
}

}  // namespace

// q/dq [B,T,Hq,D], k/v/dk/dv [B,T,Hkv,D], o/dout [B,T,Hq,D] in one dtype
// (0 bf16, 1 f32); lse (the forward's) and delta (scratch, written here)
// f32 [B,Hq,T]; mask [B,T] bool. Launches delta, dkv and dq on `stream`.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const float* lse,
                                     const unsigned char* mask, float* delta, void* dq, void* dk,
                                     void* dv, int B, int T, int Hq, int Hkv, int D, float scale,
                                     int dtype, void* stream) {
  if (Hkv < 1 || Hq < 1 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (B < 1 || T < 1) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const float sl2 = scale * kLog2e;
  const long long rows = (long long)B * T * Hq;
  const long long blocks = (rows + 31) / 32;  // 32 rows of 8 threads per block
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (dtype)
    flash_bwd_delta_kernel<float><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), mask, delta, B, T, Hq, D);
  else
    flash_bwd_delta_kernel<bf16><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), mask, delta, B, T, Hq, D);
  int err;
  if ((err = (int)cudaGetLastError()) != 0) return err;
#define PROSIM_FLASH_BWD_CASE(DD)                                                           \
  case DD:                                                                                  \
    return dtype ? launch_f32<DD>(q, k, v, dout, lse, delta, mask, dq, dk, dv, B, T, Hq, Hkv, \
                                  scale, sl2, st)                                           \
                 : launch_bf16<DD>(q, k, v, dout, lse, delta, mask, dq, dk, dv, B, T, Hq, Hkv, \
                                   scale, sl2, st);
  switch (D) {
    PROSIM_FLASH_BWD_CASE(16)
    PROSIM_FLASH_BWD_CASE(32)
    PROSIM_FLASH_BWD_CASE(48)
    PROSIM_FLASH_BWD_CASE(64)
    PROSIM_FLASH_BWD_CASE(80)
    PROSIM_FLASH_BWD_CASE(96)
    PROSIM_FLASH_BWD_CASE(112)
    PROSIM_FLASH_BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROSIM_FLASH_BWD_CASE
}
