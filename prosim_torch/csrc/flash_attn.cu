// Causal flash attention with a key-padding mask for Hopper (sm_90a).
//
// Replaces the library Pallas flash-attention kernel that
// prosim_tpu/models/llm/llama.py:_causal_attention calls on a TPU (key
// padding as segment ids). For batch b, query head h and query row t:
//   out[t, h] = sum_s softmax_s(q[t, h] . k[s, g] * scale) v[s, g]
// over the keys s <= t with mask[s], g = h / (Hq / Hkv) (grouped-query
// attention without repeating k/v). Pad query rows (mask[t] false) and rows
// with no valid key get zeros; masked keys are skipped by selection (never
// weighted by p = 0), so a non-finite value in a pad row cannot reach a
// valid row. No atomics: results are bitwise reproducible. Rows are
// [B, T, H, D], D a multiple of 16 up to 128, any T. Given an `lse` pointer
// (training; csrc/flash_attn_bwd.cu reads it) it also writes each row's
// natural-log log-sum-exp of its scaled scores, f32 [B, Hq, T], -inf on pad
// rows; with a null pointer (eval) the kernel runs its instantiation
// without those stores (kLse false), so the eval path issues none.
// Two instantiations by dtype:
//
// bf16 (flash_attn_kernel; the Llama3-8B text path). Bound on the H100: the
// work depends on the mask. It writes every output row and reads q of the
// valid rows and k/v of the valid keys (once each); its products cover the
// valid (query, key) pairs at or below the diagonal. At the Llama3-8B text
// shape (B 16, T 384, Hq 32, Hkv 8, D 128) the bytes outweigh the products
// at 3.35 TB/s against the 989 TFLOP/s bf16 tensor peak for any mask, so the
// kernel is bound by device-memory bytes. Design:
//   - one block of 8 warps serves HB query heads that share one k/v head
//     (HB = Hq/Hkv when that is at most 8, else its largest divisor up to 8)
//     for a tile of 16 * (8 / HB) query rows: each warp owns 16 rows of one
//     head, and every staged k/v tile serves all HB heads of the group;
//   - q rows of the tile (zero-filled for pad rows, which are not read) and
//     the k/v tiles of 64 keys go to shared memory by cp.async.cg; k/v use a
//     ring of two stages, so the next tile's copy overlaps this tile's
//     products. A masked key's row is zero-filled without being read (a
//     source size of 0), and a key tile with no valid key, or past the
//     block's causal diagonal, starts no copy and is not visited;
//   - q, k and v fragments are read with ldmatrix (.trans for v); q.k^T and
//     p.v run as mma.sync m16n8k16 bf16 with f32 accumulation. wgmma needs
//     64-row warpgroup tiles of one head, which for Hq/Hkv = 4 would mean a
//     query tile of 64 rows x 4 heads and 4x the diagonal waste at T = 384;
//     mma.sync keeps 16-row warps over 4 heads of a 32-row tile;
//   - an online softmax in the log2 domain, f32 statistics, per warp;
//   - persistent blocks (as many as fit on the card at once) walk the
//     (query tile, head block, batch) items, heaviest query tiles (the last
//     rows see the most keys) first; an item whose rows are all pads only
//     writes zeros, in 16-byte stores, so a mostly padded batch (the
//     rollout's text: ~37 of 384 tokens) costs little more than its output.
//
// f32 (flash_attn_f32_kernel; LlamaConfig.tiny(), what
// configs/waymo_demo.yaml resolves to without weights). f32 q/k/v/out, the
// products on the CUDA cores with FMA (TF32 keeps about three decimal digits;
// this path is held to the f32 plain version within 1e-5). One block of 4
// warps per (32 query rows, head, batch); four lanes share a query row, each
// holding D/4 of its q and output dims (dims interleaved: conflict-free
// shared reads), and the dot product is summed over the four by two shuffles.
// Key tiles of 32 are staged in shared memory with masked keys written as
// zeros without being read. Bound: f32 operations at 67 TFLOP/s against the
// f32 bytes; at tiny()'s D = 16 neither is near the time, which is latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 8;  // warps per block, bf16 path
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;    // keys per k/v tile
constexpr int kStages = 2;   // k/v ring
constexpr int kMinBlocks = 2;  // blocks per SM the register budget is set for
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.6931471805599453f;

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

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const unsigned char* __restrict__ mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int B, int T, int Hq, int Hkv,
    int HB, int WPH, float scale_log2) {
  constexpr int DP = D + 8;  // 16 bytes of row padding: ldmatrix rows hit distinct banks
  constexpr int KD = D / 16;  // k-steps of q.k^T
  constexpr int ND = D / 8;   // n-tiles of p.v
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  const int nwarps = HB * WPH;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [nwarps * 16][DP]
  __nv_bfloat16* ks = qs + nwarps * 16 * DP;                   // [kStages][kKeys][DP]
  __nv_bfloat16* vs = ks + kStages * kKeys * DP;               // [kStages][kKeys][DP]
  u64* tile_bits = reinterpret_cast<u64*>(vs + kStages * kKeys * DP);  // [key tiles]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row (and key column group)
  const int t4 = lane & 3;
  const int R = 16 * WPH;  // query rows per block
  const int n_hb = Hq / HB;
  const int n_tiles = (T + R - 1) / R;
  const int n_items = n_tiles * n_hb * B;
  const int kvg = Hq / Hkv;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;

  // persistent blocks walk the (query tile, head block, batch) items, the
  // last query tiles (the heaviest: they see the most keys) first
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row0 = (n_tiles - 1 - item / (n_hb * B)) * R;
    const int h0 = (item % n_hb) * HB;
    const int b = (item / n_hb) % B;
    const int h = h0 + warp / WPH;
    const int kvh = h0 / kvg;
    const int wrow = row0 + (warp % WPH) * 16;  // the warp's first row
    const unsigned char* mb = mask + (size_t)b * T;
    __syncthreads();  // the previous item's shared-memory reads are done

    const int r_lo = wrow + g;  // the two query rows of this thread
    const int r_hi = r_lo + 8;
    const bool ok_lo = r_lo < T && mb[r_lo];
    const bool ok_hi = r_hi < T && mb[r_hi];
    const bool warp_live = __any_sync(kFull, ok_lo || ok_hi);
    const int warp_last = min(T - 1, wrow + 15);
    if (!__syncthreads_or(ok_lo || ok_hi)) {
      // a tile of pad rows reads nothing: its rows x HB heads are zeros, in
      // 16-byte stores (the heads of one row are contiguous)
      const int rows = min(T, row0 + R) - row0, chunks = HB * D / 8;
      for (int i = tid; i < rows * chunks; i += blockDim.x) {
        const int r = i / chunks, c = (i - r * chunks) * 8;
        __nv_bfloat16* dst = out + ((size_t)b * T + row0 + r) * q_stride + (size_t)h0 * D + c;
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      if (kLse)
        for (int i = tid; i < rows * HB; i += blockDim.x)
          lse[((size_t)b * Hq + h0 + i / rows) * T + row0 + i % rows] = -INFINITY;
      continue;
    }
    const int last_kt = (min(T, row0 + R) - 1) / kKeys;
    for (int kt = warp; kt <= last_kt; kt += nwarps) {  // which keys of each tile are valid
      const int s0 = kt * kKeys + lane, s1 = s0 + 32;
      const unsigned lo = __ballot_sync(kFull, s0 < T && mb[s0]);
      const unsigned hi = __ballot_sync(kFull, s1 < T && mb[s1]);
      if (lane == 0) tile_bits[kt] = (u64)lo | ((u64)hi << 32);
    }
    for (int i = tid; i < nwarps * 16 * CH; i += blockDim.x) {  // q rows, pads as zeros
      const int rr = i / CH, c = (i - rr * CH) * 8;
      const int w = rr >> 4;
      const int t = row0 + (w % WPH) * 16 + (rr & 15);
      const bool ok = t < T && mb[t];
      const size_t off = ((size_t)b * T + t) * q_stride + (size_t)(h0 + w / WPH) * D + c;
      cp_async16(qs + rr * DP + c, ok ? q + off : q, ok ? 16 : 0);
    }
    cp_async_commit();
    __syncthreads();  // tile_bits

    const __nv_bfloat16* kb = k + (size_t)b * T * kv_stride + (size_t)kvh * D;
    const __nv_bfloat16* vb = v + (size_t)b * T * kv_stride + (size_t)kvh * D;
    auto next_tile = [&](int kt) {
      while (kt <= last_kt && tile_bits[kt] == 0ull) ++kt;
      return kt;
    };
    auto load_kv = [&](int kt, int stage) {
      const u64 bits = tile_bits[kt];
      __nv_bfloat16* kd = ks + stage * kKeys * DP;
      __nv_bfloat16* vd = vs + stage * kKeys * DP;
      for (int i = tid; i < kKeys * CH; i += blockDim.x) {
        const int r = i / CH, c = (i - r * CH) * 8;
        const bool ok = (bits >> r) & 1ull;
        const size_t off = (size_t)(kt * kKeys + r) * kv_stride + c;
        cp_async16(kd + r * DP + c, ok ? kb + off : kb, ok ? 16 : 0);
        cp_async16(vd + r * DP + c, ok ? vb + off : vb, ok ? 16 : 0);
      }
    };

    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running max (log2 domain)
    float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the running sum
    const __nv_bfloat16* qw = qs + (warp * 16 + (lane & 15)) * DP + (lane >> 4) * 8;

    int kt = next_tile(0);
    if (kt <= last_kt) load_kv(kt, 0);
    cp_async_commit();
    for (int stage = 0; kt <= last_kt; stage ^= 1) {
      const int kn = next_tile(kt + 1);
      cp_async_wait_all();  // this thread's copies of tile kt (and of q)
      __syncthreads();      // everyone's; and every warp is done with the other stage
      if (kn <= last_kt) load_kv(kn, stage ^ 1);
      cp_async_commit();
      const int key0 = kt * kKeys;
      if (warp_live && key0 <= warp_last) {  // warp-uniform
        const u64 bits = tile_bits[kt];
        const __nv_bfloat16* kst = ks + stage * kKeys * DP;
        const __nv_bfloat16* vst = vs + stage * kKeys * DP;
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        // k fragments: matrix lane/8 = (keys +0/+8) x (dims +0/+8)
        const __nv_bfloat16* kl =
            kst + (((lane >> 4) << 3) + (lane & 7)) * DP + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, qw + kk * 16);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bk[4];
            ldmatrix_x4(bk, kl + np * 16 * DP + kk * 16);
            mma_bf16(s[2 * np], a, bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
          }
        }

        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kc = n * 8 + t4 * 2 + j;
            const bool key_ok = (bits >> kc) & 1ull;
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

        // v fragments (transposed): matrix lane/8 = (keys +0/+8) x (dims +0/+8)
        const __nv_bfloat16* vl = vst + (((lane >> 3) & 1) * 8 + (lane & 7)) * DP + (lane >> 4) * 8;
#pragma unroll
        for (int kc = 0; kc < kKeys / 16; ++kc) {  // 16 keys per mma
          const uint32_t pa[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                                  pack_f32(s[2 * kc][2], s[2 * kc][3]),
                                  pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                  pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
          for (int np = 0; np < ND / 2; ++np) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vl + kc * 16 * DP + np * 16);
            mma_bf16(o[2 * np], pa, bv[0], bv[1]);
            mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
          }
        }
      }
      kt = kn;
    }

#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      l_lo += __shfl_xor_sync(kFull, l_lo, w);
      l_hi += __shfl_xor_sync(kFull, l_hi, w);
    }
    const bool w_lo = ok_lo && l_lo > 0.f, w_hi = ok_hi && l_hi > 0.f;
    const float inv_lo = w_lo ? 1.f / l_lo : 0.f, inv_hi = w_hi ? 1.f / l_hi : 0.f;
    if (kLse && t4 == 0) {  // ln(sum exp(s)) = ln 2 (m + log2 l), m in the log2 domain
      float* lb = lse + ((size_t)b * Hq + h) * T;
      if (r_lo < T) lb[r_lo] = w_lo ? (m_lo + log2f(l_lo)) * kLn2 : -INFINITY;
      if (r_hi < T) lb[r_hi] = w_hi ? (m_hi + log2f(l_hi)) * kLn2 : -INFINITY;
    }
    __nv_bfloat16* ob = out + (size_t)b * T * q_stride + (size_t)h * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + t4 * 2;
      if (r_lo < T)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r_lo * q_stride + c) =
            w_lo ? pack_f32(o[n][0] * inv_lo, o[n][1] * inv_lo) : 0u;
      if (r_hi < T)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r_hi * q_stride + c) =
            w_hi ? pack_f32(o[n][2] * inv_hi, o[n][3] * inv_hi) : 0u;
    }
  }  // items
}

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, const unsigned char* mask, void* out,
           float* lse, int B, int T, int Hq, int Hkv, float scale_log2, cudaStream_t stream) {
  const int G = Hq / Hkv;
  int HB = G < kWarps ? G : kWarps;  // heads per block: a divisor of G
  while (G % HB) --HB;
  const int WPH = kWarps / HB;       // warps (16 rows each) per head
  const int threads = 32 * HB * WPH;
  const long long items = (long long)((T + 16 * WPH - 1) / (16 * WPH)) * (Hq / HB) * B;
  const size_t smem =
      sizeof(__nv_bfloat16) * (D + 8) * (size_t)(HB * WPH * 16 + 2 * kStages * kKeys) +
      sizeof(u64) * (size_t)((T + kKeys - 1) / kKeys);
  if (smem > 227 * 1024 || items > (1ll << 31) - 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<D, kLse>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, flash_attn_kernel<D, kLse>, threads, smem)) != cudaSuccess)
    return (int)err;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(items < slots ? items : slots);  // persistent blocks
  flash_attn_kernel<D, kLse><<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out), lse, B, T,
      Hq, Hkv, HB, WPH, scale_log2);
  return (int)cudaGetLastError();
}

constexpr int kF32Rows = 32;  // query rows per block, four lanes per row
constexpr int kF32Threads = 4 * kF32Rows;

template <int D, bool kLse>
__global__ void __launch_bounds__(kF32Threads) flash_attn_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned char* __restrict__ mask, float* __restrict__ out, float* __restrict__ lse,
    int T, int Hq, int Hkv, float scale_log2) {
  constexpr int DL = D / 4;  // dims per lane: d = 4 i + part
  __shared__ float ks[kF32Rows][D];
  __shared__ float vs[kF32Rows][D];
  __shared__ unsigned tile_valid;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = tid & 3;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int t = row0 + (tid >> 2);
  const unsigned char* mb = mask + (size_t)b * T;
  const bool ok = t < T && mb[t];
  const int warp_last = min(T - 1, row0 + warp * 8 + 7);  // the warp's 8 rows

  float qv[DL], o[DL];
  const float* qr = q + (((size_t)b * T + (ok ? t : 0)) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qv[i] = ok ? qr[4 * i + part] : 0.f;  // a pad row's q is not read
    o[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const int last_kt = __syncthreads_or(ok) ? (min(T, row0 + kF32Rows) - 1) / kF32Rows : -1;
  const size_t kv_stride = (size_t)Hkv * D;
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
      if (key0 + j > warp_last) break;  // warp-uniform: past the warp's diagonal
      if (!((bits >> j) & 1u)) continue;  // block-uniform: masked key
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) dot = fmaf(qv[i], ks[j][4 * i + part], dot);
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      if (ok && key0 + j <= t) {
        const float sc = dot * scale_log2;
        if (sc > m) {
          const float c = exp2f(m - sc);  // 0 on the first key
#pragma unroll
          for (int i = 0; i < DL; ++i) o[i] *= c;
          l *= c;
          m = sc;
        }
        const float p = exp2f(sc - m);
        l += p;
#pragma unroll
        for (int i = 0; i < DL; ++i) o[i] = fmaf(p, vs[j][4 * i + part], o[i]);
      }
    }
  }

  if (t < T) {
    const bool w = ok && l > 0.f;
    float* orow = out + (((size_t)b * T + t) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) orow[4 * i + part] = w ? o[i] / l : 0.f;
    if (kLse && part == 0)
      lse[((size_t)b * Hq + h) * T + t] = w ? (m + log2f(l)) * kLn2 : -INFINITY;
  }
}

template <int D, bool kLse>
int launch_f32(const void* q, const void* k, const void* v, const unsigned char* mask, void* out,
               float* lse, int B, int T, int Hq, int Hkv, float scale_log2, cudaStream_t stream) {
  const dim3 grid((T + kF32Rows - 1) / kF32Rows, Hq, B);
  flash_attn_f32_kernel<D, kLse><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), lse, T, Hq, Hkv, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 f32; lse may be null (no log-sum-exp is written)
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 const unsigned char* mask, void* out, float* lse, int B, int T,
                                 int Hq, int Hkv, int D, float scale, int dtype, void* stream) {
  if (Hkv < 1 || Hq < 1 || Hq % Hkv != 0 || B > 65535 || Hq > 65535 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (B < 1 || T < 1) return (int)cudaSuccess;
  const float sl2 = scale * 1.4426950408889634f;  // softmax in the log2 domain
  const cudaStream_t st = (cudaStream_t)stream;
#define PROSIM_FLASH_CASE(DD)                                                  \
  case DD:                                                                     \
    if (dtype)                                                                 \
      return lse ? launch_f32<DD, true>(q, k, v, mask, out, lse, B, T, Hq, Hkv, sl2, st)   \
                 : launch_f32<DD, false>(q, k, v, mask, out, lse, B, T, Hq, Hkv, sl2, st); \
    return lse ? launch<DD, true>(q, k, v, mask, out, lse, B, T, Hq, Hkv, sl2, st)         \
               : launch<DD, false>(q, k, v, mask, out, lse, B, T, Hq, Hkv, sl2, st);
  switch (D) {
    PROSIM_FLASH_CASE(16)
    PROSIM_FLASH_CASE(32)
    PROSIM_FLASH_CASE(48)
    PROSIM_FLASH_CASE(64)
    PROSIM_FLASH_CASE(80)
    PROSIM_FLASH_CASE(96)
    PROSIM_FLASH_CASE(112)
    PROSIM_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PROSIM_FLASH_CASE
}
