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
// get dk = dv = 0. A pad row is never read (its zeros are stored, not
// computed), so non-finite values there cannot reach a valid row's
// gradient. No atomics: every output element is summed in one thread in a
// fixed order, so two launches are bitwise equal.
//
// Work on valid rows only. Three kernels (flash_bwd_*), launched in this
// order by flash_attn_bwd_launch:
//   prep - lists each scene's valid positions in order (rows[b][rank] = t,
//          and the count), writes the compacted lse (log2 domain) and delta
//          of every valid (row, head), and stores the zeros of pad rows' dq
//          and masked keys' dk/dv (the delta kernel's launch before);
//   dkv  - one block per (64-rank key tile, kv head, batch): it walks the
//          query tiles at or after its keys for all Hq/Hkv query heads of
//          the group, so the group sum happens in registers;
//   dq   - one block per (64-rank query tile, query head, batch) over the
//          key tiles up to its diagonal, recomputing S and dP (a second
//          pass keeps dq free of atomics).
// Tiles are tiles of the list and rows are fetched by index. Compaction
// keeps order, so key s may be attended from query t exactly when rank(s)
// <= rank(t): the result is the uncompacted one, each output summed in a
// fixed order. Tiles past a scene's count are never visited (their blocks
// return at once), so the work scales with the valid pairs, as the bound
// does; the grids put every (head, batch)'s heaviest tile first (dkv: the
// first key tile; dq: the last query tile). The count stays on the device.
//
// Bound on the H100: the bytes (q, o, dO of valid rows, k and v of valid
// keys, their lse, and the mask read once; dq, dk, dv written whole) over
// 3.35 TB/s against the products (10 D per valid causal pair and query
// head) over the path's peak. At the Llama3-8B text shape (B 16, T 384,
// Hq 32, Hkv 8, D 128) with the tokenizer's masks it is bound by bytes, and
// a mostly padded batch (the 8B train step's: 29 valid tokens a scene) by
// the zero stores of dq, dk, dv alone.
//
// bf16 (the Llama3-8B text path; q/k/v/o/dO bf16, lse/delta f32), FA3's
// backward scheme on wgmma. A block is two warpgroups: a producer gathers
// the indexed rows with cp.async (16 bytes a thread, each stage's row
// positions loaded first, all at once) into a three-stage ring of 128-byte
// swizzled tiles and hands each stage over on an mbarrier that counts the
// copies' completion (cp.async.mbarrier.arrive.noinc); the consumer owns
// 64 rows (wgmma's M) and hands the stage back on a second mbarrier.
// setmaxnreg moves registers from the producer (56) to the consumer (200),
// which holds its f32 accumulators (dkv: dK and dV, 2 x 64 a thread at
// D = 128; dq: dQ) without spilling; two blocks fit an SM. dkv: S^T = K Q^T
// and dP^T = V dO^T by wgmma from shared memory (m64n32k16, 32-row query
// stages), P^T and dS^T formed in registers, rounded to bf16 as the forward
// rounds P and used as the register A operand of dV += P^T dO and dK +=
// dS^T Q (m64nDk16, dO and Q read MN-major). dq: S = Q K^T and dP = dO V^T
// over 32-key stages, dQ += dS K. A head width other than 64 or 128 is
// zero-padded to the next of the two in shared memory; the padding is
// zeroed once and never copied over.
//
// f32 (LlamaConfig.tiny(), the shipped demo configuration): FMA on the CUDA
// cores (no TF32: it is held to 1e-5 of each tensor's largest value) in
// register-blocked tiles, below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBKeys = 64;  // bf16 dkv: keys per block (the consumer warpgroup's M)
constexpr int kBQ = 32;     // bf16 dkv: query rows per ring stage
constexpr int kBRows = 64;  // bf16 dq: query rows per block (M)
constexpr int kBK = 32;     // bf16 dq: keys per ring stage
// Tuned constants; scripts/flash_bwd_variants.py sets others with -D.
#ifndef FLASH_BWD_RING
#define FLASH_BWD_RING 3
#endif
#ifndef FLASH_BWD_PRODUCER_REGS
#define FLASH_BWD_PRODUCER_REGS 56
#endif
#ifndef FLASH_BWD_PREP_HEADS
#define FLASH_BWD_PREP_HEADS 4
#endif
constexpr int kRing = FLASH_BWD_RING;  // bf16: ring stages
constexpr int kWgThreads = 128;
constexpr int kBlockThreads = 2 * kWgThreads;  // a producer and a consumer warpgroup
// registers a thread after setmaxnreg (2 blocks of 256 threads at 128 each)
constexpr int kProducerRegs = FLASH_BWD_PRODUCER_REGS, kConsumerRegs = 256 - kProducerRegs;
constexpr int kRowThreads = 16;  // producer threads per gathered row: one 16-byte chunk each
constexpr int kRowsPerPass = kWgThreads / kRowThreads;
constexpr int kStatPad = 64;  // ranks a row of the compacted statistics is padded to a multiple of
constexpr int kF32Rows = 32;     // f32: ranks per tile
constexpr int kF32Team = 64;     // f32: threads of a team (one query head at a time)
constexpr int kF32MaxTeams = 4;  // f32 dkv: teams per block
constexpr int kPrepRows = 32;     // prep: positions per block
constexpr int kPrepHeads = FLASH_BWD_PREP_HEADS;  // prep: query heads per block
constexpr int kPrepThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------- prep
// 16 bytes of o and dO: their products summed onto acc, in order
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, float acc, float) {
  acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, float acc, bf16) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// One block per (kPrepRows positions, kPrepHeads query heads, batch). Each
// valid position t of scene b gets its rank (the number of valid positions
// before it): rows[b][rank] = t, counts[b] = the scene's valid count. For a
// valid (t, h): lse_c[b][h][rank] = lse[b][h][t] log2(e) and delta_c[b][h][rank]
// = dO[t, h] . o[t, h] in f32, eight threads per row. For a pad t: zeros in
// dq[t, h] and in dk[t, g], dv[t, g] for the block's share of the kv heads
// g (its o and dO are not read). rows past a scene's count are not written
// and never read.
template <typename T_>
__global__ void __launch_bounds__(kPrepThreads) flash_bwd_prep_kernel(
    const T_* __restrict__ o, const T_* __restrict__ dout, const float* __restrict__ lse,
    const unsigned char* __restrict__ mask, int* __restrict__ rows, int* __restrict__ counts,
    float* __restrict__ lse_c, float* __restrict__ delta_c, T_* __restrict__ dq,
    T_* __restrict__ dk, T_* __restrict__ dv, int T, int Tp, int Hq, int Hkv, int D) {
  __shared__ int rank_s[kPrepRows];
  const int tid = threadIdx.x, lane = tid & 31;
  const int t0 = blockIdx.x * kPrepRows, h0 = blockIdx.y * kPrepHeads, b = blockIdx.z;
  const unsigned char* mb = mask + (size_t)b * T;
  int before = 0;  // valid positions before this block's
  for (int i = 0; i < t0; i += kPrepThreads)
    before += __syncthreads_count(i + tid < t0 && mb[i + tid]);
  if (tid < 32) {
    const int t = t0 + lane;
    const bool ok = t < T && mb[t];
    const unsigned bits = __ballot_sync(kFull, ok);
    const int rank = before + __popc(bits & ((1u << lane) - 1u));
    rank_s[lane] = ok ? rank : -1;
    if (blockIdx.y == 0) {
      if (ok) rows[(size_t)b * T + rank] = t;
      if (lane == 0 && t0 + kPrepRows >= T) counts[b] = before + __popc(bits);
    }
  }
  __syncthreads();
  constexpr int V = 16 / sizeof(T_);  // values per 16 bytes
  const int CH = D / V, part = tid & 7;
  const int nh = min(kPrepHeads, Hq - h0);
  // the kv heads whose dk/dv zeros this block stores, as evenly as the
  // blocks of a position go
  const int kv_share = (Hkv + gridDim.y - 1) / gridDim.y;
  const int kh0 = blockIdx.y * kv_share, nkh = max(0, min(kv_share, Hkv - kh0));
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // (position, head) rows, the head fastest (memory order); every group of
  // eight runs the same number of iterations (kPrepRows * nh of them)
  for (int p = tid >> 3; p < kPrepRows * nh; p += kPrepThreads / 8) {
    const int r = p / nh, h = h0 + p - r * nh, t = t0 + r;
    const int rank = rank_s[r];
    const size_t row = ((size_t)b * T + t) * Hq + h;
    float acc = 0.f;
    if (rank >= 0) {
      const uint4* ov = reinterpret_cast<const uint4*>(o + row * D);
      const uint4* dv4 = reinterpret_cast<const uint4*>(dout + row * D);
      for (int c = part; c < CH; c += 8) acc = dot16(ov[c], dv4[c], acc, T_());
    } else if (t < T) {
      uint4* z = reinterpret_cast<uint4*>(dq + row * D);
      for (int c = part; c < CH; c += 8) z[c] = zero;
    }
    acc += __shfl_xor_sync(kFull, acc, 1);
    acc += __shfl_xor_sync(kFull, acc, 2);
    acc += __shfl_xor_sync(kFull, acc, 4);
    if (rank >= 0 && part == 0) {
      const size_t bh = (size_t)b * Hq + h;
      delta_c[bh * Tp + rank] = acc;
      lse_c[bh * Tp + rank] = lse[bh * T + t] * kLog2e;
    }
  }
  // the pad positions' dk/dv zeros for the block's share of the kv heads
  // (a loop of its own: the share does not depend on the query heads)
  for (int p = tid >> 3; p < kPrepRows * nkh; p += kPrepThreads / 8) {
    const int r = p / nkh, t = t0 + r;
    if (t >= T || rank_s[r] >= 0) continue;
    const size_t kv_row = ((size_t)b * T + t) * Hkv + kh0 + p - r * nkh;
    uint4* zk = reinterpret_cast<uint4*>(dk + kv_row * D);
    uint4* zv = reinterpret_cast<uint4*>(dv + kv_row * D);
    for (int c = part; c < CH; c += 8) zk[c] = zv[c] = zero;
  }
}

// ------------------------------------------------------- Hopper primitives
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// one arrival on the barrier once this thread's earlier cp.async copies have
// landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
// this thread's shared-memory writes made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving an accumulator across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 32] = (acc ? d : 0) + A[64 x 16] B[16 x 32], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Tiles for wgmma live in shared memory as [DP / 64][R rows][64 values],
// each row 128 bytes with the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)), 1024-byte aligned; columns D..DP-1 are zeros.
// Byte offset of 16-byte chunk c (of 8 values) of row r in such a tile:
__device__ __forceinline__ uint32_t sw_off(int r, int c, int R) {
  return (uint32_t)((c >> 3) * R * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// k-step kk (values 16 kk .. 16 kk + 15 of each row) of an R-row tile read
// K-major (rows are M or N, the values K)
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk, int R) {
  return desc_sw128(base + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024);
}
// k-step kk (rows 16 kk .. 16 kk + 15) of an R-row tile read MN-major (rows
// are K, the values N)
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk, int R) {
  return desc_sw128(base + kk * 2048, R * 128, 1024);
}
// C fragments of two adjacent 8-column blocks as one A fragment (k 16)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float* c0, const float* c1) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}
// The producer's gather of an R-row tile from the compacted ranks r0..:
// thread lt copies 16-byte chunk lt % 16 of rows lt / 16 + 8 j. Its rows'
// positions are loaded first, all at once (`rows_of`), so one load latency
// serves the tile; ranks past nv are written as zeros and read nothing.
template <int R>
struct TileRows {
  int pos[R / kRowsPerPass];  // -1 past nv
};
template <int R>
__device__ __forceinline__ TileRows<R> rows_of(const int* rb, int r0, int nv, int lt) {
  TileRows<R> t;
#pragma unroll
  for (int j = 0; j < R / kRowsPerPass; ++j) {
    const int r = r0 + lt / kRowThreads + kRowsPerPass * j;
    t.pos[j] = r < nv ? rb[r] : -1;
  }
  return t;
}
// the rows of two tensors (rank r at base + rows[r] * stride) into two tiles
// at once
template <int D, int R>
__device__ __forceinline__ void gather2(unsigned char* da, unsigned char* db, const bf16* a,
                                        const bf16* b, const TileRows<R>& t, size_t base,
                                        size_t stride, int lt) {
  const int c = lt % kRowThreads;
  if (c >= D / 8) return;
#pragma unroll
  for (int j = 0; j < R / kRowsPerPass; ++j) {
    const int r = lt / kRowThreads + kRowsPerPass * j;
    const bool ok = t.pos[j] >= 0;
    const size_t off = base + (size_t)(ok ? t.pos[j] : 0) * stride + c * 8;
    cp_async16(da + sw_off(r, c, R), a + off, ok ? 16 : 0);
    cp_async16(db + sw_off(r, c, R), b + off, ok ? 16 : 0);
  }
}

// zeros in the padding columns D..DP-1 of `rows` rows of a tile (once: the
// copies never write them)
template <int D, int DP>
__device__ __forceinline__ void zero_pad(unsigned char* tile, int R, int tid, int nthreads) {
  constexpr int CH = D / 8, PC = DP / 8 - D / 8;
  if constexpr (PC > 0)
    for (int i = tid; i < R * PC; i += nthreads) {
      const int r = i / PC, c = CH + i - r * PC;
      *reinterpret_cast<uint4*>(tile + sw_off(r, c, R)) = make_uint4(0u, 0u, 0u, 0u);
    }
}

// ------------------------------------------------------------ dk, dv (bf16)
// One block per (64 key ranks, kv head, batch): a producer warpgroup
// gathers the rows, a consumer warpgroup owns the 64 keys (wgmma's M) and
// holds their dK and dV in registers over every (query head of the group,
// 32-row query tile at or after the keys) item.
static_assert(kBQ == 32 && kBK == 32, "the consumers' S tiles are m64n32k16 (wgmma_ss_n32)");
static_assert(kBKeys == 64 && kBRows == 64, "one consumer warpgroup is wgmma's 64 rows");
static_assert(kProducerRegs % 8 == 0 && kProducerRegs >= 24 && kConsumerRegs <= 256,
              "setmaxnreg takes a multiple of 8 in [24, 256]");

template <int D>
__global__ void __launch_bounds__(kBlockThreads, 2) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse_c,
    const float* __restrict__ delta_c, const int* __restrict__ rows,
    const int* __restrict__ counts, bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Tp,
    int Hq, int Hkv, float scale, float scale_log2) {
  constexpr int DP = D <= 64 ? 64 : 128, KS = DP / 16;
  constexpr uint32_t kTileKV = kBKeys * DP * 2, kTileQ = kBQ * DP * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* vs = ks + kTileKV;
  unsigned char* ring = vs + kTileKV;  // kRing x (q tile, dO tile)
  // kRing x (lse, delta)[kBQ]
  float* stat = reinterpret_cast<float*>(ring + kRing * 2 * kTileQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + kRing * 2 * kBQ);  // [kRing]
  uint64_t* empty = full + kRing;                                        // [kRing]

  const int tid = threadIdx.x, lt = tid & (kWgThreads - 1);
  // key tiles of the compacted rows, the heaviest (first) tile of every
  // (head, batch) launched first
  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBKeys;
  const int nv = counts[b];
  if (k0 >= nv) return;  // past the scene's valid rows
  const int G = Hq / Hkv;
  const int qt0 = k0 / kBQ;
  const int nq = (nv + kBQ - 1) / kBQ - qt0;  // every query tile below nv holds a valid row
  const int n_items = G * nq;
  const int* rb = rows + (size_t)b * T;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + s, kWgThreads);
      mbar_init(empty + s, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_pad<D, DP>(ks, kBKeys, tid, kBlockThreads);
  zero_pad<D, DP>(vs, kBKeys, tid, kBlockThreads);
  for (int i = 0; i < 2 * kRing; ++i) zero_pad<D, DP>(ring + i * kTileQ, kBQ, tid, kBlockThreads);
  fence_async_smem();
  __syncthreads();

  if (tid < kWgThreads) {  // producer: cp.async gathers into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
    // the key tile, with the first item's stage
    gather2<D, kBKeys>(ks, vs, k, v, rows_of<kBKeys>(rb, k0, nv, lt),
                       (size_t)b * T * kv_stride + (size_t)kvh * D, kv_stride, lt);
    TileRows<kBQ> next = rows_of<kBQ>(rb, qt0 * kBQ, nv, lt);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % kRing;
      const int h = kvh * G + it / nq, q0 = (qt0 + it % nq) * kBQ;
      const TileRows<kBQ> cur = next;
      if (it + 1 < n_items) next = rows_of<kBQ>(rb, (qt0 + (it + 1) % nq) * kBQ, nv, lt);
      mbar_wait(empty + s, ((it / kRing) & 1) ^ 1);
      unsigned char* qd = ring + s * 2 * kTileQ;
      gather2<D, kBQ>(qd, qd + kTileQ, q, dout, cur, (size_t)b * T * q_stride + (size_t)h * D,
                      q_stride, lt);
      if (lt < kBQ / 2) {  // lse then delta of the tile's ranks, four a copy
        const int which = lt / (kBQ / 4), r = (lt % (kBQ / 4)) * 4;
        const size_t off = ((size_t)b * Hq + h) * Tp + q0 + r;
        cp_async16(stat + (s * 2 + which) * kBQ + r, (which ? delta_c : lse_c) + off,
                   max(0, min(16, (nv - q0 - r) * 4)));
      }
      mbar_arrive_on_copies(full + s);
    }
    cp_async_wait_all();
    return;
  }

  // consumer warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = lt >> 5, lane = lt & 31, g = lane >> 2, t4 = lane & 3;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;  // ranks of this thread's rows
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t k_base = smem_addr(ks), v_base = smem_addr(vs);
  for (int it = 0; it < n_items; ++it) {
    const int s = it % kRing;
    const int q0 = (qt0 + it % nq) * kBQ;
    mbar_wait(full + s, (it / kRing) & 1);
    fence_async_smem();  // the stage's cp.async writes, before wgmma reads them
    const uint32_t q_base = smem_addr(ring + s * 2 * kTileQ), do_base = q_base + kTileQ;
    const float* ls = stat + s * 2 * kBQ;
    const float* dl = ls + kBQ;
    // S^T [64 keys, 32 queries] = K Q^T and dP^T = V dO^T
    float st[kBQ / 2], dpt[kBQ / 2];
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss_n32(st, desc_k(k_base, kk, kBKeys), desc_k(q_base, kk, kBQ), kk > 0);
      wgmma_ss_n32(dpt, desc_k(v_base, kk, kBKeys), desc_k(do_base, kk, kBQ), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(st);
    fence_regs(dpt);
    // P^T, selected to 0 off the valid causal pairs (a key rank at most the
    // query's), and dS^T = P^T (dP^T - delta); ranks past nv were staged as
    // zeros, so dP^T and delta are finite there
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + t4 * 2 + e, t = q0 + qc;
        const bool qok = t < nv;
        const float l = ls[qc], d = dl[qc];
        const float p_lo = (qok && key_lo <= t) ? exp2f(st[4 * j + e] * scale_log2 - l) : 0.f;
        const float p_hi = (qok && key_hi <= t) ? exp2f(st[4 * j + 2 + e] * scale_log2 - l) : 0.f;
        st[4 * j + e] = p_lo;
        st[4 * j + 2 + e] = p_hi;
        dpt[4 * j + e] = p_lo * (dpt[4 * j + e] - d);
        dpt[4 * j + 2 + e] = p_hi * (dpt[4 * j + 2 + e] - d);
      }
    // dV += P^T dO, dK += dS^T Q: P^T and dS^T rounded to bf16 as the A
    // operand from registers, dO and Q read MN-major
    uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBQ / 16; ++kc) {
      c_to_a(pa[kc], st + 8 * kc, st + 8 * kc + 4);
      c_to_a(sa[kc], dpt + 8 * kc, dpt + 8 * kc + 4);
    }
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBQ / 16; ++kc) {
      wgmma_rs<DP>(dva, pa[kc], desc_mn(do_base, kc, kBQ));
      wgmma_rs<DP>(dka, sa[kc], desc_mn(q_base, kc, kBQ));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dka);
    mbar_arrive(empty + s);
  }

  // the valid keys' rows (pad keys' zeros are the prep's)
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kvh * D;
  bf16* dk_lo = dk + kv_off + (key_lo < nv ? (size_t)rb[key_lo] * kv_stride : 0);
  bf16* dv_lo = dv + kv_off + (key_lo < nv ? (size_t)rb[key_lo] * kv_stride : 0);
  bf16* dk_hi = dk + kv_off + (key_hi < nv ? (size_t)rb[key_hi] * kv_stride : 0);
  bf16* dv_hi = dv + kv_off + (key_hi < nv ? (size_t)rb[key_hi] * kv_stride : 0);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    if (key_lo < nv) {
      *reinterpret_cast<uint32_t*>(dk_lo + c) =
          pack_f32(dka[4 * j] * scale, dka[4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv_lo + c) = pack_f32(dva[4 * j], dva[4 * j + 1]);
    }
    if (key_hi < nv) {
      *reinterpret_cast<uint32_t*>(dk_hi + c) =
          pack_f32(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv_hi + c) = pack_f32(dva[4 * j + 2], dva[4 * j + 3]);
    }
  }
}

// ------------------------------------------------------------------ dq (bf16)
// One block per (64 query ranks, query head, batch): a producer warpgroup
// gathers the key tiles, a consumer warpgroup owns the 64 rows (wgmma's M)
// and walks the 32-key tiles up to its diagonal, recomputing S and dP.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, 2) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse_c,
    const float* __restrict__ delta_c, const int* __restrict__ rows,
    const int* __restrict__ counts, bf16* __restrict__ dq, int T, int Tp, int Hq, int Hkv,
    float scale, float scale_log2) {
  constexpr int DP = D <= 64 ? 64 : 128, KS = DP / 16;
  constexpr uint32_t kTileQ = kBRows * DP * 2, kTileK = kBK * DP * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* dos = qs + kTileQ;
  unsigned char* ring = dos + kTileQ;  // kRing x (k tile, v tile)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing * 2 * kTileK);  // [kRing]
  uint64_t* empty = full + kRing;                                           // [kRing]

  const int tid = threadIdx.x, lt = tid & (kWgThreads - 1);
  const int h = blockIdx.x, b = blockIdx.y;
  const int nv = counts[b];
  // query tiles of the compacted rows from the scene's last (the heaviest)
  const int qt = (nv + kBRows - 1) / kBRows - 1 - (int)blockIdx.z;
  if (qt < 0) return;
  const int q0 = qt * kBRows;
  const int n_kt = (min(nv, q0 + kBRows) + kBK - 1) / kBK;  // key tiles up to the last row
  const int kvh = h / (Hq / Hkv);
  const int* rb = rows + (size_t)b * T;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t q_off = (size_t)b * T * q_stride + (size_t)h * D;
  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + s, kWgThreads);
      mbar_init(empty + s, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_pad<D, DP>(qs, kBRows, tid, kBlockThreads);
  zero_pad<D, DP>(dos, kBRows, tid, kBlockThreads);
  for (int i = 0; i < 2 * kRing; ++i) zero_pad<D, DP>(ring + i * kTileK, kBK, tid, kBlockThreads);
  fence_async_smem();
  __syncthreads();

  if (tid < kWgThreads) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kvh * D;
    // the q and dO rows, with the first key tile's stage
    gather2<D, kBRows>(qs, dos, q, dout, rows_of<kBRows>(rb, q0, nv, lt), q_off, q_stride, lt);
    TileRows<kBK> next = rows_of<kBK>(rb, 0, nv, lt);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kRing;
      const TileRows<kBK> cur = next;
      if (kt + 1 < n_kt) next = rows_of<kBK>(rb, (kt + 1) * kBK, nv, lt);
      mbar_wait(empty + s, ((kt / kRing) & 1) ^ 1);
      unsigned char* kd = ring + s * 2 * kTileK;
      gather2<D, kBK>(kd, kd + kTileK, k, v, cur, kv_off, kv_stride, lt);
      mbar_arrive_on_copies(full + s);
    }
    cp_async_wait_all();
    return;
  }

  // consumer warpgroup
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = lt >> 5, lane = lt & 31, g = lane >> 2, t4 = lane & 3;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;  // query ranks
  const bool ok_lo = r_lo < nv, ok_hi = r_hi < nv;
  const size_t st_off = ((size_t)b * Hq + h) * Tp;
  const float l_lo = ok_lo ? lse_c[st_off + r_lo] : 0.f, l_hi = ok_hi ? lse_c[st_off + r_hi] : 0.f;
  const float d_lo = ok_lo ? delta_c[st_off + r_lo] : 0.f;
  const float d_hi = ok_hi ? delta_c[st_off + r_hi] : 0.f;
  float dqa[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
  const uint32_t q_base = smem_addr(qs), do_base = smem_addr(dos);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kRing;
    mbar_wait(full + s, (kt / kRing) & 1);
    fence_async_smem();
    const uint32_t k_base = smem_addr(ring + s * 2 * kTileK), v_base = k_base + kTileK;
    // S [64 rows, 32 keys] = Q K^T and dP = dO V^T
    float sc[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = dp[i] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss_n32(sc, desc_k(q_base, kk, kBRows), desc_k(k_base, kk, kBK), kk > 0);
      wgmma_ss_n32(dp, desc_k(do_base, kk, kBRows), desc_k(v_base, kk, kBK), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    fence_regs(dp);
    const int key0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + t4 * 2 + e;
        const float p_lo = (ok_lo && key <= r_lo) ? exp2f(sc[4 * j + e] * scale_log2 - l_lo) : 0.f;
        const float p_hi =
            (ok_hi && key <= r_hi) ? exp2f(sc[4 * j + 2 + e] * scale_log2 - l_hi) : 0.f;
        sc[4 * j + e] = p_lo * (dp[4 * j + e] - d_lo);
        sc[4 * j + 2 + e] = p_hi * (dp[4 * j + 2 + e] - d_hi);
      }
    // dQ += dS K: dS rounded to bf16 from registers, K read MN-major
    uint32_t sa[kBK / 16][4];
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) c_to_a(sa[kc], sc + 8 * kc, sc + 8 * kc + 4);
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) wgmma_rs<DP>(dqa, sa[kc], desc_mn(k_base, kc, kBK));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dqa);
    mbar_arrive(empty + s);
  }

  bf16* dq_lo = dq + q_off + (ok_lo ? (size_t)rb[r_lo] * q_stride : 0);
  bf16* dq_hi = dq + q_off + (ok_hi ? (size_t)rb[r_hi] * q_stride : 0);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + t4 * 2;
    if (ok_lo)
      *reinterpret_cast<uint32_t*>(dq_lo + c) =
          pack_f32(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
    if (ok_hi)
      *reinterpret_cast<uint32_t*>(dq_hi + c) =
          pack_f32(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
  }
}

// ------------------------------------------------------------- f32 kernels
// Register-blocked FMA tiles (as an SGEMM micro-kernel): 32-rank tiles in
// shared memory, natural layout with a row stride of D + 4 floats (the
// float4 rows read by eight threads fall in distinct banks). A team of 64
// threads forms the S^T and dP^T tile [32 keys, 32 queries] (dkv; [32
// queries, 32 keys] for dq) as 4 x 4 blocks a thread, writes P^T and dS^T
// (dS) to shared memory, and accumulates the products over the tile's
// ranks into 4 rows x D/8 dims a thread.
__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float at(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}
// rows [0, 32) of a tile from the compacted ranks r0.. (zeros past nv),
// float4 by float4, consecutive threads on consecutive rows
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, const int* rb, int r0,
                                           int nv, size_t row_stride, size_t off, int tid,
                                           int nthreads) {
  constexpr int DS = D + 4;
  for (int i = tid; i < kF32Rows * (D / 4); i += nthreads) {
    const int r = i % kF32Rows, c = (i / kF32Rows) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < nv) x = *reinterpret_cast<const float4*>(src + off + rb[r0 + r] * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * DS + c) = x;
  }
}
// s[a][c] (+)= A row 4 ia + a . B row 4 ib + c over D, both [32][D + 4]
template <int D>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A, const float* Bt,
                                          int ia, int ib) {
  constexpr int DS = D + 4;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = *reinterpret_cast<const float4*>(A + (4 * ia + j) * DS + d);
      y[j] = *reinterpret_cast<const float4*>(Bt + (4 * ib + j) * DS + d);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dot4(x[a], y[c], s[a][c]);
  }
}

// dk, dv: one block per (32 key ranks, kv head, batch) with min(G, 4) teams;
// team t takes the group's query heads t, t + teams, ...; the teams' sums
// are added in team order through shared memory at the end
template <int D>
__global__ void __launch_bounds__(kF32Team * kF32MaxTeams) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse_c,
    const float* __restrict__ delta_c, const int* __restrict__ rows,
    const int* __restrict__ counts, float* __restrict__ dk, float* __restrict__ dv, int T,
    int Tp, int Hq, int Hkv, float scale, float scale_log2) {
  constexpr int DS = D + 4, PS = kF32Rows + 4, DG = D / 8;
  constexpr int kTeamFloats = 2 * kF32Rows * DS + 2 * kF32Rows * PS + 2 * kF32Rows;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;                // [32][DS]
  float* vs = ks + kF32Rows * DS;  // [32][DS]
  const int tid = threadIdx.x, team = tid / kF32Team, tt = tid % kF32Team;
  const int NT = blockDim.x / kF32Team;
  float* qs = vs + kF32Rows * DS + team * kTeamFloats;  // the team's [32][DS] q rows
  float* dos = qs + kF32Rows * DS;                      // [32][DS] dO rows
  float* pq = dos + kF32Rows * DS;                      // [32 queries][PS] P^T
  float* sq = pq + kF32Rows * PS;                       // [32 queries][PS] dS^T
  float* ls = sq + kF32Rows * PS;                       // [32] lse (log2)
  float* dl = ls + kF32Rows;                            // [32] delta

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kF32Rows;
  const int nv = counts[b];
  if (k0 >= nv) return;
  const int G = Hq / Hkv;
  const int* rb = rows + (size_t)b * T;
  const size_t kv_stride = (size_t)Hkv * D, q_stride = (size_t)Hq * D;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kvh * D;
  stage_rows<D>(ks, k, rb, k0, nv, kv_stride, kv_off, tid, blockDim.x);
  stage_rows<D>(vs, v, rb, k0, nv, kv_stride, kv_off, tid, blockDim.x);
  const int ki = tt / 8, qi = tt % 8;  // S^T block: keys 4 ki.., queries 4 qi..
  float dka[4][DG], dva[4][DG];        // keys 4 ki + a, dims qi + 8 i
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < DG; ++i) dka[a][i] = dva[a][i] = 0.f;
  const int n_qt = (nv + kF32Rows - 1) / kF32Rows;
  for (int rd = 0; rd * NT < G; ++rd) {
    const int hi = rd * NT + team;
    const bool active = hi < G;  // team-uniform
    const int h = kvh * G + hi;
    for (int qt = k0 / kF32Rows; qt < n_qt; ++qt) {
      const int q0 = qt * kF32Rows;
      __syncthreads();  // the last step's reads are done
      if (active) {
        const size_t q_off = (size_t)b * T * q_stride + (size_t)h * D;
        stage_rows<D>(qs, q, rb, q0, nv, q_stride, q_off, tt, kF32Team);
        stage_rows<D>(dos, dout, rb, q0, nv, q_stride, q_off, tt, kF32Team);
        if (tt < kF32Rows) {
          const bool ok = q0 + tt < nv;
          const size_t off = ((size_t)b * Hq + h) * Tp + q0 + tt;
          ls[tt] = ok ? lse_c[off] : 0.f;
          dl[tt] = ok ? delta_c[off] : 0.f;
        }
      }
      __syncthreads();
      if (active) {
        float s[4][4], dp[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
        tile_dots<D>(s, ks, qs, ki, qi);
        tile_dots<D>(dp, vs, dos, ki, qi);
        // P^T selected to 0 off the valid causal pairs; dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qc = 4 * qi + c, t = q0 + qc;
          float p[4], ds[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            p[a] = (t < nv && k0 + 4 * ki + a <= t) ? exp2f(s[a][c] * scale_log2 - ls[qc]) : 0.f;
            ds[a] = p[a] * (dp[a][c] - dl[qc]);
          }
          *reinterpret_cast<float4*>(pq + qc * PS + 4 * ki) = make_float4(p[0], p[1], p[2], p[3]);
          *reinterpret_cast<float4*>(sq + qc * PS + 4 * ki) =
              make_float4(ds[0], ds[1], ds[2], ds[3]);
        }
      }
      __syncthreads();
      if (active) {  // dV += P^T dO, dK += dS^T Q over the tile's valid ranks
        const int last = min(kF32Rows, nv - q0);
        for (int j = 0; j < last; ++j) {
          const float4 p4 = *reinterpret_cast<const float4*>(pq + j * PS + 4 * ki);
          const float4 s4 = *reinterpret_cast<const float4*>(sq + j * PS + 4 * ki);
#pragma unroll
          for (int i = 0; i < DG; ++i) {
            const float o = dos[j * DS + qi + 8 * i], x = qs[j * DS + qi + 8 * i];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              dva[a][i] = fmaf(at(p4, a), o, dva[a][i]);
              dka[a][i] = fmaf(at(s4, a), x, dka[a][i]);
            }
          }
        }
      }
    }
  }
  // the teams' sums, added in team order over the team tiles' memory
  __syncthreads();
  float* red = vs + kF32Rows * DS;  // [2][32][D]
  for (int t = 0; t < NT; ++t) {
    if (team == t)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < DG; ++i) {
          const int idx = (4 * ki + a) * D + qi + 8 * i;
          red[idx] = t ? red[idx] + dka[a][i] : dka[a][i];
          red[kF32Rows * D + idx] = t ? red[kF32Rows * D + idx] + dva[a][i] : dva[a][i];
        }
    __syncthreads();
  }
  for (int i = tid; i < kF32Rows * D; i += blockDim.x) {  // the valid keys' rows
    const int r = i / D, c = i - r * D;
    if (k0 + r < nv) {
      const size_t off = kv_off + (size_t)rb[k0 + r] * kv_stride + c;
      dk[off] = red[i] * scale;
      dv[off] = red[kF32Rows * D + i];
    }
  }
}

// dq: one team per (32 query ranks, query head, batch) over the 32-rank key
// tiles up to its diagonal
template <int D>
__global__ void __launch_bounds__(kF32Team) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse_c,
    const float* __restrict__ delta_c, const int* __restrict__ rows,
    const int* __restrict__ counts, float* __restrict__ dq, int T, int Tp, int Hq, int Hkv,
    float scale, float scale_log2) {
  constexpr int DS = D + 4, PS = kF32Rows + 4, DG = D / 8;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                  // [32][DS]
  float* dos = qs + kF32Rows * DS;  // [32][DS]
  float* ks = dos + kF32Rows * DS;  // [32][DS]
  float* vs = ks + kF32Rows * DS;   // [32][DS]
  float* sk = vs + kF32Rows * DS;   // [32 keys][PS] dS
  float* ls = sk + kF32Rows * PS;   // [32]
  float* dl = ls + kF32Rows;        // [32]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int nv = counts[b];
  const int qt = (nv + kF32Rows - 1) / kF32Rows - 1 - (int)blockIdx.z;  // heaviest first
  if (qt < 0) return;
  const int q0 = qt * kF32Rows;
  const int kvh = h / (Hq / Hkv);
  const int* rb = rows + (size_t)b * T;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t q_off = (size_t)b * T * q_stride + (size_t)h * D;
  const size_t kv_off = (size_t)b * T * kv_stride + (size_t)kvh * D;
  stage_rows<D>(qs, q, rb, q0, nv, q_stride, q_off, tid, kF32Team);
  stage_rows<D>(dos, dout, rb, q0, nv, q_stride, q_off, tid, kF32Team);
  if (tid < kF32Rows) {
    const bool ok = q0 + tid < nv;
    const size_t off = ((size_t)b * Hq + h) * Tp + q0 + tid;
    ls[tid] = ok ? lse_c[off] : 0.f;
    dl[tid] = ok ? delta_c[off] : 0.f;
  }
  const int qi = tid / 8, ki = tid % 8;  // S block: queries 4 qi.., keys 4 ki..
  float dqa[4][DG];                      // queries 4 qi + a, dims ki + 8 i
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < DG; ++i) dqa[a][i] = 0.f;
  const int last_kt = (min(nv, q0 + kF32Rows) - 1) / kF32Rows;
  for (int kt = 0; kt <= last_kt; ++kt) {
    const int key0 = kt * kF32Rows;
    __syncthreads();  // the last step's reads are done
    stage_rows<D>(ks, k, rb, key0, nv, kv_stride, kv_off, tid, kF32Team);
    stage_rows<D>(vs, v, rb, key0, nv, kv_stride, kv_off, tid, kF32Team);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
    tile_dots<D>(s, qs, ks, qi, ki);
    tile_dots<D>(dp, dos, vs, qi, ki);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = key0 + 4 * ki + c;
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = 4 * qi + a, t = q0 + r;
        const float p = (t < nv && key <= t) ? exp2f(s[a][c] * scale_log2 - ls[r]) : 0.f;
        ds[a] = p * (dp[a][c] - dl[r]);
      }
      *reinterpret_cast<float4*>(sk + (4 * ki + c) * PS + 4 * qi) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    const int last = min(kF32Rows, nv - key0);  // dQ += dS K over the tile's valid keys
    for (int j = 0; j < last; ++j) {
      const float4 s4 = *reinterpret_cast<const float4*>(sk + j * PS + 4 * qi);
#pragma unroll
      for (int i = 0; i < DG; ++i) {
        const float x = ks[j * DS + ki + 8 * i];
#pragma unroll
        for (int a = 0; a < 4; ++a) dqa[a][i] = fmaf(at(s4, a), x, dqa[a][i]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = q0 + 4 * qi + a;
    if (t < nv) {
      float* out = dq + q_off + (size_t)rb[t] * q_stride;
#pragma unroll
      for (int i = 0; i < DG; ++i) out[ki + 8 * i] = dqa[a][i] * scale;
    }
  }
}

int set_smem(const void* fn, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the compacted statistics and row lists the prep writes, read by dkv and dq
struct Scratch {
  const float* lse_c;
  const float* delta_c;
  const int* rows;
  const int* counts;
};

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, Scratch sc,
                void* dq, void* dk, void* dv, int B, int T, int Tp, int Hq, int Hkv, float scale,
                float sl2, cudaStream_t st) {
  constexpr size_t DP = D <= 64 ? 64 : 128;
  // 1024 bytes of slack for the tiles' alignment
  const size_t smem_kv = 1024 + 2 * DP * 2 * (kBKeys + kRing * kBQ) +
                         sizeof(float) * 2 * kRing * kBQ + 2 * kRing * sizeof(uint64_t);
  const size_t smem_q = 1024 + 2 * DP * 2 * (kBRows + kRing * kBK) + 2 * kRing * sizeof(uint64_t);
  int err;
  if ((err = set_smem((const void*)flash_bwd_dkv_kernel<D>, smem_kv)) != 0) return err;
  if ((err = set_smem((const void*)flash_bwd_dq_kernel<D>, smem_q)) != 0) return err;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  const dim3 grid_kv(Hkv, B, (T + kBKeys - 1) / kBKeys);
  flash_bwd_dkv_kernel<D><<<grid_kv, kBlockThreads, smem_kv, st>>>(
      qb, kb, vb, db, sc.lse_c, sc.delta_c, sc.rows, sc.counts, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, Tp, Hq, Hkv, scale, sl2);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const dim3 grid_q(Hq, B, (T + kBRows - 1) / kBRows);
  flash_bwd_dq_kernel<D><<<grid_q, kBlockThreads, smem_q, st>>>(
      qb, kb, vb, db, sc.lse_c, sc.delta_c, sc.rows, sc.counts, static_cast<bf16*>(dq), T, Tp, Hq,
      Hkv, scale, sl2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, Scratch sc,
               void* dq, void* dk, void* dv, int B, int T, int Tp, int Hq, int Hkv, float scale,
               float sl2, cudaStream_t st) {
  constexpr size_t DS = D + 4, PS = kF32Rows + 4;
  const int teams = min(Hq / Hkv, kF32MaxTeams);
  const size_t team = 2 * kF32Rows * DS + 2 * kF32Rows * PS + 2 * kF32Rows;
  const size_t smem_kv = sizeof(float) * (2 * kF32Rows * DS + teams * team);
  const size_t smem_q = sizeof(float) * (4 * kF32Rows * DS + kF32Rows * PS + 2 * kF32Rows);
  int err;
  if ((err = set_smem((const void*)flash_bwd_dkv_f32_kernel<D>, smem_kv)) != 0) return err;
  if ((err = set_smem((const void*)flash_bwd_dq_f32_kernel<D>, smem_q)) != 0) return err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
  const int tiles = (T + kF32Rows - 1) / kF32Rows;
  flash_bwd_dkv_f32_kernel<D><<<dim3(Hkv, B, tiles), kF32Team * teams, smem_kv, st>>>(
      qf, kf, vf, df, sc.lse_c, sc.delta_c, sc.rows, sc.counts, static_cast<float*>(dk),
      static_cast<float*>(dv), T, Tp, Hq, Hkv, scale, sl2);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  flash_bwd_dq_f32_kernel<D><<<dim3(Hq, B, tiles), kF32Team, smem_q, st>>>(
      qf, kf, vf, df, sc.lse_c, sc.delta_c, sc.rows, sc.counts, static_cast<float*>(dq), T, Tp,
      Hq, Hkv, scale, sl2);
  return (int)cudaGetLastError();
}

}  // namespace

// q/dq [B,T,Hq,D], k/v/dk/dv [B,T,Hkv,D], o/dout [B,T,Hq,D] in one dtype
// (0 bf16, 1 f32); lse (the forward's) f32 [B,Hq,T]; mask [B,T] bool.
// Scratch, written here and never read before: rows int32 [B*T + B] (each
// scene's valid positions in order, then the B counts) and stats f32
// [2,B,Hq,Tp], Tp = T rounded up to a multiple of 64 (the compacted lse in
// the log2 domain, then delta). Launches prep, dkv and dq on `stream`.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const float* lse,
                                     const unsigned char* mask, int* rows, float* stats,
                                     void* dq, void* dk, void* dv, int B, int T, int Hq, int Hkv,
                                     int D, float scale, int dtype, void* stream) {
  if (Hkv < 1 || Hq < 1 || Hq % Hkv != 0 || B > 65535 || dtype < 0 || dtype > 1 ||
      T > 65535 * kF32Rows)
    return (int)cudaErrorInvalidValue;
  if (B < 1 || T < 1) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const float sl2 = scale * kLog2e;
  const int Tp = (T + kStatPad - 1) / kStatPad * kStatPad;
  const size_t stat = (size_t)B * Hq * Tp;
  const Scratch sc{stats, stats + stat, rows, rows + (size_t)B * T};
  const dim3 grid_prep((T + kPrepRows - 1) / kPrepRows, (Hq + kPrepHeads - 1) / kPrepHeads, B);
  if (dtype)
    flash_bwd_prep_kernel<float><<<grid_prep, kPrepThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), lse, mask, rows,
        rows + (size_t)B * T, stats, stats + stat, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), T, Tp, Hq, Hkv, D);
  else
    flash_bwd_prep_kernel<bf16><<<grid_prep, kPrepThreads, 0, st>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, mask, rows,
        rows + (size_t)B * T, stats, stats + stat, static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Tp, Hq, Hkv, D);
  int err;
  if ((err = (int)cudaGetLastError()) != 0) return err;
#define PROSIM_FLASH_BWD_CASE(DD)                                                            \
  case DD:                                                                                   \
    return dtype ? launch_f32<DD>(q, k, v, dout, sc, dq, dk, dv, B, T, Tp, Hq, Hkv, scale, sl2, \
                                  st)                                                         \
                 : launch_bf16<DD>(q, k, v, dout, sc, dq, dk, dv, B, T, Tp, Hq, Hkv, scale, sl2, \
                                   st);
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
