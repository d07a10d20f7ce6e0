// The bf16 edge engine shared by csrc/edge_attn.cu (B2's bf16 path) and
// csrc/fused_stack.cu (the edge phases of B3's bf16 path): a gated-attention
// softmax over one destination row's valid edges, with its score and its
// aggregate on the tensor cores.
//
// Replaces, in bf16, the inner loop of prosim_tpu/ops/edge_attn.py
// (_edge_attn_kernel, :57-80) and the edge part of
// prosim_tpu/ops/fused_stack.py:_site_layer (:183-198): per row and head h,
// over the valid edges k with staged rows r[k] = [x_g[k] | z[k]],
//   s[k, h] = (r[k] . q[h]) * scale,  w = online softmax_k(s),
//   agg[h]  = sum_k w[k, h] r[k] / sum_k w[k, h].
//
// What bounds it on the H100: the bytes of the gathered rows. Per valid
// edge and head the score and the aggregate take 4 (D + Dp) operations, 7.2
// kFLOP an edge at the demo widths (H = 8, D = 128, Dp = 96), which the
// tensor cores do in ~7 ps; the edge's x row (256 B from L2, gathered by
// idx) and z row (192 B from device memory) take ~60-130 ps. The design
// therefore reads each staged value from shared memory once per product,
// never converts it on the CUDA cores, and keeps copies in flight. On an
// H100 at 700 W (scripts/edge_attn_variants.py --dtype bf16) the copies
// alone take 64-69 % of B2's time at the long-row sites (K > 128) and the
// compute alone 63-66 %, at the short-row s2s site (K = 32, two tiles a
// row) the compute alone 92 %; a third ring stage measured no faster.
//
// Design (one team of two warps per row, as before; the caller places the
// teams):
//  * The team compacts its share of the row's edges by ballot, in edge
//    order, into a list in shared memory (an invalid edge's idx is never
//    dereferenced) and walks the list in tiles of 16 edges: mma's M.
//  * Each tile's rows are gathered by idx into a kStages-deep ring of
//    16-byte cp.async copies, one tile ahead of the compute. Hopper's TMA
//    copies boxes of a tensor and has no row gather, so the ring stays on
//    cp.async. A staged row holds x at columns [0, D) and z at [Dx, Dx + Dp)
//    (Dx = D rounded up to 8), zero elsewhere up to Cs (Dx + Dp rounded up
//    to 32); its stride is Cs + 8 values, so the 8 rows an ldmatrix reads
//    fall in 8 different 16-byte bank groups. A partial tile's extra rows
//    are zeroed (their weight is exactly 0, and 0 * garbage could be NaN).
//  * Warp hh of the team owns the columns [hh Cs / 2, (hh + 1) Cs / 2).
//    Score: s = R Q^T as mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//    the 16 edges on M, the 8 heads on N (H <= 8 fills n8, no padding) and
//    its columns on K; R comes from the ring by ldmatrix, the queries are
//    B fragments held in registers for the whole row. The two warps' partial
//    scores meet in shared memory (one float4 a lane) and are added; a + b
//    is commutative, so both warps hold bitwise the same scores.
//  * The online softmax runs in f32 on the accumulator fragments: a lane
//    holds 2 edges x 2 heads, the max and the sum over the tile's 16 edges
//    take 3 shuffles each. The weights are rounded to bf16, as the TPU
//    kernel rounds its weights (prosim_tpu/ops/edge_attn.py:72-74), and the
//    denominator sums those rounded weights.
//  * Aggregate: agg^T = R^T W as mma.sync.m16n8k16 with 16 columns on M,
//    the 8 heads on N and the 16 edges on K. The score fragments, rounded
//    and packed in pairs, are the transpose of the B fragments this needs:
//    one movmatrix.trans each, no shared memory. R^T comes from the same
//    staged tile by ldmatrix.trans: each staged value is read once for the
//    score and once for the aggregate, never unpacked on the CUDA cores.
//  * No atomics; every sum runs in a fixed order (the caller merges teams
//    in a fixed order), so two launches are bitwise equal.

#pragma once

#include <math.h>

#include "edge_common.cuh"

namespace edge_mma {

constexpr int kTile = 16;          // edges per tile: mma's M
constexpr int kMaxNk = 8;          // 16-column blocks per warp: half of Cs <= 256
constexpr int kSeg = 64;           // edges per segment a team takes of a row
constexpr int kListCap = 256;      // list entries per team and pass
constexpr int kStages = 2;         // ring depth (tiles a team holds)
constexpr unsigned kFull = 0xffffffffu;

// The staged row's column layout.
struct Cols {
  int D, Dp;  // the x and z widths
  int Dx;     // z's first column: D rounded up to 8 (16 bytes)
  int Cs;     // staged columns: Dx + Dp rounded up to 32 (a warp takes half)
  int ld;     // row stride in values: Cs + 8
  int nk;     // 16-column blocks per warp: Cs / 32
};

__host__ __device__ inline Cols make_cols(int D, int Dp) {
  Cols c;
  c.D = D;
  c.Dp = Dp;
  c.Dx = (D + 7) & ~7;
  c.Cs = (c.Dx + Dp + 31) & ~31;
  c.ld = c.Cs + 8;
  c.nk = c.Cs / 32;
  return c;
}

// bytes of one team's ring
__host__ __device__ inline int ring_bytes(const Cols& c) { return kStages * kTile * c.ld * 2; }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of an 8x8 bf16 matrix held as one fragment register a lane.
__device__ __forceinline__ uint32_t movm_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// Two f32 values rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two raw bf16 values packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_raw(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A warp's state over one row: the queries of its columns as B fragments,
// the aggregates of its columns (acc[i]: columns 16 (hh nk + i) + gid (+ 8)
// x heads 2 tig, 2 tig + 1, gid = lane / 4, tig = lane % 4) and the running
// max and denominator of heads 2 tig and 2 tig + 1.
struct State {
  uint32_t q[kMaxNk][2];
  float acc[kMaxNk][4];
  float m[2], l[2];
};

__device__ __forceinline__ void reset(State& s) {
#pragma unroll
  for (int i = 0; i < kMaxNk; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) s.acc[i][r] = 0.f;
  s.m[0] = s.m[1] = -INFINITY;
  s.l[0] = s.l[1] = 0.f;
}

// Query fragments of warp hh from q_of(h, c): the raw bf16 bits of query h
// at staged column c (0 outside the tables and for h >= H).
template <typename QOf>
__device__ __forceinline__ void load_queries(State& s, const Cols& c, int hh, int lane, QOf q_of) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < kMaxNk; ++i) {
    if (i < c.nk) {
      const int c0 = 16 * (hh * c.nk + i) + 2 * tig;
      s.q[i][0] = pack_raw(q_of(gid, c0), q_of(gid, c0 + 1));
      s.q[i][1] = pack_raw(q_of(gid, c0 + 8), q_of(gid, c0 + 9));
    } else {
      s.q[i][0] = s.q[i][1] = 0u;
    }
  }
}

// The rows of a tile's edges: x rows of the source table (x_ld values
// apart) gathered by the list's source index, z rows of the row's table
// (z_ld apart) by its edge index.
struct Rows {
  const bf16* xs;  // the scene's source table
  const bf16* z;   // the destination row's z table
  int z_ld;
  bool vec_x, vec_z;  // rows 16-byte aligned: copy chunks inside a table by cp.async
};

// Stage the rows of list entries [e0, e0 + n) into tile `st` (kTile rows of
// c.ld values): warp hh of the team rows hh, hh + 2, ..., lane j the 16-byte
// chunk j (columns 8j .. 8j + 7) of each. A chunk inside x or inside z goes
// by cp.async; a chunk across a table's end or in the padding is assembled
// from 2-byte loads and zeros; rows n.. are zero.
__device__ __forceinline__ void stage_tile(bf16* st, const Rows& t, const int* lk, const int* ls,
                                           int e0, int n, const Cols& c, int hh, int lane) {
  const int c0 = 8 * lane;
  if (c0 < c.Cs) {
    for (int e = hh; e < kTile; e += 2) {
      bf16* dst = st + e * c.ld + c0;
      if (e >= n) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const bf16* xrow = t.xs + (size_t)ls[e0 + e] * c.D;
      const bf16* zrow = t.z + (size_t)lk[e0 + e] * t.z_ld;
      if (t.vec_x && c0 + 8 <= c.D) {
        cp_async16(dst, xrow + c0);
      } else if (t.vec_z && c0 >= c.Dx && c0 + 8 <= c.Dx + c.Dp) {
        cp_async16(dst, zrow + (c0 - c.Dx));
      } else {
        const unsigned short* xr = reinterpret_cast<const unsigned short*>(xrow);
        const unsigned short* zr = reinterpret_cast<const unsigned short*>(zrow);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned short v[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int cc = c0 + 2 * i + j;
            v[j] = cc < c.D ? xr[cc] : (cc >= c.Dx && cc < c.Dx + c.Dp ? zr[cc - c.Dx] : 0);
          }
          w[i] = pack_raw(v[0], v[1]);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  cp_async_commit();
}

// One tile of nt (>= 1) valid edges, staged in `st`: the score, one online
// softmax step, the aggregate. xb: the team's exchange buffer [2][32]
// float4; bar / bar_threads: the team's named barrier. kRound: the scaled
// score rounds through bf16 (B2, as the TPU edge kernel's sim).
template <bool kRound>
__device__ __forceinline__ void tile_step(State& s, const bf16* st, int nt, const Cols& c,
                                          float scale, float4* xb, int bar, int hh, int lane) {
  const int gid = lane >> 2;
  // score: this warp's columns
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  {
    const bf16* a0 = st + (lane & 15) * c.ld + 16 * hh * c.nk + (lane >> 4) * 8;
#pragma unroll
    for (int i = 0; i < kMaxNk; ++i) {
      if (i < c.nk) {
        uint32_t a[4];
        ldsm_x4(a, a0 + 16 * i);
        mma16816(p, a, s.q[i][0], s.q[i][1]);
      }
    }
  }
  xb[hh * 32 + lane] = make_float4(p[0], p[1], p[2], p[3]);
  bar_sync(bar, 64);
  const float4 o = xb[(hh ^ 1) * 32 + lane];
  // v[r]: edge gid + 8 (r >> 1), head 2 tig + (r & 1)
  float v[4] = {p[0] + o.x, p[1] + o.y, p[2] + o.z, p[3] + o.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float x = v[r] * scale;
    if (kRound) x = round_to<bf16>(x);
    v[r] = gid + 8 * (r >> 1) < nt ? x : -INFINITY;
  }
  float mt[2] = {fmaxf(v[0], v[2]), fmaxf(v[1], v[3])};  // edge 0 is valid: finite
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int w = 4; w < 32; w <<= 1) mt[j] = fmaxf(mt[j], __shfl_xor_sync(kFull, mt[j], w));
  float corr[2], wt[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float mn = fmaxf(s.m[j], mt[j]);
    corr[j] = expf(s.m[j] - mn);  // 0 while m is -inf
    s.m[j] = mn;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) wt[r] = round_to<bf16>(expf(v[r] - s.m[r & 1]));  // 0 past nt
  float ls[2] = {wt[0] + wt[2], wt[1] + wt[3]};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int w = 4; w < 32; w <<= 1) ls[j] += __shfl_xor_sync(kFull, ls[j], w);
    s.l[j] = fmaf(s.l[j], corr[j], ls[j]);
  }
  // the weights as B fragments (edges on K, heads on N): the transpose of
  // the accumulator's (edges on M, heads on N) 8x8 halves
  const uint32_t b0 = movm_t(pack2(wt[0], wt[1]));
  const uint32_t b1 = movm_t(pack2(wt[2], wt[3]));
  const bf16* a0 = st + ((lane & 7) + ((lane >> 4) << 3)) * c.ld + 16 * hh * c.nk +
                   ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < kMaxNk; ++i) {
    if (i < c.nk) {
      s.acc[i][0] *= corr[0];
      s.acc[i][1] *= corr[1];
      s.acc[i][2] *= corr[0];
      s.acc[i][3] *= corr[1];
      uint32_t a[4];
      ldsm_x4_t(a, a0 + 16 * i);
      mma16816(s.acc[i], a, b0, b1);
    }
  }
}

// The edges of one row that this team takes: chunk j of 32 edges of each
// pass of span = nteams kListCap edges lies in segment my + (j / 2) nteams
// of kSeg edges (with nteams = 1: the pass's edges in order). The team's
// warp 0 compacts the valid ones into (list_k, list_s) and count; the team
// streams them through its ring in tiles. bar: the team's named barrier.
template <bool kRound>
__device__ __forceinline__ void run_row(State& s, bf16* ring, int* list_k, int* list_s,
                                        int* count, float4* xb, const Rows& rows,
                                        const int* __restrict__ idx_row,
                                        const unsigned char* __restrict__ v_row, int K,
                                        int nteams, int my, const Cols& c, float scale, int bar,
                                        int hh, int lane) {
  const int span = nteams * kListCap;
  const int tile_vals = kTile * c.ld;
  for (int base = 0; base < K; base += span) {
    if (hh == 0) {
      // all flags and indices are loaded first, so their latencies overlap
      constexpr int kChunks = kListCap / 32;
      bool v[kChunks];
      int src[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int k = base + (my + (j >> 1) * nteams) * kSeg + (j & 1) * 32 + lane;
        v[j] = k < K && v_row[k] != 0;
        src[j] = v[j] ? idx_row[k] : 0;
      }
      int n = 0;
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const unsigned mask = __ballot_sync(kFull, v[j]);
        if (v[j]) {
          const int at = n + __popc(mask & ((1u << lane) - 1));
          list_k[at] = base + (my + (j >> 1) * nteams) * kSeg + (j & 1) * 32 + lane;
          list_s[at] = src[j];
        }
        n += __popc(mask);
      }
      if (lane == 0) *count = n;
    }
    bar_sync(bar, 64);
    const int n = *count;
    const int tiles = (n + kTile - 1) / kTile;
    // tiles u < kStages - 1 first; then tile t + kStages - 1 is copied while
    // tile t is computed (one copy group per tile, empty past the last)
#pragma unroll
    for (int u = 0; u < kStages - 1; ++u) {
      if (u < tiles)
        stage_tile(ring + u * tile_vals, rows, list_k, list_s, u * kTile,
                   min(kTile, n - u * kTile), c, hh, lane);
      else
        cp_async_commit();
    }
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<kStages - 2>();
      bar_sync(bar, 64);  // tile t visible to the team; tile t - 1 consumed by both warps
      const int u = t + kStages - 1;
      if (u < tiles)
        stage_tile(ring + (u % kStages) * tile_vals, rows, list_k, list_s, u * kTile,
                   min(kTile, n - u * kTile), c, hh, lane);
      else
        cp_async_commit();
      tile_step<kRound>(s, ring + (t % kStages) * tile_vals, min(kTile, n - t * kTile), c, scale,
                        xb, bar, hh, lane);
    }
    bar_sync(bar, 64);  // the list and the ring are free again
  }
}

// Calls f(col, head, value, ok) for each aggregate this lane holds (value
// = acc / l; ok: the head's row had a valid edge, else value is 0).
template <typename F>
__device__ __forceinline__ void for_each_out(const State& s, const Cols& c, int hh, int lane,
                                             F f) {
  const int gid = lane >> 2, tig = lane & 3;
  const bool ok[2] = {s.l[0] > 0.f, s.l[1] > 0.f};
#pragma unroll
  for (int i = 0; i < kMaxNk; ++i) {
    if (i < c.nk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = r & 1;
        f(16 * (hh * c.nk + i) + gid + 8 * (r >> 1), 2 * tig + j,
          ok[j] ? s.acc[i][r] / s.l[j] : 0.f, ok[j]);
      }
    }
  }
}

// A warp's state in shared memory, for a merge: acc [kMaxNk][4][32], then
// m [2][32] and l [2][32].
constexpr int kSaveFloats = (kMaxNk * 4 + 4) * 32;

__device__ __forceinline__ void save(const State& s, float* o, const Cols& c, int lane) {
#pragma unroll
  for (int i = 0; i < kMaxNk; ++i)
    if (i < c.nk)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[(i * 4 + r) * 32 + lane] = s.acc[i][r];
  float* ml = o + kMaxNk * 4 * 32;
  ml[lane] = s.m[0];
  ml[32 + lane] = s.m[1];
  ml[64 + lane] = s.l[0];
  ml[96 + lane] = s.l[1];
}

// Merge another team's state of the same row (saved by its warp of the
// same hh) into s: s first, then o, so the result does not depend on timing.
__device__ __forceinline__ void merge(State& s, const float* o, const Cols& c, int lane) {
  const float* ml = o + kMaxNk * 4 * 32;
  float f0[2], f1[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float m1 = ml[32 * j + lane], l1 = ml[64 + 32 * j + lane];
    const float M = fmaxf(s.m[j], m1);
    f0[j] = s.m[j] == -INFINITY ? 0.f : expf(s.m[j] - M);
    f1[j] = m1 == -INFINITY ? 0.f : expf(m1 - M);
    s.l[j] = fmaf(f1[j], l1, s.l[j] * f0[j]);
    s.m[j] = M;
  }
#pragma unroll
  for (int i = 0; i < kMaxNk; ++i)
    if (i < c.nk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s.acc[i][r] = fmaf(f1[r & 1], o[(i * 4 + r) * 32 + lane], s.acc[i][r] * f0[r & 1]);
}

}  // namespace edge_mma
