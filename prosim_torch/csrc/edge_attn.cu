// One-pass gated-attention edge core for Hopper (sm_90a), with the gather
// of the source rows inside the kernel.
//
// Replaces prosim_tpu/ops/edge_attn.py:edge_attn_core (_edge_attn_kernel)
// composed with the gather the JAX package does before it
// (gather_neighbors(x_src_n, idx), prosim_tpu/ops/attention.py). Per
// destination row (b, q) and head h, over the row's K edges:
//   x[k]       = x_src_n[b, idx[b, q, k]]      (read only for valid edges)
//   sim[k, h]  = (x[k] . qx[h] + z_r[k] . qp[h]) * scale
//   attn[:, h] = softmax over the valid k (rows with no valid edge give 0)
//   agg_x[h]   = sum_k attn[k, h] x[k];  agg_z[h] = sum_k attn[k, h] z_r[k]
//   attn_sum[h] = 1 if any edge is valid else 0
// The per-query score bias of the layer is constant over k and cancels in
// the softmax, so it is not an input (as in the TPU kernel).
//
// Bound on the H100: per valid edge 4 B of idx and the Dp f32 values of its
// z_r row come from device memory; the source table x_src_n [B,S,D] is at
// most 1.1 MB per scene (18 MB at B = 16) and stays in the 50 MB L2, so its
// rows are read from L2 by idx, not from a stored [B,Q,K,D] copy. The
// 4 H (D + Dp) f32 operations per valid edge take about as long on the CUDA
// cores as its bytes take from memory, so the FMA pipe, the instruction
// issue and the shared-memory pipe (each staged value is read four times:
// by both warps of a team, for the score and for the aggregate) bound it
// as much as the bytes do.
//
// Design:
//  * A team of two warps owns a row's edges; warp hh of the team holds the
//    queries and [.,D + Dp] accumulators of heads hh*HH .. hh*HH + HH - 1
//    (HH = ceil(H / 2) <= 4) for the columns 4 lane .. 4 lane + 3 of each
//    table (one 16-byte shared-memory load per table and edge), so a thread
//    keeps 32 query and 32 accumulator registers.
//  * Short rows (K <= 128): one team per row, two rows per block of four
//    warps, no block-level merge. Long rows: one row per block, the two
//    teams take alternate 64-edge segments (top-K puts the valid edges
//    first, so both get a share) and their states merge at the end in a
//    fixed order.
//  * Each team compacts its valid edges (ballot, in edge order) into a list
//    in shared memory, then walks the list in tiles of 8 edges: the tile's
//    x rows (gathered by idx) and z_r rows go into a two-stage shared-memory
//    ring by cp.async, one tile ahead of the compute (a partial tile's
//    extra rows are zeroed). Invalid edges are never read, and their idx
//    never dereferenced.
//  * Per tile, each lane's 32 partial dot products (8 edges x 4 heads over
//    its columns) are reduced across the warp by one recursive-halving
//    transpose (31 shuffles) after which lane l holds the score of edge
//    l / 4 for head l % 4. The online softmax then runs once per tile and
//    head, over the 8 lanes of that head: one max and one sum by 3
//    shuffles each, one rescale and one exp per lane. The tile's weights
//    reach every lane through shared memory (float4 broadcasts), and the
//    lanes, owning columns again, accumulate the weighted rows of the tile.
//  * No atomics: results are bitwise reproducible from launch to launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;              // two teams of two warps
constexpr int kThreads = 32 * kWarps;
constexpr int kTeamThreads = 64;
constexpr int kMaxH = 8;
constexpr int kHH = 4;                 // heads per warp
constexpr int kTile = 8;               // edges per tile
constexpr int kStages = 2;
constexpr int kSeg = 64;               // edges per segment a team takes
constexpr int kListCap = 256;          // list entries per team
constexpr int kShortK = 128;           // rows up to this K: one team per row
constexpr int kMergeFloats = 4 * kHH + 2 * kHH * 8 * 32;
constexpr unsigned kFull = 0xffffffffu;

// One stage of reduce_scatter32: lanes with bit W set keep the upper half
// of v[0, 2W), the others the lower half, and add the partner's copy.
template <int W>
__device__ __forceinline__ void reduce_half(float (&v)[kTile * kHH], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = up ? v[k] : v[k + W];
    const float keep = up ? v[k + W] : v[k];
    v[k] = keep + __shfl_xor_sync(kFull, send, W);
  }
}

// v[k] for k < 32 (k = e * kHH + i: edge e of the tile, head i): returns on
// lane l the warp's sum of v[l]. Recursive halving: 16 + 8 + 4 + 2 + 1
// shuffles, each stage's shuffles independent of each other.
__device__ __forceinline__ float reduce_scatter32(float (&v)[kTile * kHH], int lane) {
  static_assert(kTile * kHH == 32, "one sum per lane");
  reduce_half<16>(v, lane);
  reduce_half<8>(v, lane);
  reduce_half<4>(v, lane);
  reduce_half<2>(v, lane);
  reduce_half<1>(v, lane);
  return v[0];
}

__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(kTeamThreads) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Shapes {
  int Q, S, K, H, D, Dp;
  int Dx, Cs;  // staged row: x at [0, D), z_r at [Dx, Dx + Dp); Dx = D and Cs = Dx + Dp
               // rounded up to 4, the padding zero
  int ring;    // floats of both teams' rings, at least the merge state's
  float scale;
  bool vec;    // D and Dp multiples of 4 and the tables 16-byte aligned: 16-byte copies
};

// Stage the x and z_r rows of list entries [e0, e0 + n) into `st`, edges
// hh, hh + 2, ... by warp hh of the team, and zero the rows n..kTile-1 (a
// partial tile is computed in full; its extra edges get no weight).
__device__ __forceinline__ void stage_tile(float* st, const float* __restrict__ xs_b,
                                           const float* __restrict__ zr_row,
                                           const int* lk, const int* ls, int e0, int n,
                                           const Shapes& s, int hh, int lane) {
  for (int e = hh; e < n; e += 2) {
    const float* xrow = xs_b + (size_t)ls[e0 + e] * s.D;
    const float* zrow = zr_row + (size_t)lk[e0 + e] * s.Dp;
    float* dst = st + e * s.Cs;
    if (s.vec) {
      if (4 * lane < s.D) cp_async16(dst + 4 * lane, xrow + 4 * lane);
      if (4 * lane < s.Dp) cp_async16(dst + s.Dx + 4 * lane, zrow + 4 * lane);
    } else {
      for (int c = lane; c < s.D; c += 32) cp_async4(dst + c, xrow + c);
      for (int c = lane; c < s.Dp; c += 32) cp_async4(dst + s.Dx + c, zrow + c);
    }
  }
  cp_async_commit();
  for (int i = 32 * hh + lane; i < (kTile - n) * s.Cs; i += kTeamThreads) st[n * s.Cs + i] = 0.f;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Block layout of the dynamic shared memory (floats / ints):
//   stage[2 teams][kStages][kTile][Cs] in `ring` floats (after the edge
//                                        loop: the merge state, kMergeFloats)
//   list_k[2 teams][kListCap], list_s[2 teams][kListCap], count[2 teams]
//   wsm[kWarps][kTile][kHH], csm[kWarps][kHH]
// Lane l owns the columns 4l..4l+3 of both tables: q[i][0..3] and acc[i][0..3]
// for x, q[i][4..7] and acc[i][4..7] for z_r, i the warp's head.
template <bool kBlockRow>
__global__ void __launch_bounds__(kThreads, 4) edge_attn_kernel(
    const float* __restrict__ xs, const int* __restrict__ idx,
    const float* __restrict__ zr, const float* __restrict__ qx,
    const float* __restrict__ qp, const unsigned char* __restrict__ valid,
    float* __restrict__ aggx, float* __restrict__ aggz, float* __restrict__ asum,
    int rows, Shapes s) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = warp >> 1;
  const int hh = warp & 1;
  const size_t row = kBlockRow ? blockIdx.x : (size_t)blockIdx.x * 2 + team;
  if (!kBlockRow && row >= (size_t)rows) return;  // the whole team leaves

  const int stage_floats = kStages * kTile * s.Cs;
  float* stage = smem + team * stage_floats;
  int* list_k = reinterpret_cast<int*>(smem + s.ring) + team * kListCap;
  int* list_s = reinterpret_cast<int*>(smem + s.ring) + (2 + team) * kListCap;
  int* count = reinterpret_cast<int*>(smem + s.ring) + 4 * kListCap;
  float* wsm = smem + s.ring + 4 * kListCap + 4 + warp * (kTile * kHH + kHH);
  float* csm = wsm + kTile * kHH;
  // the padding columns are never copied into: zero the ring once
  for (int i = 32 * hh + lane; i < stage_floats; i += kTeamThreads) stage[i] = 0.f;

  const int HH = (s.H + 1) >> 1;
  const int h0 = hh * HH;
  const int nh = max(0, min(HH, s.H - h0));
  const int D = s.D, Dp = s.Dp, Dx = s.Dx, K = s.K;
  const int c0 = 4 * lane;
  const bool own_x = c0 < D, own_z = c0 < Dp;

  float q[kHH][8];
  float acc[kHH][8];
#pragma unroll
  for (int i = 0; i < kHH; ++i) {
    const size_t qrow = row * s.H + h0 + i;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      q[i][t] = (i < nh && c0 + t < D) ? qx[qrow * D + c0 + t] : 0.f;
      q[i][4 + t] = (i < nh && c0 + t < Dp) ? qp[qrow * Dp + c0 + t] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[i][t] = 0.f;
  }
  float m = -INFINITY;  // running max and denominator of head h0 + lane % kHH
  float l = 0.f;

  const size_t b = row / s.Q;
  const float* xs_b = xs + b * s.S * D;
  const float* zr_row = zr + row * K * Dp;
  const int* idx_row = idx + row * K;
  const unsigned char* v_row = valid + row * K;
  const int nteams = kBlockRow ? 2 : 1;
  const int my = kBlockRow ? team : 0;
  const int span = nteams * kListCap;

  for (int base = 0; base < K; base += span) {
    // this team's segments of [base, base + span): compact the valid edges
    if (hh == 0) {
      // chunk c of 32 edges: segment my + (c / 2) * nteams, half c % 2;
      // all flags and indices are loaded first, so their latencies overlap
      constexpr int kChunks = kListCap / 32;
      bool v[kChunks];
      int src[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int k = base + (my + (c >> 1) * nteams) * kSeg + (c & 1) * 32 + lane;
        v[c] = k < K && v_row[k] != 0;
        src[c] = v[c] ? idx_row[k] : 0;
      }
      int n = 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const unsigned mask = __ballot_sync(kFull, v[c]);
        if (v[c]) {
          const int at = n + __popc(mask & ((1u << lane) - 1));
          list_k[at] = base + (my + (c >> 1) * nteams) * kSeg + (c & 1) * 32 + lane;
          list_s[at] = src[c];
        }
        n += __popc(mask);
      }
      if (lane == 0) count[team] = n;
    }
    team_sync(team);
    const int n = count[team];
    const int tiles = (n + kTile - 1) / kTile;
    // tiles u < kStages - 1 first; then tile t + kStages - 1 is copied while
    // tile t is computed (one copy group per tile, empty past the last)
#pragma unroll
    for (int u = 0; u < kStages - 1; ++u) {
      if (u < tiles)
        stage_tile(stage + u * kTile * s.Cs, xs_b, zr_row, list_k, list_s, u * kTile,
                   min(kTile, n - u * kTile), s, hh, lane);
      else
        cp_async_commit();
    }
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<kStages - 2>();
      team_sync(team);  // tile t visible to the team; tile t - 1 consumed by both warps
      const int u = t + kStages - 1;
      if (u < tiles)
        stage_tile(stage + (u % kStages) * kTile * s.Cs, xs_b, zr_row, list_k, list_s,
                   u * kTile, min(kTile, n - u * kTile), s, hh, lane);
      else
        cp_async_commit();
      if (nh == 0) continue;  // warp-uniform: a warp without heads only stages
      const float* st = stage + (t % kStages) * kTile * s.Cs;
      const int nt = min(kTile, n - t * kTile);
      float p[kTile * kHH];
#pragma unroll
      for (int e = 0; e < kTile; ++e) {
        const float4 x = own_x ? lds4(st + e * s.Cs + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 z = own_z ? lds4(st + e * s.Cs + Dx + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < kHH; ++i) {
          float a = x.x * q[i][0];
          a = fmaf(x.y, q[i][1], a);
          a = fmaf(x.z, q[i][2], a);
          a = fmaf(x.w, q[i][3], a);
          a = fmaf(z.x, q[i][4], a);
          a = fmaf(z.y, q[i][5], a);
          a = fmaf(z.z, q[i][6], a);
          p[e * kHH + i] = fmaf(z.w, q[i][7], a);
        }
      }
      // lane l now scores edge l / kHH for head l % kHH; the 8 lanes of a
      // head (lane % kHH) run its online softmax over the tile together
      const float sum = reduce_scatter32(p, lane);
      const float sc = (lane >> 2) < nt ? sum * s.scale : -INFINITY;
      float mt = sc;  // edge 0 is valid: finite
#pragma unroll
      for (int w = 4; w < 32; w <<= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, w));
      const float m_new = fmaxf(m, mt);
      const float corr = expf(m - m_new);  // 0 while m is -inf
      const float wt = expf(sc - m_new);   // 0 for the tile's extra edges
      float lsum = wt;
#pragma unroll
      for (int w = 4; w < 32; w <<= 1) lsum += __shfl_xor_sync(kFull, lsum, w);
      l = fmaf(l, corr, lsum);
      m = m_new;
      wsm[lane] = wt;  // wsm[e * kHH + i]
      if (lane < kHH) csm[lane] = corr;
      __syncwarp();
      const float4 c4 = lds4(csm);
      const float cf[kHH] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < kHH; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[i][t] *= cf[i];
#pragma unroll
      for (int e = 0; e < kTile; ++e) {
        const float4 w4 = lds4(wsm + e * kHH);
        const float w[kHH] = {w4.x, w4.y, w4.z, w4.w};
        const float4 x = own_x ? lds4(st + e * s.Cs + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 z = own_z ? lds4(st + e * s.Cs + Dx + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float v[8] = {x.x, x.y, x.z, x.w, z.x, z.y, z.z, z.w};
#pragma unroll
        for (int i = 0; i < kHH; ++i)
#pragma unroll
          for (int t = 0; t < 8; ++t) acc[i][t] = fmaf(w[i], v[t], acc[i][t]);
      }
    }
    team_sync(team);  // the list and the ring are free again
  }

  if (kBlockRow) {
    // merge team 1's state into team 0's, head by head, in a fixed order
    __syncthreads();  // both teams are done with their rings
    float* ms = smem;                          // [2 warps][kHH]
    float* ls = smem + 2 * kHH;                // [2 warps][kHH]
    float* as = smem + 4 * kHH + hh * kHH * 8 * 32;  // [2 warps][kHH][8 values][32 lanes]
    if (team == 1) {
      if (lane < kHH) {
        ms[hh * kHH + lane] = m;
        ls[hh * kHH + lane] = l;
      }
#pragma unroll
      for (int i = 0; i < kHH; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t) as[(i * 8 + t) * 32 + lane] = acc[i][t];
    }
    __syncthreads();
    if (team == 1) return;
#pragma unroll
    for (int i = 0; i < kHH; ++i) {
      const float m0 = __shfl_sync(kFull, m, i), l0 = __shfl_sync(kFull, l, i);
      const float m1 = ms[hh * kHH + i], l1 = ls[hh * kHH + i];
      const float M = fmaxf(m0, m1);
      const float f0 = m0 == -INFINITY ? 0.f : expf(m0 - M);
      const float f1 = m1 == -INFINITY ? 0.f : expf(m1 - M);
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[i][t] = fmaf(f1, as[(i * 8 + t) * 32 + lane], acc[i][t] * f0);
      const float L = fmaf(f1, l1, l0 * f0);
      if (lane == i) l = L;  // lane i holds head i's denominator below
    }
  }

#pragma unroll
  for (int i = 0; i < kHH; ++i) {
    if (i < nh) {  // warp-uniform
      const float L = __shfl_sync(kFull, l, i);
      const float inv_ok = L > 0.f;
      const size_t orow = row * s.H + h0 + i;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (c0 + t < D) aggx[orow * D + c0 + t] = inv_ok ? acc[i][t] / L : 0.f;
        if (c0 + t < Dp) aggz[orow * Dp + c0 + t] = inv_ok ? acc[i][4 + t] / L : 0.f;
      }
      if (lane == 0) asum[orow] = inv_ok ? 1.f : 0.f;
    }
  }
}

Shapes make_shapes(int Q, int S, int K, int H, int D, int Dp, float scale) {
  Shapes s;
  s.Q = Q;
  s.S = S;
  s.K = K;
  s.H = H;
  s.D = D;
  s.Dp = Dp;
  s.Dx = (D + 3) & ~3;
  s.Cs = s.Dx + ((Dp + 3) & ~3);
  s.ring = 2 * kStages * kTile * s.Cs;
  if (s.ring < kMergeFloats) s.ring = kMergeFloats;
  s.scale = scale;
  s.vec = false;
  return s;
}

size_t smem_bytes(const Shapes& s) {
  return sizeof(float) * ((size_t)s.ring + 4 * kListCap + 4 + kWarps * (kTile * kHH + kHH));
}

}  // namespace

extern "C" int edge_attn_launch(const float* xs, const int* idx, const float* zr,
                                const float* qx, const float* qp,
                                const unsigned char* valid, float* aggx, float* aggz,
                                float* asum, int B, int Q, int S, int K, int H, int D,
                                int Dp, float scale, void* stream) {
  if (H < 1 || H > kMaxH || D < 1 || Dp < 1 || D > 128 || Dp > 128 || K < 0)
    return (int)cudaErrorInvalidValue;
  const int rows = B * Q;
  if (rows == 0) return 0;
  Shapes s = make_shapes(Q, S, K, H, D, Dp, scale);
  s.vec = (D % 4 == 0) && (Dp % 4 == 0) &&
          ((reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(zr)) & 15) == 0;
  const size_t smem = smem_bytes(s);
  cudaStream_t st = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(edge_attn_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaFuncSetAttribute(edge_attn_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  if (K <= kShortK)
    edge_attn_kernel<false><<<(rows + 1) / 2, kThreads, smem, st>>>(
        xs, idx, zr, qx, qp, valid, aggx, aggz, asum, rows, s);
  else
    edge_attn_kernel<true><<<rows, kThreads, smem, st>>>(
        xs, idx, zr, qx, qp, valid, aggx, aggz, asum, rows, s);
  return (int)cudaGetLastError();
}

// For the record of occupancy: the dynamic shared memory of a block at these
// widths, and the resident blocks of four warps per SM of the short-row
// (block_row 0) or long-row (1) instantiation.
extern "C" int edge_attn_smem_bytes(int D, int Dp) {
  return (int)smem_bytes(make_shapes(1, 1, 1, 1, D, Dp, 1.f));
}

extern "C" int edge_attn_blocks_per_sm(int block_row, int D, int Dp) {
  const size_t smem = smem_bytes(make_shapes(1, 1, 1, 1, D, Dp, 1.f));
  int n = 0;
  cudaError_t err = block_row
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, edge_attn_kernel<true>, kThreads, smem)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, edge_attn_kernel<false>, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}
