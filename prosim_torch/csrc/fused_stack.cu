// The policy's fused two-site gated-attention stack for Hopper (sm_90a).
//
// Replaces prosim_tpu/ops/fused_stack.py:fused_two_site_stack (_kernel,
// _site_layer). One launch runs the policy's whole interleaved
// (a2p, m2p) x L stack of GatedNeighborAttention layers for one replan
// step. Per query row and layer of a site:
//   xn = LN_dst(x); q = xn Wq + bq
//   sim_h[k] = (q_h . k_h[k]) * scale over the row's valid edges k, where
//              k[k] | v[k] = LN(src[idx[k]]) wkv + LN(z[k]) wkvr + bkv and
//              z[k] = sin(feats[k] m1 + phase), the fixed Fourier rel-PE
//   agg_h = softmax_K(sim_h) . v_h           (rows with no valid edge -> 0)
//   x += LN_post(to_out(agg + sigmoid(to_g[agg, xn]) (to_s(xn) - agg)))
//   x += LN_ffpost(FFN(LN_ff(x)))
// with the packed weights of prosim_torch/ops/fused_stack.py:pack_site_weights
// (the LayerNorm affines of src and rel-PE folded into wkv / wkvr / bkv).
//
// What bounds it on the H100: by count, the f32 operations of the edge
// phases. Per valid edge and layer the score and the aggregate take
// 4 H (D + P) operations on the CUDA cores: at the demo shape (B=16, N=128,
// K = 160 / 768, L = 6) ~70 GFLOP a step, ~1.0 ms at 67 TFLOP/s; the dense
// products around the edges are ~14 GFLOP, and the inputs, read once,
// ~72 MB (the packed weights 13.4 MB of it). In practice the edge phases
// are held by the engine's instruction issue and shared-memory reads (each
// staged value is read four times: by both warps of a team, for the score
// and for the aggregate), and the rel-PE table adds ~0.7 GB of writes and
// ~4.4 GB of reads a step at the demo shape.
//
// Design:
//  * One block of 16 warps owns a tile of kRows = 8 query rows through all
//    2L layers, with the rows' state in shared memory and no grid-wide
//    synchronization: the source tables and the query rows are fixed
//    within a replan step and the rows are independent. 128 registers a
//    thread (__launch_bounds__(512, 1)): 16 warps per SM. The blocks take
//    the rows in the order the wrapper gives (heaviest first), so the 8
//    rows of a block carry about as many edges: its teams meet at a
//    barrier after every layer's edges.
//  * The rel-PE is expanded once per launch, not once per layer. Before
//    layer 0 the block writes the normalized rel-PE row of each valid edge
//    of its rows, at both sites, into a scratch table z [B, N, K, Pz] (Pz =
//    P rounded up to 4, the padding zero) that the wrapper allocates: one
//    warp per edge, sinf (not the fast intrinsic: arguments reach several
//    hundred radians) of the product and the sum rounded apart, the
//    duplicated 4th feature reusing the 3rd's sines, then the parameter-free
//    LayerNorm. An invalid edge's row is neither written nor read.
//  * The k|v projections fold onto the query side (as
//    prosim_torch/ops/attention.py does), so an edge costs 2 H (D + P)
//    multiply-adds and not 2 (D + P) 2I:
//      score: q_h . k_h[k] = x_g[k] . (wkv_k[:, h] q_h) + z[k] . (wkvr_k[:, h] q_h)
//             + q_h . bkv_k[h], and the last term is constant over k;
//      value: v_h = (sum_k a_k x_g[k]) wkv_v[:, h] + (sum_k a_k z[k]) wkvr_v[:, h]
//             + bkv_v[h] * any(valid).
//  * The edge phase is csrc/edge_attn.cu's tile engine (the same function:
//    a masked softmax of x_g . qx_h + z . qp_h and the per-head aggregates
//    of [x_g | z]). Row t of the tile belongs to team t, warps 2t and
//    2t + 1; warp hh of a team holds the folded queries and the [D + P]
//    accumulators of heads hh HH .. hh HH + HH - 1 (HH = ceil(H / 2) <= 4)
//    for the columns 4 lane .. 4 lane + 3 of each table. The team compacts
//    its row's valid edges by ballot (an invalid edge's idx is never
//    dereferenced), streams them in tiles of 8 edges through a two-stage
//    cp.async ring (the x_src_n rows gathered by idx, which the L2 holds,
//    and the z rows), reduces each tile's 32 partial scores with one
//    31-shuffle transpose, and takes one online-softmax step per tile and
//    head. The rings (8 teams x 2 stages x 8 edges x 256 floats, 128 KB)
//    alias the dense phases' buffers, which are dead while the edges
//    stream; the queries are in registers by then, and the aggregates are
//    written back after every team is done.
//  * The dense products around it (to_q, the folds, to_g, to_s, to_out, the
//    FFN) run on all 8 rows at once, one output column per thread, so every
//    weight read from device memory (or L2: both sites' packed weights are
//    13.4 MB at the demo width) serves the whole tile.
//  * No atomics; every sum runs in a fixed order, so results are bitwise
//    reproducible, whatever the row order.
// The cp.async wrappers, lds4 and the storage-type conversions (to_f /
// from_f / round_to) come from csrc/edge_common.cuh, which edge_attn.cu
// includes too. Copied from csrc/edge_attn.cu and fitted to this block's
// layout: reduce_half / reduce_scatter32 (the transpose reduction),
// team_sync, stage_tile, and the compaction and the tile loop of
// edge_attn_kernel.
//
// The f32 path (fused_stack_launch) is fused_stack_kernel<float> above.
//
// The bf16 path (fused_stack_launch_bf16: x, the source tokens, the packed
// weights, the rel-PE scratch table and the output in bf16, the TPU
// kernel's model dtype; the raw rel-PE features, every sum and the rows'
// state in shared memory f32) is fused_stack_kernel_mma below. It replaces
// the same TPU kernel with its products on the tensor cores, as the TPU
// kernel runs them on its matrix unit (`_dot`, bf16 in, f32 accumulate,
// prosim_tpu/ops/fused_stack.py:153-154):
//  * The same block (16 warps, 8 query rows, rows heaviest first), rel-PE
//    pass, norms and k|v fold onto the queries as the f32 path.
//  * The edge phases run on the bf16 edge engine of csrc/edge_mma.cuh, which
//    csrc/edge_attn.cu's bf16 path shares (team t = warps 2t, 2t + 1 runs
//    row t; 16-edge tiles; score and aggregate as mma.sync products; a
//    2-stage ring of 16.5 KB a team at the demo widths). The folded
//    queries enter it rounded to bf16, and the per-head aggregates leave it
//    rounded to bf16 (the value fold's operand). At the demo shape the
//    card's gate reads the kernel's error at 0.8x the bf16 plain
//    version's, inside its 2x rule, so they are not split into hi and lo
//    parts.
//  * The dense products (to_q, the query and value folds, to_g, to_s,
//    to_out, the FFN) run as out^T = W^T in^T: the weight's 16-column
//    blocks on mma's M, the block's 8 rows on its n8, k on K, f32
//    accumulators, the bias, activation and bf16 rounding in the epilogue at
//    the TPU kernel's cast points (:183-226). The weights stream through two
//    68 KB shared-memory slabs by cp.async (ldmatrix.trans reads them as A),
//    one slab ahead, and the last slab of each product overlaps the first
//    of the next; the rows' inputs are read as B from shared memory, their
//    rows 8 mod 32 banks apart.
// What bounds it on the H100: bytes. Every layer reads each valid edge's
// gathered x row (from L2) and z row (256 B from device memory: the table is
// 369 MB at the demo shape, beyond the L2), 4.4 GB a launch, and every
// block streams all 12 layers' weights (6.5 MB) from L2, 1.7 GB a launch;
// the operations (~86 GFLOP) take ~0.09 ms on the tensor cores. The ring,
// the slabs and the spills of the 128 registers a thread leaves (16 warps a
// SM) bound how many of those bytes are in flight.

#include <math.h>

#include "edge_common.cuh"
#include "edge_mma.cuh"

namespace {

constexpr int kRows = 8;              // query rows per block
constexpr int kTeams = kRows;         // team t runs row t's edges
constexpr int kWarps = 2 * kTeams;
constexpr int kThreads = 32 * kWarps;
constexpr int kTeamThreads = 64;
constexpr int kMaxH = 8;
constexpr int kHH = 4;                // heads per warp of a team
constexpr int kMaxJ = 4;              // columns per lane of a warp's row: D, P <= 32 * kMaxJ
constexpr int kDx = 32 * kMaxJ;       // staged edge row: x at [0, D), z at [kDx, kDx + P)
constexpr int kCs = 2 * kDx;          // floats per staged edge row (a constant stride keeps
                                      // the tile's addresses immediate offsets of one register)
constexpr int kTile = 8;              // edges per tile
constexpr int kStages = 2;
constexpr int kListCap = 256;         // list entries per team and pass
constexpr int kFields = 23;
constexpr unsigned kFull = 0xffffffffu;

// packed field order of prosim_torch/ops/fused_stack.py:_FIELDS
enum Field { GD, BD, WQ, BQ, WKV, WKVR, BKV, WG, BG, WS, BS2, WO, BO,
             PNG, PNB, F1G, F1B, W0, B0, W1, B1, F2G, F2B };
enum Act { kNone, kRelu, kSigmoid };

template <typename T>
struct Site {
  const T* src;                // [B, S, D] parameter-free-normalized source tokens
  const int* idx;              // [B, N, K]
  const float* feats;          // [B, N, K, F] raw rel-PE features
  const unsigned char* valid;  // [B, N, K]
  T* z;                        // [B, N, K, Pz] scratch: the normalized rel-PE
  const T* w[kFields];         // packed fields, each stacked over L
  int S, K;
};

struct Dims {
  int R, N, L, D, H, hd, I, F, P;  // R = B N query rows
  int Pz;    // z row stride: P rounded up to 16 bytes (4 floats, 8 bf16)
  int tb;    // bytes of the storage type
  bool vec;  // D a multiple of 16 bytes and src 16-byte aligned: x rows by 16-byte copies
  float scale;
};

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Offsets (floats) into the block's dynamic shared memory, each a multiple
// of 4. The edge rings share the region from `ring` on with the dense
// buffers vec, big, qa and red.
struct Layout {
  int xs, cat, any, wsm, count, rowid, list, vec, big, qa, red, ring, total, ldv, ldb;
};

__host__ __device__ inline Layout layout(const Dims& d) {
  Layout o;
  o.ldv = imax(d.I, d.D);
  o.ldb = imax(4 * d.D, 2 * d.I);
  int at = 0;
  o.xs = at;    at += up4(kRows * d.D);               // [kRows][D]     the residual stream
  o.cat = at;   at += up4(kRows * (d.I + d.D));       // [kRows][I + D] agg | xn
  o.any = at;   at += up4(kRows);                     // [kRows]
  o.wsm = at;   at += kWarps * (kTile * kHH + kHH);   // [kWarps][tile weights | rescales]
  o.count = at; at += up4(kTeams);                    // [kTeams] ints
  o.rowid = at; at += up4(kRows);                     // [kRows] ints: b N + n, -1 past the end
  o.list = at;  at += 2 * kTeams * kListCap;          // [kTeams][edge k | source s][kListCap] ints
  o.ring = at;                                        // [kTeams][kStages][kTile][kCs]
  o.vec = at;   at += up4(kRows * o.ldv);             // [kRows][ldv]
  o.big = at;   at += up4(kRows * o.ldb);             // [kRows][ldb]
  o.qa = at;    at += up4(kRows * d.H * (d.D + d.P)); // [kRows][H][D + P]
  o.red = at;   at += kThreads * kRows;               // rowmat's split sums
  o.total = imax(at, o.ring + (kTeams * kStages * kTile * kCs * d.tb + 3) / 4);
  return o;
}

__device__ __forceinline__ int field_size(int f, const Dims& d) {
  switch (f) {
    case WQ: case WS: case WO: return d.D * d.I;
    case BQ: case BG: case BS2: return d.I;
    case WKV: return d.D * 2 * d.I;
    case WKVR: return d.P * 2 * d.I;
    case BKV: return 2 * d.I;
    case WG: return (d.I + d.D) * d.I;
    case W0: case W1: return 4 * d.D * d.D;
    case B0: return 4 * d.D;
    default: return d.D;  // LayerNorm affines, bo, b1
  }
}

template <typename T>
__device__ __forceinline__ const T* weight(const Site<T>& s, int f, int l, const Dims& d) {
  return s.w[f] + (size_t)l * field_size(f, d);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Parameter-free LayerNorm of one row of n <= 128 values, run by one warp
// (flax statistics: mean, then the fast variance max(E[x^2] - mean^2, 0),
// eps 1e-5), then the affine: out = (residual ? out : 0) + norm * g + b,
// each step rounded through T.
template <typename T>
__device__ void warp_norm(const float* in, float* out, int n, const T* __restrict__ g,
                          const T* __restrict__ b, bool residual, int lane) {
  float v[kMaxJ];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < n ? in[c] : 0.f;
    s += v[j];
    ss = fmaf(v[j], v[j], ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / n;
  const float r = rsqrtf(fmaxf(ss / n - mu * mu, 0.f) + 1e-5f);
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int c = lane + 32 * j;
    if (c < n) {
      const float y = round_to<T>(round_to<T>((v[j] - mu) * r) * to_f(g[c]));
      out[c] = residual ? round_to<T>(round_to<T>(out[c] + y) + to_f(b[c]))
                        : round_to<T>(y + to_f(b[c]));
    }
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kSigmoid) return 1.f / (1.f + expf(-v));
  return v;
}

// The TPU kernel's casts around a product: a plain one rounds, then its
// bias is added and the sum rounds (`_dot(.).astype(dt) + b`); an activated
// one adds its bias in f32 and rounds after the activation; one without a
// bias (the value fold, which its caller rounds) stays f32.
template <typename T>
__device__ __forceinline__ float epilogue(float acc, float bj, bool has_bias, int act) {
  if constexpr (sizeof(T) == sizeof(float)) {
    return activate(acc + bj, act);
  } else {
    if (act != kNone) return round_to<T>(activate(acc + bj, act));
    return has_bias ? round_to<T>(round_to<T>(acc) + bj) : acc;
  }
}

// out[t][j] = act(bias[j] + sum_k in_j[t][k] W[k][j]) for the block's kRows
// rows t and j < Nd. W's Kd = k1 + k2 rows are w1's k1 rows, then w2's k2
// rows, both with leading dimension ldw. in_j[t] = in + t * ldi + (j / hd) *
// ldh: ldh is 0 except in the value fold, where column j reads the
// aggregates of its head. One output column per thread and all kRows rows
// at once, so each weight is read once per block; when Nd < kThreads the
// K range is split across thread groups, whose partial sums are added in a
// fixed order. bias may be null. The results are rounded through T as
// `epilogue` says. Ends with __syncthreads().
template <typename T>
__device__ void rowmat(const float* in, int ldi, int ldh, int hd, const T* __restrict__ w1,
                       int k1, const T* __restrict__ w2, int k2, int ldw, int Nd,
                       const T* __restrict__ bias, int act, float* out, int ldo, float* red) {
  const int tid = threadIdx.x;
  const int Kd = k1 + k2;
  const int split = Nd >= kThreads ? 1 : kThreads / Nd;
  const int used = split == 1 ? kThreads : split * Nd;
  if (tid < used) {
    const int part = split == 1 ? 0 : tid / Nd;
    const int k0 = part * Kd / split, kend = (part + 1) * Kd / split;
    const int step = split == 1 ? kThreads : Nd;
    for (int j = split == 1 ? tid : tid % Nd; j < Nd; j += step) {
      const float* inj = in + (ldh ? (j / hd) * ldh : 0);
      float acc[kRows];
#pragma unroll
      for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
      for (int k = k0; k < min(kend, k1); ++k) {
        const float w = to_f(w1[(size_t)k * ldw + j]);
#pragma unroll
        for (int t = 0; t < kRows; ++t) acc[t] = fmaf(inj[t * ldi + k], w, acc[t]);
      }
      for (int k = max(k0, k1); k < kend; ++k) {
        const float w = to_f(w2[(size_t)(k - k1) * ldw + j]);
#pragma unroll
        for (int t = 0; t < kRows; ++t) acc[t] = fmaf(inj[t * ldi + k], w, acc[t]);
      }
      if (split == 1) {
        const float bj = bias ? to_f(bias[j]) : 0.f;
#pragma unroll
        for (int t = 0; t < kRows; ++t)
          out[t * ldo + j] = epilogue<T>(acc[t], bj, bias != nullptr, act);
      } else {
#pragma unroll
        for (int t = 0; t < kRows; ++t) red[(part * kRows + t) * Nd + j] = acc[t];
      }
    }
  }
  if (split > 1) {
    __syncthreads();
    for (int i = tid; i < kRows * Nd; i += kThreads) {
      const int t = i / Nd, j = i - t * Nd;
      float s = 0.f;
      for (int p = 0; p < split; ++p) s += red[(p * kRows + t) * Nd + j];
      out[t * ldo + j] = epilogue<T>(s, bias ? to_f(bias[j]) : 0.f, bias != nullptr, act);
    }
  }
  __syncthreads();
}

// Folds each row's query onto the source and rel-PE columns, per head:
// qa[t][h][c] = sum_{e < hd} W[c][h hd + e] q[t][h hd + e], with W = wkv
// (its k half) for c < D and W = wkvr for D <= c < D + P. One (column, head)
// per thread for all rows: the thread reads its weights 4 at a time
// (hd % 4 == 0), and the queries are shared-memory broadcasts. f32 out.
template <typename T>
__device__ void fold_queries(const float* q, int ldq, const T* __restrict__ wkv,
                             const T* __restrict__ wkvr, float* qa, const Dims& d) {
  const int C = d.D + d.P;
  for (int it = threadIdx.x; it < C * d.H; it += kThreads) {
    const int h = it / C, c = it - h * C;
    const T* wrow = c < d.D ? wkv + (size_t)c * 2 * d.I : wkvr + (size_t)(c - d.D) * 2 * d.I;
    float acc[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
    for (int i = h * d.hd; i < (h + 1) * d.hd; i += 4) {
      const float4 w = lds4(wrow + i);
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        const float* qt = q + t * ldq + i;
        acc[t] = fmaf(w.w, qt[3], fmaf(w.z, qt[2], fmaf(w.y, qt[1], fmaf(w.x, qt[0], acc[t]))));
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) qa[(t * d.H + h) * C + c] = acc[t];
  }
}

// Writes the normalized rel-PE row of every valid edge of the block's rows
// (rowid) at one site into s.z (the padding columns P..Pz zero), one warp
// per edge, lane l holding the columns l + 32 j. Each warp takes chunks of
// 32 edges of a row; an invalid edge is skipped. The sines round through T
// before the statistics, and the row rounds once as it is stored.
template <typename T>
__device__ void expand_pe(const Site<T>& s, const int* rowid, const Dims& d,
                          const float* __restrict__ fc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int P = d.P, F = d.F, K = s.K;
  const int npf = P / F;
  float fr[kMaxJ], ph[kMaxJ];
  int fi[kMaxJ];
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int c = lane + 32 * j;
    fr[j] = c < P ? fc[c] : 0.f;
    ph[j] = c < P ? fc[P + c] : 0.f;
    fi[j] = c < P ? c / npf : 0;
  }
  // bit j: the lane's column j has the frequency and phase of its column
  // j - 1 (with npf = 32 a lane's columns are one frequency in each
  // feature's block)
  unsigned twins = 0;
#pragma unroll
  for (int j = 1; j < kMaxJ; ++j)
    if (lane + 32 * j < P && fr[j] == fr[j - 1] && ph[j] == ph[j - 1]) twins |= 1u << j;
  const int chunks = (K + 31) >> 5;
  for (int it = warp; it < kRows * chunks; it += kWarps) {
    const int t = it / chunks, c0 = (it - t * chunks) * 32;
    if (rowid[t] < 0) break;  // later items are past the end too
    const size_t rg = rowid[t];
    const int e = c0 + lane;
    const bool ok = e < K && s.valid[rg * K + e] != 0;
    const float* f_row = s.feats + rg * K * F;
    if (ok) asm volatile("prefetch.global.L1 [%0];" ::"l"(f_row + (size_t)e * F));
    T* z_row = s.z + rg * K * d.Pz;
    for (unsigned bal = __ballot_sync(kFull, ok); bal; bal &= bal - 1) {
      const int k = c0 + __ffs(bal) - 1;
      const float* fe = f_row + (size_t)k * F;
      float v[kMaxJ];
      float sum = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        // the product and the sum rounded apart, as the plain version and
        // XLA compute feats @ m1 + phase; contracting them into an fma would
        // move sin by up to an ulp of a ~300 rad argument. A column at the
        // same frequency and phase as the lane's previous one (bit j of
        // `twins`) whose feature has the same value there (the reference's
        // duplicated rel_ori_vec) reuses that sine: the argument is the same.
        float z = 0.f;
        if (j > 0 && ((twins >> j) & 1u) && fe[fi[j]] == fe[fi[j > 0 ? j - 1 : 0]])
          z = v[j > 0 ? j - 1 : 0];
        else if (lane + 32 * j < P)
          z = round_to<T>(sinf(__fadd_rn(__fmul_rn(fe[fi[j]], fr[j]), ph[j])));
        v[j] = z;
        sum += z;
        ss = fmaf(z, z, ss);
      }
      sum = warp_sum(sum);
      ss = warp_sum(ss);
      const float mu = sum / P;
      const float r = rsqrtf(fmaxf(ss / P - mu * mu, 0.f) + 1e-5f);
      T* zr = z_row + (size_t)k * d.Pz;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int c = lane + 32 * j;
        if (c < d.Pz) zr[c] = from_f<T>(c < P ? (v[j] - mu) * r : 0.f);
      }
    }
  }
}

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

// Stage the x and z rows of list entries [e0, e0 + n) into `st`, edges hh,
// hh + 2, ... by warp hh of the team, and zero the rows n..kTile-1 (a
// partial tile is computed in full; its extra edges get no weight). x rows
// go by 16-byte copies (d.vec), else value by value; z rows (of Pz values,
// a multiple of 16 bytes) by 16-byte copies. The ring aliases other
// buffers, so x's padding columns D..up4(D) are zeroed too; z's come zero
// from the table. Columns past those are never read.
template <typename T>
__device__ __forceinline__ void stage_tile(T* st, const T* __restrict__ xs_b,
                                           const T* __restrict__ z_row, const int* lk,
                                           const int* ls, int e0, int n, const Dims& d, int hh,
                                           int lane) {
  constexpr int per16 = 16 / sizeof(T);  // values of T in a 16-byte copy
  for (int e = hh; e < n; e += 2) {
    const T* xrow = xs_b + (size_t)ls[e0 + e] * d.D;
    const T* zrow = z_row + (size_t)lk[e0 + e] * d.Pz;
    T* dst = st + e * kCs;
    if (d.vec) {
      if (per16 * lane < d.D) cp_async16(dst + per16 * lane, xrow + per16 * lane);
    } else {
      for (int c = lane; c < d.D; c += 32) copy_value(dst + c, xrow + c);
      if (d.D + lane < up4(d.D)) dst[d.D + lane] = from_f<T>(0.f);
    }
    if (per16 * lane < d.Pz) cp_async16(dst + kDx + per16 * lane, zrow + per16 * lane);
  }
  cp_async_commit();
  for (int i = 32 * hh + lane; i < (kTile - n) * kCs; i += kTeamThreads)
    st[n * kCs + i] = from_f<T>(0.f);
}

// The edges of one site and layer: team t runs row rowid[t]. On entry qa
// holds the rows' folded queries [kRows][H][D + P]; on exit the per-head
// aggregates sum_k a_k [x_g[k] | z[k]] over the row's valid edges (a the
// masked softmax), and any[t] = 1 if row t has a valid edge. Starts and
// ends with __syncthreads().
template <typename T>
__device__ __forceinline__ void edge_phase(const Site<T>& s, const int* rowid, const Dims& d,
                                           const Layout& o, float* sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = warp >> 1;
  const int hh = warp & 1;
  const int row = rowid[team];
  const int D = d.D, P = d.P, C = D + P, K = s.K;
  const int HH = (d.H + 1) >> 1;
  const int h0 = hh * HH;
  const int nh = max(0, min(HH, d.H - h0));
  const int c0 = 4 * lane;
  const bool own_x = c0 < D, own_z = c0 < P;
  float* qa_t = sm + o.qa + team * d.H * C;

  float q[kHH][8];
  float acc[kHH][8];
#pragma unroll
  for (int i = 0; i < kHH; ++i) {
    const float* qh = qa_t + (h0 + i) * C;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      q[i][t] = (i < nh && c0 + t < D) ? qh[c0 + t] : 0.f;
      q[i][4 + t] = (i < nh && c0 + t < P) ? qh[D + c0 + t] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[i][t] = 0.f;
  }
  float m = -INFINITY;  // running max and denominator of head h0 + lane % kHH
  float l = 0.f;
  __syncthreads();  // every query is in registers: the rings may overwrite qa

  if (row >= 0) {
    const int stage_floats = kStages * kTile * kCs;  // values of T
    T* stage = reinterpret_cast<T*>(sm + o.ring) + team * stage_floats;
    int* list_k = reinterpret_cast<int*>(sm + o.list) + 2 * team * kListCap;
    int* list_s = list_k + kListCap;
    int* count = reinterpret_cast<int*>(sm + o.count);
    float* wsm = sm + o.wsm + warp * (kTile * kHH + kHH);
    float* csm = wsm + kTile * kHH;
    const size_t rg = row;
    const T* xs_b = s.src + (size_t)(row / d.N) * s.S * D;
    const T* z_row = s.z + rg * K * d.Pz;
    const int* idx_row = s.idx + rg * K;
    const unsigned char* v_row = s.valid + rg * K;

    for (int base = 0; base < K; base += kListCap) {
      // compact the valid edges of [base, base + kListCap) in edge order;
      // all flags and indices are loaded first, so their latencies overlap
      if (hh == 0) {
        constexpr int kChunks = kListCap / 32;
        bool v[kChunks];
        int src[kChunks];
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int k = base + 32 * c + lane;
          v[c] = k < K && v_row[k] != 0;
          src[c] = v[c] ? idx_row[k] : 0;
        }
        int n = 0;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const unsigned mask = __ballot_sync(kFull, v[c]);
          if (v[c]) {
            const int at = n + __popc(mask & ((1u << lane) - 1));
            list_k[at] = base + 32 * c + lane;
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
          stage_tile(stage + u * kTile * kCs, xs_b, z_row, list_k, list_s, u * kTile,
                     min(kTile, n - u * kTile), d, hh, lane);
        else
          cp_async_commit();
      }
      for (int t = 0; t < tiles; ++t) {
        cp_async_wait<kStages - 2>();
        team_sync(team);  // tile t visible to the team; tile t - 1 consumed by both warps
        const int u = t + kStages - 1;
        if (u < tiles)
          stage_tile(stage + (u % kStages) * kTile * kCs, xs_b, z_row, list_k, list_s,
                     u * kTile, min(kTile, n - u * kTile), d, hh, lane);
        else
          cp_async_commit();
        if (nh == 0) continue;  // warp-uniform: a warp without heads only stages
        const T* st = stage + (t % kStages) * kTile * kCs;
        const int nt = min(kTile, n - t * kTile);
        float p[kTile * kHH];
#pragma unroll
        for (int e = 0; e < kTile; ++e) {
          const float4 x = own_x ? lds4(st + e * kCs + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 z = own_z ? lds4(st + e * kCs + kDx + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
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
        const float sc = (lane >> 2) < nt ? sum * d.scale : -INFINITY;
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
          for (int t2 = 0; t2 < 8; ++t2) acc[i][t2] *= cf[i];
#pragma unroll
        for (int e = 0; e < kTile; ++e) {
          const float4 w4 = lds4(wsm + e * kHH);
          const float w[kHH] = {w4.x, w4.y, w4.z, w4.w};
          const float4 x = own_x ? lds4(st + e * kCs + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 z = own_z ? lds4(st + e * kCs + kDx + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
          const float v[8] = {x.x, x.y, x.z, x.w, z.x, z.y, z.z, z.w};
#pragma unroll
          for (int i = 0; i < kHH; ++i)
#pragma unroll
            for (int t2 = 0; t2 < 8; ++t2) acc[i][t2] = fmaf(w[i], v[t2], acc[i][t2]);
        }
      }
      team_sync(team);  // the list and the ring are free again
    }
  }

  __syncthreads();  // every team is done with its ring: qa may be written
#pragma unroll
  for (int i = 0; i < kHH; ++i) {
    if (i < nh) {  // warp-uniform
      const float L = __shfl_sync(kFull, l, i);
      const bool ok = L > 0.f;
      float* out = qa_t + (h0 + i) * C;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (c0 + t < D) out[c0 + t] = ok ? acc[i][t] / L : 0.f;
        if (c0 + t < P) out[D + c0 + t] = ok ? acc[i][4 + t] / L : 0.f;
      }
    }
  }
  // lane 0 of the team's first warp holds head 0's denominator
  if (hh == 0 && lane == 0) sm[o.any + team] = l > 0.f ? 1.f : 0.f;
  __syncthreads();
}

// One GatedNeighborAttention layer of one site on the block's rows.
template <typename T>
__device__ void site_layer(const Site<T>& s, int l, const int* rowid, const Dims& d,
                           const Layout& o, float* sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = d.D, I = d.I, P = d.P, C = D + P, ldc = I + D, ldv = o.ldv, ldb = o.ldb;
  float *xs = sm + o.xs, *cat = sm + o.cat, *vec = sm + o.vec, *big = sm + o.big;
  float *qa = sm + o.qa, *red = sm + o.red, *any = sm + o.any;
  auto W = [&](int f) { return weight(s, f, l, d); };

  // xn = LN_dst(x), kept in cat[:, I:] (cat = [agg | xn] feeds to_g)
  if (warp < kRows) warp_norm(xs + warp * D, cat + warp * ldc + I, D, W(GD), W(BD), false, lane);
  __syncthreads();
  // q = xn Wq + bq, folded onto the source and rel-PE columns per head
  rowmat<T>(cat + I, ldc, 0, 1, W(WQ), D, nullptr, 0, I, I, W(BQ), kNone, vec, ldv, red);
  fold_queries(vec, ldv, W(WKV), W(WKVR), qa, d);
  __syncthreads();
  // the edges: per-head aggregates over [x_g | z] into qa
  edge_phase(s, rowid, d, o, sm);
  // agg = the aggregates through the v halves of wkv / wkvr, + bkv_v * any
  rowmat<T>(qa, d.H * C, C, d.hd, W(WKV) + I, D, W(WKVR) + I, P, 2 * I, I, nullptr, kNone,
            cat, ldc, red);
  const T* bkv = W(BKV);
  for (int i = threadIdx.x; i < kRows * I; i += kThreads) {
    const int t = i / I, j = i - t * I;
    cat[t * ldc + j] = round_to<T>(cat[t * ldc + j] + to_f(bkv[I + j]) * any[t]);
  }
  __syncthreads();
  // gate g = sigmoid(to_g [agg, xn]) and s = to_s(xn), then the gated update
  rowmat<T>(cat, ldc, 0, 1, W(WG), I + D, nullptr, 0, I, I, W(BG), kSigmoid, big, ldb, red);
  rowmat<T>(cat + I, ldc, 0, 1, W(WS), D, nullptr, 0, I, I, W(BS2), kNone, big + I, ldb, red);
  for (int i = threadIdx.x; i < kRows * I; i += kThreads) {
    const int t = i / I, j = i - t * I;
    const float agg = cat[t * ldc + j];
    vec[t * ldv + j] =
        round_to<T>(agg + round_to<T>(big[t * ldb + j] * round_to<T>(big[t * ldb + I + j] - agg)));
  }
  __syncthreads();
  rowmat<T>(vec, ldv, 0, 1, W(WO), I, nullptr, 0, D, D, W(BO), kNone, big, ldb, red);
  // x += LN_post(out); ff_in = LN_ff(x) (warp t owns row t in both)
  if (warp < kRows) {
    warp_norm(big + warp * ldb, xs + warp * D, D, W(PNG), W(PNB), true, lane);
    __syncwarp();
    warp_norm(xs + warp * D, vec + warp * ldv, D, W(F1G), W(F1B), false, lane);
  }
  __syncthreads();
  // FFN, then x += LN_ffpost(ff)
  rowmat<T>(vec, ldv, 0, 1, W(W0), D, nullptr, 0, 4 * D, 4 * D, W(B0), kRelu, big, ldb, red);
  rowmat<T>(big, ldb, 0, 1, W(W1), 4 * D, nullptr, 0, D, D, W(B1), kNone, vec, ldv, red);
  if (warp < kRows)
    warp_norm(vec + warp * ldv, xs + warp * D, D, W(F2G), W(F2B), true, lane);
  __syncthreads();
}

// Block i runs the query rows order[8 i .. 8 i + 7] (b N + n, a permutation
// of the B N rows). o = layout(d), computed on the host: its offsets are
// read from the parameter bank and hold no registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_stack_kernel(
    const T* __restrict__ x_in, T* __restrict__ x_out, const int* __restrict__ order,
    const Site<T> a, const Site<T> mp, const float* __restrict__ fc, const Dims d,
    const Layout o) {
  extern __shared__ __align__(16) float sm[];
  const int D = d.D;
  int* rowid = reinterpret_cast<int*>(sm + o.rowid);
  if (threadIdx.x < kRows) {
    const int slot = blockIdx.x * kRows + threadIdx.x;
    rowid[threadIdx.x] = slot < d.R ? order[slot] : -1;
  }
  __syncthreads();
  // the rel-PE of both sites, once for all layers
  expand_pe(a, rowid, d, fc);
  expand_pe(mp, rowid, d, fc);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int g = rowid[i / D];
    sm[o.xs + i] = g >= 0 ? to_f(x_in[(size_t)g * D + i % D]) : 0.f;
  }
  __syncthreads();  // the block's z rows are written before any layer reads them
  for (int l = 0; l < d.L; ++l) {
    site_layer(a, l, rowid, d, o, sm);
    site_layer(mp, l, rowid, d, o, sm);
  }
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int g = rowid[i / D];
    if (g >= 0) x_out[(size_t)g * D + i % D] = from_f<T>(sm[o.xs + i]);
  }
}

template <typename T>
Site<T> make_site(const T* src, const int* idx, const float* feats, const unsigned char* valid,
                  T* z, const void* const* w, int S, int K) {
  Site<T> s;
  s.src = src;
  s.idx = idx;
  s.feats = feats;
  s.valid = valid;
  s.z = z;
  for (int f = 0; f < kFields; ++f) s.w[f] = static_cast<const T*>(w[f]);
  s.S = S;
  s.K = K;
  return s;
}

template <typename T>
Dims make_dims(int R, int N, int L, int D, int H, int hd, int F, int P, float scale) {
  constexpr int per16 = 16 / sizeof(T);  // values of T in 16 bytes
  Dims d{};
  d.R = R;
  d.N = N;
  d.L = L;
  d.D = D;
  d.H = H;
  d.hd = hd;
  d.I = H * hd;
  d.F = F;
  d.P = P;
  d.Pz = (P + per16 - 1) / per16 * per16;
  d.tb = sizeof(T);
  d.vec = false;
  d.scale = scale;
  return d;
}

size_t smem_bytes(const Dims& d) { return sizeof(float) * (size_t)layout(d).total; }

template <typename T>
int launch(const T* x, T* out, const int* order, const T* src_a, const int* idx_a,
           const float* feats_a, const unsigned char* valid_a, const T* src_m, const int* idx_m,
           const float* feats_m, const unsigned char* valid_m, T* z_a, T* z_m,
           const void* const* w_a, const void* const* w_m, const float* fconst, int B, int N,
           int Sa, int Ka, int Sm, int Km, int L, int D, int H, int hd, int F, int P, float scale,
           void* stream) {
  const int I = H * hd;
  if (B < 1 || N < 1 || H < 1 || H > kMaxH || hd < 4 || hd % 4 != 0 || I > 32 * kMaxJ ||
      D < 1 || D > 32 * kMaxJ || P < 1 || P > 32 * kMaxJ || F < 1 || P % F != 0 || Ka < 0 ||
      Km < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int per16 = 16 / sizeof(T);
  Dims d = make_dims<T>(B * N, N, L, D, H, hd, F, P, scale);
  d.vec = D % per16 == 0 &&
          ((reinterpret_cast<uintptr_t>(src_a) | reinterpret_cast<uintptr_t>(src_m)) & 15) == 0;
  const Site<T> a = make_site<T>(src_a, idx_a, feats_a, valid_a, z_a, w_a, Sa, Ka);
  const Site<T> m = make_site<T>(src_m, idx_m, feats_m, valid_m, z_m, w_m, Sm, Km);
  const size_t smem = smem_bytes(d);
  static size_t smem_allowed = 48 * 1024;  // one per instantiation
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const int blocks = (B * N + kRows - 1) / kRows;
  fused_stack_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(x, out, order, a, m,
                                                                          fconst, d, layout(d));
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int D, int H, int hd, int P) {
  const size_t smem = smem_bytes(make_dims<T>(1, 1, 1, D, H, hd, 1, P, 1.f));
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fused_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_stack_kernel<T>, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}


// ---- the bf16 path: tensor-core dense products and csrc/edge_mma.cuh ------

namespace em = edge_mma;

constexpr int kSlab = 34816;  // bf16 values of one staged weight slab (256 x 136); two alternate

// A row stride (floats) of the rows the dense products read as B: 8 mod
// 32, so the 8 rows of a fragment load (8 bytes a lane) fall in different
// banks.
__host__ __device__ constexpr int ld_b(int n) { return ((n + 31) & ~31) + 8; }

// Offsets (floats) into the bf16 kernel's dynamic shared memory, each a
// multiple of 4. The teams' rings share the region from `ring` on with the
// dense buffers vec, big, qa and the weight slabs.
struct LayoutMma {
  int xs, cat, any, count, rowid, list, xb, ring, vec, big, qa, slab, total;
  int ldc, ldv, ldb, qs;  // row strides of cat, vec, big (floats) and qa (bf16)
};

__host__ __device__ inline LayoutMma layout_mma(const Dims& d, const em::Cols& c) {
  LayoutMma o;
  o.ldc = ld_b(d.I + d.D);
  o.ldv = ld_b(imax(d.I, d.D));
  o.ldb = ld_b(imax(4 * d.D, 2 * d.I));
  o.qs = d.H * c.Cs + 8;  // a row's 32-bit words 4 mod 32 banks apart (H Cs / 2 is 0 or 16 mod 32)
  int at = 0;
  o.xs = at;    at += up4(kRows * d.D);                // [kRows][D]     the residual stream
  o.cat = at;   at += up4(kRows * o.ldc);              // [kRows][ldc]   agg | xn
  o.any = at;   at += up4(kRows);                      // [kRows]
  o.count = at; at += up4(kTeams);                     // [kTeams] ints
  o.rowid = at; at += up4(kRows);                      // [kRows] ints: b N + n, -1 past the end
  o.list = at;  at += 2 * kTeams * em::kListCap;       // [kTeams][edge k | source s][kListCap] ints
  o.xb = at;    at += kTeams * 2 * 32 * 4;             // [kTeams][2 warps][32] float4
  o.ring = at;                                         // [kTeams][kStages][16][c.ld] bf16
  o.vec = at;   at += up4(kRows * o.ldv);              // [kRows][ldv]
  o.big = at;   at += up4(kRows * o.ldb);              // [kRows][ldb]
  o.qa = at;    at += up4(kRows * o.qs / 2);           // [kRows][qs]: [H][Cs] bf16 a row
  o.slab = at;  at += kSlab;                           // [2][kSlab] bf16
  o.total = imax(at, o.ring + kTeams * em::ring_bytes(c) / 4);
  return o;
}

// A weight matrix of a dense product as the kernel reads it: row k < Kd is
// w1's row k for k < k1, w2's row k - k2o for k2o <= k < k2o + k2, and zero
// otherwise; each row has Nd values, rows ldw values apart. Kd = 0: none.
struct WMat {
  const bf16* w1;
  int k1;
  const bf16* w2;
  int k2o, k2, ldw, Kd, Nd;
};

__device__ __forceinline__ const unsigned short* wrow(const WMat& w, int k) {
  const bf16* r = nullptr;
  if (k < w.k1)
    r = w.w1 + (size_t)k * w.ldw;
  else if (w.w2 && k >= w.k2o && k < w.k2o + w.k2)
    r = w.w2 + (size_t)(k - w.k2o) * w.ldw;
  return reinterpret_cast<const unsigned short*>(r);
}

__device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

// Rows per slab of a weight matrix with Np staged columns: a multiple of 16.
__device__ __forceinline__ int slab_rows(int Np) { return (kSlab / (Np + 8)) & ~15; }

// Stage rows [k0, k0 + kr) of W, columns [0, Np) (Np = Nd rounded up to 16),
// into sl (row stride Np + 8) with all the block's threads: 16-byte chunks
// inside a row by cp.async (rows 16-byte aligned), others from 2-byte loads
// and zeros. One copy group per thread.
__device__ void stage_w(bf16* sl, const WMat w, int k0, int kr, int Np) {
  const int chunks = Np / 8, ld = Np + 8;
  const uintptr_t rows = reinterpret_cast<uintptr_t>(w.w1) | reinterpret_cast<uintptr_t>(w.w2);
  const bool vec = w.ldw % 8 == 0 && (rows & 15) == 0;
  for (int i = threadIdx.x; i < kr * chunks; i += kThreads) {
    const int r = i / chunks, j = 8 * (i - r * chunks);
    bf16* dst = sl + r * ld + j;
    const unsigned short* src = k0 + r < w.Kd ? wrow(w, k0 + r) : nullptr;
    if (src && vec && j + 8 <= w.Nd) {
      cp_async16(dst, src + j);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int cc = j + 2 * t;
        v[t] = em::pack_raw(src && cc < w.Nd ? src[cc] : 0, src && cc + 1 < w.Nd ? src[cc + 1] : 0);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  cp_async_commit();
}

// The weight slabs between products: buffer `buf` of the two holds (or is
// receiving) the next product's first slab when `staged`.
struct Slabs {
  int buf;
  bool staged;
};

__device__ __forceinline__ void stage_first(const WMat w, bf16* dst) {
  const int Np = pad16(w.Nd);
  stage_w(dst, w, 0, min(pad16(w.Kd), slab_rows(Np)), Np);
}

// Streams W's rows through the two slabs at `base`, one slab ahead of the
// products: compute(slab, k0, rows) for each slab of rows [k0, k0 + rows)
// (multiples of 16; rows past Kd are zero). While the last slab is
// computed, the first slab of `next` (if next.Kd > 0) is staged, so the
// next product starts on weights in flight. Ends with __syncthreads().
template <typename F>
__device__ __forceinline__ Slabs run_slabs(const WMat w, bf16* base, Slabs sl, const WMat next,
                                           F compute) {
  const int Np = pad16(w.Nd), Kp = pad16(w.Kd);
  const int kr = min(Kp, slab_rows(Np));
  const int ns = (Kp + kr - 1) / kr;
  if (!sl.staged) stage_w(base + sl.buf * kSlab, w, 0, kr, Np);
  for (int si = 0; si < ns; ++si) {
    const int k0 = si * kr;
    bf16* nb = base + ((sl.buf + si + 1) & 1) * kSlab;  // free: its slab was computed
    if (si + 1 < ns)
      stage_w(nb, w, k0 + kr, min(kr, Kp - k0 - kr), Np);
    else if (next.Kd > 0)
      stage_first(next, nb);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // slab si is in place
    compute(base + ((sl.buf + si) & 1) * kSlab, k0, min(kr, Kp - k0));
    __syncthreads();  // slab si may be staged over
  }
  return Slabs{(sl.buf + ns) & 1, next.Kd > 0};
}

// out[t][j] = epilogue(sum_k B(t, k) W(k, j)) for the block's kRows rows t
// and j < w.Nd, as out^T = W^T B^T on the tensor cores: 16 output columns
// on M (ldmatrix.trans of the staged W slab), the 8 rows on N, k on K,
// f32 accumulators; warp w takes the column blocks w, w + 16. B(t, k) =
// in[t ldi + k] (f32 values that are bf16 already: the TPU kernel's cast
// points; ldi = ld_b(.), in 8-byte aligned), or with kPerHead, for the
// value fold, the bf16 aggregates qa[t qs + h Cs + k] of each output
// column's head h = j / hd. The epilogue is `epilogue<bf16>` with the bias,
// if any, and act. Ends with __syncthreads().
template <bool kPerHead>
__device__ Slabs dense_t(const WMat w, const float* in, int ldi, const bf16* qa, int qs,
                         const Dims& d, int Cs, const bf16* __restrict__ bias, int act, float* out,
                         int ldo, bf16* base, Slabs sl, const WMat next) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int Np = pad16(w.Nd), lds = Np + 8, nmb = Np / 16;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float bj[2][2];  // the bias of the lane's output columns, loaded ahead
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = 16 * (warp + 16 * i) + gid + 8 * r;
      bj[i][r] = bias && j < w.Nd ? to_f(bias[j]) : 0.f;
    }
  const int arow = (lane & 7) + ((lane >> 4) << 3), acol = ((lane >> 3) & 1) * 8;
  sl = run_slabs(w, base, sl, next, [&](const bf16* slab, int k0, int krs) {
    for (int kk = 0; kk < krs; kk += 16) {
      const int k = k0 + kk + 2 * tig;
      uint32_t b0 = 0u, b1 = 0u;
      if (!kPerHead) {
        const float2 lo = *reinterpret_cast<const float2*>(in + gid * ldi + k);
        const float2 hi = *reinterpret_cast<const float2*>(in + gid * ldi + k + 8);
        b0 = em::pack2(k < w.Kd ? lo.x : 0.f, k + 1 < w.Kd ? lo.y : 0.f);
        b1 = em::pack2(k + 8 < w.Kd ? hi.x : 0.f, k + 9 < w.Kd ? hi.y : 0.f);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mb = warp + 16 * i;
        if (mb < nmb) {
          uint32_t a[4];
          em::ldsm_x4_t(a, slab + (kk + arow) * lds + 16 * mb + acol);
          if (!kPerHead) {
            em::mma16816(acc[i], a, b0, b1);
          } else {
            // the column block's heads; rows of A in another head are zeroed
            const int j0 = 16 * mb + gid;
            const int hlo = (16 * mb) / d.hd, hhi = min(d.H - 1, (16 * mb + 15) / d.hd);
            for (int h = hlo; h <= hhi; ++h) {
              const uint32_t* q = reinterpret_cast<const uint32_t*>(qa + gid * qs + h * Cs + k);
              const bool lo = j0 / d.hd == h, hi = (j0 + 8) / d.hd == h;
              const uint32_t am[4] = {lo ? a[0] : 0u, hi ? a[1] : 0u, lo ? a[2] : 0u,
                                      hi ? a[3] : 0u};
              em::mma16816(acc[i], am, q[0], q[4]);
            }
          }
        }
      }
    }
  });
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int mb = warp + 16 * i;
    if (mb < nmb) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 16 * mb + gid + 8 * (r >> 1), t = 2 * tig + (r & 1);
        if (j < w.Nd)
          out[t * ldo + j] = epilogue<bf16>(acc[i][r], bj[i][r >> 1], bias != nullptr, act);
      }
    }
  }
  __syncthreads();
  return sl;
}

// Folds each row's query onto the staged columns, per head, on the tensor
// cores: qa[t qs + h Cs + c] = bf16(sum_{e < hd} W(c, h hd + e) q[t][h hd +
// e]) for c < Cs, W = fold (rows c: wkv's for c < D, wkvr's for Dx <= c <
// Dx + P, zero between; its first I columns, the k half). 16 columns c on
// M (ldmatrix of the staged rows of W), the 8 rows on N, the head's e on K
// (q zero outside the head). Stages nothing ahead: the edge rings come
// next. Ends with __syncthreads().
__device__ Slabs fold_q(const WMat w, const float* q, int ldq, bf16* qa, int qs, const Dims& d,
                        int Cs, bf16* base, Slabs sl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int lds = pad16(w.Nd) + 8;
  const float* qt = q + gid * ldq;
  return run_slabs(w, base, sl, WMat{}, [&](const bf16* slab, int c0, int krs) {
    const int nmb = krs / 16;
    for (int task = warp; task < nmb * d.H; task += kWarps) {
      const int h = task / nmb, mb = task - h * nmb;
      const int e0 = h * d.hd, e1 = e0 + d.hd;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kb = e0 / 16; kb * 16 < e1; ++kb) {
        uint32_t a[4];
        em::ldsm_x4(a, slab + (16 * mb + (lane & 15)) * lds + 16 * kb + (lane >> 4) * 8);
        const int e = 16 * kb + 2 * tig;
        auto qv = [&](int i) { return i >= e0 && i < e1 ? qt[i] : 0.f; };
        em::mma16816(acc, a, em::pack2(qv(e), qv(e + 1)), em::pack2(qv(e + 8), qv(e + 9)));
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = c0 + 16 * mb + gid + 8 * (r >> 1), t = 2 * tig + (r & 1);
        qa[t * qs + h * Cs + c] = __float2bfloat16_rn(acc[r]);
      }
    }
  });
}

// The edges of one site and layer on the edge engine: team t (warps 2t and
// 2t + 1) runs row rowid[t]. On entry qa holds the rows' folded queries
// (row t at qa + t o.qs, [H][Cs] bf16); on exit the per-head aggregates of the staged
// [x_g | z] columns, rounded to bf16 (the value fold's operand), and any[t]
// = 1 if row t has a valid edge. Starts and ends with __syncthreads().
__device__ void edge_phase_mma(const Site<bf16>& s, const int* rowid, const Dims& d,
                               const em::Cols& c, const LayoutMma& o, float* sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int team = warp >> 1;
  const int hh = warp & 1;
  const int row = rowid[team];
  bf16* qt = reinterpret_cast<bf16*>(sm + o.qa) + team * o.qs;
  const unsigned short* qr = reinterpret_cast<const unsigned short*>(qt);
  em::State st;
  em::reset(st);
  em::load_queries(st, c, hh, lane, [&](int h, int cc) -> unsigned short {
    return h < d.H ? qr[h * c.Cs + cc] : 0;
  });
  __syncthreads();  // every query is in registers: the rings may overwrite qa
  if (row >= 0) {
    int* list_k = reinterpret_cast<int*>(sm + o.list) + 2 * team * em::kListCap;
    const em::Rows r{s.src + (size_t)(row / d.N) * s.S * d.D, s.z + (size_t)row * s.K * d.Pz,
                     d.Pz, d.vec, true};
    em::run_row<false>(st, reinterpret_cast<bf16*>(sm + o.ring) + team * (em::ring_bytes(c) / 2),
                       list_k, list_k + em::kListCap, reinterpret_cast<int*>(sm + o.count) + team,
                       reinterpret_cast<float4*>(sm + o.xb) + team * 64, r,
                       s.idx + (size_t)row * s.K, s.valid + (size_t)row * s.K, s.K, 1, 0, c,
                       d.scale, 1 + team, hh, lane);
  }
  __syncthreads();  // every team is done with its ring: qa may be written
  em::for_each_out(st, c, hh, lane, [&](int cc, int h, float v, bool) {
    if (h < d.H) qt[h * c.Cs + cc] = __float2bfloat16_rn(v);
  });
  // lane 0 of the team's first warp holds head 0's denominator
  if (hh == 0 && lane == 0) sm[o.any + team] = st.l[0] > 0.f ? 1.f : 0.f;
  __syncthreads();
}

// to_q's weights of layer l of a site, the first product of its layer
__device__ __forceinline__ WMat wq_mat(const Site<bf16>& s, int l, const Dims& d) {
  return WMat{weight(s, WQ, l, d), d.D, nullptr, 0, 0, d.I, d.D, d.I};
}

// One GatedNeighborAttention layer of one site on the block's rows, bf16;
// `next`: the next layer's to_q weights (staged during this layer's last
// product), or none (Kd = 0). Returns the slabs' state.
__device__ Slabs site_layer_mma(const Site<bf16>& s, int l, const int* rowid, const Dims& d,
                                const em::Cols& c, const LayoutMma& o, float* sm, Slabs sl,
                                const WMat next) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = d.D, I = d.I, P = d.P, ldc = o.ldc, ldv = o.ldv, ldb = o.ldb, Cs = c.Cs;
  float *xs = sm + o.xs, *cat = sm + o.cat, *vec = sm + o.vec, *big = sm + o.big, *any = sm + o.any;
  bf16* qa = reinterpret_cast<bf16*>(sm + o.qa);
  bf16* base = reinterpret_cast<bf16*>(sm + o.slab);
  auto W = [&](int f) { return weight(s, f, l, d); };
  auto mat = [&](int f, int Kd, int ldw, int Nd) {
    return WMat{weight(s, f, l, d), Kd, nullptr, 0, 0, ldw, Kd, Nd};
  };
  auto fold = [&](int half) {  // wkv's and wkvr's k (0) or v (1) half on the staged columns
    return WMat{W(WKV) + half * I, D, W(WKVR) + half * I, c.Dx, P, 2 * I, Cs, I};
  };

  // xn = LN_dst(x), kept in cat[:, I:] (cat = [agg | xn] feeds to_g)
  if (warp < kRows) warp_norm(xs + warp * D, cat + warp * ldc + I, D, W(GD), W(BD), false, lane);
  __syncthreads();
  // q = xn Wq + bq, folded onto the staged columns per head
  sl = dense_t<false>(wq_mat(s, l, d), cat + I, ldc, nullptr, 0, d, Cs, W(BQ), kNone, vec, ldv,
                      base, sl, fold(0));
  sl = fold_q(fold(0), vec, ldv, qa, o.qs, d, Cs, base, sl);
  // the edges: per-head aggregates over [x_g | z] into qa (the rings
  // overwrite the slabs: nothing is staged across)
  edge_phase_mma(s, rowid, d, c, o, sm);
  // agg = the aggregates through the v halves of wkv / wkvr, + bkv_v * any
  sl = dense_t<true>(fold(1), nullptr, 0, qa, o.qs, d, Cs, nullptr, kNone, cat, ldc, base, sl,
                     mat(WG, I + D, I, I));
  const bf16* bkv = W(BKV);
  for (int i = threadIdx.x; i < kRows * I; i += kThreads) {
    const int t = i / I, j = i - t * I;
    cat[t * ldc + j] = round_to<bf16>(cat[t * ldc + j] + to_f(bkv[I + j]) * any[t]);
  }
  __syncthreads();
  // gate g = sigmoid(to_g [agg, xn]) and s = to_s(xn), then the gated update
  sl = dense_t<false>(mat(WG, I + D, I, I), cat, ldc, nullptr, 0, d, Cs, W(BG), kSigmoid, big, ldb,
                      base, sl, mat(WS, D, I, I));
  sl = dense_t<false>(mat(WS, D, I, I), cat + I, ldc, nullptr, 0, d, Cs, W(BS2), kNone, big + I,
                      ldb, base, sl, mat(WO, I, D, D));
  for (int i = threadIdx.x; i < kRows * I; i += kThreads) {
    const int t = i / I, j = i - t * I;
    const float agg = cat[t * ldc + j];
    vec[t * ldv + j] = round_to<bf16>(
        agg + round_to<bf16>(big[t * ldb + j] * round_to<bf16>(big[t * ldb + I + j] - agg)));
  }
  __syncthreads();
  sl = dense_t<false>(mat(WO, I, D, D), vec, ldv, nullptr, 0, d, Cs, W(BO), kNone, big, ldb, base,
                      sl, mat(W0, D, 4 * D, 4 * D));
  // x += LN_post(out); ff_in = LN_ff(x) (warp t owns row t in both)
  if (warp < kRows) {
    warp_norm(big + warp * ldb, xs + warp * D, D, W(PNG), W(PNB), true, lane);
    __syncwarp();
    warp_norm(xs + warp * D, vec + warp * ldv, D, W(F1G), W(F1B), false, lane);
  }
  __syncthreads();
  // FFN, then x += LN_ffpost(ff)
  sl = dense_t<false>(mat(W0, D, 4 * D, 4 * D), vec, ldv, nullptr, 0, d, Cs, W(B0), kRelu, big,
                      ldb, base, sl, mat(W1, 4 * D, D, D));
  sl = dense_t<false>(mat(W1, 4 * D, D, D), big, ldb, nullptr, 0, d, Cs, W(B1), kNone, vec, ldv,
                      base, sl, next);
  if (warp < kRows) warp_norm(vec + warp * ldv, xs + warp * D, D, W(F2G), W(F2B), true, lane);
  __syncthreads();
  return sl;
}

// The bf16 kernel: block i runs the query rows order[8 i .. 8 i + 7], as
// fused_stack_kernel does.
__global__ void __launch_bounds__(kThreads, 1) fused_stack_kernel_mma(
    const bf16* __restrict__ x_in, bf16* __restrict__ x_out, const int* __restrict__ order,
    const Site<bf16> a, const Site<bf16> mp, const float* __restrict__ fc, const Dims d,
    const em::Cols c, const LayoutMma o) {
  extern __shared__ __align__(16) float sm[];
  const int D = d.D;
  int* rowid = reinterpret_cast<int*>(sm + o.rowid);
  if (threadIdx.x < kRows) {
    const int slot = blockIdx.x * kRows + threadIdx.x;
    rowid[threadIdx.x] = slot < d.R ? order[slot] : -1;
  }
  // the first layer's to_q weights stream in while the rel-PE is expanded
  stage_first(wq_mat(a, 0, d), reinterpret_cast<bf16*>(sm + o.slab));
  Slabs sl{0, true};
  __syncthreads();
  // the rel-PE of both sites, once for all layers
  expand_pe(a, rowid, d, fc);
  expand_pe(mp, rowid, d, fc);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int g = rowid[i / D];
    sm[o.xs + i] = g >= 0 ? to_f(x_in[(size_t)g * D + i % D]) : 0.f;
  }
  __syncthreads();  // the block's z rows are written before any layer reads them
  for (int l = 0; l < d.L; ++l) {
    sl = site_layer_mma(a, l, rowid, d, c, o, sm, sl, wq_mat(mp, l, d));
    sl = site_layer_mma(mp, l, rowid, d, c, o, sm, sl, l + 1 < d.L ? wq_mat(a, l + 1, d) : WMat{});
  }
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int g = rowid[i / D];
    if (g >= 0) x_out[(size_t)g * D + i % D] = from_f<bf16>(sm[o.xs + i]);
  }
}

int launch_mma(const bf16* x, bf16* out, const int* order, const bf16* src_a, const int* idx_a,
               const float* feats_a, const unsigned char* valid_a, const bf16* src_m,
               const int* idx_m, const float* feats_m, const unsigned char* valid_m, bf16* z_a,
               bf16* z_m, const void* const* w_a, const void* const* w_m, const float* fconst,
               int B, int N, int Sa, int Ka, int Sm, int Km, int L, int D, int H, int hd, int F,
               int P, float scale, void* stream) {
  const int I = H * hd;
  if (B < 1 || N < 1 || H < 1 || H > kMaxH || hd < 4 || hd % 4 != 0 || I > 32 * kMaxJ ||
      D < 1 || D > 32 * kMaxJ || P < 1 || P > 32 * kMaxJ || F < 1 || P % F != 0 || Ka < 0 ||
      Km < 0)
    return (int)cudaErrorInvalidValue;
  Dims d = make_dims<bf16>(B * N, N, L, D, H, hd, F, P, scale);
  d.vec = D % 8 == 0 &&
          ((reinterpret_cast<uintptr_t>(src_a) | reinterpret_cast<uintptr_t>(src_m)) & 15) == 0;
  const em::Cols c = em::make_cols(D, P);
  const Site<bf16> a = make_site<bf16>(src_a, idx_a, feats_a, valid_a, z_a, w_a, Sa, Ka);
  const Site<bf16> m = make_site<bf16>(src_m, idx_m, feats_m, valid_m, z_m, w_m, Sm, Km);
  const LayoutMma o = layout_mma(d, c);
  const size_t smem = sizeof(float) * (size_t)o.total;
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_stack_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const int blocks = (B * N + kRows - 1) / kRows;
  fused_stack_kernel_mma<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(x, out, order, a, m,
                                                                           fconst, d, c, o);
  return (int)cudaGetLastError();
}

size_t smem_bytes_mma(int D, int H, int hd, int P) {
  const Dims d = make_dims<bf16>(1, 1, 1, D, H, hd, 1, P, 1.f);
  return sizeof(float) * (size_t)layout_mma(d, em::make_cols(D, P)).total;
}

int blocks_per_sm_mma(int D, int H, int hd, int P) {
  const size_t smem = smem_bytes_mma(D, H, hd, P);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(fused_stack_kernel_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_stack_kernel_mma, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// order [B N] int32: the query rows (b N + n) in the order the blocks take
// them, 8 a block (any permutation; the result does not depend on it).
// w_a, w_m: host arrays of the kFields device pointers of each site's packed
// fields. z_a, z_m: scratch [B, N, K, Pz] of each site (Pz: P rounded up to
// 16 bytes), no initial contents needed. fconst [2][P]: the Fourier
// frequency and phase of each rel-PE column. The f32 instantiation;
// fused_stack_launch_bf16 takes the same arguments with x, out, the sources,
// the scratch tables and the packed fields in bf16.
extern "C" int fused_stack_launch(
    const float* x, float* out, const int* order,
    const float* src_a, const int* idx_a, const float* feats_a, const unsigned char* valid_a,
    const float* src_m, const int* idx_m, const float* feats_m, const unsigned char* valid_m,
    float* z_a, float* z_m, const void* const* w_a, const void* const* w_m, const float* fconst,
    int B, int N, int Sa, int Ka, int Sm, int Km, int L, int D, int H, int hd, int F, int P,
    float scale, void* stream) {
  return launch<float>(x, out, order, src_a, idx_a, feats_a, valid_a, src_m, idx_m, feats_m,
                       valid_m, z_a, z_m, w_a, w_m, fconst, B, N, Sa, Ka, Sm, Km, L, D, H, hd, F,
                       P, scale, stream);
}

extern "C" int fused_stack_launch_bf16(
    const bf16* x, bf16* out, const int* order,
    const bf16* src_a, const int* idx_a, const float* feats_a, const unsigned char* valid_a,
    const bf16* src_m, const int* idx_m, const float* feats_m, const unsigned char* valid_m,
    bf16* z_a, bf16* z_m, const void* const* w_a, const void* const* w_m, const float* fconst,
    int B, int N, int Sa, int Ka, int Sm, int Km, int L, int D, int H, int hd, int F, int P,
    float scale, void* stream) {
  return launch_mma(x, out, order, src_a, idx_a, feats_a, valid_a, src_m, idx_m, feats_m,
                    valid_m, z_a, z_m, w_a, w_m, fconst, B, N, Sa, Ka, Sm, Km, L, D, H, hd, F, P,
                    scale, stream);
}

// For the record of occupancy: the dynamic shared memory of a block at these
// widths, and the resident blocks of kThreads threads per SM, of each
// instantiation.
extern "C" int fused_stack_smem_bytes(int D, int H, int hd, int P) {
  return (int)smem_bytes(make_dims<float>(1, 1, 1, D, H, hd, 1, P, 1.f));
}

extern "C" int fused_stack_smem_bytes_bf16(int D, int H, int hd, int P) {
  return (int)smem_bytes_mma(D, H, hd, P);
}

extern "C" int fused_stack_blocks_per_sm(int D, int H, int hd, int P) {
  return blocks_per_sm<float>(D, H, hd, P);
}

extern "C" int fused_stack_blocks_per_sm_bf16(int D, int H, int hd, int P) {
  return blocks_per_sm_mma(D, H, hd, P);
}
