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
// Design: the source tables and the query rows are fixed within a replan
// step and the rows are independent, so one block of 8 warps owns a tile of
// 8 query rows through all 2L layers, with the rows' state in shared memory
// and no grid-wide synchronization. The TPU kernel projected every edge's
// k|v ([qt*K, D] @ [D, 2I]) to feed its matrix unit; here the projections
// fold onto the query side instead (as prosim_torch/ops/attention.py does):
//   score: q_h . k_h[k] = x_g[k] . (wkv_k[:, h] q_h) + z[k] . (wkvr_k[:, h] q_h)
//          + q_h . bkv_k[h], and the last term is constant over k;
//   value: v_h = (sum_k a_k x_g[k]) wkv_v[:, h] + (sum_k a_k z[k]) wkvr_v[:, h]
//          + bkv_v[h] * any(valid),
// which cuts the per-edge work from 2 (D + P) 2I to 2 H (D + P) multiply-adds.
// The edge phase reuses csrc/edge_attn.cu's register scheme: warp t
// compacts row t's valid edges into shared memory and streams them in
// pairs, gathering each source row by idx straight from the [B, S, D]
// normalized tokens (the next pair's rows are prefetched into L1) and
// expanding the edge's rel-PE from its F raw features (sinf, not the fast
// intrinsic: arguments reach several hundred radians; the duplicated 4th
// feature reuses the 3rd's sines), keeps the folded queries and the
// [H, D + P] accumulators of its lane's columns in registers, and runs one
// online softmax per head. The dense products around it (to_q, the folds,
// to_g, to_s, to_out, the FFN) run on all 8 rows at once, one output column
// per thread, so every weight read from device memory (or L2: both sites'
// packed weights are 13.4 MB at the demo width) serves the whole tile. No
// atomics; every sum runs in a fixed order, so results are bitwise
// reproducible.
//
// Bound on the H100: by f32 operations. At the demo shape (B=16, N=128,
// K = 160 / 768, L = 6) the inputs, read once, are ~72 MB (the packed
// weights 13.4 MB of it), while the edges alone need up to 6 x 1.9M x
// (4 H (D + P) + 8 P) ~ 105 GFLOP when every edge is valid: ~1.6 ms at
// 67 TFLOP/s against ~21 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;            // query rows per block
constexpr int kWarps = kRows;       // warp t runs row t's edges and norms
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxH = 8;
constexpr int kMaxJ = 4;            // columns per lane: D, P, I <= 32 * kMaxJ
constexpr int kCols = 2 * kMaxJ;    // source columns, then rel-PE columns
constexpr int kFields = 23;
constexpr int kChunk = 256;         // edges a warp compacts per pass
constexpr unsigned kFull = 0xffffffffu;

// packed field order of prosim_torch/ops/fused_stack.py:_FIELDS
enum Field { GD, BD, WQ, BQ, WKV, WKVR, BKV, WG, BG, WS, BS2, WO, BO,
             PNG, PNB, F1G, F1B, W0, B0, W1, B1, F2G, F2B };
enum Act { kNone, kRelu, kSigmoid };

struct Site {
  const float* src;            // [B, S, D] parameter-free-normalized source tokens
  const int* idx;              // [B, N, K]
  const float* feats;          // [B, N, K, F] raw rel-PE features
  const unsigned char* valid;  // [B, N, K]
  const float* w[kFields];     // packed fields, each stacked over L
  int S, K;
};

struct Dims {
  int N, L, D, H, hd, I, F, P;
  float scale;
};

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

__device__ __forceinline__ const float* weight(const Site& s, int f, int l, const Dims& d) {
  return s.w[f] + (size_t)l * field_size(f, d);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Sums v[h] over the warp for every h; lanes 4h..4h+3 end up holding the
// sum of v[h] (h = lane >> 2). Copied from csrc/edge_attn.cu.
__device__ __forceinline__ float reduce_scatter8(const float (&v)[kMaxH], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? v[i] : v[i + 4];
    const float keep = b4 ? v[i + 4] : v[i];
    w[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  float x[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? w[i] : w[i + 2];
    const float keep = b3 ? w[i + 2] : w[i];
    x[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
  float y = (b2 ? x[1] : x[0]) + __shfl_xor_sync(kFull, b2 ? x[0] : x[1], 4);
  y += __shfl_xor_sync(kFull, y, 2);
  y += __shfl_xor_sync(kFull, y, 1);
  return y;
}

// Parameter-free LayerNorm of one row of n <= 128 values, run by one warp
// (flax statistics: mean, then the fast variance max(E[x^2] - mean^2, 0),
// eps 1e-5), then the affine: out = (residual ? out : 0) + norm * g + b.
__device__ void warp_norm(const float* in, float* out, int n, const float* __restrict__ g,
                          const float* __restrict__ b, bool residual, int lane) {
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
      const float y = (v[j] - mu) * r * g[c];
      out[c] = residual ? (out[c] + y) + b[c] : y + b[c];
    }
  }
}

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kRelu) return fmaxf(v, 0.f);
  if (act == kSigmoid) return 1.f / (1.f + expf(-v));
  return v;
}

// out[t][j] = act(bias[j] + sum_k in_j[t][k] W[k][j]) for the block's kRows
// rows t and j < Nd. W's Kd = k1 + k2 rows are w1's k1 rows, then w2's k2
// rows, both with leading dimension ldw. in_j[t] = in + t * ldi + (j / hd) *
// ldh: ldh is 0 except in the value fold, where column j reads the
// aggregates of its head. One output column per thread and all kRows rows
// at once, so each weight is read once per block; when Nd < kThreads the
// K range is split across thread groups, whose partial sums are added in a
// fixed order. bias may be null. Ends with __syncthreads().
__device__ void rowmat(const float* in, int ldi, int ldh, int hd, const float* __restrict__ w1,
                       int k1, const float* __restrict__ w2, int k2, int ldw, int Nd,
                       const float* __restrict__ bias, int act, float* out, int ldo, float* red) {
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
        const float w = w1[(size_t)k * ldw + j];
#pragma unroll
        for (int t = 0; t < kRows; ++t) acc[t] = fmaf(inj[t * ldi + k], w, acc[t]);
      }
      for (int k = max(k0, k1); k < kend; ++k) {
        const float w = w2[(size_t)(k - k1) * ldw + j];
#pragma unroll
        for (int t = 0; t < kRows; ++t) acc[t] = fmaf(inj[t * ldi + k], w, acc[t]);
      }
      if (split == 1) {
        const float bj = bias ? bias[j] : 0.f;
#pragma unroll
        for (int t = 0; t < kRows; ++t) out[t * ldo + j] = activate(acc[t] + bj, act);
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
      out[t * ldo + j] = activate(s + (bias ? bias[j] : 0.f), act);
    }
  }
  __syncthreads();
}

// Folds each row's query onto the source and rel-PE columns, per head:
// qa[t][h][c] = sum_{e < hd} W[c][h hd + e] q[t][h hd + e], with W = wkv
// (its k half) for c < D and W = wkvr for D <= c < D + P. One column c per
// thread for all rows and heads: the thread reads its weight row as float4
// (hd % 4 == 0), L1 serving each line to the next three reads, and the
// queries are shared-memory broadcasts.
__device__ void fold_queries(const float* q, int ldq, const float* __restrict__ wkv,
                             const float* __restrict__ wkvr, float* qa, const Dims& d) {
  const int C = d.D + d.P;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float* wrow = c < d.D ? wkv + (size_t)c * 2 * d.I : wkvr + (size_t)(c - d.D) * 2 * d.I;
    for (int h = 0; h < d.H; ++h) {
      float acc[kRows];
#pragma unroll
      for (int t = 0; t < kRows; ++t) acc[t] = 0.f;
      for (int i = h * d.hd; i < (h + 1) * d.hd; i += 4) {
        const float4 w = *reinterpret_cast<const float4*>(wrow + i);
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
}

// One edge into registers: t[0..kMaxJ) the lane's columns of the gathered
// source row, t[kMaxJ..kCols) its rel-PE columns, normalized over all P.
// `ok` is warp-uniform; an invalid edge is not read.
__device__ __forceinline__ void load_edge(const float* __restrict__ x_row,
                                          const float* __restrict__ fe, int D, int P, bool ok,
                                          const float (&fr)[kMaxJ], const float (&ph)[kMaxJ],
                                          const int (&fi)[kMaxJ], unsigned twins, int lane,
                                          float (&t)[kCols]) {
  if (!ok) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) t[j] = 0.f;
    return;
  }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int c = lane + 32 * j;
    t[j] = c < D ? x_row[c] : 0.f;
    // the product and the sum rounded apart, as the plain version and XLA
    // compute feats @ m1 + phase; contracting them into an fma would move
    // sin by up to an ulp of a ~300 rad argument. A column at the same
    // frequency and phase as the lane's previous one (bit j of `twins`)
    // whose feature has the same value there (the reference's duplicated
    // rel_ori_vec) reuses that sine: the argument is the same.
    float z = 0.f;
    if (j > 0 && ((twins >> j) & 1u) && fe[fi[j]] == fe[fi[j > 0 ? j - 1 : 0]])
      z = t[kMaxJ + (j > 0 ? j - 1 : 0)];
    else if (c < P)
      z = sinf(__fadd_rn(__fmul_rn(fe[fi[j]], fr[j]), ph[j]));
    t[kMaxJ + j] = z;
    s += z;
    ss = fmaf(z, z, ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mu = s / P;
  const float r = rsqrtf(fmaxf(ss / P - mu * mu, 0.f) + 1e-5f);
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    t[kMaxJ + j] = lane + 32 * j < P ? (t[kMaxJ + j] - mu) * r : 0.f;
}

// Asks for an edge's source row and features in L1 ahead of load_edge.
__device__ __forceinline__ void prefetch_edge(const float* x_row, const float* fe, int D,
                                              int lane) {
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j)
    if (lane + 32 * j < D) asm volatile("prefetch.global.L1 [%0];" ::"l"(x_row + lane + 32 * j));
  if (lane == 0) asm volatile("prefetch.global.L1 [%0];" ::"l"(fe));
}

// One warp's row: the masked online softmax over the row's valid edges and
// the aggregates sum_k a_k [x_g[k] | z[k]] per head, written over the row's
// folded queries in qa_t [H][D + P]; any_t = 1 if the row has a valid edge.
// The warp compacts the valid edges of each chunk of kChunk into `list`
// (its own [kChunk] in shared memory), so the edge loop runs over valid
// edges only, with their source index at hand, and asks for the next
// pair's rows in L1 while it works on the current pair.
__device__ void edge_phase(const Site& s, int b, int row, bool live, const Dims& d,
                           const float* __restrict__ fc, float* qa_t, float* any_t, int2* list,
                           int lane) {
  const int D = d.D, P = d.P, H = d.H, C = D + P;
  float q[kMaxH][kCols];
  float acc[kMaxH][kCols];
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int c = lane + 32 * j;
      q[h][j] = (h < H && c < D) ? qa_t[h * C + c] : 0.f;
      q[h][kMaxJ + j] = (h < H && c < P) ? qa_t[h * C + D + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[h][j] = 0.f;
  }
  float fr[kMaxJ], ph[kMaxJ];
  int fi[kMaxJ];
  const int npf = P / d.F;
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
  float m = -INFINITY;  // running max and denominator of head lane >> 2
  float l = 0.f;
  if (live) {
    const size_t rg = (size_t)b * d.N + row;
    const int K = s.K;
    const int* idx_row = s.idx + rg * K;
    const unsigned char* v_row = s.valid + rg * K;
    const float* f_row = s.feats + rg * K * d.F;
    const float* src_b = s.src + (size_t)b * s.S * D;
    auto x_row = [&](int2 ed) { return src_b + (size_t)ed.y * D; };
    auto fe = [&](int2 ed) { return f_row + (size_t)ed.x * d.F; };
    for (int c0 = 0; c0 < K; c0 += kChunk) {
      // compact the chunk's valid edges, (edge, source index), in edge order
      int n = 0;
      for (int base = c0; base < min(c0 + kChunk, K); base += 32) {
        const int e = base + lane;
        const bool ok = e < K && v_row[e] != 0;
        const int src = e < K ? idx_row[e] : 0;
        const unsigned bal = __ballot_sync(kFull, ok);
        if (ok) list[n + __popc(bal & ((1u << lane) - 1))] = make_int2(e, src);
        n += __popc(bal);
      }
      __syncwarp();
      if (n > 0) prefetch_edge(x_row(list[0]), fe(list[0]), D, lane);
      if (n > 1) prefetch_edge(x_row(list[1]), fe(list[1]), D, lane);
      for (int i = 0; i < n; i += 2) {
        const int2 e0 = list[i];
        const bool v1 = i + 1 < n;
        const int2 e1 = v1 ? list[i + 1] : e0;
        if (i + 2 < n) prefetch_edge(x_row(list[i + 2]), fe(list[i + 2]), D, lane);
        if (i + 3 < n) prefetch_edge(x_row(list[i + 3]), fe(list[i + 3]), D, lane);
        float t0[kCols], t1[kCols];
        load_edge(x_row(e0), fe(e0), D, P, true, fr, ph, fi, twins, lane, t0);
        load_edge(x_row(e1), fe(e1), D, P, v1, fr, ph, fi, twins, lane, t1);
        float p0[kMaxH], p1[kMaxH];
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          float a = 0.f, bb = 0.f;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            a = fmaf(t0[j], q[h][j], a);
            bb = fmaf(t1[j], q[h][j], bb);
          }
          p0[h] = a;
          p1[h] = bb;
        }
        const float s0 = reduce_scatter8(p0, lane) * d.scale;
        const float s1 = v1 ? reduce_scatter8(p1, lane) * d.scale : -INFINITY;
        const float m_new = fmaxf(m, fmaxf(s0, s1));  // finite: edge e0 is valid
        const float corr = expf(m - m_new);           // 0 while m is -inf
        const float w0 = expf(s0 - m_new);
        const float w1 = v1 ? expf(s1 - m_new) : 0.f;
        l = l * corr + w0 + w1;
        m = m_new;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h) {
          if (h < H) {  // warp-uniform
            const float c = __shfl_sync(kFull, corr, 4 * h);
            const float a = __shfl_sync(kFull, w0, 4 * h);
            const float bb = __shfl_sync(kFull, w1, 4 * h);
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[h][j] = fmaf(bb, t1[j], fmaf(a, t0[j], acc[h][j] * c));
          }
        }
      }
      __syncwarp();  // the list is rewritten by the next chunk
    }
  }
  __syncwarp();  // every lane has read its queries before qa_t is overwritten
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
    if (h < H) {
      const float L = __shfl_sync(kFull, l, 4 * h);
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int c = lane + 32 * j;
        if (c < D) qa_t[h * C + c] = L > 0.f ? acc[h][j] / L : 0.f;
        if (c < P) qa_t[h * C + D + c] = L > 0.f ? acc[h][kMaxJ + j] / L : 0.f;
      }
    }
  }
  if (lane == 0) *any_t = l > 0.f ? 1.f : 0.f;  // lane 0 holds head 0's denominator
}

struct Smem {
  float *xs, *cat, *vec, *big, *qa, *red, *any;
  int2* list;
  int ldv, ldb;
};

// One GatedNeighborAttention layer of one site on the block's rows.
__device__ void site_layer(const Site& s, int l, int b, int row0, const Dims& d,
                           const float* __restrict__ fc, const Smem& m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = d.D, I = d.I, P = d.P, C = D + P, ldc = I + D;
  auto W = [&](int f) { return weight(s, f, l, d); };

  // xn = LN_dst(x), kept in cat[:, I:] (cat = [agg | xn] feeds to_g)
  warp_norm(m.xs + warp * D, m.cat + warp * ldc + I, D, W(GD), W(BD), false, lane);
  __syncthreads();
  // q = xn Wq + bq, folded onto the source and rel-PE columns per head
  rowmat(m.cat + I, ldc, 0, 1, W(WQ), D, nullptr, 0, I, I, W(BQ), kNone, m.vec, m.ldv, m.red);
  fold_queries(m.vec, m.ldv, W(WKV), W(WKVR), m.qa, d);
  __syncthreads();
  // the edges: per-head aggregates over [x_g | z] into qa
  edge_phase(s, b, row0 + warp, row0 + warp < d.N, d, fc, m.qa + warp * d.H * C,
             m.any + warp, m.list + warp * kChunk, lane);
  __syncthreads();
  // agg = the aggregates through the v halves of wkv / wkvr, + bkv_v * any
  rowmat(m.qa, d.H * C, C, d.hd, W(WKV) + I, D, W(WKVR) + I, P, 2 * I, I, nullptr, kNone,
         m.cat, ldc, m.red);
  const float* bkv = W(BKV);
  for (int i = threadIdx.x; i < kRows * I; i += kThreads) {
    const int t = i / I, j = i - t * I;
    m.cat[t * ldc + j] += bkv[I + j] * m.any[t];
  }
  __syncthreads();
  // gate g = sigmoid(to_g [agg, xn]) and s = to_s(xn), then the gated update
  rowmat(m.cat, ldc, 0, 1, W(WG), I + D, nullptr, 0, I, I, W(BG), kSigmoid, m.big, m.ldb, m.red);
  rowmat(m.cat + I, ldc, 0, 1, W(WS), D, nullptr, 0, I, I, W(BS2), kNone, m.big + I, m.ldb,
         m.red);
  for (int i = threadIdx.x; i < kRows * I; i += kThreads) {
    const int t = i / I, j = i - t * I;
    const float agg = m.cat[t * ldc + j];
    m.vec[t * m.ldv + j] = agg + m.big[t * m.ldb + j] * (m.big[t * m.ldb + I + j] - agg);
  }
  __syncthreads();
  rowmat(m.vec, m.ldv, 0, 1, W(WO), I, nullptr, 0, D, D, W(BO), kNone, m.big, m.ldb, m.red);
  // x += LN_post(out); ff_in = LN_ff(x) (warp t owns row t in both)
  warp_norm(m.big + warp * m.ldb, m.xs + warp * D, D, W(PNG), W(PNB), true, lane);
  __syncwarp();
  warp_norm(m.xs + warp * D, m.vec + warp * m.ldv, D, W(F1G), W(F1B), false, lane);
  __syncthreads();
  // FFN, then x += LN_ffpost(ff)
  rowmat(m.vec, m.ldv, 0, 1, W(W0), D, nullptr, 0, 4 * D, 4 * D, W(B0), kRelu, m.big, m.ldb,
         m.red);
  rowmat(m.big, m.ldb, 0, 1, W(W1), 4 * D, nullptr, 0, D, D, W(B1), kNone, m.vec, m.ldv, m.red);
  warp_norm(m.vec + warp * m.ldv, m.xs + warp * D, D, W(F2G), W(F2B), true, lane);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) fused_stack_kernel(
    const float* __restrict__ x_in, float* __restrict__ x_out, const Site a, const Site mp,
    const float* __restrict__ fc, const Dims d) {
  extern __shared__ float sm[];
  const int D = d.D, I = d.I;
  Smem m;
  m.ldv = max(I, D);
  m.ldb = max(4 * D, 2 * I);
  m.xs = sm;                              // [kRows][D]      the residual stream
  m.cat = m.xs + kRows * D;               // [kRows][I + D]  agg | xn
  m.vec = m.cat + kRows * (I + D);        // [kRows][ldv]
  m.big = m.vec + kRows * m.ldv;          // [kRows][ldb]
  m.qa = m.big + kRows * m.ldb;           // [kRows][H][D + P]
  m.red = m.qa + kRows * d.H * (D + d.P); // [kThreads * kRows]
  m.any = m.red + kThreads * kRows;       // [kRows]
  m.list = reinterpret_cast<int2*>(m.any + 2 * kRows);  // [kWarps][kChunk], 8-byte aligned
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = row0 + i / D;
    m.xs[i] = r < d.N ? x_in[((size_t)b * d.N + r) * D + i % D] : 0.f;
  }
  __syncthreads();
  for (int l = 0; l < d.L; ++l) {
    site_layer(a, l, b, row0, d, fc, m);
    site_layer(mp, l, b, row0, d, fc, m);
  }
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = row0 + i / D;
    if (r < d.N) x_out[((size_t)b * d.N + r) * D + i % D] = m.xs[i];
  }
}

Site make_site(const float* src, const int* idx, const float* feats, const unsigned char* valid,
               const void* const* w, int S, int K) {
  Site s;
  s.src = src;
  s.idx = idx;
  s.feats = feats;
  s.valid = valid;
  for (int f = 0; f < kFields; ++f) s.w[f] = static_cast<const float*>(w[f]);
  s.S = S;
  s.K = K;
  return s;
}

}  // namespace

// w_a, w_m: host arrays of the kFields device pointers of each site's packed
// fields. fconst [2][P]: the Fourier frequency and phase of each rel-PE column.
extern "C" int fused_stack_launch(
    const float* x, float* out,
    const float* src_a, const int* idx_a, const float* feats_a, const unsigned char* valid_a,
    const float* src_m, const int* idx_m, const float* feats_m, const unsigned char* valid_m,
    const void* const* w_a, const void* const* w_m, const float* fconst,
    int B, int N, int Sa, int Ka, int Sm, int Km, int L, int D, int H, int hd, int F, int P,
    float scale, void* stream) {
  const int I = H * hd;
  if (B < 1 || N < 1 || H < 1 || H > kMaxH || hd < 4 || hd % 4 != 0 || I > 32 * kMaxJ ||
      D < 1 || D > 32 * kMaxJ || P < 1 || P > 32 * kMaxJ || F < 1 || P % F != 0 || Ka < 0 ||
      Km < 0)
    return (int)cudaErrorInvalidValue;
  Dims d{N, L, D, H, hd, I, F, P, scale};
  const Site a = make_site(src_a, idx_a, feats_a, valid_a, w_a, Sa, Ka);
  const Site m = make_site(src_m, idx_m, feats_m, valid_m, w_m, Sm, Km);
  const size_t floats = (size_t)kRows * (D + (I + D) + (I > D ? I : D) + (4 * D > 2 * I ? 4 * D : 2 * I) +
                                         H * (D + P)) +
                        (size_t)kThreads * kRows + 2 * kRows + 2 * kWarps * kChunk;
  const size_t smem = floats * sizeof(float);
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  const dim3 grid((N + kRows - 1) / kRows, B);
  fused_stack_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(x, out, a, m, fconst, d);
  return (int)cudaGetLastError();
}
