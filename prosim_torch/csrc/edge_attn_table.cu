// The edge core's earlier design, over a materialised per-edge source
// table x_g [B,Q,K,D] (gather_src_features), kept as the measured baseline
// of csrc/edge_attn.cu: chip_smoke.py phase 3 times it, plus the gather it
// needs, on the same inputs as the kernel the model runs. It is not on the
// model's path.
//
// Computes prosim_tpu/ops/edge_attn.py:edge_attn_core (_edge_attn_kernel) on the
// gathered table.
// Per destination row (b, q) and head h, over the row's K edges:
//   sim[k, h]  = (x_g[k] . qx[h] + z_r[k] . qp[h]) * scale
//   attn[:, h] = softmax over the valid k (rows with no valid edge give 0)
//   agg_x[h]   = sum_k attn[k, h] x_g[k];  agg_z[h] = sum_k attn[k, h] z_r[k]
//   attn_sum[h] = 1 if any edge is valid else 0
// The per-query score bias of the layer is constant over k and cancels in
// the softmax, so it is not an input (as in the TPU kernel).
//
// Bound on the H100: the per-edge tables x_g [B,Q,K,D] and z_r [B,Q,K,Dp]
// dominate the bytes (1.4 GB at the policy's m2p site, B=16, K=768, D=128,
// Dp=96); the 4*H*(D+Dp) f32 operations per edge sit below the memory line,
// so the kernel is bound by device-memory bytes.
//
// Design: each valid edge's rows are read from device memory exactly once,
// straight into registers; invalid edges are not read at all. One block of
// four warps per (b, q); each warp streams every fourth pair of edges. A
// lane owns columns lane + 32 j of both tables and keeps the queries of all
// H <= 8 heads for them, and the [H, D + Dp] accumulators, in registers.
// The H partial dot products of an edge are reduced across the warp by one
// transpose-reduction (9 shuffles for 8 sums), after which lanes 4h..4h+3
// hold head h's score and run its online softmax (running max and
// denominator); the rescale and the two edges' weights then go to every
// lane by shuffle. At the end the four warps' (max, denominator,
// accumulator) states merge through shared memory in a fixed order. No
// atomics: results are bitwise reproducible from run to run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxH = 8;
constexpr int kMaxJ = 4;          // columns per lane of each table: D, Dp <= 32 * kMaxJ
constexpr int kCols = 2 * kMaxJ;  // x_g columns, then z_r columns
constexpr unsigned kFull = 0xffffffffu;

// Sums v[h] over the warp for every h; lanes 4h..4h+3 end up holding the
// sum of v[h] (h = lane >> 2).
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

__device__ __forceinline__ void load_edge(const float* __restrict__ x_row,
                                          const float* __restrict__ z_row, bool ok,
                                          int lane, int D, int Dp, float (&t)[kCols]) {
#pragma unroll
  for (int j = 0; j < kMaxJ; ++j) {
    const int c = lane + 32 * j;
    t[j] = (ok && c < D) ? x_row[c] : 0.f;
    t[kMaxJ + j] = (ok && c < Dp) ? z_row[c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads) edge_attn_table_kernel(
    const float* __restrict__ xg, const float* __restrict__ zr,
    const float* __restrict__ qx, const float* __restrict__ qp,
    const unsigned char* __restrict__ valid, float* __restrict__ aggx,
    float* __restrict__ aggz, float* __restrict__ asum, int K, int H, int D,
    int Dp, float scale) {
  __shared__ float m_s[kWarps][kMaxH];
  __shared__ float l_s[kWarps][kMaxH];
  extern __shared__ float acc_s[];  // [kWarps][H][D + Dp]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = blockIdx.x;
  const int C = D + Dp;

  float q[kMaxH][kCols];
  float acc[kMaxH][kCols];
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int c = lane + 32 * j;
      q[h][j] = (h < H && c < D) ? qx[(row * H + h) * D + c] : 0.f;
      q[h][kMaxJ + j] = (h < H && c < Dp) ? qp[(row * H + h) * Dp + c] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[h][j] = 0.f;
  }
  float m = -INFINITY;  // running max and denominator of head lane >> 2
  float l = 0.f;

  const float* x_row = xg + row * K * D;
  const float* z_row = zr + row * K * Dp;
  const unsigned char* v_row = valid + row * K;
  for (int e0 = 2 * warp; e0 < K; e0 += 2 * kWarps) {
    const int e1 = e0 + 1;
    const bool v0 = v_row[e0] != 0;
    const bool v1 = e1 < K && v_row[e1] != 0;
    if (!v0 && !v1) continue;  // warp-uniform
    float t0[kCols], t1[kCols];
    load_edge(x_row + (size_t)e0 * D, z_row + (size_t)e0 * Dp, v0, lane, D, Dp, t0);
    load_edge(x_row + (size_t)e1 * D, z_row + (size_t)e1 * Dp, v1, lane, D, Dp, t1);
    float p0[kMaxH], p1[kMaxH];
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        a = fmaf(t0[j], q[h][j], a);
        b = fmaf(t1[j], q[h][j], b);
      }
      p0[h] = a;
      p1[h] = b;
    }
    const float s0 = v0 ? reduce_scatter8(p0, lane) * scale : -INFINITY;
    const float s1 = v1 ? reduce_scatter8(p1, lane) * scale : -INFINITY;
    const float m_new = fmaxf(m, fmaxf(s0, s1));  // finite: one edge is valid
    const float corr = expf(m - m_new);           // 0 while m is -inf
    const float w0 = v0 ? expf(s0 - m_new) : 0.f;
    const float w1 = v1 ? expf(s1 - m_new) : 0.f;
    l = l * corr + w0 + w1;
    m = m_new;
#pragma unroll
    for (int h = 0; h < kMaxH; ++h) {
      if (h < H) {  // warp-uniform
        const float c = __shfl_sync(kFull, corr, 4 * h);
        const float a = __shfl_sync(kFull, w0, 4 * h);
        const float b = __shfl_sync(kFull, w1, 4 * h);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[h][j] = fmaf(b, t1[j], fmaf(a, t0[j], acc[h][j] * c));
      }
    }
  }

  // merge the warps' states in a fixed order
  if ((lane & 3) == 0 && (lane >> 2) < H) {
    m_s[warp][lane >> 2] = m;
    l_s[warp][lane >> 2] = l;
  }
#pragma unroll
  for (int h = 0; h < kMaxH; ++h) {
    if (h < H) {
      float* dst = acc_s + ((size_t)warp * H + h) * C;
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int c = lane + 32 * j;
        if (c < D) dst[c] = acc[h][j];
        if (c < Dp) dst[D + c] = acc[h][kMaxJ + j];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H * C + H; i += kThreads) {
    const int h = i < H * C ? i / C : i - H * C;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w][h]);
    float L = 0.f, sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = m_s[w][h] == -INFINITY ? 0.f : expf(m_s[w][h] - M);
      L = fmaf(f, l_s[w][h], L);
      if (i < H * C) sum = fmaf(f, acc_s[((size_t)w * H + h) * C + (i - h * C)], sum);
    }
    if (i >= H * C) {
      asum[row * H + h] = L > 0.f ? 1.f : 0.f;
      continue;
    }
    const int c = i - h * C;
    const float out = L > 0.f ? sum / L : 0.f;
    if (c < D)
      aggx[(row * H + h) * D + c] = out;
    else
      aggz[(row * H + h) * Dp + (c - D)] = out;
  }
}

}  // namespace

extern "C" int edge_attn_table_launch(const float* xg, const float* zr, const float* qx,
                                const float* qp, const unsigned char* valid,
                                float* aggx, float* aggz, float* asum, int rows,
                                int K, int H, int D, int Dp, float scale,
                                void* stream) {
  if (H < 1 || H > kMaxH || D > 32 * kMaxJ || Dp > 32 * kMaxJ)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kWarps * H * (D + Dp);
  edge_attn_table_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      xg, zr, qx, qp, valid, aggx, aggz, asum, K, H, D, Dp, scale);
  return (int)cudaGetLastError();
}
