"""The rounding points of the bf16 edge core (B2) and the bf16 fused stack
(B3) on the tensor cores, emulated in plain PyTorch on the CPU and held to
the 2x rule against the JAX package's bf16 Pallas kernels run in interpret
mode.

csrc/edge_mma.cuh, csrc/edge_attn.cu and csrc/fused_stack.cu run the
products of their bf16 paths as bf16 mma.sync products with f32
accumulators. The emulation below rounds where they round, and nowhere
else:
  * every product takes bf16 operands and accumulates in f32;
  * the edges go in tiles of 16 valid edges, in edge order (B2's long rows:
    two teams on alternate 64-edge segments, merged at the end), with one
    online-softmax step per tile in f32, the weights rounded to bf16 against
    the running max and the denominator summing the rounded weights;
  * B2 rounds the scaled score and each output, as the TPU kernel does;
  * B3 folds k|v onto the queries: the folded queries are rounded to bf16
    (the score's operand), as are the per-head aggregates of the staged
    [x_g | z] columns (the value fold's operand); every dense product's
    operands are the TPU kernel's bf16 values.
The rule: max |emulation - f32 kernel| <= 2 * max |bf16 kernel - f32 kernel|
+ 1e-5, both kernels the JAX package's in interpret mode on the same
bf16-rounded inputs (B3's f32 kernel with the f32 packed weights), the card's
gate for B2 and B3 in bf16 (chip_smoke.py phase 3).
"""

import jax.numpy as jnp
import numpy as np
import torch

from prosim_tpu.ops import fused_stack as jfs
from prosim_tpu.ops.attention import gather_src_features as jax_gather
from prosim_tpu.ops.edge_attn import edge_attn_core as jax_edge_attn_core
from prosim_torch.ops import fused_stack as tfs
from prosim_torch.ops.attention import GatedNeighborAttention, _norm_stats
from prosim_torch.utils.params import init_params

ATOL = 1e-5
TILE, SEG = 16, 64  # edges per tile, per segment of a long row's team
BF = torch.bfloat16


def _bf(t):
    return t.to(BF).float()


def online_row(R, Q, valid, scale, round_score, nteams, span):
    """One row's softmax-weighted aggregate of R [K, C] under queries
    Q [H, C] (bf16 values in f32) over the valid edges, as the edge engine
    computes it: edge k goes to team (k // SEG) % nteams, each team's
    valid edges in order in passes of `span` edges, in tiles of TILE.
    Returns (agg [H, C] f32, any valid)."""
    H, C = Q.shape
    states = []
    for team in range(nteams):
        m = torch.full((H,), -torch.inf)
        l = torch.zeros(H)
        acc = torch.zeros(H, C)
        ks = [k for k in range(R.shape[0]) if valid[k] and (k // SEG) % nteams == team]
        passes = {}
        for k in ks:
            passes.setdefault(k // span, []).append(k)
        for p in sorted(passes):
            ids = passes[p]
            for t0 in range(0, len(ids), TILE):
                rt = R[ids[t0:t0 + TILE]]
                s = (rt @ Q.T) * scale
                if round_score:
                    s = _bf(s)
                mn = torch.maximum(m, s.amax(0))
                corr = torch.exp(m - mn)
                w = _bf(torch.exp(s - mn))
                l = l * corr + w.sum(0)
                acc = acc * corr[:, None] + w.T @ rt
                m = mn
        states.append((m, l, acc))
    m, l, acc = states[0]
    for m1, l1, a1 in states[1:]:  # in a fixed order
        M = torch.maximum(m, m1)
        f0 = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
        f1 = torch.where(m1 == -torch.inf, 0.0, torch.exp(m1 - M))
        l, acc, m = f1 * l1 + l * f0, f1[:, None] * a1 + acc * f0[:, None], M
    ok = l > 0
    return torch.where(ok[:, None], acc / torch.where(ok, l, 1.0)[:, None], 0.0), bool(ok.any())


def emulate_edge_core(x_src_n, idx, z_r, qx, qp, valid, scale):
    """B2's bf16 path on bf16 inputs: (agg_x, agg_z) in bf16."""
    B, Q, K = valid.shape
    D = x_src_n.shape[-1]
    nteams = 2 if K > 128 else 1
    ax, az = torch.zeros(qx.shape), torch.zeros(qp.shape)
    for b in range(B):
        for q in range(Q):
            rows = torch.cat([x_src_n[b, torch.where(valid[b, q], idx[b, q], 0).long()].float(),
                              z_r[b, q].float()], -1)
            agg, _ = online_row(rows, torch.cat([qx[b, q], qp[b, q]], -1).float(), valid[b, q],
                                scale, True, nteams, nteams * 256)
            ax[b, q], az[b, q] = agg[:, :D], agg[:, D:]
    return ax.to(BF), az.to(BF)


def test_edge_core_mma_rounding_two_x_rule():
    """B2 at a short-row (one team) and a long-row (two teams, K not a
    multiple of 16) shape, H < 8 in one; rows with 0 and 1 valid edges."""
    rng = np.random.default_rng(0)
    for B, Q, S, K, D, Dp, H in ((2, 8, 40, 37, 32, 24, 4), (2, 8, 60, 150, 32, 24, 8)):
        bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(BF)  # noqa: E731
        x_src_n = bf(rng.normal(size=(B, S, D)))
        z_r = bf(rng.normal(size=(B, Q, K, Dp)))
        qx, qp = bf(rng.normal(size=(B, Q, H, D)) * 0.5), bf(rng.normal(size=(B, Q, H, Dp)) * 0.5)
        idx = torch.from_numpy(rng.integers(0, S, (B, Q, K)).astype(np.int32))
        valid = torch.from_numpy(rng.random((B, Q, K)) > 0.3)
        valid[0, 1] = False
        valid[1, 2] = False
        valid[1, 2, K - 1] = True  # one valid edge, the last
        scale = (D // H) ** -0.5
        got = emulate_edge_core(x_src_n, idx, z_r, qx, qp, valid, scale)
        safe = np.where(valid.numpy(), idx.numpy(), 0)
        xg = x_src_n.float().numpy()[np.arange(B)[:, None, None], safe]
        ref = {}
        for dt in (jnp.float32, jnp.bfloat16):
            j = lambda t: jnp.asarray(t.float().numpy(), dt)  # noqa: E731
            ref[dt] = [np.asarray(a, np.float32) for a in jax_edge_attn_core(
                jnp.asarray(xg, dt), j(z_r), j(qx), j(qp), jnp.asarray(valid.numpy()), scale,
                interpret=True)[:2]]
        err = max(np.abs(g.float().numpy() - r).max() for g, r in zip(got, ref[jnp.float32]))
        err16 = max(np.abs(a - r).max() for a, r in zip(ref[jnp.bfloat16], ref[jnp.float32]))
        assert err <= 2 * err16 + ATOL, (K, err, err16)
        for o in got:
            assert not o[0, 1].float().any() and o[1, 2].float().abs().max() > 0


def _site_layer_mma(x, w, l, xg, z, valid, H, hd):
    """One GatedNeighborAttention layer as B3's bf16 path computes it;
    prosim_torch.ops.fused_stack._site_layer with the edges replaced."""
    B, N, K, D = xg.shape
    P = z.shape[-1]
    I = H * hd
    dt = x.dtype

    def dot(a, b):
        return a.float() @ b.float()

    xn = _norm_stats(x) * w["gd"][l] + w["bd"][l]
    q = dot(xn, w["wq"][l]).to(dt) + w["bq"][l]
    wk = torch.cat([w["wkv"][l][:, :I], w["wkvr"][l][:, :I]]).float().view(D + P, H, hd)
    wv = torch.cat([w["wkv"][l][:, I:], w["wkvr"][l][:, I:]]).float().view(D + P, H, hd)
    qa = _bf(torch.einsum("bnhe,che->bnhc", q.float().view(B, N, H, hd), wk))
    R = torch.cat([xg, z], -1).float()
    agg_rc = torch.zeros(B, N, H, D + P)
    anyv = torch.zeros(B, N, 1)
    for b in range(B):
        for n in range(N):
            a, anyv[b, n] = online_row(R[b, n], qa[b, n], valid[b, n], hd ** -0.5, False, 1, 256)
            agg_rc[b, n] = a
    agg = torch.einsum("bnhc,chd->bnhd", _bf(agg_rc), wv).reshape(B, N, I)
    agg = (agg + w["bkv"][l][I:].float() * anyv).to(dt)
    g = torch.sigmoid(dot(torch.cat([agg, xn], -1), w["wg"][l]) + w["bg"][l].float()).to(dt)
    s = dot(xn, w["ws"][l]).to(dt) + w["bs2"][l]
    gated = agg + g * (s - agg)
    out = dot(gated, w["wo"][l]).to(dt) + w["bo"][l]
    x = x + _norm_stats(out) * w["png"][l] + w["pnb"][l]
    ff_in = _norm_stats(x) * w["f1g"][l] + w["f1b"][l]
    h0 = torch.relu(dot(ff_in, w["w0"][l]) + w["b0"][l].float()).to(dt)
    ff = dot(h0, w["w1"][l]).to(dt) + w["b1"][l]
    return x + _norm_stats(ff) * w["f2g"][l] + w["f2b"][l]


def emulate_fused_stack(x, tables, weights, H, hd):
    """B3's bf16 path: x [B,N,D] bf16, tables (src bf16, idx, feats f32,
    valid) per site, weights packed in bf16."""
    L = weights[0][0].shape[0]
    P = weights[0][tfs._FIELDS.index("wkvr")].shape[1]
    sites = []
    for (src, idx, feats, valid), w in zip(tables, weights):
        xg = _norm_stats(src)[torch.arange(src.shape[0])[:, None, None],
                              torch.where(valid, idx, 0).long()]
        sites.append((xg, tfs._z_from_feats(feats, P, BF), valid, dict(zip(tfs._FIELDS, w))))
    for l in range(L):
        for xg, z, valid, w in sites:
            x = _site_layer_mma(x, w, l, xg, z, valid, H, hd)
    return x


def test_fused_stack_mma_rounding_two_x_rule():
    """B3 at the JAX tests' widths with two layers, hd = 8 (two heads in a
    16-column block of the value fold), a row with no valid edge, K not a
    multiple of 16."""
    B, N, D, H, hd, L, Sa, Ka, Sm, Km = 2, 8, 32, 4, 8, 2, 12, 21, 24, 37
    rng = np.random.default_rng(1)
    stack = torch.nn.Module()
    for i in range(L):
        for site in ("a2p", "m2p"):
            stack.add_module(f"{site}_{i}", GatedNeighborAttention(D, H, hd, bipartite=True))
    init_params(stack, seed=3)
    with torch.no_grad():
        for p in stack.parameters():  # exercise the norm affines and the biases
            p.add_(torch.from_numpy(0.1 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
        w32 = [tfs.pack_site_weights(stack, s) for s in ("a2p", "m2p")]
        w16 = [tfs.pack_site_weights(stack, s, BF) for s in ("a2p", "m2p")]
    x = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32)).to(BF)
    tables = []
    for S, K in ((Sa, Ka), (Sm, Km)):
        src = torch.from_numpy(rng.normal(size=(B, S, D)).astype(np.float32)).to(BF)
        idx = torch.from_numpy(rng.integers(0, S, (B, N, K)).astype(np.int32))
        valid = torch.from_numpy(rng.random((B, N, K)) > 0.3)
        valid[0, 1] = False
        v = rng.uniform(-np.pi, np.pi, (B, N, K))
        feats = np.stack([rng.uniform(0, 50, (B, N, K)), rng.uniform(-np.pi, np.pi, (B, N, K)),
                          v, v], -1).astype(np.float32)
        tables.append((src, idx, torch.from_numpy(feats), valid))
    with torch.no_grad():
        got = emulate_fused_stack(x, tables, w16, H, hd)
    ref = {}
    for dt, w in ((jnp.float32, w32), (jnp.bfloat16, w16)):
        jt = [(jax_gather(jnp.asarray(src.float().numpy(), dt), jnp.asarray(idx.numpy())),
               jnp.asarray(feats.numpy()), jnp.asarray(valid.numpy(), jnp.float32))
              for src, idx, feats, valid in tables]
        jw = [[jnp.asarray(t.float().numpy(), dt) for t in ws] for ws in w]
        ref[dt] = np.asarray(jfs.fused_two_site_stack(
            jnp.asarray(x.float().numpy(), dt), jt[0], jt[1], jw[0], jw[1], num_layers=L,
            num_heads=H, head_dim=hd, pe_dim=D, q_tile=8, interpret=True), np.float32)
    assert got.dtype == BF and bool(torch.isfinite(got).all())
    err = np.abs(got.float().numpy() - ref[jnp.float32]).max()
    err16 = np.abs(ref[jnp.bfloat16] - ref[jnp.float32]).max()
    assert err <= 2 * err16 + ATOL, (err, err16)
