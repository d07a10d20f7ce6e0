"""Gated neighborhood attention over fixed-K neighbor grids (port of
prosim_tpu/ops/attention.py).

One op serves every sparse-attention site of the rollout (scene a2a/s2s,
decoder p2p/s2p, policy a2p/m2p). The parameter tree is the flax one, and
the math is the JAX package's weight-folded form: LayerNorm splits into a
parameter-free normalization (shared across layers) and a per-layer affine,
and the k/v/PE projections fold onto the query side, so per layer only the
score/softmax/aggregate core touches the per-edge tables. That core is
`ops/edge_attn.py:edge_attn_core`, a CUDA kernel on the card.
"""

import torch
from torch import nn

from prosim_torch.ops.edge_attn import edge_attn_core
from prosim_torch.ops.fourier import FourierEmbedding, FourierEmbeddingFix
from prosim_torch.ops.mlp import LayerNorm
from prosim_torch.ops.neighbors import gather_neighbors
from prosim_torch.utils.geometry import angle_between_2d_vectors, wrap_angle


def rel_pe_input(dst_pos, dst_ori, nbr_pos, nbr_ori):
    """Relative PE features from gathered neighbor pos/ori.
    dst_pos [B,Q,2], dst_ori [B,Q], nbr_pos [B,Q,K,2], nbr_ori [B,Q,K]
    -> [B,Q,K,3] = (dist, rel_ori, rel_ori_vec)."""
    rel_pos = nbr_pos - dst_pos[:, :, None, :]
    dist = torch.linalg.vector_norm(rel_pos, dim=-1)
    rel_ori = wrap_angle(nbr_ori - dst_ori[:, :, None])
    ori_vec_dst = torch.stack([torch.cos(dst_ori), torch.sin(dst_ori)], dim=-1)
    rel_ori_vec = angle_between_2d_vectors(ori_vec_dst[:, :, None, :], rel_pos)
    return torch.stack([dist, rel_ori, rel_ori_vec], dim=-1)


def _pos_ori_table(pos, ori):
    return torch.cat([pos.float(), ori[..., None].float()], dim=-1)


def rel_pe_features(dst_pos, dst_ori, src_pos, src_ori, idx):
    """The 3 unique rel-PE features [B,Q,K,3] of neighbor pairs; the
    reference's 4th feature duplicates rel_ori_vec and is folded instead
    (RelPE.fold_dup, GatedNeighborAttention.pe_full_dim)."""
    g = gather_neighbors(_pos_ori_table(src_pos, src_ori), idx)
    return rel_pe_input(dst_pos, dst_ori, g[..., :2], g[..., 2])


class RelPE(nn.Module):
    """Rel-PE features -> embeddings. Fixed path with fold_dup=True embeds
    only the 3 unique features (3/4 * hidden_dim dims); fold_dup=False
    re-appends the duplicate block (reference layout)."""

    def __init__(self, hidden_dim: int, learnable_pe: bool = False,
                 num_freq_bands: int = 64, fold_dup: bool = True):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.learnable_pe = learnable_pe
        self.fold_dup = fold_dup
        if learnable_pe:
            self.fourier = FourierEmbedding(3, hidden_dim, num_freq_bands)
        else:
            self.fourier_fix = FourierEmbeddingFix(num_pos_feats=hidden_dim // 4)

    def forward(self, pe_input):
        if self.learnable_pe:
            return self.fourier(pe_input)
        npf = self.hidden_dim // 4
        emb = self.fourier_fix(pe_input)
        if not self.fold_dup:
            emb = torch.cat([emb, emb[..., 2 * npf :]], dim=-1)
        return emb


def _norm_stats(x, eps: float = 1e-5, dup_tail: int = 0):
    """Parameter-free LayerNorm (flax stats: last dim, fast variance).
    dup_tail > 0: stats of the wider row in which the last dup_tail dims
    appear twice (the folded rel-PE duplicate); only unique dims returned."""
    n = x.shape[-1] + dup_tail
    s = x.sum(-1, keepdim=True)
    ss = (x * x).sum(-1, keepdim=True)
    if dup_tail:
        t = x[..., -dup_tail:]
        s = s + t.sum(-1, keepdim=True)
        ss = ss + (t * t).sum(-1, keepdim=True)
    mu = s / n
    var = (ss / n - mu * mu).clamp_min(0.0)
    return (x - mu) * torch.rsqrt(var + eps)


def _fold_pe_tail(w, tail: int):
    """Add the duplicated rel-PE parameter rows (the last `tail` of the P
    rows) onto their twins: [P, ...] -> [P - tail, ...], exact math."""
    if tail == 0:
        return w
    out = w[:-tail].clone()
    out[-tail:] += w[-tail:]
    return out


def normalize_rel_pe(rel_pe, full_dim: int):
    """Parameter-free LayerNorm of a rel-PE table that carries the unique
    rel_pe.shape[-1] of full_dim reference dims. The table is constant over
    a stack of layers, so one normalization serves every layer (the JAX
    package gets this by XLA's common-subexpression elimination)."""
    return _norm_stats(rel_pe, dup_tail=full_dim - rel_pe.shape[-1])


def gather_src_features(x_src, idx):
    """Gathered parameter-free-normalized source features [B,Q,K,D]: the
    per-edge table of the fused stack's plain version (ops/fused_stack.py).
    The layer loop's edge core gathers the rows of _norm_stats(x_src) itself."""
    return gather_neighbors(_norm_stats(x_src), idx)


class GatedNeighborAttention(nn.Module):
    """QCNet gated attention layer (reference: attention_layer.py:87-121),
    eval mode: dropout is the identity."""

    def __init__(self, hidden_dim: int, num_heads: int, head_dim: int,
                 bipartite: bool = False, pe_dim: int = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.bipartite = bipartite
        D = hidden_dim
        P = pe_dim or hidden_dim  # full reference width of the rel-PE
        inner = num_heads * head_dim
        self.prenorm_src = LayerNorm(D)
        if bipartite:
            self.prenorm_dst = LayerNorm(D)
        self.prenorm_r = LayerNorm(P)
        self.to_q = nn.Linear(D, inner)
        self.to_k = nn.Linear(D, inner, bias=False)
        self.to_v = nn.Linear(D, inner)
        self.to_k_r = nn.Linear(P, inner, bias=False)
        self.to_v_r = nn.Linear(P, inner)
        self.to_g = nn.Linear(inner + D, inner)
        self.to_s = nn.Linear(D, inner)
        self.to_out = nn.Linear(inner, hidden_dim)
        self.postnorm = LayerNorm(hidden_dim)
        self.ff_prenorm = LayerNorm(hidden_dim)
        self.ff_dense0 = nn.Linear(hidden_dim, hidden_dim * 4)
        self.ff_dense1 = nn.Linear(hidden_dim * 4, hidden_dim)
        self.ff_postnorm = LayerNorm(hidden_dim)

    def forward(self, x_dst, x_src, idx, edge_valid, pe_normed, src_normed=None):
        """x_dst [B,Q,D], x_src [B,S,D], idx [B,Q,K], edge_valid [B,Q,K],
        pe_normed [B,Q,K,D_pe] = normalize_rel_pe(rel_pe, P) (D_pe < P when
        folded) -> [B,Q,D].

        src_normed: optional [B,S,D] = _norm_stats(x_src), the parameter-free
        normalized source rows that the edge core gathers by idx. Both tables
        are shared across a stack whose inputs they depend on are
        layer-constant.
        The folds (exact math, see prosim_tpu/ops/attention.py:242-262):
          score: q . W_k LN_s(x_j)  = ((W_k^T q) * g_s) . z_x[j] + const_q
                 q . W_kr LN_r(r_j) = ((W_kr^T q) * g_r) . z_r[j] + const_q
          value: sum_k a_k (W_v LN_s(x_k) + c_v + W_vr LN_r(r_k) + c_vr)
               = W_v (g_s * agg_x) + W_vr (g_r * agg_z) + const * sum_k a_k
        """
        H, hd = self.num_heads, self.head_dim
        inner = H * hd
        scale = hd ** -0.5
        B, Q, K = idx.shape
        D_src = x_src.shape[-1]

        g_s, b_s = self.prenorm_src.weight, self.prenorm_src.bias
        norm_dst = self.prenorm_dst if self.bipartite else self.prenorm_src
        x_dst_n = _norm_stats(x_dst) * norm_dst.weight + norm_dst.bias
        x_src_n = _norm_stats(x_src) if src_normed is None else src_normed

        qh = self.to_q(x_dst_n).view(B, Q, H, hd)
        w_k = self.to_k.weight.t()                  # [D_src, inner]
        w_v, c_v = self.to_v.weight.t(), self.to_v.bias

        z_r = pe_normed
        D_pe = z_r.shape[-1]
        P = self.prenorm_r.weight.shape[0]
        tail = P - D_pe
        g_r, b_r = self.prenorm_r.weight, self.prenorm_r.bias
        w_kr = self.to_k_r.weight.t()               # [P, inner]
        w_vr, c_vr = self.to_v_r.weight.t(), self.to_v_r.bias
        w_kr_g = _fold_pe_tail(w_kr * g_r[:, None], tail).view(D_pe, H, hd)
        w_vr_g = _fold_pe_tail(w_vr * g_r[:, None], tail).view(D_pe, H, hd)

        q_k = torch.einsum("bqhe,dhe->bqhd", qh, w_k.reshape(D_src, H, hd))
        q_pe = torch.einsum("bqhe,dhe->bqhd", qh, w_kr_g)
        agg_x, agg_z, attn_sum = edge_attn_core(
            x_src_n.contiguous(), idx.to(torch.int32).contiguous(), z_r.contiguous(),
            (q_k * g_s).contiguous(), q_pe.contiguous(), edge_valid.contiguous(), scale,
        )
        agg_v = torch.einsum("bqhd,dhe->bqhe", agg_x * g_s, w_v.reshape(D_src, H, hd))
        agg_pe = torch.einsum("bqhd,dhe->bqhe", agg_z, w_vr_g)
        const = (b_s @ w_v + c_v + b_r @ w_vr + c_vr).view(H, hd)
        agg = (agg_v + agg_pe + const * attn_sum[..., None]).reshape(B, Q, inner)

        g = torch.sigmoid(self.to_g(torch.cat([agg, x_dst_n], dim=-1)))
        s = self.to_s(x_dst_n)
        gated = agg + g * (s - agg)
        x = x_dst + self.postnorm(self.to_out(gated))
        ff = self.ff_dense1(torch.relu(self.ff_dense0(self.ff_prenorm(x))))
        return x + self.ff_postnorm(ff)
