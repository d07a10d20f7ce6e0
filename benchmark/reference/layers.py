"""Plain layers of the reference: geometry, Dense/LayerNorm/MLP, the fixed
Fourier embedding, the PointNet encoder, nearest-neighbour selection and
the gated neighbourhood attention, in plain PyTorch with no kernel.

A frozen copy of the eval-mode math of prosim_torch/utils/geometry.py,
ops/mlp.py, ops/fourier.py, ops/pointnet.py, ops/neighbors.py
(`neighbor_topk_plain`), ops/edge_attn.py (`edge_attn_core_plain`) and
ops/attention.py, taken when the benchmark was written. It imports nothing of
the program. The attention keeps the program's weight-folded form (exact
algebra of the QCNet layer, see `GatedNeighborAttention.forward`); its core
is the gather-softmax-aggregate over the K neighbour slots of every query,
with invalid slots masked out. `dtype` is the compute dtype, as in the
program; the reference itself runs in float32.
"""

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# ------------------------------------------------------------------ geometry


def wrap_angle(angle, min_val: float = -math.pi, max_val: float = math.pi):
    return min_val + torch.remainder(angle + max_val, max_val - min_val)


def rotate_2d(xy, theta):
    c, s = torch.cos(theta), torch.sin(theta)
    x = xy[..., 0] * c - xy[..., 1] * s
    y = xy[..., 1] * c + xy[..., 0] * s
    return torch.stack([x, y], dim=-1)


def angle_between_2d_vectors(ctr_vector, nbr_vector):
    cross = ctr_vector[..., 0] * nbr_vector[..., 1] - ctr_vector[..., 1] * nbr_vector[..., 0]
    dot = (ctr_vector[..., :2] * nbr_vector[..., :2]).sum(dim=-1)
    return torch.atan2(cross, dot)


def rel_traj_to_last_step(traj):
    """(x, y, sin, cos) trajectory [..., T, 4] in its last step's frame."""
    theta = torch.atan2(traj[..., 2], traj[..., 3])
    xy_off = rotate_2d(traj[..., :2] - traj[..., -1:, :2], -theta[..., -1:])
    theta_off = wrap_angle(theta - theta[..., -1:])
    return torch.cat([xy_off, torch.sin(theta_off)[..., None], torch.cos(theta_off)[..., None]],
                     dim=-1)


def rel_vel_to_last_step(traj, vel):
    theta = torch.atan2(traj[..., 2], traj[..., 3])
    return rotate_2d(vel, -theta[..., -1:])


# ------------------------------------------------------------- dense layers


def layer_norm(x, weight, bias, eps: float = 1e-5, dtype=torch.float32):
    """flax statistics (mean, E[x^2] - mean^2), in f32, rounded to dtype once."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return ((x - mu) * (torch.rsqrt(var + eps) * weight) + bias).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


class Dense(nn.Linear):
    """Linear in `dtype`; outside f32 the bias is added after the product."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        if dt == torch.float32:
            return super().forward(x.to(dt))
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class MLP(nn.Module):
    def __init__(self, dims: Sequence[int], ret_before_act: bool = False,
                 without_norm: bool = False, dtype=torch.float32):
        super().__init__()
        dims = list(dims)
        self.n = len(dims) - 1
        self.ret_before_act = ret_before_act
        self.without_norm = without_norm
        for i in range(self.n):
            self.add_module(f"dense_{i}", Dense(dims[i], dims[i + 1], dtype=dtype))
            if i < self.n - 1 and not without_norm:
                self.add_module(f"norm_{i}", LayerNorm(dims[i + 1], dtype=dtype))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1:
                if not self.without_norm:
                    x = getattr(self, f"norm_{i}")(x)
                x = torch.relu(x)
        if not self.ret_before_act:
            x = torch.relu(x)
        return x


class MCGBlock(nn.Module):
    def __init__(self, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.dense = Dense(hidden_dim, hidden_dim, dtype=dtype)
        self.norm = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, tokens, context, mask):
        x = torch.relu(self.norm(self.dense(tokens)))
        x = x * context[..., None, :]
        x = torch.where(mask[..., None], x, torch.full_like(x, -1e9))
        return x, x.amax(dim=-2)


class ContextGating(nn.Module):
    def __init__(self, num_blocks: int, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", MCGBlock(hidden_dim, dtype))

    def forward(self, tokens, context, mask):
        tok_acc, ctx_acc = self.block_0(tokens, context, mask)
        for i in range(1, self.num_blocks):
            tok, ctx = getattr(self, f"block_{i}")(tok_acc, ctx_acc, mask)
            tok_acc = (tok_acc * i + tok) / (i + 1)
            ctx_acc = (ctx_acc * i + ctx) / (i + 1)
        return tok_acc, ctx_acc


class FourierEmbeddingFix(nn.Module):
    """Fixed sinusoidal embedding, f32: sin(x * 2 pi / ramp + phase), the
    phase pi/2 on odd slots."""

    def __init__(self, num_pos_feats: int = 128, temperature: float = 10000.0):
        super().__init__()
        self.num_pos_feats = int(num_pos_feats)
        self.temperature = temperature

    def forward(self, x):
        npf = self.num_pos_feats
        d = x.shape[-1]
        dim_t = torch.arange(npf, dtype=torch.float32, device=x.device)
        ramp = torch.tensor(self.temperature, dtype=torch.float32, device=x.device) ** (
            2 * torch.div(dim_t, 2, rounding_mode="floor") / npf)
        inv_t = (2 * math.pi) / ramp
        phase = torch.where(torch.arange(npf, device=x.device) % 2 == 0, 0.0, 0.5 * math.pi)
        return torch.sin((x[..., None] * inv_t + phase).reshape(*x.shape[:-1], d * npf))


class PointNetPolylineEncoder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_pre_layers: int = 1,
                 num_mlp_layers: int = 3, dtype=torch.float32):
        super().__init__()
        h = hidden_dim
        self.pre_mlps = MLP([in_dim] + [h] * num_pre_layers, ret_before_act=False, dtype=dtype)
        self.mlps = MLP([h * 2] + [h] * (num_mlp_layers - num_pre_layers), ret_before_act=False,
                        dtype=dtype)
        self.out_mlps = MLP([h, h, h], without_norm=True, ret_before_act=True, dtype=dtype)

    def forward(self, polylines, point_mask):
        m = point_mask[..., None]
        x = torch.where(m, torch.nan_to_num(polylines), 0.0)
        pre = torch.where(m, self.pre_mlps(x), 0.0)
        x = torch.cat([pre, pre.amax(dim=-2)[..., None, :].expand_as(pre)], dim=-1)
        mid = torch.where(m, self.mlps(x), 0.0)
        out = self.out_mlps(mid.amax(dim=-2))
        return torch.where(point_mask.any(dim=-1)[..., None], out, 0.0)


# --------------------------------------------------------- neighbour graphs


def pairwise_d2(dst_pos, src_pos):
    """Squared distances [B,Q,S] rounded as fma(dy, dy, dx * dx) in f32:
    the float64 sum rounded to odd, then to f32."""
    dx = dst_pos[:, :, None, 0] - src_pos[:, None, :, 0]
    dy = dst_pos[:, :, None, 1] - src_pos[:, None, :, 1]
    p = dy.double() * dy.double()
    q = (dx * dx).double()
    s = p + q
    b = s - p
    err = (p - (s - b)) + (q - b)
    even = (s.view(torch.int64) & 1) == 0
    step = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf).to(s))
    return torch.where((err != 0) & even, step, s).float()


def neighbor_topk(dst_pos, src_pos, dst_mask, src_mask, k: int, radius=None,
                  exclude_self: bool = False, block: int = 64):
    """The k nearest valid sources of each destination, ties to the lower
    index: (idx [B,Q,min(k,S)] int32, valid). Computed over blocks of
    destination rows, so the [B, rows, S] distance table stays small."""
    idxs, valids = [], []
    eff_k = min(k, src_pos.shape[1])
    r2 = None
    if radius is not None:
        r = torch.tensor(float(radius), dtype=torch.float32)
        r2 = float(r * r)
    for q0 in range(0, dst_pos.shape[1], block):
        dpos = dst_pos[:, q0:q0 + block].float()
        d2 = pairwise_d2(dpos, src_pos.float())
        bad = ~(src_mask[:, None, :] & dst_mask[:, q0:q0 + block, None])
        if r2 is not None:
            bad = bad | (d2 > r2)
        if exclude_self:
            q, s = d2.shape[1], d2.shape[2]
            bad = bad | (torch.arange(q0, q0 + q, device=d2.device)[:, None]
                         == torch.arange(s, device=d2.device)[None])[None]
        d2 = torch.where(bad, torch.inf, d2)
        vals, idx = torch.sort(d2, dim=-1, stable=True)
        idxs.append(idx[..., :eff_k].to(torch.int32))
        valids.append(vals[..., :eff_k] < torch.inf)
    return torch.cat(idxs, 1), torch.cat(valids, 1)


def gather_neighbors(src, idx):
    bidx = torch.arange(src.shape[0], device=src.device)[:, None, None]
    return src[bidx, idx.long()]


# ---------------------------------------------------------------- attention


def rel_pe_input(dst_pos, dst_ori, nbr_pos, nbr_ori):
    rel_pos = nbr_pos - dst_pos[:, :, None, :]
    dist = torch.linalg.vector_norm(rel_pos, dim=-1)
    rel_ori = wrap_angle(nbr_ori - dst_ori[:, :, None])
    ori_vec_dst = torch.stack([torch.cos(dst_ori), torch.sin(dst_ori)], dim=-1)
    rel_ori_vec = angle_between_2d_vectors(ori_vec_dst[:, :, None, :], rel_pos)
    return torch.stack([dist, rel_ori, rel_ori_vec], dim=-1)


def rel_pe_features(dst_pos, dst_ori, src_pos, src_ori, idx):
    table = torch.cat([src_pos.float(), src_ori[..., None].float()], dim=-1)
    g = gather_neighbors(table, idx)
    return rel_pe_input(dst_pos, dst_ori, g[..., :2], g[..., 2])


class RelPE(nn.Module):
    """Fixed rel-PE of the 3 unique features (fold_dup) or of 4, the 4th a
    copy of the 3rd; computed in f32 and cast to dtype."""

    def __init__(self, hidden_dim: int, fold_dup: bool = True, dtype=torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.fold_dup = fold_dup
        self.dtype = dtype
        self.fourier_fix = FourierEmbeddingFix(num_pos_feats=hidden_dim // 4)

    def forward(self, pe_input):
        npf = self.hidden_dim // 4
        emb = self.fourier_fix(pe_input).to(self.dtype)
        if not self.fold_dup:
            emb = torch.cat([emb, emb[..., 2 * npf:]], dim=-1)
        return emb


def norm_stats(x, eps: float = 1e-5, dup_tail: int = 0):
    """Parameter-free LayerNorm in f32, returned in x's dtype; dup_tail > 0
    takes the statistics of the row with its last dup_tail dims twice."""
    dt = x.dtype
    x = x.float()
    n = x.shape[-1] + dup_tail
    s = x.sum(-1, keepdim=True)
    ss = (x * x).sum(-1, keepdim=True)
    if dup_tail:
        t = x[..., -dup_tail:]
        s = s + t.sum(-1, keepdim=True)
        ss = ss + (t * t).sum(-1, keepdim=True)
    mu = s / n
    var = (ss / n - mu * mu).clamp_min(0.0)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt)


def normalize_rel_pe(rel_pe, full_dim: int):
    return norm_stats(rel_pe, dup_tail=full_dim - rel_pe.shape[-1])


def _fold_pe_tail(w, tail: int):
    if tail == 0:
        return w
    out = w[:-tail].clone()
    out[-tail:] += w[-tail:]
    return out


def attend(x_g, z_r, qx, qp, edge_valid, scale: float):
    """Softmax attention of every query over its K gathered rows, invalid
    slots masked: (agg_x, agg_z, attn_sum). Products accumulate in f32; the
    values round to x_g.dtype where the program's bf16 path rounds them."""
    dt = x_g.dtype
    sim = (torch.einsum("bqhd,bqkd->bqkh", qx.float(), x_g.float())
           + torch.einsum("bqhd,bqkd->bqkh", qp.float(), z_r.float()))
    sim = (sim * scale).to(dt).float()
    valid = edge_valid[..., None]
    sim = torch.where(valid, sim, -torch.inf)
    sim_max = sim.amax(dim=2, keepdim=True)
    sim_max = torch.where(torch.isfinite(sim_max), sim_max, 0.0)
    expw = torch.where(valid, torch.exp(sim - sim_max), 0.0).to(dt).float()
    attn = (expw / expw.sum(dim=2, keepdim=True).clamp_min(1e-9)).to(dt)
    agg_x = torch.einsum("bqkh,bqkd->bqhd", attn.float(), x_g.float()).to(dt)
    agg_z = torch.einsum("bqkh,bqkd->bqhd", attn.float(), z_r.float()).to(dt)
    attn_sum = edge_valid.any(-1).to(dt)[..., None].expand(*qx.shape[:3])
    return agg_x, agg_z, attn_sum


class GatedNeighborAttention(nn.Module):
    """QCNet gated attention over fixed-K neighbour grids, eval mode.

    Per query: LN the destination, q = W_q x; the score of neighbour j is
    q . (W_k LN_s(x_j) + W_kr LN_r(r_j)), computed through the folds
    ((W_k^T q) * g_s) . z_x[j] (z_x the parameter-free normalised source
    row) and ((W_kr^T q) * g_r) . z_r[j]; the per-query constants cancel in
    the softmax. The value sum is W_v (g_s * agg_x) + W_vr (g_r * agg_z)
    plus the constant part times the weights' sum. Then the sigmoid gate
    against W_s x, W_out, post-LN residual, and the LN'd FFN residual."""

    def __init__(self, hidden_dim: int, num_heads: int, head_dim: int,
                 bipartite: bool = False, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.bipartite = bipartite
        self.dtype = dtype
        D = P = hidden_dim
        inner = num_heads * head_dim
        self.prenorm_src = LayerNorm(D)
        if bipartite:
            self.prenorm_dst = LayerNorm(D)
        self.prenorm_r = LayerNorm(P)
        self.to_q = Dense(D, inner, dtype=dtype)
        self.to_k = Dense(D, inner, bias=False, dtype=dtype)
        self.to_v = Dense(D, inner, dtype=dtype)
        self.to_k_r = Dense(P, inner, bias=False, dtype=dtype)
        self.to_v_r = Dense(P, inner, dtype=dtype)
        self.to_g = Dense(inner + D, inner, dtype=dtype)
        self.to_s = Dense(D, inner, dtype=dtype)
        self.to_out = Dense(inner, hidden_dim, dtype=dtype)
        self.postnorm = LayerNorm(hidden_dim, dtype=dtype)
        self.ff_prenorm = LayerNorm(hidden_dim, dtype=dtype)
        self.ff_dense0 = Dense(hidden_dim, hidden_dim * 4, dtype=dtype)
        self.ff_dense1 = Dense(hidden_dim * 4, hidden_dim, dtype=dtype)
        self.ff_postnorm = LayerNorm(hidden_dim, dtype=dtype)

    def forward(self, x_dst, x_src, idx, edge_valid, pe_normed):
        H, hd = self.num_heads, self.head_dim
        scale = hd ** -0.5
        B, Q, K = idx.shape
        D_src = x_src.shape[-1]
        dt = self.dtype
        g_s, b_s = self.prenorm_src.weight.to(dt), self.prenorm_src.bias.to(dt)
        norm_dst = self.prenorm_dst if self.bipartite else self.prenorm_src
        x_dst_n = norm_stats(x_dst) * norm_dst.weight.to(dt) + norm_dst.bias.to(dt)
        qh = self.to_q(x_dst_n).view(B, Q, H, hd)
        w_k = self.to_k.weight.t().to(dt)
        w_v, c_v = self.to_v.weight.t().to(dt), self.to_v.bias.to(dt)
        z_r = pe_normed
        D_pe = z_r.shape[-1]
        P = self.prenorm_r.weight.shape[0]
        tail = P - D_pe
        g_r, b_r = self.prenorm_r.weight.to(dt), self.prenorm_r.bias.to(dt)
        w_kr = self.to_k_r.weight.t().to(dt)
        w_vr, c_vr = self.to_v_r.weight.t().to(dt), self.to_v_r.bias.to(dt)
        w_kr_g = _fold_pe_tail(w_kr * g_r[:, None], tail).view(D_pe, H, hd)
        w_vr_g = _fold_pe_tail(w_vr * g_r[:, None], tail).view(D_pe, H, hd)
        q_k = torch.einsum("bqhe,dhe->bqhd", qh, w_k.reshape(D_src, H, hd))
        q_pe = torch.einsum("bqhe,dhe->bqhd", qh, w_kr_g)
        x_g = gather_neighbors(norm_stats(x_src), torch.where(edge_valid, idx, 0))
        agg_x, agg_z, attn_sum = attend(x_g, z_r, q_k * g_s, q_pe, edge_valid, scale)
        agg_v = torch.einsum("bqhd,dhe->bqhe", agg_x * g_s, w_v.reshape(D_src, H, hd))
        agg_pe = torch.einsum("bqhd,dhe->bqhe", agg_z, w_vr_g)
        const = (b_s @ w_v + c_v + b_r @ w_vr + c_vr).view(H, hd)
        agg = (agg_v + agg_pe + const * attn_sum[..., None]).reshape(B, Q, H * hd)
        g = torch.sigmoid(self.to_g(torch.cat([agg, x_dst_n], dim=-1)))
        s = self.to_s(x_dst_n)
        gated = agg + g * (s - agg)
        x = x_dst + self.postnorm(self.to_out(gated))
        ff = torch.relu(self.ff_dense0(self.ff_prenorm(x)))
        return x + self.ff_postnorm(self.ff_dense1(ff))
