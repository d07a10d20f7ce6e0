"""Gated neighborhood attention over fixed-K neighbor grids (port of
prosim_tpu/ops/attention.py).

One op serves every sparse-attention site of the rollout (scene a2a/s2s,
decoder p2p/s2p, policy a2p/m2p). The parameter tree is the flax one, and
the math is the JAX package's weight-folded form: LayerNorm splits into a
parameter-free normalization (shared across layers) and a per-layer affine,
and the k/v/PE projections fold onto the query side, so per layer only the
score/softmax/aggregate core touches the per-edge tables. In eval mode that
core is `ops/edge_attn.py:edge_attn_core`, a CUDA kernel on the card, which
has no backward; where a gradient may be wanted (grad mode on, or training
with `deterministic=False`) it is `attend_gathered`, the JAX package's
differentiable XLA branch with the score bias and attention dropout.

The layer computes in `dtype` where the JAX layer does
(prosim_tpu/ops/attention.py:297-393): the parameter-free normalizations
in f32, rounded to the input's dtype; the LayerNorm affines, the folded
weights and the query folds cast to `dtype`; the Dense layers and the
LayerNorms as ops/mlp.py's Dense and LayerNorm. The JAX package reads the
k/v/PE weights back through identity probes and bit-packs bf16 rows for the
TPU gather (:160-189); both give the same weight and row values, so the
port reads the weights and gathers the bf16 rows directly.
"""

import ctypes
import functools

import torch
from torch import nn

from prosim_torch.ops import _build
from prosim_torch.ops.edge_attn import attend_gathered, edge_attn_core
from prosim_torch.ops.fourier import FourierEmbedding, FourierEmbeddingFix
from prosim_torch.ops.mlp import Dense, LayerNorm
from prosim_torch.ops.neighbors import _check, gather_neighbors
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
    """Rel-PE features -> embeddings in `dtype`. Fixed path with
    fold_dup=True embeds only the 3 unique features (3/4 * hidden_dim dims);
    fold_dup=False re-appends the duplicate block (reference layout). The
    fixed embedding is computed in f32 and cast to `dtype`."""

    def __init__(self, hidden_dim: int, learnable_pe: bool = False,
                 num_freq_bands: int = 64, fold_dup: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.learnable_pe = learnable_pe
        self.fold_dup = fold_dup
        self.dtype = dtype
        if learnable_pe:
            self.fourier = FourierEmbedding(3, hidden_dim, num_freq_bands, dtype)
        else:
            self.fourier_fix = FourierEmbeddingFix(num_pos_feats=hidden_dim // 4)

    def forward(self, pe_input):
        if self.learnable_pe:
            return self.fourier(pe_input)
        npf = self.hidden_dim // 4
        emb = self.fourier_fix(pe_input).to(self.dtype)
        if not self.fold_dup:
            emb = torch.cat([emb, emb[..., 2 * npf :]], dim=-1)
        return emb


def _norm_stats(x, eps: float = 1e-5, dup_tail: int = 0):
    """Parameter-free LayerNorm (flax stats: last dim, fast variance),
    computed in f32 and returned in x's dtype.
    dup_tail > 0: stats of the wider row in which the last dup_tail dims
    appear twice (the folded rel-PE duplicate); only unique dims returned."""
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


def takes_kernel(deterministic: bool) -> bool:
    """Whether the layer's core is the kernel (`edge_attn_core`, no
    backward): only when the layer is deterministic and grad mode is off."""
    return deterministic and not torch.is_grad_enabled()


def rel_pe_table_plain(dst_pos, dst_ori, src_pos, src_ori, idx, pe: RelPE):
    """The normalized rel-PE table [B,Q,K,D_pe] of a site: the features of
    the pairs (dst q, src idx[b,q,k]), embedded by `pe` and normalized over
    its reference width."""
    return normalize_rel_pe(pe(rel_pe_features(dst_pos, dst_ori, src_pos, src_ori, idx)),
                            pe.hidden_dim)


def table_takes_kernel(pe: RelPE, deterministic: bool) -> bool:
    """Whether a site's table on the card is the kernel's: the fixed folded
    embedding, with no gradient wanted. The learnable embedding, the
    reference layout (fold_dup=False) and training take the plain chain."""
    return not pe.learnable_pe and pe.fold_dup and takes_kernel(deterministic)


@functools.cache
def _table_launcher(dtype: torch.dtype):
    """The table kernel's instantiation for the table's dtype: f32 or bf16."""
    lib = _build.load("rel_pe_table")
    fn = lib.rel_pe_table_launch_bf16 if dtype == torch.bfloat16 else lib.rel_pe_table_launch
    pose = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    fn.argtypes = pose * 4 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _table_freqs(npf: int, temperature: float, device: torch.device):
    """cat(inv_t, phase) [2 npf] f32 of FourierEmbeddingFix, computed on
    `device` by its own expressions, so the kernel's sines take the plain
    chain's arguments."""
    return torch.cat(FourierEmbeddingFix(npf, temperature).freqs(device)).contiguous()


def _pose_args(pos, ori, name):
    """A pose's kernel arguments: f32 position [B,N,2] and orientation [B,N]
    with their batch and row strides (a view that keeps each position's two
    coordinates adjacent is read in place)."""
    pos, ori = pos.float(), ori.float()
    if pos.dim() != 3 or pos.shape[-1] != 2 or ori.shape != pos.shape[:2]:
        raise ValueError(f"{name}: pos [B,N,2] and ori [B,N], got {tuple(pos.shape)} and "
                         f"{tuple(ori.shape)}")
    if pos.stride(-1) != 1:
        pos = pos.contiguous()
    return pos, ori, [pos.data_ptr(), pos.stride(0), pos.stride(1),
                      ori.data_ptr(), ori.stride(0), ori.stride(1)]


def rel_pe_table(dst_pos, dst_ori, src_pos, src_ori, idx, pe: RelPE, deterministic: bool):
    """rel_pe_table_plain(...) of a site: dst_pos [B,Q,2], dst_ori [B,Q],
    src_pos [B,S,2], src_ori [B,S], idx [B,Q,K] (in [0, S), arbitrary where
    an edge is invalid) -> [B,Q,K,3 (hidden // 4)] in pe's dtype. On a CUDA
    tensor where `table_takes_kernel`, one launch of csrc/rel_pe_table.cu
    writes it, with the plain chain's roundings (the statistics' sums in
    another order); elsewhere the plain chain builds it (on the card counted
    in `rel_pe_table.plain_builds`)."""
    on_card = dst_pos.device.type == "cuda"
    if not (on_card and table_takes_kernel(pe, deterministic)):
        rel_pe_table.plain_builds += on_card
        return rel_pe_table_plain(dst_pos, dst_ori, src_pos, src_ori, idx, pe)
    npf = pe.hidden_dim // 4
    if not 1 <= npf <= 32:  # a lane a Fourier feature
        raise ValueError("rel_pe_table kernel takes hidden_dim // 4 from 1 to 32, got "
                         f"hidden_dim {pe.hidden_dim}")
    dt = pe.dtype
    if dt not in (torch.float32, torch.bfloat16) or dst_ori.dtype not in (torch.float32,
                                                                          torch.bfloat16):
        raise TypeError(f"rel_pe_table kernel takes a float32 or bfloat16 table and destination "
                        f"pose, got {dt} and {dst_ori.dtype}")
    B, Q, K = idx.shape
    S = src_pos.shape[1]
    dev = dst_pos.device
    idx = idx.to(torch.int32).contiguous()
    _check("idx", idx, torch.int32, (B, Q, K), dev)
    dst = _pose_args(dst_pos, dst_ori, "dst")
    src = _pose_args(src_pos, src_ori, "src")
    for name, (pos, _, _), n in (("dst", dst, Q), ("src", src, S)):
        if pos.shape[0] != B or pos.shape[1] != n or pos.device != dev:
            raise ValueError(f"{name} pose {tuple(pos.shape)} on {pos.device} does not fit idx "
                             f"{(B, Q, K)} on {dev}")
    z = torch.empty((B, Q, K, 3 * npf), dtype=dt, device=dev)
    if z.numel() == 0:
        return z
    freqs = _table_freqs(npf, pe.fourier_fix.temperature, dev)
    err = _table_launcher(dt)(
        *dst[2], *src[2], idx.data_ptr(), freqs.data_ptr(), z.data_ptr(), B, Q, S, K, npf,
        pe.hidden_dim, int(dst_ori.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rel_pe_table kernel launch failed: CUDA error {err}")
    rel_pe_table.launches += 1
    return z


rel_pe_table.launches = 0
rel_pe_table.plain_builds = 0


def gather_src_features(x_src, idx):
    """Gathered parameter-free-normalized source features [B,Q,K,D]: the
    per-edge table of the fused stack's plain version (ops/fused_stack.py).
    The layer loop's edge core gathers the rows of _norm_stats(x_src) itself."""
    return gather_neighbors(_norm_stats(x_src), idx)


def dropout(x, rate: float, generator: torch.Generator):
    """flax's nn.Dropout in training: keep each element with probability
    1 - rate and scale it by 1 / (1 - rate). The mask is drawn from
    `generator`, so a checkpointed region that rebuilds its generator from
    the same seed draws the same masks when it is recomputed."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def shared_source(x_src, idx, edge_valid, deterministic: bool) -> dict:
    """The normalized source rows that every layer of a stack shares while
    x_src is layer-constant, as the layer's keyword: `src_normed` [B,S,D]
    for the kernel, which gathers its rows itself, or `src_gathered`
    [B,Q,K,D] for the differentiable branch, one gather (and one backward
    scatter) per stack, as the JAX package's decoder and policy pass
    `src_gathered` (prosim_tpu/models/policy.py:236-247)."""
    x_n = _norm_stats(x_src)
    if takes_kernel(deterministic):
        return {"src_normed": x_n}
    return {"src_gathered": gather_neighbors(x_n, torch.where(edge_valid, idx, 0))}


class GatedNeighborAttention(nn.Module):
    """QCNet gated attention layer (reference: attention_layer.py:87-121).
    `dropout` acts on the attention weights and the FFN's hidden layer when
    the layer runs with deterministic=False."""

    def __init__(self, hidden_dim: int, num_heads: int, head_dim: int,
                 bipartite: bool = False, pe_dim: int = None, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.bipartite = bipartite
        self.dropout = dropout
        self.dtype = dtype
        D = hidden_dim
        P = pe_dim or hidden_dim  # full reference width of the rel-PE
        inner = num_heads * head_dim
        # affine-only: the parameter-free part is shared (_norm_stats)
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

    def forward(self, x_dst, x_src, idx, edge_valid, pe_normed, src_normed=None,
                src_gathered=None, deterministic: bool = True, generator=None):
        """x_dst [B,Q,D], x_src [B,S,D], idx [B,Q,K], edge_valid [B,Q,K],
        pe_normed [B,Q,K,D_pe] = normalize_rel_pe(rel_pe, P) (D_pe < P when
        folded) -> [B,Q,D]. The core is the kernel (`edge_attn_core`) when
        the layer is deterministic and grad mode is off; otherwise it is the
        differentiable training branch, with dropout drawn from `generator`
        when deterministic=False.

        src_normed: optional [B,S,D] = _norm_stats(x_src), the parameter-free
        normalized source rows that the kernel gathers by idx; src_gathered:
        optional [B,Q,K,D], those rows gathered, for the differentiable
        branch (`shared_source` makes the one the layer takes). The tables
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
        dt = self.dtype

        g_s, b_s = self.prenorm_src.weight.to(dt), self.prenorm_src.bias.to(dt)
        norm_dst = self.prenorm_dst if self.bipartite else self.prenorm_src
        x_dst_n = _norm_stats(x_dst) * norm_dst.weight.to(dt) + norm_dst.bias.to(dt)

        qh = self.to_q(x_dst_n).view(B, Q, H, hd)
        w_k = self.to_k.weight.t().to(dt)           # [D_src, inner]
        w_v, c_v = self.to_v.weight.t().to(dt), self.to_v.bias.to(dt)

        z_r = pe_normed
        D_pe = z_r.shape[-1]
        P = self.prenorm_r.weight.shape[0]
        tail = P - D_pe
        g_r, b_r = self.prenorm_r.weight.to(dt), self.prenorm_r.bias.to(dt)
        w_kr = self.to_k_r.weight.t().to(dt)        # [P, inner]
        w_vr, c_vr = self.to_v_r.weight.t().to(dt), self.to_v_r.bias.to(dt)
        w_kr_g = _fold_pe_tail(w_kr * g_r[:, None], tail).view(D_pe, H, hd)
        w_vr_g = _fold_pe_tail(w_vr * g_r[:, None], tail).view(D_pe, H, hd)

        q_k = torch.einsum("bqhe,dhe->bqhd", qh, w_k.reshape(D_src, H, hd))
        q_pe = torch.einsum("bqhe,dhe->bqhd", qh, w_kr_g)
        if takes_kernel(deterministic):
            x_src_n = _norm_stats(x_src) if src_normed is None else src_normed
            agg_x, agg_z, attn_sum = edge_attn_core(
                x_src_n.contiguous(), idx.to(torch.int32).contiguous(), z_r.contiguous(),
                (q_k * g_s).contiguous(), q_pe.contiguous(), edge_valid.contiguous(), scale,
            )
        else:
            if src_gathered is None:
                src_gathered = shared_source(x_src, idx, edge_valid, False)["src_gathered"]
            # the score bias q.(W_k b_s) + q.(W_kr b_r) over all P rows; it
            # cancels in the softmax, and is kept as the JAX package keeps it
            bias = torch.einsum("bqhd,d->bqh", q_k, b_s) + torch.einsum(
                "bqhe,he->bqh", qh, torch.einsum("dhe,d->he", w_kr.reshape(P, H, hd), b_r))
            drop = None if deterministic else (lambda a: dropout(a, self.dropout, generator))
            agg_x, agg_z, attn = attend_gathered(
                src_gathered, z_r, q_k * g_s, q_pe, edge_valid, scale, bias, drop)
            attn_sum = attn.sum(dim=2)  # not 1 under dropout
        agg_v = torch.einsum("bqhd,dhe->bqhe", agg_x * g_s, w_v.reshape(D_src, H, hd))
        agg_pe = torch.einsum("bqhd,dhe->bqhe", agg_z, w_vr_g)
        const = (b_s @ w_v + c_v + b_r @ w_vr + c_vr).view(H, hd)
        agg = (agg_v + agg_pe + const * attn_sum[..., None]).reshape(B, Q, inner)

        g = torch.sigmoid(self.to_g(torch.cat([agg, x_dst_n], dim=-1)))
        s = self.to_s(x_dst_n)
        gated = agg + g * (s - agg)
        x = x_dst + self.postnorm(self.to_out(gated))
        ff = torch.relu(self.ff_dense0(self.ff_prenorm(x)))
        if not deterministic:
            ff = dropout(ff, self.dropout, generator)
        return x + self.ff_postnorm(self.ff_dense1(ff))
