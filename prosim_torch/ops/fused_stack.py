"""The policy's fused two-site attention stack, with its CUDA kernel.

Port of prosim_tpu/ops/fused_stack.py. One call runs the policy's whole
interleaved (a2p, m2p) x L stack of GatedNeighborAttention layers for one
replan step, with the fixed Fourier rel-PE expanded from the edges' raw
features inside the stack, once per call. `pack_site_weights` stacks one
site's layers into the TPU kernel's packed field order (the src and rel-PE
LayerNorm affines folded into the k|v projections), once per forward.

On a CUDA tensor `fused_two_site_stack` launches csrc/fused_stack.cu, which
writes each valid edge's normalized rel-PE row once into a scratch table
[B, N, K, P rounded up to 4] per site (allocated here, no initial
contents), gathers the source rows by idx itself and folds the k|v
projections onto the query side; its blocks take the query rows 8 at a
time, heaviest first (`_row_order`), so the rows of a block carry about as
many edges. On a CPU tensor it runs `fused_two_site_stack_plain`, the math
of the TPU kernel's `_kernel` / `_site_layer` written plainly, with the
per-edge k|v projections. Compared with the TPU kernel, queries are not
padded to a tile and `valid` stays bool [B, N, K] (the TPU kernel's int8
head broadcast was a Mosaic workaround).

x_p, the source tokens and the packed weights are in the model dtype (f32
or bf16), the raw rel-PE features in f32, and the output in x_p's dtype.
The plain version rounds to the model dtype where the TPU kernel casts
(prosim_tpu/ops/fused_stack.py:141-226): the rel-PE's sine and its
normalized row, q, the per-edge k|v, the score products, the attention
weights and their products with v, the aggregate, the gate, s, the gated
update, out, the FFN's hidden layer and output, and each LayerNorm step;
every product accumulates in f32.
"""

import ctypes
import functools

import numpy as np
import torch

from prosim_torch.ops import _build
from prosim_torch.ops.attention import _norm_stats, gather_src_features
from prosim_torch.ops.neighbors import _check, refuse_grad

# packed field order per site, each stacked over the L layers:
#   wkv  = [diag(g_s) W_k | diag(g_s) W_v]
#   wkvr = [diag(g_r) W_kr | diag(g_r) W_vr]
#   bkv  = [b_s W_k + b_r W_kr | b_s W_v + c_v + b_r W_vr + c_vr]
_FIELDS = (
    "gd", "bd",          # prenorm_dst affine            [L,D]
    "wq", "bq",          # to_q                          [L,D,I], [L,I]
    "wkv",               # folded k|v over src feats     [L,D,2I]
    "wkvr",              # folded k|v over rel-PE        [L,P,2I]
    "bkv",               # folded k|v bias               [L,2I]
    "wg", "bg",          # to_g                          [L,I+D,I], [L,I]
    "ws", "bs2",         # to_s                          [L,D,I], [L,I]
    "wo", "bo",          # to_out                        [L,I,D], [L,D]
    "png", "pnb",        # postnorm affine               [L,D]
    "f1g", "f1b",        # ff_prenorm affine             [L,D]
    "w0", "b0",          # ff_dense0                     [L,D,4D], [L,4D]
    "w1", "b1",          # ff_dense1                     [L,4D,D], [L,D]
    "f2g", "f2b",        # ff_postnorm affine            [L,D]
)


def _field_shapes(L, D, I, P):
    vec_d = (L, D)
    return {
        "gd": vec_d, "bd": vec_d, "wq": (L, D, I), "bq": (L, I),
        "wkv": (L, D, 2 * I), "wkvr": (L, P, 2 * I), "bkv": (L, 2 * I),
        "wg": (L, I + D, I), "bg": (L, I), "ws": (L, D, I), "bs2": (L, I),
        "wo": (L, I, D), "bo": vec_d, "png": vec_d, "pnb": vec_d, "f1g": vec_d, "f1b": vec_d,
        "w0": (L, D, 4 * D), "b0": (L, 4 * D), "w1": (L, 4 * D, D), "b1": vec_d,
        "f2g": vec_d, "f2b": vec_d,
    }


def pack_site_weights(policy, site: str, dtype: torch.dtype = torch.float32):
    """Stack one site's GatedNeighborAttention layers (the children
    f"{site}_0", f"{site}_1", ... of `policy`) into the kernel's field
    order, dense kernels in the flax [in, out] layout. As in the JAX
    package, each leaf is cast to `dtype` first and the folds are computed
    in `dtype`. Returns a list of len(_FIELDS) contiguous tensors."""
    layers = []
    while hasattr(policy, f"{site}_{len(layers)}"):
        layers.append(getattr(policy, f"{site}_{len(layers)}"))
    if not layers:
        raise ValueError(f"{type(policy).__name__} has no {site}_0 layer")

    def stack(fn):
        return torch.stack([fn(m).to(dtype) for m in layers]).contiguous()

    wk = stack(lambda m: m.to_k.weight.t())
    wv = stack(lambda m: m.to_v.weight.t())
    wkr = stack(lambda m: m.to_k_r.weight.t())
    wvr = stack(lambda m: m.to_v_r.weight.t())
    gs, bs = stack(lambda m: m.prenorm_src.weight), stack(lambda m: m.prenorm_src.bias)
    gr, br = stack(lambda m: m.prenorm_r.weight), stack(lambda m: m.prenorm_r.bias)
    cvb = stack(lambda m: m.to_v.bias) + stack(lambda m: m.to_v_r.bias)
    fields = {
        "gd": stack(lambda m: m.prenorm_dst.weight),
        "bd": stack(lambda m: m.prenorm_dst.bias),
        "wq": stack(lambda m: m.to_q.weight.t()),
        "bq": stack(lambda m: m.to_q.bias),
        "wkv": torch.cat([gs[:, :, None] * wk, gs[:, :, None] * wv], -1),
        "wkvr": torch.cat([gr[:, :, None] * wkr, gr[:, :, None] * wvr], -1),
        "bkv": torch.cat([
            torch.einsum("ld,ldi->li", bs, wk) + torch.einsum("ld,ldi->li", br, wkr),
            torch.einsum("ld,ldi->li", bs, wv) + torch.einsum("ld,ldi->li", br, wvr) + cvb,
        ], -1),
        "wg": stack(lambda m: m.to_g.weight.t()),
        "bg": stack(lambda m: m.to_g.bias),
        "ws": stack(lambda m: m.to_s.weight.t()),
        "bs2": stack(lambda m: m.to_s.bias),
        "wo": stack(lambda m: m.to_out.weight.t()),
        "bo": stack(lambda m: m.to_out.bias),
        "png": stack(lambda m: m.postnorm.weight),
        "pnb": stack(lambda m: m.postnorm.bias),
        "f1g": stack(lambda m: m.ff_prenorm.weight),
        "f1b": stack(lambda m: m.ff_prenorm.bias),
        "w0": stack(lambda m: m.ff_dense0.weight.t()),
        "b0": stack(lambda m: m.ff_dense0.bias),
        "w1": stack(lambda m: m.ff_dense1.weight.t()),
        "b1": stack(lambda m: m.ff_dense1.bias),
        "f2g": stack(lambda m: m.ff_postnorm.weight),
        "f2b": stack(lambda m: m.ff_postnorm.bias),
    }
    return [fields[name].contiguous() for name in _FIELDS]


def fourier_consts(num_features: int, pe_dim: int, temperature: float = 10000.0):
    """FourierEmbeddingFix as ONE sin: emb = sin(feats @ m1 + phase), with
    cos(x) = sin(x + pi/2); per-feature blocks of interleaved sin/cos over
    the temperature ramp (ops/fourier.py's column layout). Returns m1
    [F, F*npf] and phase [1, F*npf], float32 on the CPU."""
    npf = pe_dim // num_features
    dim_t = temperature ** (2 * (np.arange(npf) // 2) / npf)
    m1 = np.zeros((num_features, num_features * npf), np.float32)
    phase = np.zeros((1, num_features * npf), np.float32)
    for j in range(num_features):
        for k in range(npf):
            m1[j, j * npf + k] = 2.0 * np.pi / dim_t[k]
            phase[0, j * npf + k] = 0.0 if k % 2 == 0 else np.pi / 2
    return torch.from_numpy(m1), torch.from_numpy(phase)


@functools.cache
def _fourier_table(num_features: int, pe_dim: int, device) -> torch.Tensor:
    """[2, P]: each rel-PE column's frequency (the one nonzero of its m1
    column) and phase, on `device`."""
    m1, phase = fourier_consts(num_features, pe_dim)
    with torch.inference_mode(False):  # cached: usable in and out of inference mode
        return torch.stack([m1.sum(0), phase[0]]).to(device)


def _z_from_feats(feats, pe_dim: int, dtype: torch.dtype = torch.float32):
    """The normalized fixed rel-PE [.., K, P] of raw features [.., K, F] in
    `dtype`: feats @ m1 is one product per column (the other terms are
    exact zeros), then + phase, sin (rounded to `dtype`) and the
    parameter-free LayerNorm."""
    F = feats.shape[-1]
    freq, phase = _fourier_table(F, pe_dim, feats.device)
    scaled = feats.repeat_interleave(pe_dim // F, dim=-1) * freq + phase
    return _norm_stats(torch.sin(scaled).to(dtype))


def _site_layer(x, w, l, xg, z, valid, num_heads: int, head_dim: int):
    """One GatedNeighborAttention layer (prosim_tpu/ops/fused_stack.py
    `_site_layer`) in x's dtype dt. x [B,N,D]; xg [B,N,K,D]; z [B,N,K,P];
    valid [B,N,K]. Each product takes the f32 values of its dt operands
    (`_dot`'s f32 accumulation); in f32 every cast is the identity."""
    B, N, K, _ = xg.shape
    H, hd = num_heads, head_dim
    I = H * hd
    dt = x.dtype

    def dot(a, b):
        return a.float() @ b.float()

    xn = _norm_stats(x) * w["gd"][l] + w["bd"][l]
    q = dot(xn, w["wq"][l]).to(dt) + w["bq"][l]
    kv = (dot(xg, w["wkv"][l]) + dot(z, w["wkvr"][l]) + w["bkv"][l].float()).to(dt)  # [B,N,K,2I]
    sim = (kv[..., :I] * q[:, :, None]).float().view(B, N, K, H, hd).sum(-1) * hd ** -0.5
    vmask = valid[..., None]
    sim = torch.where(vmask, sim, -torch.inf)
    smax = sim.amax(dim=2, keepdim=True)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    expw = torch.where(vmask, torch.exp(sim - smax), 0.0)
    attn = (expw / expw.sum(dim=2, keepdim=True).clamp_min(1e-9)).to(dt)  # [B,N,K,H]
    agg = (attn[..., None] * kv[..., I:].reshape(B, N, K, H, hd)).float().sum(2)
    agg = agg.to(dt).reshape(B, N, I)
    g = torch.sigmoid(dot(torch.cat([agg, xn], -1), w["wg"][l]) + w["bg"][l].float()).to(dt)
    s = dot(xn, w["ws"][l]).to(dt) + w["bs2"][l]
    gated = agg + g * (s - agg)
    out = dot(gated, w["wo"][l]).to(dt) + w["bo"][l]
    x = x + _norm_stats(out) * w["png"][l] + w["pnb"][l]
    ff_in = _norm_stats(x) * w["f1g"][l] + w["f1b"][l]
    h0 = torch.relu(dot(ff_in, w["w0"][l]) + w["b0"][l].float()).to(dt)
    ff = dot(h0, w["w1"][l]).to(dt) + w["b1"][l]
    return x + _norm_stats(ff) * w["f2g"][l] + w["f2b"][l]


def fused_two_site_stack_plain(x_p, a2p_tables, m2p_tables, weights_a, weights_m, *,
                               num_heads: int, head_dim: int):
    """Plain PyTorch version of `fused_two_site_stack`."""
    num_layers = weights_a[0].shape[0]
    pe_dim = weights_a[_FIELDS.index("wkvr")].shape[1]
    sites = []
    for (x_src, idx, feats, valid), w in ((a2p_tables, weights_a), (m2p_tables, weights_m)):
        # idx is arbitrary where an edge is invalid: gather row 0 there
        xg = gather_src_features(x_src, torch.where(valid, idx, 0))
        sites.append((xg, _z_from_feats(feats, pe_dim, x_p.dtype), valid, dict(zip(_FIELDS, w))))
    x = x_p
    for l in range(num_layers):
        for xg, z, valid, w in sites:
            x = _site_layer(x, w, l, xg, z, valid, num_heads, head_dim)
    return x


def _row_order(valid_a, valid_m):
    """The query rows (b * N + n) heaviest first, by valid m2p edges, then
    valid a2p edges, as int32: the kernel's blocks take them 8 at a time,
    and a block's rows wait for its longest one at every layer."""
    key = valid_m.sum(-1) * (valid_a.shape[-1] + 1) + valid_a.sum(-1)
    return torch.argsort(key.flatten(), descending=True, stable=True).to(torch.int32)


@functools.cache
def _launcher(dtype: torch.dtype):
    """The kernel's instantiation for the model dtype: f32 or bf16."""
    lib = _build.load("fused_stack")
    fn = lib.fused_stack_launch_bf16 if dtype == torch.bfloat16 else lib.fused_stack_launch
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def fused_two_site_stack(x_p, a2p_tables, m2p_tables, weights_a, weights_m, *,
                         num_heads: int, head_dim: int):
    """Run the interleaved (a2p, m2p) x L gated-attention stack.

    x_p [B,N,D] in the model dtype (f32 or bf16: the kernel's two
    instantiations); each site's tables are (x_src [B,S,D] source tokens in
    x_p's dtype, idx [B,N,K] int32, feats [B,N,K,F] f32 raw rel-PE features
    (the reference's 4, rel_ori_vec twice), valid [B,N,K] bool), idx in
    [0, S) where valid (arbitrary elsewhere); weights_* are
    `pack_site_weights` outputs in x_p's dtype. The two sites may have
    different S and K. Returns [B,N,D] in x_p's dtype. Forward only: refuses
    inputs that require grad while grad mode is on."""
    refuse_grad("fused_two_site_stack", x_p, a2p_tables, m2p_tables, weights_a, weights_m)
    dt = x_p.dtype
    got = [t.dtype for t in (a2p_tables[0], m2p_tables[0], *weights_a, *weights_m)]
    feats = [a2p_tables[2].dtype, m2p_tables[2].dtype]
    if (dt not in (torch.float32, torch.bfloat16) or any(d != dt for d in got)
            or any(d != torch.float32 for d in feats)):
        raise TypeError("fused_two_site_stack takes x_p, the source tokens and the packed weights "
                        f"in one dtype, float32 or bfloat16, and f32 feats; got x_p {dt}, "
                        f"the rest {sorted(set(map(str, got)))}, feats {feats}")
    if x_p.device.type == "cpu":
        return fused_two_site_stack_plain(x_p, a2p_tables, m2p_tables, weights_a, weights_m,
                                          num_heads=num_heads, head_dim=head_dim)
    if x_p.device.type != "cuda":
        raise ValueError(f"fused_two_site_stack: unsupported device {x_p.device}")
    B, N, D = x_p.shape
    dev = x_p.device
    H, hd = num_heads, head_dim
    I = H * hd
    L = weights_a[0].shape[0]
    P = weights_a[_FIELDS.index("wkvr")].shape[1]
    F = a2p_tables[2].shape[-1]
    _check("x_p", x_p, dt, (B, N, D), dev)
    sites = []
    for name, (x_src, idx, feats, valid) in (("a2p", a2p_tables), ("m2p", m2p_tables)):
        S, K = x_src.shape[1], idx.shape[-1]
        # the kernel gathers rows of the normalized tokens (any layout in)
        src_n = _norm_stats(x_src).contiguous()
        _check(f"{name} x_src", src_n, dt, (B, S, D), dev)
        _check(f"{name} idx", idx, torch.int32, (B, N, K), dev)
        _check(f"{name} feats", feats, torch.float32, (B, N, K, F), dev)
        _check(f"{name} valid", valid, torch.bool, (B, N, K), dev)
        sites.append((src_n, idx, feats, valid, S, K))
    shapes = _field_shapes(L, D, I, P)
    for site, weights in (("a2p", weights_a), ("m2p", weights_m)):
        if len(weights) != len(_FIELDS):
            raise ValueError(f"{site} weights: expected {len(_FIELDS)} packed fields")
        for name, t in zip(_FIELDS, weights):
            _check(f"{site} {name}", t, dt, shapes[name], dev)
    if not (1 <= H <= 8 and hd % 4 == 0 and 0 < I <= 128 and D <= 128 and P <= 128
            and P % F == 0):
        raise ValueError(f"fused_stack kernel takes H <= 8, hd a multiple of 4, I = H*hd <= 128, "
                         f"D, P <= 128 and F | P; got H={H}, hd={hd}, D={D}, P={P}, F={F}")
    (src_a, idx_a, feats_a, valid_a, Sa, Ka), (src_m, idx_m, feats_m, valid_m, Sm, Km) = sites
    ptrs = [(ctypes.c_void_p * len(_FIELDS))(*[t.data_ptr() for t in w])
            for w in (weights_a, weights_m)]
    fconst = _fourier_table(F, P, dev)
    # the kernel's rel-PE tables, rows of 16 bytes a multiple; rows of
    # invalid edges are never written or read
    per16 = 16 // x_p.element_size()
    pz = (P + per16 - 1) // per16 * per16
    z_a = torch.empty((B, N, Ka, pz), dtype=dt, device=dev)
    z_m = torch.empty((B, N, Km, pz), dtype=dt, device=dev)
    order = _row_order(valid_a, valid_m)
    out = torch.empty_like(x_p)
    err = _launcher(dt)(
        x_p.data_ptr(), out.data_ptr(), order.data_ptr(),
        src_a.data_ptr(), idx_a.data_ptr(), feats_a.data_ptr(), valid_a.data_ptr(),
        src_m.data_ptr(), idx_m.data_ptr(), feats_m.data_ptr(), valid_m.data_ptr(),
        z_a.data_ptr(), z_m.data_ptr(),
        ctypes.cast(ptrs[0], ctypes.c_void_p), ctypes.cast(ptrs[1], ctypes.c_void_p),
        fconst.data_ptr(), B, N, Sa, Ka, Sm, Km, L, D, H, hd, F, P, float(hd ** -0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_stack kernel launch failed: CUDA error {err}")
    fused_two_site_stack.launches += 1
    return out


fused_two_site_stack.launches = 0
