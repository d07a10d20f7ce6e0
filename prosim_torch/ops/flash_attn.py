"""Causal self-attention with a key-padding mask, with its CUDA kernels
(forward and backward).

Port of the attention of prosim_tpu/models/llm/llama.py:_causal_attention,
which on a TPU calls the library Pallas flash-attention kernel (key padding
given as segment ids) and elsewhere its dense path. For query row t of
head h:
    out[t, h] = softmax_s(q[t, h] . k[s, g] * scale) v[s, g]
over the keys s <= t with token_mask[s], g = h // (Hq / Hkv) (grouped-query
attention: consecutive query heads share a key/value head, jnp.repeat's
order).

On a CUDA tensor `causal_attention` launches csrc/flash_attn.cu: bf16 q/k/v
(tensor-core products, f32 accumulation and softmax statistics; the
Llama3-8B text path) or f32 q/k/v (products by FMA on the CUDA cores, the
f32 `LlamaConfig.tiny()` that configs/waymo_demo.yaml resolves to without
weights), out in the inputs' dtype, at any head width D <= 128: the
kernels take D a multiple of 16, so a narrower or ragged D is zero-padded
to the next multiple of 16 before the launch and the results sliced back
(exact: a zero column adds nothing to any product, and the caller's scale
is that of the true D). The kernel writes zeros on
pad query rows (token_mask False) and on rows with no valid key; the dense
path gives those rows a mean over whatever keys the -1e30 fill leaves. No
reader of the Llama's hidden states looks at a pad row (LlamaTextAttn reads
`read_positions` or the token-masked scatter-back), and pad keys are masked
for every query, so valid rows are the same in both. Masked keys are
skipped, never weighted by p = 0, so a non-finite value in a pad row cannot
reach a valid row. On a CPU tensor it runs `causal_attention_plain`, the
dense path written in torch.

Gradients. With grad mode on and any of q/k/v requiring grad,
`causal_attention` goes through `CausalAttention`, whose forward also keeps
each row's log-sum-exp `lse [B, Hq, T]` (f32; -inf on pad rows) and whose
backward is csrc/flash_attn_bwd.cu on the card (the counterpart of the
library kernel's backward, which the JAX package reaches under
jax.value_and_grad) and `causal_attention_bwd_plain` on the CPU. The
kernel works on each scene's valid rows only: its prep launch lists them
in order (`valid_rows_plain` is that list's plain version) and the dkv
and dq launches walk tiles of the list; compaction keeps order, so the
result is the uncompacted one. Its
semantics: pad query rows get dq = 0 and contribute nothing; pad keys get
dk = dv = 0; dk and dv sum over each group's Hq/Hkv query heads. That is the
dense path's gradient on every valid row: the upstream gradient of a pad
row is zero (no reader looks at one, as above), so in the dense path a pad
row's dq is zero and it adds nothing to any key, and a pad key's
probability is exactly 0 in every valid row. Outside grad mode (eval) the
forward launch is the one without `lse`.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from prosim_torch.ops import _build
from prosim_torch.ops.neighbors import _check


_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}  # the kernel's instantiations


@functools.cache
def _launcher():
    fn = _build.load("flash_attn").flash_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    fn = _build.load("flash_attn_bwd").flash_attn_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _masked_logits(q, k, token_mask, scale: float):
    """[B, Hq, T, T] logits of the dense path in the inputs' dtype, -1e30
    off the causal valid keys; k repeated per query head group."""
    T, Hq, Hkv = q.shape[1], q.shape[2], k.shape[2]
    k = k.repeat_interleave(Hq // Hkv, dim=2)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    mask = causal[None] & token_mask[:, None, :]
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return torch.where(mask[:, None], att, -1e30)


def causal_attention_plain(q, k, v, token_mask, scale: float):
    """The dense path of prosim_tpu/models/llm/llama.py:172-177 in torch:
    logits in the inputs' dtype, masked with -1e30, softmax in f32, the
    probabilities cast back to the inputs' dtype; k/v repeated per query
    head group."""
    Hq, Hkv = q.shape[2], k.shape[2]
    att = torch.softmax(_masked_logits(q, k, token_mask, scale).float(), dim=-1).to(q.dtype)
    v = v.repeat_interleave(Hq // Hkv, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", att, v)


def causal_attention_fwd_plain(q, k, v, token_mask, scale: float):
    """(out, lse): the dense path with pad query rows zeroed, as the kernel
    writes them, and each row's natural-log log-sum-exp of its scaled
    logits over its valid keys, f32 [B, Hq, T], -inf on pad rows."""
    out = causal_attention_plain(q, k, v, token_mask, scale)
    lse = torch.logsumexp(_masked_logits(q, k, token_mask, scale).float(), dim=-1)
    lse = torch.where(token_mask[:, None, :], lse, float("-inf"))
    return torch.where(token_mask[:, :, None, None], out, 0.0), lse


def causal_attention_bwd_plain(q, k, v, o, lse, do, token_mask, scale: float):
    """(dq, dk, dv) of the causal attention, the flash backward step by step
    in torch: products in the inputs' dtype with P and dS rounded to it as
    product inputs (as the kernel rounds them), statistics in f32:
      P = exp(S scale - lse) over the valid causal pairs (0 elsewhere, by
          selection), D = rowsum(dO o), dV = P^T dO, dS = P (dO V^T - D),
      dQ = dS K scale, dK = dS^T Q scale,
    dK and dV summed over each group's Hq/Hkv query heads. Pad rows of
    every input are selected out before any product, so a non-finite value
    there reaches no gradient; pad query rows' dq and pad keys' dk/dv are
    exactly zero."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    dt = q.dtype
    rows = token_mask[:, :, None, None]
    q, o, do = (torch.where(rows, x, 0.0) for x in (q, o, do))
    k, v = (torch.where(rows, x, 0.0).repeat_interleave(G, dim=2) for x in (k, v))
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    valid = (causal[None] & token_mask[:, None, :] & token_mask[:, :, None])[:, None]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B, Hq, T]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt), do).float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v).float()
    ds = (p * (dp - delta[..., None])).to(dt)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k).float() * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q).float() * scale
    group = lambda x: x.view(B, T, Hkv, G, D).sum(dim=3).to(dt)  # noqa: E731
    return dq.to(dt), group(dk), group(dv)


def valid_rows_plain(token_mask):
    """(rows [B, T] int32, counts [B] int32): each scene's valid positions
    in ascending order, then -1; the plain version of the list the
    backward's prep launch builds (on the card the entries past a scene's
    count are left unwritten and never read). Compaction keeps order, so a
    key s may be attended from a query t (s <= t) exactly when its rank in
    the list is at most t's."""
    B, T = token_mask.shape
    pos = torch.arange(T, dtype=torch.int32, device=token_mask.device).expand(B, T)
    # valid positions sort first and keep their order (a stable sort)
    key = torch.where(token_mask, pos, T + pos)
    rows = key.sort(dim=1, stable=True).values.to(torch.int32)
    counts = token_mask.sum(dim=1, dtype=torch.int32)
    past = torch.arange(T, device=token_mask.device)[None] >= counts[:, None]
    return rows.masked_fill(past, -1), counts


def _check_inputs(q, k, v, token_mask):
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    dev = q.device
    dtype = q.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"causal_attention on the card takes bf16 or f32 q/k/v, got {dtype}")
    _check("q", q, dtype, (B, T, Hq, D), dev)
    _check("k", k, dtype, (B, T, Hkv, D), dev)
    _check("v", v, dtype, (B, T, Hkv, D), dev)
    _check("token_mask", token_mask, torch.bool, (B, T), dev)
    if Hkv < 1 or Hq % Hkv or not 1 <= D <= 128:
        raise ValueError(f"flash_attn kernel takes Hq a multiple of Hkv and D up to 128, "
                         f"got Hq={Hq}, Hkv={Hkv}, D={D}")


def _pad_width(*ts):
    """The tensors zero-padded along the head width to the kernels' next
    multiple of 16 (unchanged when D is one), each 16-byte aligned."""
    pad = (-ts[0].shape[-1]) % 16
    ts = tuple(F.pad(t, (0, pad)) for t in ts) if pad else ts
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attn kernels need 16-byte aligned inputs")
    return ts


def _flash_fwd(q, k, v, token_mask, scale: float, with_lse: bool):
    """One launch of csrc/flash_attn.cu: out, and lse when asked for."""
    _check_inputs(q, k, v, token_mask)
    D0 = q.shape[-1]
    q, k, v = _pad_width(q, k, v)
    B, T, Hq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) if with_lse else None
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), token_mask.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, T, Hq, k.shape[2], D, float(scale),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {err}")
    causal_attention.launches += 1
    return (out if D == D0 else out[..., :D0].contiguous()), lse


def causal_attention_bwd(q, k, v, o, lse, do, token_mask, scale: float):
    """(dq, dk, dv). On a CUDA tensor one call of csrc/flash_attn_bwd.cu
    (its prep, dkv and dq kernels); on a CPU tensor
    `causal_attention_bwd_plain`. o, do [B,T,Hq,D] in q's dtype, lse f32
    [B,Hq,T] from the forward."""
    if q.device.type == "cpu":
        return causal_attention_bwd_plain(q, k, v, o, lse, do, token_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention_bwd: unsupported device {q.device}")
    _check_inputs(q, k, v, token_mask)
    B, T, Hq, D0 = q.shape
    Hkv = k.shape[2]
    _check("o", o, q.dtype, (B, T, Hq, D0), q.device)
    _check("do", do, q.dtype, (B, T, Hq, D0), q.device)
    _check("lse", lse, torch.float32, (B, Hq, T), q.device)
    q, k, v, o, do = _pad_width(q, k, v, o, do)
    D = q.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # scratch the prep launch writes: each scene's valid positions and the
    # counts; the compacted lse (log2 domain) and delta
    rows = torch.empty((B * T + B,), dtype=torch.int32, device=q.device)
    stats = torch.empty((2, B, Hq, -(-T // 64) * 64), dtype=torch.float32, device=q.device)
    err = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        token_mask.data_ptr(), rows.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, Hq, Hkv, D, float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed: CUDA error {err}")
    causal_attention_bwd.launches += 1
    if D != D0:
        dq, dk, dv = (t[..., :D0].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


# Callables that CausalAttention's backward calls after each backward with
# its inputs (q, k, v, out, lse, do, token_mask, scale) and its (dq, dk,
# dv): a check can hold every backward of a train step on its own inputs.
backward_observers = []


class CausalAttention(torch.autograd.Function):
    """causal_attention with a gradient: the forward keeps q, k, v, out and
    lse; the backward is `causal_attention_bwd` (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, token_mask, scale: float):
        if q.device.type == "cpu":
            out, lse = causal_attention_fwd_plain(q, k, v, token_mask, scale)
        elif q.device.type == "cuda":
            out, lse = _flash_fwd(q, k, v, token_mask, scale, with_lse=True)
        else:
            raise ValueError(f"causal_attention: unsupported device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse, token_mask)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, token_mask = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = causal_attention_bwd(q, k, v, out, lse, do, token_mask, ctx.scale)
        for fn in backward_observers:
            fn((q, k, v, out, lse, do, token_mask, ctx.scale), (dq, dk, dv))
        return dq, dk, dv, None, None


def causal_attention(q, k, v, token_mask, scale: float):
    """q [B,T,Hq,D], k/v [B,T,Hkv,D], token_mask [B,T] bool -> [B,T,Hq,D].
    On the card: bf16 or f32 q/k/v (never cast), Hq a multiple of Hkv, D up
    to 128 (padded to a multiple of 16 for the kernel), any T.
    Differentiable through `CausalAttention` when grad mode is on and q, k
    or v requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return CausalAttention.apply(q, k, v, token_mask, scale)
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, token_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention: unsupported device {q.device}")
    return _flash_fwd(q, k, v, token_mask, scale, with_lse=False)[0]


causal_attention.launches = 0
causal_attention_bwd.launches = 0
