"""Causal self-attention with a key-padding mask, with its CUDA kernel.

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
weights), out in the inputs' dtype. The kernel writes zeros on
pad query rows (token_mask False) and on rows with no valid key; the dense
path gives those rows a mean over whatever keys the -1e30 fill leaves. No
reader of the Llama's hidden states looks at a pad row (LlamaTextAttn reads
`read_positions` or the token-masked scatter-back), and pad keys are masked
for every query, so valid rows are the same in both. Masked keys are
skipped, never weighted by p = 0, so a non-finite value in a pad row cannot
reach a valid row. On a CPU tensor it runs `causal_attention_plain`, the
dense path written in torch.
"""

import ctypes
import functools

import torch

from prosim_torch.ops import _build
from prosim_torch.ops.neighbors import _check


_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}  # the kernel's instantiations


@functools.cache
def _launcher():
    fn = _build.load("flash_attn").flash_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def causal_attention_plain(q, k, v, token_mask, scale: float):
    """The dense path of prosim_tpu/models/llm/llama.py:172-177 in torch:
    logits in the inputs' dtype, masked with -1e30, softmax in f32, the
    probabilities cast back to the inputs' dtype; k/v repeated per query
    head group."""
    T, Hq, Hkv = q.shape[1], q.shape[2], k.shape[2]
    k = k.repeat_interleave(Hq // Hkv, dim=2)
    v = v.repeat_interleave(Hq // Hkv, dim=2)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    mask = causal[None] & token_mask[:, None, :]
    att = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    att = torch.where(mask[:, None], att, -1e30)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att, v)


def causal_attention(q, k, v, token_mask, scale: float):
    """q [B,T,Hq,D], k/v [B,T,Hkv,D], token_mask [B,T] bool -> [B,T,Hq,D].
    On the card: bf16 or f32 q/k/v (never cast), Hq a multiple of Hkv, D a
    multiple of 16 up to 128, any T."""
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, token_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention: unsupported device {q.device}")
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
    if Hkv < 1 or Hq % Hkv or D % 16 or not 16 <= D <= 128:
        raise ValueError(f"flash_attn kernel takes Hq a multiple of Hkv and D a multiple of 16 "
                         f"up to 128, got Hq={Hq}, Hkv={Hkv}, D={D}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attn kernel needs 16-byte aligned q/k/v")
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), token_mask.data_ptr(), out.data_ptr(),
        B, T, Hq, Hkv, D, float(scale), _DTYPE_CODE[dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn kernel launch failed: CUDA error {err}")
    causal_attention.launches += 1
    return out


causal_attention.launches = 0
