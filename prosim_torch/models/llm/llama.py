"""Llama3 decoder with LoRA (port of prosim_tpu/models/llm/llama.py), for
inference and for LoRA training through a frozen body.

Architecture: RMSNorm, rotary embeddings (HF half-split), grouped-query
attention, SwiGLU; LoRA adapters on q/k/v and on the token embedding
(reference: text_attns.py:96-120). `LlamaConfig.llama3_8b()` has the
released checkpoint's widths, `tiny()` is for tests. Module and parameter
names mirror the flax ones, so utils/params.py carries a flax tree over
leaf by leaf (LoRA factors keep their flax [in, r] / [r, out] layout).

Precision follows the JAX package's dtype flow. Flax params are f32 and
RMSNorm's f32 scale promotes its output to f32, so after the first norm the
residual stream, the norms, RoPE and the softmax statistics are f32, and
every product multiplies f32 activations by weights rounded to cfg.dtype
(on a TPU at default precision: bf16 inputs, f32 accumulation). Here:
  - the frozen projection weights and the embedding are stored in
    cfg.dtype, norm scales in f32;
  - the trainable LoRA factors (lora_a/lora_b, lora_embed_a/lora_embed_b)
    are stored in f32, as the flax params are, and cast to cfg.dtype at the
    product (LoraDense's `a.astype(dtype)`), so AdamW updates them in f32;
    the embedding's LoRA delta take(A) @ B is computed in f32 and added to
    the gathered row in f32 before the cast (llama.py:252-265);
  - GEMM inputs, and the q/k/v handed to the attention kernel, are cast to
    cfg.dtype; products accumulate in f32 and come back as f32;
  - residual, norms, RoPE angles and softmax statistics stay f32.
Training: `causal_attention` is differentiable (its backward is
csrc/flash_attn_bwd.cu on the card), and with `LlamaConfig.remat` (set by
`llama3_8b()`, as in the JAX package) each block runs under
torch.utils.checkpoint while grad mode is on, as `nn.remat(LlamaBlock)`
does: the backward recomputes one block at a time from its input.
At `tiny()` (cfg.dtype float32) this is the JAX CPU computation. On the
card the attention is csrc/flash_attn.cu (ops/flash_attn.py) in cfg.dtype:
its bf16 instantiation at the Llama3-8B widths, its f32 one at `tiny()`.

`load_hf_llama_params` writes HF-layout safetensors shards (f32, f16 or
bf16) into a built `LlamaModel`, tensor by tensor on the model's device.
Left for later (ROADMAP.md queue A4): the LM head (`return_logits`, used
only by the training-time QA probe); the loader returns the head's weights
when asked, as the JAX loader does.
"""

import dataclasses
import glob
import os

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from prosim_torch.ops.flash_attn import causal_attention
from prosim_torch.utils.safetensors_io import SafetensorsFile


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    num_agent_tokens: int = 128  # extra <A{i}> tokens appended to the vocab
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    lora_rank: int = 0
    lora_alpha: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # recompute each block in the backward (LlamaModel.forward); forward-only
    # use is unaffected
    remat: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def total_vocab(self):
        return self.vocab_size + self.num_agent_tokens

    @classmethod
    def llama3_8b(cls, lora_rank=16):
        return cls(lora_rank=lora_rank, remat=True)

    @classmethod
    def tiny(cls, lora_rank=4):
        return cls(vocab_size=512, num_agent_tokens=128, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, lora_rank=lora_rank,
                   dtype=torch.float32)


def _rope(x, positions, theta: float):
    """Rotary embedding, HF half-split (`rotate_half`) convention, in f32.
    x [B, T, H, D]; positions [B, T]."""
    d = x.shape[-1]
    freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions[..., None].float() * freq  # [B, T, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps), rounded to `dtype`, times an f32 scale:
    the output is f32, as in the JAX package."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(self.dtype) * self.weight


class LoraLinear(nn.Module):
    """y = x W^T + (alpha / r) (x A) B (the flax LoraDense, no bias); the
    inputs are cast to W's dtype, the f32 LoRA factors too at the product,
    the result is f32."""

    def __init__(self, in_dim: int, out_dim: int, lora_rank: int = 0, lora_alpha: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.lora_rank = lora_rank
        self.lora_scale = lora_alpha / lora_rank if lora_rank else 0.0
        self.weight = nn.Parameter(torch.empty((out_dim, in_dim), dtype=dtype))
        if lora_rank:
            self.lora_a = nn.Parameter(torch.empty((in_dim, lora_rank)))
            self.lora_b = nn.Parameter(torch.zeros((lora_rank, out_dim)))

    def forward(self, x):
        xc = x.to(self.weight.dtype)
        y = F.linear(xc, self.weight).float()
        if self.lora_rank:
            dt = xc.dtype
            y = y + ((xc @ self.lora_a.to(dt)) @ self.lora_b.to(dt)).float() * self.lora_scale
        return y


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = c = cfg
        H, hd, dt = c.hidden_size, c.head_dim, c.dtype
        lora = dict(lora_rank=c.lora_rank, lora_alpha=c.lora_alpha, dtype=dt)
        self.input_norm = RMSNorm(H, c.rms_eps, dt)
        self.q_proj = LoraLinear(H, c.num_heads * hd, **lora)
        self.k_proj = LoraLinear(H, c.num_kv_heads * hd, **lora)
        self.v_proj = LoraLinear(H, c.num_kv_heads * hd, **lora)
        self.o_proj = LoraLinear(c.num_heads * hd, H, dtype=dt)
        self.post_attn_norm = RMSNorm(H, c.rms_eps, dt)
        self.gate_proj = LoraLinear(H, c.intermediate_size, dtype=dt)
        self.up_proj = LoraLinear(H, c.intermediate_size, dtype=dt)
        self.down_proj = LoraLinear(c.intermediate_size, H, dtype=dt)

    def forward(self, x, positions, attn_mask):
        """x [B, T, H]; positions [B, T]; attn_mask [B, T] bool token
        validity (the causal mask is the attention's own)."""
        c = self.cfg
        h = self.input_norm(x)
        B, T = h.shape[:2]
        q = _rope(self.q_proj(h).view(B, T, c.num_heads, c.head_dim), positions, c.rope_theta)
        k = _rope(self.k_proj(h).view(B, T, c.num_kv_heads, c.head_dim), positions, c.rope_theta)
        v = self.v_proj(h).view(B, T, c.num_kv_heads, c.head_dim)
        # grouped-query attention: the kernel maps query head i to kv head
        # i // (num_heads / num_kv_heads), jnp.repeat's order, unrepeated
        out = causal_attention(q.to(c.dtype).contiguous(), k.to(c.dtype).contiguous(),
                               v.to(c.dtype).contiguous(), attn_mask,
                               1.0 / float(c.head_dim) ** 0.5)
        x = x + self.o_proj(out.reshape(B, T, -1))
        h = self.post_attn_norm(x)
        return x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class LlamaModel(nn.Module):
    """Decoder stack returning the final hidden states [B, T, H] in f32 (no
    LM head: the text conditioning reads hidden states)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = c = cfg
        dt = c.dtype
        self.embed_tokens = nn.Parameter(torch.empty((c.total_vocab, c.hidden_size), dtype=dt))
        if c.lora_rank:
            self.lora_embed_a = nn.Parameter(torch.empty((c.total_vocab, c.lora_rank)))
            self.lora_embed_b = nn.Parameter(torch.zeros((c.lora_rank, c.hidden_size)))
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(c))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_eps, dt)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded random weights drawn on the model's own device (so a
        Llama3-8B model never passes through host memory), with the flax
        initializers' scales: projection weights lecun_normal (normal of std
        1/sqrt(fan_in) truncated at 2 std, rescaled to that std), the
        embedding and the LoRA A factors N(0, 0.02), the LoRA B factors 0 (so
        the adapters start as the identity), norm scales 1."""
        dev = self.embed_tokens.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim == 1:
                p.fill_(1.0)
            elif leaf in ("lora_b", "lora_embed_b"):
                p.zero_()
            else:
                val = torch.empty(p.shape, dtype=torch.float32, device=dev)
                if leaf in ("embed_tokens", "lora_a", "lora_embed_a"):
                    val.normal_(0.0, 0.02, generator=gen)
                else:  # weight [out, in]
                    std = p.shape[1] ** -0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(val, 0.0, std, -2 * std, 2 * std, generator=gen)
                p.copy_(val)

    def lookup(self, ids):
        """Token embeddings [B, T, H] in cfg.dtype. The LoRA delta is applied
        per gathered row (A[ids] @ B, in f32), never as a dense [V, H]
        table."""
        c = self.cfg
        ids = ids.long()
        base = self.embed_tokens[ids]
        if not c.lora_rank:
            return base
        delta = self.lora_embed_a[ids] @ self.lora_embed_b
        return (base.float() + (c.lora_alpha / c.lora_rank) * delta).to(c.dtype)

    def forward(self, input_ids, attention_mask, agent_embs=None, agent_slot_ids=None,
                agent_add_mode: bool = False):
        """input_ids [B, T]; attention_mask [B, T] bool. With agent_embs
        [B, N, H] and agent_slot_ids [B, T], each <A{i}> position takes (or
        with agent_add_mode adds) agent i's vector. Positions are
        cumsum(mask) - 1, so they run on across the mask's holes."""
        c = self.cfg
        x = self.lookup(input_ids)
        if agent_embs is not None and agent_slot_ids is not None:
            x = embed_with_agent_tokens(x, agent_embs.to(c.dtype), agent_slot_ids,
                                        add_mode=agent_add_mode)
        x = x.to(c.dtype)
        positions = attention_mask.long().cumsum(dim=-1) - 1
        remat = c.remat and torch.is_grad_enabled()
        for i in range(c.num_layers):
            block = getattr(self, f"layer_{i}")
            if remat:
                x = checkpoint(block, x, positions, attention_mask, use_reentrant=False)
            else:
                x = block(x, positions, attention_mask)
        return self.final_norm(x)


def embed_with_agent_tokens(base, agent_embs, agent_slot_ids, add_mode: bool = False):
    """Token embeddings base [B, T, H] with <A{i}> rows replaced by
    per-agent vectors agent_embs [B, N, H]; agent_slot_ids [B, T] = agent
    index at each position or -1 (reference REPLACE_AGENT_TOKEN,
    text_attns.py:395-422). With add_mode the agent vector is added onto the
    token embedding (AGENT_TOKEN_MODE='add')."""
    safe = agent_slot_ids.long().clamp(0, agent_embs.shape[1] - 1)
    repl = torch.gather(agent_embs, 1, safe[..., None].expand(-1, -1, agent_embs.shape[-1]))
    if add_mode:
        repl = base + repl
    return torch.where((agent_slot_ids >= 0)[..., None], repl, base)


@torch.no_grad()
def load_hf_llama_params(path: str, model: LlamaModel, rng_seed: int = 0,
                         with_lm_head: bool = False):
    """Load HF-format Llama weights (`*.safetensors` shards under `path`,
    the HF hub layout) into `model` (port of prosim_tpu/models/llm/llama.py
    load_hf_llama_params; the reference loads them through
    AutoModelForCausalLM and resizes the embedding for the agent tokens,
    text_attns.py:78-138).

    Each tensor goes from its shard's memory map straight into the model's
    parameter on the model's device and in its dtype; no host copy of the
    whole model is made. As in the JAX loader: shards are read in name
    order (a later shard's tensor wins), a missing weight raises KeyError,
    the embedding rows of the agent tokens are the mean row, taken in f32,
    and the LoRA leaves are drawn from np.random.default_rng(rng_seed) in
    the JAX order (lora_embed_a, then q/k/v lora_a layer by layer, N(0,
    0.02); every lora_b zero), so they equal the JAX loader's bit for bit.
    With with_lm_head, returns the LM head [H, V + agent tokens] in f32
    (lm_head.weight, or the embedding when the checkpoint ties them);
    otherwise None."""
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no .safetensors under {path}")
    where = {}
    for f in map(SafetensorsFile, shards):
        where.update(dict.fromkeys(f.keys(), f))

    def t(key):
        if key not in where:
            raise KeyError(f"missing weight '{key}' in {path}")
        return where[key].get_tensor(key)

    def put(param, value):
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {tuple(value.shape)} does not fit a parameter "
                             f"of shape {tuple(param.shape)}")
        param.copy_(value)

    c = model.cfg
    dev = model.embed_tokens.device

    def extend_vocab(w):  # [V, H] -> [V + agent tokens, H], f32, on the model's device
        w = w.to(dev).float()
        return torch.cat([w, w.mean(dim=0, keepdim=True).expand(c.num_agent_tokens, -1)])

    rng = np.random.default_rng(rng_seed)

    def lora_a(shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))

    put(model.embed_tokens, extend_vocab(t("model.embed_tokens.weight")))
    put(model.final_norm.weight, t("model.norm.weight"))
    if c.lora_rank:
        put(model.lora_embed_a, lora_a((c.total_vocab, c.lora_rank)))
        model.lora_embed_b.zero_()
    for i in range(c.num_layers):
        block, hf = getattr(model, f"layer_{i}"), f"model.layers.{i}"
        put(block.input_norm.weight, t(f"{hf}.input_layernorm.weight"))
        put(block.post_attn_norm.weight, t(f"{hf}.post_attention_layernorm.weight"))
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put(getattr(block, proj).weight, t(f"{hf}.self_attn.{proj}.weight"))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            put(getattr(block, proj).weight, t(f"{hf}.mlp.{proj}.weight"))
        if c.lora_rank:
            for proj in ("q_proj", "k_proj", "v_proj"):
                lin = getattr(block, proj)
                put(lin.lora_a, lora_a((lin.weight.shape[1], c.lora_rank)))
                lin.lora_b.zero_()
    if with_lm_head:
        key = "lm_head.weight" if "lm_head.weight" in where else "model.embed_tokens.weight"
        return extend_vocab(t(key)).T
    return None
