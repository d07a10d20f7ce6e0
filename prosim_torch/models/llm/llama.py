"""Llama3 decoder with LoRA (port of prosim_tpu/models/llm/llama.py), eval
mode.

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
  - projection weights, LoRA factors and the embedding are stored in
    cfg.dtype, norm scales in f32;
  - GEMM inputs, and the q/k/v handed to the attention kernel, are cast to
    cfg.dtype; products accumulate in f32 and come back as f32;
  - residual, norms, RoPE angles and softmax statistics stay f32.
At `tiny()` (cfg.dtype float32) this is the JAX CPU computation. On the
card the attention is csrc/flash_attn.cu (ops/flash_attn.py), which takes
bf16 only, so a CUDA model runs at cfg.dtype bfloat16.

Left for later (ROADMAP.md queue A8): `load_hf_llama_params` (needs
weight files and safetensors) and the LM head (`return_logits`, used only
by the training-time QA probe).
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from prosim_torch.ops.flash_attn import causal_attention


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

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def total_vocab(self):
        return self.vocab_size + self.num_agent_tokens

    @classmethod
    def llama3_8b(cls, lora_rank=16):
        return cls(lora_rank=lora_rank)

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
    inputs are cast to the weights' dtype, the result is f32."""

    def __init__(self, in_dim: int, out_dim: int, lora_rank: int = 0, lora_alpha: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.lora_rank = lora_rank
        self.lora_scale = lora_alpha / lora_rank if lora_rank else 0.0
        self.weight = nn.Parameter(torch.empty((out_dim, in_dim), dtype=dtype))
        if lora_rank:
            self.lora_a = nn.Parameter(torch.empty((in_dim, lora_rank), dtype=dtype))
            self.lora_b = nn.Parameter(torch.zeros((lora_rank, out_dim), dtype=dtype))

    def forward(self, x):
        xc = x.to(self.weight.dtype)
        y = F.linear(xc, self.weight).float()
        if self.lora_rank:
            y = y + ((xc @ self.lora_a) @ self.lora_b).float() * self.lora_scale
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
            self.lora_embed_a = nn.Parameter(torch.empty((c.total_vocab, c.lora_rank), dtype=dt))
            self.lora_embed_b = nn.Parameter(torch.zeros((c.lora_rank, c.hidden_size), dtype=dt))
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
        per gathered row (A[ids] @ B), never as a dense [V, H] table."""
        c = self.cfg
        ids = ids.long()
        base = self.embed_tokens[ids]
        if not c.lora_rank:
            return base
        delta = self.lora_embed_a[ids] @ self.lora_embed_b
        return (base.float() + (c.lora_alpha / c.lora_rank) * delta.float()).to(c.dtype)

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
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}")(x, positions, attention_mask)
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
