"""Light text attentions (port of prosim_tpu/models/condition/text.py):
the identity, and a bag-of-tokens conditioner. Each maps
(text_cond, prompt_cond_emb [B, N, D], prompt) -> (emb', aux or None).
The bag-of-tokens conditioner computes in `dtype`."""

import torch
from torch import nn

from prosim_torch.data.batch import Prompt
from prosim_torch.ops.mlp import MLP


class NoTextAttn(nn.Module):
    """Identity: text conditions are configured but no text model is."""

    def forward(self, text_cond, prompt_cond_emb, prompt: Prompt):
        return prompt_cond_emb, None


class BagOfTokensTextAttn(nn.Module):
    """Mean token embedding of each text, pooled over the scene's texts, ->
    one residual for every addressed agent. Inputs are [B, X, L] token
    arrays (X texts per scene)."""

    def __init__(self, hidden_dim: int, vocab_size: int = 128256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size = vocab_size
        self.dtype = dtype
        self.tok_embed = nn.Embedding(vocab_size, hidden_dim)
        self.to_cond = MLP([hidden_dim, hidden_dim, hidden_dim], ret_before_act=True, dtype=dtype)

    def forward(self, text_cond, prompt_cond_emb, prompt: Prompt):
        ids = text_cond["input_ids"]            # [B, X, L]
        tok_mask = text_cond["token_mask"]      # [B, X, L]
        agent_cover = text_cond["prompt_mask"]  # [B, N]
        emb = self.tok_embed(ids.long().clamp(0, self.vocab_size - 1)).to(self.dtype)
        emb = torch.where(tok_mask[..., None], emb, 0.0)
        denom = tok_mask.sum(dim=-1, keepdim=True).clamp_min(1)
        text_vec = emb.sum(dim=-2) / denom      # [B, X, D]
        text_mask = tok_mask.any(dim=-1)
        tv = (torch.where(text_mask[..., None], text_vec, 0.0).sum(dim=1)
              / text_mask.sum(dim=-1, keepdim=True).clamp_min(1))  # [B, D]
        res = self.to_cond(tv)
        out = torch.where((agent_cover & prompt.mask)[..., None], prompt_cond_emb + res[:, None],
                          prompt_cond_emb)
        return out, None
