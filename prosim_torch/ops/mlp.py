"""MLP and context-gating blocks (port of prosim_tpu/ops/mlp.py).

MLP: Linear stacks with LayerNorm + ReLU between hidden layers;
`ret_before_act=False` appends a final ReLU; `without_norm=True` drops the
LayerNorms. ContextGating chains MCG blocks with running-average skips.

LayerNorm follows flax's statistics (last-dim mean, fast variance
E[x^2] - mean^2 clamped at 0), not F.layer_norm's two-pass variance, so both
packages round alike.
"""

from typing import Sequence

import torch
from torch import nn


def layer_norm(x, weight, bias, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * weight) + bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class MLP(nn.Module):
    def __init__(self, dims: Sequence[int], ret_before_act: bool = False,
                 without_norm: bool = False):
        super().__init__()
        dims = list(dims)  # (in, hidden..., out)
        self.n = len(dims) - 1
        self.ret_before_act = ret_before_act
        self.without_norm = without_norm
        for i in range(self.n):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))
            if i < self.n - 1 and not without_norm:
                self.add_module(f"norm_{i}", LayerNorm(dims[i + 1]))

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
    def __init__(self, hidden_dim: int):
        super().__init__()
        self.dense = nn.Linear(hidden_dim, hidden_dim)
        self.norm = LayerNorm(hidden_dim)

    def forward(self, tokens, context, mask):
        # tokens [..., S, D], context [..., D], mask [..., S] bool
        x = torch.relu(self.norm(self.dense(tokens)))
        x = x * context[..., None, :]
        x = torch.where(mask[..., None], x, torch.full_like(x, -1e9))
        return x, x.amax(dim=-2)


class ContextGating(nn.Module):
    """CG_stacked-equivalent: chained MCG blocks with running-average skips."""

    def __init__(self, num_blocks: int, hidden_dim: int):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", MCGBlock(hidden_dim))

    def forward(self, tokens, context, mask):
        tok_acc, ctx_acc = self.block_0(tokens, context, mask)
        for i in range(1, self.num_blocks):
            tok, ctx = getattr(self, f"block_{i}")(tok_acc, ctx_acc, mask)
            tok_acc = (tok_acc * i + tok) / (i + 1)
            ctx_acc = (ctx_acc * i + ctx) / (i + 1)
        return tok_acc, ctx_acc
