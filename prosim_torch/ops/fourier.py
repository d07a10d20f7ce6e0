"""Fourier positional embeddings (port of prosim_tpu/ops/fourier.py).

`FourierEmbeddingFix` is the fixed sinusoidal embedding of the demo
architecture: each input dim is scaled by 2*pi over a temperature ramp and
mapped to interleaved (sin of even slots, cos of odd slots) features. As in
the JAX package, cos(t) is written sin(t + pi/2), so the whole row is one
sin with a per-lane phase and both packages round alike.

`FourierEmbedding` is the QCNet learnable variant, computed in `dtype`
(its Fourier features in f32, its layers as ops/mlp.py's Dense and
LayerNorm). `FourierEmbeddingFix` stays f32; its callers cast.
"""

import math

import torch
from torch import nn

from prosim_torch.ops.mlp import Dense, LayerNorm


class FourierEmbeddingFix(nn.Module):
    def __init__(self, num_pos_feats: int = 128, temperature: float = 10000.0):
        super().__init__()
        self.num_pos_feats = int(num_pos_feats)  # features PER input dim
        self.temperature = temperature

    def freqs(self, device):
        """(inv_t, phase) [num_pos_feats] f32: lane j's feature is
        sin(x * inv_t[j] + phase[j]), computed on `device` as forward does."""
        npf = self.num_pos_feats
        dim_t = torch.arange(npf, dtype=torch.float32, device=device)
        ramp = torch.tensor(self.temperature, dtype=torch.float32, device=device) ** (
            2 * torch.div(dim_t, 2, rounding_mode="floor") / npf)
        inv_t = (2 * math.pi) / ramp
        phase = torch.where(torch.arange(npf, device=device) % 2 == 0, 0.0, 0.5 * math.pi)
        return inv_t, phase

    def forward(self, x):
        # x [..., D] -> [..., D * num_pos_feats]
        d = x.shape[-1]
        inv_t, phase = self.freqs(x.device)
        flat = (x[..., None] * inv_t + phase).reshape(*x.shape[:-1], d * self.num_pos_feats)
        return torch.sin(flat)


class FourierEmbedding(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, num_freq_bands: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim = input_dim
        self.freqs = nn.Parameter(torch.randn(input_dim, num_freq_bands))
        feat = 2 * num_freq_bands + 1
        for i in range(input_dim):
            self.add_module(f"mlp_{i}_dense0", Dense(feat, hidden_dim, dtype=dtype))
            self.add_module(f"mlp_{i}_norm", LayerNorm(hidden_dim, dtype=dtype))
            self.add_module(f"mlp_{i}_dense1", Dense(hidden_dim, hidden_dim, dtype=dtype))
        self.out_norm = LayerNorm(hidden_dim, dtype=dtype)
        self.out_dense = Dense(hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, x):
        # x [..., input_dim] -> [..., hidden_dim]
        proj = x[..., None] * self.freqs * (2 * math.pi)  # [..., D, F]
        feats = torch.cat([torch.cos(proj), torch.sin(proj), x[..., None]], dim=-1)
        out = None
        for i in range(self.input_dim):
            h = getattr(self, f"mlp_{i}_dense0")(feats[..., i, :])
            h = torch.relu(getattr(self, f"mlp_{i}_norm")(h))
            h = getattr(self, f"mlp_{i}_dense1")(h)
            out = h if out is None else out + h
        return self.out_dense(torch.relu(self.out_norm(out)))
