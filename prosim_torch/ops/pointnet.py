"""Masked PointNet polyline encoder (port of prosim_tpu/ops/pointnet.py).

Pre-MLP on valid points (invalid points contribute zeros, NOT -inf, to the
max-pool), max-pool + concat, second MLP, max-pool, out-MLP on polylines
with >= 1 valid point. The MLPs compute in `dtype`.
"""

import torch
from torch import nn

from prosim_torch.ops.mlp import MLP


class PointNetPolylineEncoder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, num_pre_layers: int = 1,
                 num_mlp_layers: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden_dim
        self.pre_mlps = MLP([in_dim] + [h] * num_pre_layers, ret_before_act=False, dtype=dtype)
        self.mlps = MLP([h * 2] + [h] * (num_mlp_layers - num_pre_layers), ret_before_act=False,
                        dtype=dtype)
        self.out_mlps = MLP([h, h, h], without_norm=True, ret_before_act=True, dtype=dtype)

    def forward(self, polylines, point_mask):
        """polylines [..., P, C], point_mask [..., P] bool -> [..., hidden_dim]."""
        m = point_mask[..., None]
        x = torch.where(m, torch.nan_to_num(polylines), 0.0)
        pre = torch.where(m, self.pre_mlps(x), 0.0)
        pooled = pre.amax(dim=-2)  # zeros of invalid slots participate
        x = torch.cat([pre, pooled[..., None, :].expand_as(pre)], dim=-1)
        mid = torch.where(m, self.mlps(x), 0.0)
        out = self.out_mlps(mid.amax(dim=-2))
        return torch.where(point_mask.any(dim=-1)[..., None], out, 0.0)
