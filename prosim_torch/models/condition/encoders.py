"""Condition encoders: each prompt-condition type to embedding tokens (port
of prosim_tpu/models/condition/encoders.py).

  goal         - xy MLP + temporal Fourier PE of the valid timestep
  v_action_tag - learned per-tag vector + Fourier PE of the tag's interval
  v2v_tag      - the binary variant with 2D vectors (source/target halves)
  drag_point   - PointNet over route-sketch points (NaN padded)

Every condition keeps its fixed slot; a tag's vector is gathered by tag id.
"""

import torch
from torch import nn

from prosim_torch.data.batch import Condition
from prosim_torch.ops.fourier import FourierEmbeddingFix
from prosim_torch.ops.mlp import MLP
from prosim_torch.ops.pointnet import PointNetPolylineEncoder


class GoalConditionEncoder(nn.Module):
    def __init__(self, hidden_dim: int, use_temporal_pe: bool = True):
        super().__init__()
        self.use_temporal_pe = use_temporal_pe
        self.goal_encoder = MLP([2, hidden_dim, hidden_dim], ret_before_act=True,
                                without_norm=True)
        self.pe = FourierEmbeddingFix(num_pos_feats=hidden_dim)

    def forward(self, cond: Condition):
        """cond.feat [B, C, 3] = (rel x, rel y, valid timestep) -> [B, C, D]."""
        emd = self.goal_encoder(cond.feat[..., :2])
        if self.use_temporal_pe:
            emd = emd + self.pe(cond.feat[..., 2:3])
        return emd


class _TagEncoder(nn.Module):
    binary = False

    def __init__(self, hidden_dim: int, num_tags: int, use_temporal_pe: bool = True):
        super().__init__()
        self.num_tags = num_tags
        self.use_temporal_pe = use_temporal_pe
        self.tag_params = nn.Parameter(
            torch.empty((num_tags, hidden_dim * 2 if self.binary else hidden_dim)))
        self.pe = FourierEmbeddingFix(num_pos_feats=hidden_dim // 2)

    def forward(self, cond: Condition):
        """cond.feat [B, C, 3] = (tag id, start t, end t) -> [B, C, D or 2D]."""
        tag_id = cond.feat[..., 0].to(torch.int32).clamp(0, self.num_tags - 1)
        emd = self.tag_params[tag_id.long()]
        if self.use_temporal_pe:
            pe = self.pe(cond.feat[..., 1:3])
            if self.binary:
                pe = pe.repeat(1, 1, 2)
            emd = emd + pe
        return emd


class VActionTagEncoder(_TagEncoder):
    binary = False


class V2VTagEncoder(_TagEncoder):
    binary = True


class DragPointEncoder(nn.Module):
    def __init__(self, hidden_dim: int, num_points: int = 8, num_pre_layers: int = 1,
                 num_mlp_layers: int = 3):
        super().__init__()
        self.num_points = num_points
        self.pointnet = PointNetPolylineEncoder(2, hidden_dim, num_pre_layers, num_mlp_layers)

    def forward(self, cond: Condition):
        """cond.feat [B, C, P*2] route-sketch points (NaN padded) -> [B, C, D]."""
        B, C = cond.feat.shape[:2]
        pts = cond.feat.reshape(B, C, self.num_points, 2)
        pt_mask = ~torch.isnan(pts).any(dim=-1)
        return self.pointnet(torch.nan_to_num(pts), pt_mask)
