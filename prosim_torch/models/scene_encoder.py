"""Scene encoder: map + obs PointNet encoders fused by neighborhood attention
(port of prosim_tpu/models/scene_encoder.py).

Per layer, agent tokens self-attend over agent neighbors (a2a), then every
scene token attends over scene neighbors (s2s), on a fixed [B, L + A] grid
with kNN graphs that keep self-loops. This slice ports the PointNet map/obs
encoders and the 'replace' obs update of the demo architecture; the MLP
encoders, the 'mlp' fusion and ATTN_UPDATE are still to be ported
(ROADMAP.md queue A4). With deterministic=False (training) the attention
layers drop out at MODEL.SCENE_ENCODER.ATTN.DROPOUT. The encoders and the
attention compute in `dtype`; positions and graphs stay f32.
"""

import torch
from torch import nn

from prosim_torch.data.batch import MapInputs, ObsInputs, SceneTokens
from prosim_torch.data.synthetic import map_feature_dim, obs_feature_dim
from prosim_torch.ops.attention import (
    GatedNeighborAttention,
    RelPE,
    normalize_rel_pe,
    rel_pe_features,
)
from prosim_torch.ops.neighbors import neighbor_topk
from prosim_torch.ops.pointnet import PointNetPolylineEncoder


class MapEncoderPointNet(nn.Module):
    def __init__(self, hidden_dim, num_pre_layers, num_mlp_layers, in_dim=11,
                 dtype=torch.float32):
        super().__init__()
        self.pointnet = PointNetPolylineEncoder(in_dim, hidden_dim, num_pre_layers, num_mlp_layers,
                                                dtype)

    def forward(self, m: MapInputs):
        return self.pointnet(m.vectors, m.mask), m.token_mask  # [B, L, D], [B, L]


class ObsEncoderPointNet(nn.Module):
    def __init__(self, hidden_dim, num_pre_layers, num_mlp_layers, in_dim=24,
                 dtype=torch.float32):
        super().__init__()
        self.pointnet = PointNetPolylineEncoder(in_dim, hidden_dim, num_pre_layers, num_mlp_layers,
                                                dtype)

    def forward(self, feat, step_mask):
        """feat [B, A, Th, C], step_mask [B, A, Th] -> [B, A, D], [B, A]."""
        return self.pointnet(feat, step_mask), step_mask.any(dim=-1)


class SceneEncoderAttnRelPE(nn.Module):
    def __init__(self, hidden_dim, num_layers, num_heads, head_dim, max_neigh,
                 learnable_pe, pe_num_freq, map_pre_layers, map_mlp_layers,
                 obs_pre_layers, obs_mlp_layers, map_in_dim=11, obs_in_dim=24,
                 dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.max_neigh = max_neigh
        self.map_encoder = MapEncoderPointNet(
            hidden_dim, map_pre_layers, map_mlp_layers, map_in_dim, dtype)
        self.obs_encoder = ObsEncoderPointNet(
            hidden_dim, obs_pre_layers, obs_mlp_layers, obs_in_dim, dtype)
        self.a2a_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq, dtype=dtype)
        self.s2s_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq, dtype=dtype)
        for i in range(num_layers):
            for site in ("a2a", "s2s"):
                self.add_module(f"{site}_{i}", GatedNeighborAttention(
                    hidden_dim, num_heads, head_dim, bipartite=False, dropout=dropout,
                    dtype=dtype))

    def forward(self, init_obs: ObsInputs, init_map: MapInputs, deterministic: bool = True,
                generator=None) -> SceneTokens:
        map_emb, map_tok_mask = self.map_encoder(init_map)
        obs_emb, obs_tok_mask = self.obs_encoder(init_obs.feat, init_obs.mask)
        scene = SceneTokens(
            tokens=torch.cat([map_emb, obs_emb], dim=1),
            pos=torch.cat([init_map.pos, init_obs.pos], dim=1),
            ori=torch.cat([init_map.ori, init_obs.ori], dim=1),
            mask=torch.cat([map_tok_mask, obs_tok_mask], dim=1),
            num_map=map_emb.shape[1],
        )
        return self._fuse(scene, deterministic, generator)

    def _fuse(self, scene: SceneTokens, deterministic=True, generator=None) -> SceneTokens:
        """Alternating a2a/s2s attention over the full token grid."""
        m = scene.num_map
        obs_pos, obs_ori, obs_mask = scene.pos[:, m:], scene.ori[:, m:], scene.mask[:, m:]

        a2a_k = min(self.max_neigh * 4, 100)
        a2a_idx, a2a_valid = neighbor_topk(
            obs_pos.contiguous(), obs_pos.contiguous(), obs_mask.contiguous(),
            obs_mask.contiguous(), k=a2a_k)
        a2a_pe = self.a2a_pe(rel_pe_features(obs_pos, obs_ori, obs_pos, obs_ori, a2a_idx))

        s2s_idx, s2s_valid = neighbor_topk(
            scene.pos, scene.pos, scene.mask, scene.mask, k=self.max_neigh)
        s2s_pe = self.s2s_pe(rel_pe_features(scene.pos, scene.ori, scene.pos, scene.ori, s2s_idx))

        a2a_z = normalize_rel_pe(a2a_pe, self.hidden_dim)
        s2s_z = normalize_rel_pe(s2s_pe, self.hidden_dim)
        x = scene.tokens
        drop = dict(deterministic=deterministic, generator=generator)
        for i in range(self.num_layers):
            x_obs = getattr(self, f"a2a_{i}")(
                x[:, m:], x[:, m:], a2a_idx, a2a_valid, a2a_z, **drop)
            x = torch.cat([x[:, :m], x_obs], dim=1)
            x = getattr(self, f"s2s_{i}")(x, x, s2s_idx, s2s_valid, s2s_z, **drop)
        return scene.replace(tokens=x)

    def update_obs(self, scene: SceneTokens, obs_feat, obs_step_mask, obs_pos,
                   obs_ori) -> SceneTokens:
        """Per-replan-step obs update, FUSION='replace' without re-attention
        (reference: attn_fusion.py:238-250)."""
        new_emb, new_tok_mask = self.obs_encoder(obs_feat, obs_step_mask)
        return scene.replace_obs(new_emb, obs_pos, obs_ori, new_tok_mask)


def _unsupported(what):
    return NotImplementedError(f"{what} is not ported yet (see ROADMAP.md queue A4)")


def build_scene_encoder(config, dtype=torch.float32) -> SceneEncoderAttnRelPE:
    mc = config.MODEL
    attn = mc.SCENE_ENCODER.ATTN
    if mc.SCENE_ENCODER.MAP_TYPE != "pointnet" or mc.SCENE_ENCODER.OBS_TYPE != "pointnet":
        raise _unsupported("the MLP map/obs encoder")
    if mc.OBS_UPDATE.FUSION != "replace" or mc.OBS_UPDATE.ATTN_UPDATE:
        raise _unsupported("OBS_UPDATE other than FUSION='replace' without ATTN_UPDATE")
    return SceneEncoderAttnRelPE(
        hidden_dim=mc.HIDDEN_DIM,
        num_layers=attn.NUM_LAYER,
        num_heads=attn.NUM_HEAD,
        head_dim=attn.FF_DIM,
        max_neigh=attn.MAX_NUM_NEIGH,
        learnable_pe=attn.LEARNABLE_PE,
        pe_num_freq=attn.PE_NUM_FREQ,
        map_pre_layers=mc.MAP_ENCODER.POINTNET.NUM_PRE_LAYERS,
        map_mlp_layers=mc.MAP_ENCODER.POINTNET.NUM_MLP_LAYERS,
        obs_pre_layers=mc.OBS_ENCODER.POINTNET.NUM_PRE_LAYERS,
        obs_mlp_layers=mc.OBS_ENCODER.POINTNET.NUM_MLP_LAYERS,
        map_in_dim=map_feature_dim(config),
        obs_in_dim=obs_feature_dim(config),
        dropout=attn.DROPOUT,
        dtype=dtype,
    )
