"""Scene encoder: map + obs encoders fused by neighborhood attention (port
of prosim_tpu/models/scene_encoder.py).

Per layer, agent tokens self-attend over agent neighbors (a2a), then every
scene token attends over scene neighbors (s2s), on a fixed [B, L + A] grid
with kNN graphs that keep self-loops. The map and obs encoders are PointNets
(MODEL.SCENE_ENCODER.MAP_TYPE / OBS_TYPE 'pointnet', the demo architecture)
or MLPs ('mlp': a segment MLP with lane-type and traffic-light embeddings
pooled over segments, a per-step history MLP pooled over time, or one MLP
of the flattened history with pool 'none'). `update_obs`, once per replan
step, swaps in the re-encoded obs tokens (MODEL.OBS_UPDATE.FUSION
'replace'), or fuses old and new tokens with `obs_update_mlp` ('mlp'); with
OBS_UPDATE.ATTN_UPDATE the agents then re-attend: a2a over a radius graph
without self-loops, then the s2s layers from the agents to the map (m2a).
With deterministic=False (training) the attention layers drop out at
MODEL.SCENE_ENCODER.ATTN.DROPOUT. The encoders and the attention compute in
`dtype`; positions and graphs stay f32.
"""

import torch
from torch import nn

from prosim_torch.data.batch import MapInputs, ObsInputs, SceneTokens
from prosim_torch.data.synthetic import map_feature_dim, obs_feature_dim
from prosim_torch.ops.attention import (
    GatedNeighborAttention,
    RelPE,
    rel_pe_table,
    shared_source,
)
from prosim_torch.ops.mlp import MLP
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


def _masked_pool(x, mask, pool: str):
    """Pool [..., T, D] over T with a [..., T] mask: 'mean' zeroes rows with
    no valid entry, 'max' fills invalid entries with -1e9 (reference:
    map_encoder.py:33-48, obs_encoder.py:38-54)."""
    if pool == "mean":
        x = torch.where(mask[..., None], x, 0.0)
        cnt = mask.sum(dim=-1, keepdim=True).clamp_min(1)
        return torch.where(mask.any(dim=-1, keepdim=True), x.sum(dim=-2) / cnt, 0.0)
    if pool == "max":
        return torch.where(mask[..., None], x, -1e9).amax(dim=-2)
    raise ValueError(f"unknown pool '{pool}'")


def _embed(table: nn.Embedding, ids, dtype):
    """table's rows at integer ids, as flax's nn.Embed takes them
    (jnp.take's default mode): an id in [-n, 0) counts from the end, and an
    id outside [-n, n) gives a row of NaN."""
    n = table.num_embeddings
    ok = (ids >= -n) & (ids < n)
    rows = table.weight[torch.remainder(ids, n).long()].to(dtype)
    return torch.where(ok[..., None], rows, torch.nan)


class MapEncoderMLP(nn.Module):
    """Lane 4-d segment MLP plus lane-type and traffic-light embeddings,
    masked pool over segments (reference: map_encoder.py:5-65). Reads the
    first 6 channels of the map vectors [x0, y0, x1, y1, type, tls]."""

    def __init__(self, hidden_dim, pool="max", dtype=torch.float32):
        super().__init__()
        self.pool = pool
        self.dtype = dtype
        self.lane_encode = MLP([4, 256, 512, hidden_dim], ret_before_act=True, dtype=dtype)
        self.type_embedding = nn.Embedding(4, hidden_dim)
        self.traf_embedding = nn.Embedding(4, hidden_dim)

    def forward(self, m: MapInputs):
        vec = m.vectors
        ptype = vec[..., 4].to(torch.int32)
        ptraf = vec[..., 5].to(torch.int32) + 1
        lane_enc = (self.lane_encode(vec[..., :4])
                    + _embed(self.type_embedding, ptype, self.dtype)
                    + _embed(self.traf_embedding, ptraf, self.dtype))
        return _masked_pool(lane_enc, m.mask, self.pool), m.token_mask  # [B, L, D], [B, L]


class ObsEncoderMLP(nn.Module):
    """Per-step history MLP with a masked pool over time, or with pool
    'none' one MLP of the flattened history (reference: obs_encoder.py:19-74)."""

    def __init__(self, hidden_dim, in_dim, hist_steps, pool="max", dtype=torch.float32):
        super().__init__()
        self.pool = pool
        first = hist_steps * in_dim if pool == "none" else in_dim
        self.hist_encoder = MLP([first, hidden_dim // 2, hidden_dim], ret_before_act=True,
                                dtype=dtype)

    def forward(self, feat, step_mask):
        """feat [B, A, Th, C], step_mask [B, A, Th] -> [B, A, D], [B, A]."""
        feat = torch.where(step_mask[..., None], feat, 0.0)
        if self.pool == "none":
            return self.hist_encoder(feat.flatten(2)), step_mask.all(dim=-1)
        return (_masked_pool(self.hist_encoder(feat), step_mask, self.pool),
                step_mask.any(dim=-1))


class SceneEncoderAttnRelPE(nn.Module):
    def __init__(self, hidden_dim, num_layers, num_heads, head_dim, max_neigh,
                 agent_radius, scene_radius, learnable_pe, pe_num_freq, map_pre_layers,
                 map_mlp_layers, obs_pre_layers, obs_mlp_layers, map_in_dim=11, obs_in_dim=24,
                 map_type="pointnet", obs_type="pointnet", hist_steps=11, map_pool="max",
                 obs_pool="max", obs_fusion="replace", attn_update=False, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.max_neigh = max_neigh
        self.agent_radius = agent_radius
        self.scene_radius = scene_radius
        self.obs_fusion = obs_fusion
        self.attn_update = attn_update
        if map_type == "mlp":
            self.map_encoder = MapEncoderMLP(hidden_dim, map_pool, dtype)
        else:
            self.map_encoder = MapEncoderPointNet(
                hidden_dim, map_pre_layers, map_mlp_layers, map_in_dim, dtype)
        if obs_type == "mlp":
            self.obs_encoder = ObsEncoderMLP(hidden_dim, obs_in_dim, hist_steps, obs_pool, dtype)
        else:
            self.obs_encoder = ObsEncoderPointNet(
                hidden_dim, obs_pre_layers, obs_mlp_layers, obs_in_dim, dtype)
        self.a2a_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq, dtype=dtype)
        self.s2s_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq, dtype=dtype)
        for i in range(num_layers):
            for site in ("a2a", "s2s"):
                self.add_module(f"{site}_{i}", GatedNeighborAttention(
                    hidden_dim, num_heads, head_dim, bipartite=False, dropout=dropout,
                    dtype=dtype))
        if obs_fusion == "mlp":
            self.obs_update_mlp = MLP([2 * hidden_dim, hidden_dim, hidden_dim],
                                      ret_before_act=True, dtype=dtype)

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
        a2a_z = rel_pe_table(obs_pos, obs_ori, obs_pos, obs_ori, a2a_idx, self.a2a_pe,
                             deterministic)

        s2s_idx, s2s_valid = neighbor_topk(
            scene.pos, scene.pos, scene.mask, scene.mask, k=self.max_neigh)
        s2s_z = rel_pe_table(scene.pos, scene.ori, scene.pos, scene.ori, s2s_idx, self.s2s_pe,
                             deterministic)
        x = scene.tokens
        drop = dict(deterministic=deterministic, generator=generator)
        for i in range(self.num_layers):
            x_obs = getattr(self, f"a2a_{i}")(
                x[:, m:], x[:, m:], a2a_idx, a2a_valid, a2a_z, **drop)
            x = torch.cat([x[:, :m], x_obs], dim=1)
            x = getattr(self, f"s2s_{i}")(x, x, s2s_idx, s2s_valid, s2s_z, **drop)
        return scene.replace(tokens=x)

    def update_obs(self, scene: SceneTokens, obs_feat, obs_step_mask, obs_pos, obs_ori,
                   deterministic: bool = True, generator=None) -> SceneTokens:
        """Per-replan-step obs update (reference: attn_fusion.py:238-250):
        the re-encoded obs tokens replace the old ones, or with FUSION 'mlp'
        agents valid in both the old and the new obs take
        obs_update_mlp([old, new]); then, with ATTN_UPDATE, the agents
        re-attend (`_update_attn`)."""
        new_emb, new_tok_mask = self.obs_encoder(obs_feat, obs_step_mask)
        if self.obs_fusion == "mlp":
            fused = self.obs_update_mlp(torch.cat([scene.obs_tokens, new_emb], dim=-1))
            both = new_tok_mask & scene.mask[:, scene.num_map:]
            new_emb = torch.where(both[..., None], fused, new_emb)
        scene = scene.replace_obs(new_emb, obs_pos, obs_ori, new_tok_mask)
        if self.attn_update:
            scene = self._update_attn(scene, deterministic, generator)
        return scene

    def _update_attn(self, scene: SceneTokens, deterministic=True, generator=None) -> SceneTokens:
        """Re-attend the agents: per layer a2a over the agents, then the s2s
        layer from the agents to the map (m2a), on radius graphs without
        self-loops (reference: attn_fusion.py:136-173)."""
        m = scene.num_map
        obs_pos, obs_ori = scene.pos[:, m:].contiguous(), scene.ori[:, m:]
        map_pos, map_ori = scene.pos[:, :m].contiguous(), scene.ori[:, :m]
        obs_mask, map_mask = scene.mask[:, m:].contiguous(), scene.mask[:, :m].contiguous()

        a2a_idx, a2a_valid = neighbor_topk(obs_pos, obs_pos, obs_mask, obs_mask, k=self.max_neigh,
                                           radius=self.agent_radius, exclude_self=True)
        a2a_z = rel_pe_table(obs_pos, obs_ori, obs_pos, obs_ori, a2a_idx, self.a2a_pe,
                             deterministic)
        m2a_idx, m2a_valid = neighbor_topk(obs_pos, map_pos, obs_mask, map_mask, k=self.max_neigh,
                                           radius=self.scene_radius)
        m2a_z = rel_pe_table(obs_pos, obs_ori, map_pos, map_ori, m2a_idx, self.s2s_pe,
                             deterministic)
        x_a, x_m = scene.obs_tokens, scene.map_tokens
        # the map tokens are layer-constant: one normalized (in training,
        # gathered) source table serves every m2a layer
        m2a_src = shared_source(x_m, m2a_idx, m2a_valid, deterministic)
        drop = dict(deterministic=deterministic, generator=generator)
        for i in range(self.num_layers):
            x_a = getattr(self, f"a2a_{i}")(x_a, x_a, a2a_idx, a2a_valid, a2a_z, **drop)
            x_a = getattr(self, f"s2s_{i}")(x_a, x_m, m2a_idx, m2a_valid, m2a_z, **m2a_src, **drop)
        return scene.replace(tokens=torch.cat([x_m, x_a], dim=1))


def build_scene_encoder(config, dtype=torch.float32) -> SceneEncoderAttnRelPE:
    mc = config.MODEL
    attn = mc.SCENE_ENCODER.ATTN
    return SceneEncoderAttnRelPE(
        hidden_dim=mc.HIDDEN_DIM,
        num_layers=attn.NUM_LAYER,
        num_heads=attn.NUM_HEAD,
        head_dim=attn.FF_DIM,
        max_neigh=attn.MAX_NUM_NEIGH,
        agent_radius=attn.AGENT_RADIUS,
        scene_radius=attn.SCENE_RADIUS,
        learnable_pe=attn.LEARNABLE_PE,
        pe_num_freq=attn.PE_NUM_FREQ,
        map_pre_layers=mc.MAP_ENCODER.POINTNET.NUM_PRE_LAYERS,
        map_mlp_layers=mc.MAP_ENCODER.POINTNET.NUM_MLP_LAYERS,
        obs_pre_layers=mc.OBS_ENCODER.POINTNET.NUM_PRE_LAYERS,
        obs_mlp_layers=mc.OBS_ENCODER.POINTNET.NUM_MLP_LAYERS,
        map_in_dim=map_feature_dim(config),
        obs_in_dim=obs_feature_dim(config),
        map_type=mc.SCENE_ENCODER.MAP_TYPE,
        obs_type=mc.SCENE_ENCODER.OBS_TYPE,
        hist_steps=config.DATASET.FORMAT.HISTORY.STEPS,
        map_pool=mc.MAP_ENCODER.MLP.POOL,
        obs_pool=mc.OBS_ENCODER.MLP.POOL,
        obs_fusion=mc.OBS_UPDATE.FUSION,
        attn_update=mc.OBS_UPDATE.ATTN_UPDATE,
        dropout=attn.DROPOUT,
        dtype=dtype,
    )
