"""The reference model: ProSim's eval-mode closed loop in plain PyTorch.

A frozen copy of the eval-mode math of prosim_torch/models/ (scene_encoder,
prompt_encoder, decoder, condition/{encoders,attn,transformer}, policy's
layer loop, prosim) and rollout/rollout.py (goal sampling, replica tiling,
world frame), taken when the benchmark was written, on the plain layers of
reference/layers.py. It imports nothing of the program. Module and
parameter names are the program's, so one weight dictionary loads into
both. What it leaves out: training (dropout, losses), text conditions,
the MLP encoders, ATTN_UPDATE and the 'mlp' obs fusion, learnable rel-PE,
and the policy's cluster/mlp/aux heads and goal context (no benchmark
configuration uses them; `check_config` refuses them).

`rollout` with `forced_traj` is the closed loop with the program's state put
in: each replan step reads the agents' trajectory so far from the program's
rollout, so the reference follows the program step by step and a gap does
not compound over the eight steps. Without it, it runs free.
"""

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (
    MLP,
    ContextGating,
    FourierEmbeddingFix,
    GatedNeighborAttention,
    PointNetPolylineEncoder,
    RelPE,
    neighbor_topk,
    normalize_rel_pe,
    rel_pe_features,
    rel_traj_to_last_step,
    rel_vel_to_last_step,
    rotate_2d,
    wrap_angle,
)

NUM_V_ACTION_TAGS = 11  # the v_action_tag enum's size (the tag bank's rows)

# ------------------------------------------------------------- containers


def _tensors(cls, arrays, device):
    return cls(**{f.name: torch.as_tensor(np.ascontiguousarray(arrays[f.name])).to(device)
                  for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class MapInputs:
    vectors: torch.Tensor
    mask: torch.Tensor
    pos: torch.Tensor
    ori: torch.Tensor

    @property
    def token_mask(self):
        return self.mask.any(dim=-1)


@dataclasses.dataclass
class ObsInputs:
    feat: torch.Tensor
    mask: torch.Tensor
    pos: torch.Tensor
    ori: torch.Tensor


@dataclasses.dataclass
class Prompt:
    feat: torch.Tensor
    mask: torch.Tensor
    pos: torch.Tensor
    ori: torch.Tensor
    agent_type: torch.Tensor
    obs_index: torch.Tensor
    extent: torch.Tensor
    goal_point: torch.Tensor


@dataclasses.dataclass
class FutObs:
    feat: torch.Tensor
    mask: torch.Tensor
    pos: torch.Tensor
    ori: torch.Tensor
    obs_index: torch.Tensor


@dataclasses.dataclass
class Condition:
    feat: torch.Tensor
    mask: torch.Tensor
    prompt_idx: torch.Tensor
    prompt_mask: torch.Tensor


@dataclasses.dataclass
class Scene:
    init_map: MapInputs
    init_obs: ObsInputs
    prompt: Prompt
    fut_obs: FutObs
    conditions: Dict[str, Condition]

    def rows(self, fn):
        """fn over every tensor, all of which lead with the scene axis."""
        sub = lambda c: type(c)(**{f.name: fn(getattr(c, f.name)) for f in dataclasses.fields(c)})
        return Scene(sub(self.init_map), sub(self.init_obs), sub(self.prompt), sub(self.fut_obs),
                     {k: sub(v) for k, v in self.conditions.items()})


def scene_from_arrays(arrays: dict, device) -> Scene:
    """The benchmark's numpy arrays (the SceneBatch layout) -> a Scene."""
    return Scene(
        init_map=_tensors(MapInputs, arrays["init_map"], device),
        init_obs=_tensors(ObsInputs, arrays["init_obs"], device),
        prompt=_tensors(Prompt, arrays["prompt"], device),
        fut_obs=_tensors(FutObs, arrays["fut_obs"], device),
        conditions={k: _tensors(Condition, v, device)
                    for k, v in (arrays.get("conditions") or {}).items()})


@dataclasses.dataclass
class SceneTokens:
    tokens: torch.Tensor
    pos: torch.Tensor
    ori: torch.Tensor
    mask: torch.Tensor
    num_map: int

    def replace_obs(self, obs_tokens, obs_pos, obs_ori, obs_mask):
        m = self.num_map
        return SceneTokens(torch.cat([self.tokens[:, :m], obs_tokens], 1),
                           torch.cat([self.pos[:, :m], obs_pos], 1),
                           torch.cat([self.ori[:, :m], obs_ori], 1),
                           torch.cat([self.mask[:, :m], obs_mask], 1), m)


def check_config(cfg) -> None:
    """Refuse the modes this reference does not hold."""
    mc = cfg.MODEL
    ad = mc.POLICY.ACT_DECODER
    unsupported = {
        "SCENE_ENCODER.MAP_TYPE": mc.SCENE_ENCODER.MAP_TYPE != "pointnet",
        "SCENE_ENCODER.OBS_TYPE": mc.SCENE_ENCODER.OBS_TYPE != "pointnet",
        "OBS_UPDATE.FUSION": mc.OBS_UPDATE.FUSION != "replace",
        "OBS_UPDATE.ATTN_UPDATE": mc.OBS_UPDATE.ATTN_UPDATE,
        "LEARNABLE_PE": any(a.LEARNABLE_PE for a in (mc.SCENE_ENCODER.ATTN, mc.DECODER.ATTN,
                                                     ad.ATTN)),
        "TRAJ.PRED_MODE": ad.TRAJ.PRED_MODE != "anchor",
        "TRAJ.PRED_GMM": ad.TRAJ.PRED_GMM,
        "CONTEXT.GOAL": ad.CONTEXT.GOAL or not ad.CONTEXT.EMD,
        "NOT_USE_MAP": ad.ATTN.NOT_USE_MAP,
        "REL_POS_EDGE_FUNC": mc.REL_POS_EDGE_FUNC != "radius",
        "text conditions": any("OneText" in t for t in cfg.PROMPT.CONDITION.TYPES),
        "PARITY.REFERENCE_STEP_ENV_FRAME": mc.PARITY.REFERENCE_STEP_ENV_FRAME,
        "ROLLOUT.POLICY.TOP_K": cfg.ROLLOUT.POLICY.TOP_K != 1,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the reference does not hold {bad}")


def obs_feature_dim(cfg) -> int:
    h = cfg.DATASET.FORMAT.HISTORY
    return (len(h.ELEMENTS.split(",")) + 2 * h.WITH_EXTEND + 3 * h.WITH_AGENT_TYPE
            + h.STEPS * h.WITH_TIME_EMB)


def map_feature_dim(cfg) -> int:
    m = cfg.DATASET.FORMAT.MAP
    return 6 + 3 * m.WITH_TYPE_EMB + 2 * m.WITH_DIR


# ---------------------------------------------------------- scene encoder


class _PointNetEncoder(nn.Module):
    def __init__(self, in_dim, hidden_dim, pre, mlp, dtype):
        super().__init__()
        self.pointnet = PointNetPolylineEncoder(in_dim, hidden_dim, pre, mlp, dtype)

    def forward(self, feat, mask):
        return self.pointnet(feat, mask), mask.any(dim=-1)


class SceneEncoder(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        mc = cfg.MODEL
        a = mc.SCENE_ENCODER.ATTN
        D = mc.HIDDEN_DIM
        self.hidden_dim, self.num_layers, self.max_neigh = D, a.NUM_LAYER, a.MAX_NUM_NEIGH
        self.map_encoder = _PointNetEncoder(map_feature_dim(cfg), D,
                                            mc.MAP_ENCODER.POINTNET.NUM_PRE_LAYERS,
                                            mc.MAP_ENCODER.POINTNET.NUM_MLP_LAYERS, dtype)
        self.obs_encoder = _PointNetEncoder(obs_feature_dim(cfg), D,
                                            mc.OBS_ENCODER.POINTNET.NUM_PRE_LAYERS,
                                            mc.OBS_ENCODER.POINTNET.NUM_MLP_LAYERS, dtype)
        self.a2a_pe = RelPE(D, dtype=dtype)
        self.s2s_pe = RelPE(D, dtype=dtype)
        for i in range(a.NUM_LAYER):
            for site in ("a2a", "s2s"):
                self.add_module(f"{site}_{i}", GatedNeighborAttention(
                    D, a.NUM_HEAD, a.FF_DIM, bipartite=False, dtype=dtype))

    def forward(self, init_obs: ObsInputs, init_map: MapInputs) -> SceneTokens:
        map_emb, map_mask = self.map_encoder(init_map.vectors, init_map.mask)
        obs_emb, obs_mask = self.obs_encoder(init_obs.feat, init_obs.mask)
        scene = SceneTokens(torch.cat([map_emb, obs_emb], 1),
                            torch.cat([init_map.pos, init_obs.pos], 1),
                            torch.cat([init_map.ori, init_obs.ori], 1),
                            torch.cat([map_mask, obs_mask], 1), map_emb.shape[1])
        m = scene.num_map
        obs_pos, obs_ori, obs_m = scene.pos[:, m:], scene.ori[:, m:], scene.mask[:, m:]
        a2a_idx, a2a_valid = neighbor_topk(obs_pos, obs_pos, obs_m, obs_m,
                                           k=min(self.max_neigh * 4, 100))
        a2a_z = normalize_rel_pe(self.a2a_pe(
            rel_pe_features(obs_pos, obs_ori, obs_pos, obs_ori, a2a_idx)), self.hidden_dim)
        s2s_idx, s2s_valid = neighbor_topk(scene.pos, scene.pos, scene.mask, scene.mask,
                                           k=self.max_neigh)
        s2s_z = normalize_rel_pe(self.s2s_pe(
            rel_pe_features(scene.pos, scene.ori, scene.pos, scene.ori, s2s_idx)), self.hidden_dim)
        x = scene.tokens
        for i in range(self.num_layers):
            x_obs = getattr(self, f"a2a_{i}")(x[:, m:], x[:, m:], a2a_idx, a2a_valid, a2a_z)
            x = torch.cat([x[:, :m], x_obs], 1)
            x = getattr(self, f"s2s_{i}")(x, x, s2s_idx, s2s_valid, s2s_z)
        return dataclasses.replace(scene, tokens=x)

    def update_obs(self, scene, obs_feat, obs_step_mask, obs_pos, obs_ori):
        new_emb, new_mask = self.obs_encoder(obs_feat, obs_step_mask)
        return scene.replace_obs(new_emb, obs_pos, obs_ori, new_mask)


# ------------------------------------------------- prompt encoder, decoder


class PromptEncoder(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        s = cfg.PROMPT.AGENT_STATUS
        in_dim = 2 * s.USE_VEL + 2 * s.USE_EXTEND + 3 * s.USE_AGENT_TYPE
        D = cfg.MODEL.HIDDEN_DIM
        self.state_encoder = MLP([in_dim, D, D], ret_before_act=True, dtype=dtype)

    def forward(self, prompt: Prompt):
        return torch.where(prompt.mask[..., None], self.state_encoder(prompt.feat), 0.0)


class Decoder(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        mc = cfg.MODEL
        a = mc.DECODER.ATTN
        D = mc.HIDDEN_DIM
        self.hidden_dim, self.num_layers, self.max_neigh = D, a.NUM_LAYER, a.MAX_NUM_NEIGH
        self.prompt_radius, self.scene_radius = a.PROMPT_RADIUS, a.SCENE_RADIUS
        self.goal_pred, self.goal_k = mc.DECODER.GOAL_PRED.ENABLE, mc.DECODER.GOAL_PRED.K
        self.p2p_pe = RelPE(D, dtype=dtype)
        self.s2p_pe = RelPE(D, dtype=dtype)
        for i in range(a.NUM_LAYER):
            self.add_module(f"p2p_{i}", GatedNeighborAttention(D, a.NUM_HEAD, a.FF_DIM,
                                                               bipartite=False, dtype=dtype))
            self.add_module(f"s2p_{i}", GatedNeighborAttention(D, a.NUM_HEAD, a.FF_DIM,
                                                               bipartite=True, dtype=dtype))
        if self.goal_pred:
            self.goal_prob_head = MLP([D, D // 2, self.goal_k], ret_before_act=True, dtype=dtype)
            self.goal_point_head = MLP([D, D // 2, self.goal_k * 2], ret_before_act=True,
                                       dtype=dtype)

    def forward(self, scene: SceneTokens, prompt: Prompt, prompt_emb) -> dict:
        p2p_idx, p2p_valid = neighbor_topk(prompt.pos, prompt.pos, prompt.mask, prompt.mask,
                                           k=self.max_neigh, radius=self.prompt_radius,
                                           exclude_self=True)
        p2p_z = normalize_rel_pe(self.p2p_pe(rel_pe_features(
            prompt.pos, prompt.ori, prompt.pos, prompt.ori, p2p_idx)), self.hidden_dim)
        s2p_idx, s2p_valid = neighbor_topk(prompt.pos, scene.pos, prompt.mask, scene.mask,
                                           k=self.max_neigh, radius=self.scene_radius)
        s2p_z = normalize_rel_pe(self.s2p_pe(rel_pe_features(
            prompt.pos, prompt.ori, scene.pos, scene.ori, s2p_idx)), self.hidden_dim)
        x_p = prompt_emb
        for i in range(self.num_layers):
            x_p = getattr(self, f"p2p_{i}")(x_p, x_p, p2p_idx, p2p_valid, p2p_z)
            x_p = getattr(self, f"s2p_{i}")(x_p, scene.tokens, s2p_idx, s2p_valid, s2p_z)
        x_p = torch.where(prompt.mask[..., None], x_p, 0.0)
        out = {"emd": x_p}
        if self.goal_pred:
            out["goal_prob"] = torch.where(prompt.mask[..., None], self.goal_prob_head(x_p), 0.0)
            gp = self.goal_point_head(x_p).reshape(*x_p.shape[:-1], self.goal_k, 2)
            out["goal_point"] = torch.where(prompt.mask[..., None, None], gp, 0.0)
        return out


# ------------------------------------------------------------- conditions


class GoalConditionEncoder(nn.Module):
    def __init__(self, D, use_temporal_pe, dtype):
        super().__init__()
        self.use_temporal_pe, self.dtype = use_temporal_pe, dtype
        self.goal_encoder = MLP([2, D, D], ret_before_act=True, without_norm=True, dtype=dtype)
        self.pe = FourierEmbeddingFix(num_pos_feats=D)

    def forward(self, cond: Condition):
        emd = self.goal_encoder(cond.feat[..., :2])
        if self.use_temporal_pe:
            emd = emd + self.pe(cond.feat[..., 2:3]).to(self.dtype)
        return emd


class VActionTagEncoder(nn.Module):
    def __init__(self, D, num_tags, use_temporal_pe, dtype):
        super().__init__()
        self.num_tags, self.use_temporal_pe, self.dtype = num_tags, use_temporal_pe, dtype
        self.tag_params = nn.Parameter(torch.empty((num_tags, D)))
        self.pe = FourierEmbeddingFix(num_pos_feats=D // 2)

    def forward(self, cond: Condition):
        tag_id = cond.feat[..., 0].to(torch.int32).clamp(0, self.num_tags - 1)
        emd = self.tag_params[tag_id.long()].to(self.dtype)
        if self.use_temporal_pe:
            emd = emd + self.pe(cond.feat[..., 1:3]).to(self.dtype)
        return emd


class DragPointEncoder(nn.Module):
    def __init__(self, D, num_points, pre, mlp, dtype):
        super().__init__()
        self.num_points = num_points
        self.pointnet = PointNetPolylineEncoder(2, D, pre, mlp, dtype)

    def forward(self, cond: Condition):
        B, C = cond.feat.shape[:2]
        pts = cond.feat.reshape(B, C, self.num_points, 2)
        return self.pointnet(torch.nan_to_num(pts), ~torch.isnan(pts).any(dim=-1))


def _one_hot(idx, valid, N: int):
    tgt = torch.where(valid & (idx >= 0) & (idx < N), idx, N).long()
    return F.one_hot(tgt, N + 1)[..., :N].float()


class GNNConditionAttn(nn.Module):
    """Unary conditions on the diagonal of a dense [B, N, N] edge matrix,
    mean-pooled over types, plus the fixed rel-PE between the two agents,
    as edge features of gated attention over the prompt tokens."""

    def __init__(self, D, num_layers, num_heads, head_dim, pool, dtype):
        super().__init__()
        if pool != "mean":
            raise ValueError("the reference holds the mean condition pool only")
        self.num_layers, self.dtype = num_layers, dtype
        self.rel_pe = RelPE(D, fold_dup=False, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", GatedNeighborAttention(
                D, num_heads, head_dim, bipartite=False, dtype=dtype))

    def forward(self, cond_embs, conditions, prompt_emb, prompt: Prompt):
        B, N, D = prompt_emb.shape
        dt = self.dtype
        acc, n_hit = None, 0.0
        hit_any = torch.zeros((B, N, N), dtype=torch.bool, device=prompt_emb.device)
        for ctype, emb in sorted(cond_embs.items()):
            cond = conditions[ctype]
            if cond.prompt_idx.shape[-1] != 1:
                raise ValueError("the reference holds unary conditions only")
            s = _one_hot(cond.prompt_idx[..., 0], cond.mask, N)
            hits = torch.einsum("bci,bcj->bij", s, s)
            s = s.to(dt)
            attr = torch.einsum("bci,bcj,bcd->bijd", s, s, emb[..., :D])
            acc = attr if acc is None else acc + attr
            n_hit = n_hit + (hits > 0).float()
            hit_any |= hits > 0
        pooled = (acc / n_hit.clamp_min(1)[..., None]).to(dt)
        edge_mask = hit_any & prompt.mask[:, :, None] & prompt.mask[:, None, :]
        all_idx = torch.arange(N, dtype=torch.int32, device=prompt_emb.device).expand(B, N, N)
        pe_in = rel_pe_features(prompt.pos, prompt.ori, prompt.pos, prompt.ori, all_idx)
        edge_z = normalize_rel_pe(pooled + self.rel_pe(pe_in), D)
        x = prompt_emb
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, x, all_idx, edge_mask, edge_z)
        return torch.where(prompt.mask[..., None], prompt_emb + x, prompt_emb)


class ConditionTransformer(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        ct = cfg.MODEL.CONDITION_TRANSFORMER
        D = cfg.MODEL.HIDDEN_DIM
        self.cond_types = tuple(cfg.PROMPT.CONDITION.TYPES)
        for t in self.cond_types:
            if t == "goal":
                enc = GoalConditionEncoder(D, ct.USE_TEMPORAL_ENCODING, dtype)
            elif t == "v_action_tag":
                enc = VActionTagEncoder(D, NUM_V_ACTION_TAGS, ct.USE_TEMPORAL_ENCODING, dtype)
            elif t == "drag_point":
                dp = ct.CONDITION_ENCODER.DRAG_POINTS
                enc = DragPointEncoder(D, cfg.PROMPT.CONDITION.DRAG_POINT.MAX_POINTS,
                                       dp.NUM_PRE_LAYERS, dp.NUM_MLP_LAYERS, dtype)
            else:
                raise ValueError(f"the reference does not hold condition type {t!r}")
            self.add_module(f"encoders_{t}", enc)
        self.cond_attn = GNNConditionAttn(D, ct.NLAYER, ct.NHEAD, ct.FF_DIM, ct.COND_POOL_FUNC,
                                          dtype)

    def forward(self, conditions, prompt_emb, prompt):
        embs = {t: getattr(self, f"encoders_{t}")(conditions[t])
                for t in self.cond_types if t in conditions}
        if embs:
            prompt_emb = self.cond_attn(embs, conditions, prompt_emb, prompt)
        return prompt_emb


# ----------------------------------------------------------------- policy


class Policy(nn.Module):
    """a2p and m2p attention at the agents' current poses, layer by layer,
    then the per-type anchor head through context gating, integrated within
    the chunk."""

    def __init__(self, cfg, dtype):
        super().__init__()
        mc = cfg.MODEL
        ad = mc.POLICY.ACT_DECODER
        a = ad.ATTN
        D = mc.HIDDEN_DIM
        self.dtype, self.hidden_dim, self.num_layers = dtype, D, a.NUM_LAYER
        self.max_neigh, self.agent_radius, self.map_radius = (a.MAX_NUM_NEIGH, a.AGENT_RADIUS,
                                                              a.MAP_RADIUS)
        self.motion_k, self.pred_steps = ad.TRAJ.K, cfg.DATASET.FORMAT.TARGET.STEPS
        self.state_dim = len(cfg.DATASET.FORMAT.TARGET.ELEMENTS.split(","))
        self.use_ped_cycl = cfg.DATASET.USE_PED_CYCLIST
        self.a2p_pe = RelPE(D, dtype=dtype)
        self.m2p_pe = RelPE(D, dtype=dtype)
        for i in range(a.NUM_LAYER):
            for site in ("a2p", "m2p"):
                self.add_module(f"{site}_{i}", GatedNeighborAttention(
                    D, a.NUM_HEAD, a.FF_DIM, bipartite=True, dtype=dtype))
        self.motion_anchors = nn.Embedding(self.motion_k * (3 if self.use_ped_cycl else 1), D)
        self.cg_decode = ContextGating(3, D, dtype)
        self.motion_head = MLP([D, D, D // 2, self.pred_steps * self.state_dim],
                               ret_before_act=True, dtype=dtype)
        self.goal_recon_head = cfg.LOSS.ROLLOUT_TRAJ.USE_GOAL_PRED_LOSS
        if self.goal_recon_head:
            self.pred_mlp = MLP([D, D, D // 2, 2], ret_before_act=True, dtype=dtype)

    def forward(self, policy_emd, scene: SceneTokens, pos, ori, mask, agent_type):
        m = scene.num_map
        pos32 = pos.float()
        obs_pos, map_pos = scene.pos[:, m:], scene.pos[:, :m]
        obs_ori, map_ori = scene.ori[:, m:], scene.ori[:, :m]
        a2p_idx, a2p_valid = neighbor_topk(pos32, obs_pos, mask, scene.mask[:, m:],
                                           k=self.max_neigh, radius=self.agent_radius)
        m2p_idx, m2p_valid = neighbor_topk(pos32, map_pos, mask, scene.mask[:, :m],
                                           k=self.max_neigh, radius=self.map_radius)
        a2p_z = normalize_rel_pe(self.a2p_pe(rel_pe_features(pos, ori, obs_pos, obs_ori,
                                                             a2p_idx)), self.hidden_dim)
        m2p_z = normalize_rel_pe(self.m2p_pe(rel_pe_features(pos, ori, map_pos, map_ori,
                                                             m2p_idx)), self.hidden_dim)
        x_p = policy_emd["emd"]
        for i in range(self.num_layers):
            x_p = getattr(self, f"a2p_{i}")(x_p, scene.tokens[:, m:], a2p_idx, a2p_valid, a2p_z)
            x_p = getattr(self, f"m2p_{i}")(x_p, scene.tokens[:, :m], m2p_idx, m2p_valid, m2p_z)
        B, N, _ = x_p.shape
        K, S = self.motion_k, self.pred_steps
        if self.use_ped_cycl:
            type_base = (agent_type.long().clamp_min(1) - 1) * K
        else:
            type_base = torch.zeros_like(agent_type, dtype=torch.long)
        anchor_ids = type_base[..., None] + torch.arange(K, device=x_p.device)
        anchor_emb = self.motion_anchors(anchor_ids).to(self.dtype)
        pred_emd, _ = self.cg_decode(anchor_emb, x_p, torch.ones((B, N, K), dtype=torch.bool,
                                                                  device=x_p.device))
        motion = self.motion_head(pred_emd).reshape(B, N, K, S, self.state_dim)
        traj = torch.cumsum(motion[..., :2], dim=-2)
        head = wrap_angle(torch.cumsum(motion[..., 2:3], dim=-2))
        out = {"motion_pred": torch.cat([traj, head, motion[..., 3:]], dim=-1),
               "motion_prob": torch.ones((B, N, K), dtype=motion.dtype, device=x_p.device)}
        if self.goal_recon_head:
            out["reconst_pred"] = self.pred_mlp(policy_emd["emd"])
        return out


# ------------------------------------------------------------------ model


def topk_stable(x, k: int):
    return torch.sort(-x, dim=-1, stable=True)[1][..., :k]


class ReferenceProSim(nn.Module):
    def __init__(self, cfg, dtype=torch.float32):
        super().__init__()
        check_config(cfg)
        self.dtype = dtype
        self.condition_locations = (list(cfg.MODEL.CONDITION_TRANSFORMER.CONDITION_LOCATIONS)
                                    if cfg.PROMPT.CONDITION.TYPES else [])
        if any(loc != "policy_decoder" for loc in self.condition_locations):
            raise ValueError("the reference holds conditions at 'policy_decoder' only")
        self.scene_encoder = SceneEncoder(cfg, dtype)
        self.prompt_encoder = PromptEncoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.policy = Policy(cfg, dtype)
        if self.condition_locations:
            self.condition_transformer_policy_decoder = ConditionTransformer(cfg, dtype)
        self.hist_steps = cfg.DATASET.FORMAT.HISTORY.STEPS
        self.replan = cfg.ROLLOUT.POLICY.REPLAN_FREQ
        self.top_k = cfg.ROLLOUT.POLICY.TOP_K
        self.dt = cfg.DATASET.MOTION.DT
        self.pred_vel = cfg.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_VEL

    # the once-per-scene half
    def generate_policy(self, batch: Scene, scene: SceneTokens, prompt_emb) -> dict:
        policy_emd = self.decoder(scene, batch.prompt, prompt_emb)
        policy_emd["goal"] = batch.prompt.goal_point
        if self.condition_locations:
            policy_emd["emd"] = self.condition_transformer_policy_decoder(
                batch.conditions, policy_emd["emd"], batch.prompt)
        return policy_emd

    def prepare(self, batch: Scene):
        scene = self.scene_encoder(batch.init_obs, batch.init_map)
        return scene, self.generate_policy(batch, scene, self.prompt_encoder(batch.prompt))

    # the closed loop
    def init_agent_trajs(self, batch: Scene, total_steps: int):
        obs, prompt = batch.init_obs, batch.prompt
        B, N = prompt.mask.shape
        safe_idx = prompt.obs_index.long().clamp_min(0)
        bidx = torch.arange(B, device=obs.feat.device)[:, None]
        feat = obs.feat[bidx, safe_idx]
        traj = torch.zeros((B, N, total_steps, 4), dtype=torch.float32, device=obs.feat.device)
        traj[:, :, :self.hist_steps] = torch.nan_to_num(feat[..., :4]).float()
        vel = torch.zeros((B, N, total_steps, 2), dtype=torch.float32, device=obs.feat.device)
        if self.pred_vel:
            vel[:, :, :self.hist_steps] = torch.nan_to_num(feat[..., 4:6]).float()
        return traj, vel, obs.pos[bidx, safe_idx], obs.ori[bidx, safe_idx]

    def agent_pose(self, traj, cursor, init_pos, init_heading):
        last = traj[:, :, cursor - 1]
        pos = init_pos + rotate_2d(last[..., :2], init_heading)
        return pos, wrap_angle(torch.atan2(last[..., 2], last[..., 3]) + init_heading)

    def step_env(self, batch, scene, traj, vel, r, cursor, init_pos, init_heading,
                 type_onehot, time_onehot):
        Th = self.hist_steps
        fo, prompt = batch.fut_obs, batch.prompt
        window = traj[:, :, cursor - Th - 2:cursor]
        rel = rel_traj_to_last_step(window)
        if self.pred_vel:
            rel_v = rel_vel_to_last_step(window, vel[:, :, cursor - Th - 1:cursor])
        else:
            rel_v = torch.diff(rel[..., :2], dim=-2) / self.dt
        rel_acc = torch.diff(rel_v, dim=-2) / self.dt
        B, N = rel.shape[:2]
        feat_n = torch.cat([rel[:, :, -Th:], torch.cat([rel_v[:, :, 1:], rel_acc], -1),
                            prompt.extent[:, :, None, :].expand(B, N, Th, 2),
                            type_onehot[:, :, None, :].expand(B, N, Th, 3),
                            time_onehot.expand(B, N, Th, Th)], dim=-1)
        pos_n, theta_n = self.agent_pose(traj, cursor, init_pos, init_heading)
        A = fo.feat.shape[2]
        obs_index = fo.obs_index[:, r].long()
        tgt = torch.where(prompt.mask & (obs_index >= 0), obs_index, A)
        bidx = torch.arange(B, device=tgt.device)[:, None]

        def scatter(base, val):
            buf = torch.cat([base, base[:, :1]], dim=1)
            buf[bidx, tgt] = val.to(buf.dtype) if torch.is_tensor(val) else val
            return buf[:, :A]

        return self.scene_encoder.update_obs(
            scene, scatter(fo.feat[:, r], feat_n), scatter(fo.mask[:, r], True),
            scatter(fo.pos[:, r], pos_n), scatter(fo.ori[:, r], theta_n))

    def rollout(self, batch: Scene, scene: SceneTokens, policy_emd: dict, num_steps: int,
                forced_traj=None):
        """The closed loop over `num_steps` replan steps. Free-running
        (`forced_traj` None) it integrates its own predictions; forced, each
        step reads the agents' trajectory so far from `forced_traj`
        [B, N, num_steps * replan, 4] (the program's rollout, in each agent's
        initial frame), so the reference follows the program step by step
        and a gap does not compound. The velocities are always the
        reference's own. Returns {'segs' [R, B, N, S, 4]: each step's
        integrated chunk, 'last' [R, B, N, 4]: the state it started from,
        'traj' [B, N, R*S, 4], 'init_pos', 'init_heading'}."""
        Th = self.hist_steps
        total = Th + num_steps * self.replan
        traj, vel, init_pos, init_heading = self.init_agent_trajs(batch, total)
        if forced_traj is not None:
            traj[:, :, Th:] = forced_traj.float()
        dev = traj.device
        prompt = batch.prompt
        mask = prompt.mask
        type_onehot = (prompt.agent_type.long()[..., None] - 1
                       == torch.arange(3, device=dev)).to(self.dtype)
        time_onehot = torch.eye(Th, dtype=self.dtype, device=dev)
        segs, lasts = [], []
        for r in range(num_steps):
            cursor = Th + r * self.replan
            pos_now, theta_now = self.agent_pose(traj, cursor, init_pos, init_heading)
            if r > 0:
                scene = self.step_env(batch, scene, traj, vel, r, cursor, init_pos, init_heading,
                                      type_onehot, time_onehot)
            out = self.policy(policy_emd, scene, pos_now.to(self.dtype),
                              theta_now.to(self.dtype), mask, prompt.agent_type)
            mp = out["motion_pred"]
            sel = torch.argmax(out["motion_prob"], dim=-1)  # TOP_K 1: the first maximum
            chunk = mp.gather(2, sel[:, :, None, None, None].expand(
                *mp.shape[:2], 1, *mp.shape[3:]))[:, :, 0, :self.replan].float()
            last = traj[:, :, cursor - 1].clone()
            seg, vseg = integrate_chunk(chunk, last)
            S = seg.shape[2]
            seg = torch.where(mask[..., None, None], seg, 0.0)
            if forced_traj is None:
                traj[:, :, cursor:cursor + S] = seg
            if self.pred_vel:
                vel[:, :, cursor:cursor + S] = torch.where(mask[..., None, None], vseg, 0.0)
            segs.append(seg)
            lasts.append(last)
        return {"segs": torch.stack(segs), "last": torch.stack(lasts), "traj": traj[:, :, Th:],
                "init_pos": init_pos, "init_heading": init_heading}


# ------------------------------------------------- rollout-level functions


def integrate_chunk(chunk, last):
    """The program's integration of one replan chunk: chunk [..., S, C] in
    the agent's frame at `last` [..., 4] = (x, y, sin, cos) -> the new
    (x, y, sin, cos) segment [..., S, 4] and the velocity (rotated)."""
    last_theta = torch.atan2(last[..., 2], last[..., 3])
    xy = rotate_2d(chunk[..., :2], last_theta[..., None]) + last[..., None, :2]
    th = wrap_angle(last_theta[..., None] + chunk[..., 2])
    seg = torch.cat([xy, torch.sin(th)[..., None], torch.cos(th)[..., None]], dim=-1)
    return seg, rotate_2d(chunk[..., 3:5], last_theta[..., None])


def sample_goals(goal_point, goal_prob, picks, top_k: int, stop_smooth: float,
                 horizon: float = 80.0):
    """Per-replica goals: replica j of scene i takes each agent's
    picks[i, j]-th most likely goal; goals within `stop_smooth` m of the
    origin on both axes snap to (0, 0). -> feat [B*m, N, 3]."""
    B, N, K, _ = goal_point.shape
    m = picks.shape[1]
    k_eff = min(top_k, K)
    topk_idx = topk_stable(goal_prob, k_eff)
    sel = topk_idx[:, None].expand(B, m, N, k_eff).gather(-1, picks[..., None].long())[..., 0]
    goals = goal_point[:, None].expand(B, m, N, K, 2).gather(
        3, sel[..., None, None].expand(B, m, N, 1, 2))[:, :, :, 0]
    stop = (goals[..., 0].abs() < stop_smooth) & (goals[..., 1].abs() < stop_smooth)
    goals = torch.where(stop[..., None], 0.0, goals)
    return torch.cat([goals, torch.full((B, m, N, 1), horizon, dtype=goals.dtype,
                                        device=goals.device)], dim=-1).reshape(B * m, N, 3)


def goal_condition(feat, prompt_mask, m: int) -> Condition:
    """The goal Condition of `sample_goals`' feat for the m-tiled prompt."""
    BM, N, _ = feat.shape
    mask = prompt_mask.repeat_interleave(m, dim=0)
    idx = torch.arange(N, dtype=torch.int32, device=feat.device)[None, :, None].expand(BM, N, 1)
    return Condition(feat=feat, mask=mask, prompt_idx=idx, prompt_mask=mask)


def to_world(traj, init_pos, init_h, center_xy, center_h):
    """Local rollout [B, N, T, 4] -> world (x, y, heading) [B, N, T, 3]."""
    xy_scene = rotate_2d(traj[..., :2], init_h[..., None]) + init_pos[..., None, :]
    h_scene = wrap_angle(torch.atan2(traj[..., 2], traj[..., 3]) + init_h[..., None])
    xy_world = rotate_2d(xy_scene, center_h[:, None, None]) + center_xy[:, None, None, :]
    return torch.cat([xy_world, wrap_angle(h_scene + center_h[:, None, None])[..., None]], -1)


def tile_rows(x, m: int):
    return x.repeat_interleave(m, dim=0)


def tile_scene_tokens(s: SceneTokens, m: int) -> SceneTokens:
    return SceneTokens(tile_rows(s.tokens, m), tile_rows(s.pos, m), tile_rows(s.ori, m),
                       tile_rows(s.mask, m), s.num_map)
