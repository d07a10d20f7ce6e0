"""Policy action decoder (port of prosim_tpu/models/policy.py).

Queries sit at the agents' current rollout positions and cross-attend to
agent observation tokens (a2p) and map tokens (m2p) with rel-PE; a head
emits K-mode [steps, state_dim] action deltas, cumsum-integrated within the
chunk. The a2p/m2p stack runs either as the interleaved per-layer loop or,
with FUSED_STACK, as one call of the fused two-site stack per replan step
(ops/fused_stack.py, one CUDA kernel on the card), under the JAX package's
conditions: fixed rel-PE, the map site in use, and a deterministic pass
with grad mode off (the kernel has no backward, so training, with
deterministic=False, takes the layer loop and its dropout at
MODEL.POLICY.ACT_DECODER.ATTN.DROPOUT, as prosim_tpu/models/policy.py:199-206
does). The JAX package's TPU-backend term does not apply.

The stack's query rows are the context (`_extract_context`): the policy
embedding, or with CONTEXT.GOAL the encoded goal point (through the fixed
Fourier PE with CONTEXT.USE_POSE_EMB), fused with the embedding by
`context_fuse` when CONTEXT.EMD is on too. TRAJ.PRED_MODE picks the head:
'anchor' (per-type anchor embeddings through context gating), 'cluster'
(the fixed Fourier PE of the K goals in TRAJ.CLUSTER_PATH through
`cluster_mlp` and context gating), 'mlp' (one MLP emits every mode's
chunk), or the aux heads 'vel_pred' and 'goal_pred', which return only
`init_vel_pred` [B,N,2] or `goal_pred` [B,N,3] and no trajectory (as in the
JAX package, the closed loop does not run them). The goal-reconstruction
head (`pred_mlp`, LOSS.ROLLOUT_TRAJ.USE_GOAL_PRED_LOSS) rides along with
the trajectory heads.

The policy computes in `dtype`, as the JAX module does: ProSim hands it
the agents' poses in `dtype`; the neighbor graphs take them as f32 (the
JAX top-K promotes them against the f32 scene positions) and the rel-PE
features are f32; the stack, the anchor embeddings, the context gating, the
heads and the in-chunk cumsum run in `dtype`, and the fused stack takes
its weights packed in `dtype`. The cluster goals are rounded to `dtype`
before their (f32) Fourier PE, as the JAX module does.
"""

import numpy as np
import torch
from torch import nn

from prosim_torch.data.batch import SceneTokens
from prosim_torch.ops.attention import (
    GatedNeighborAttention,
    RelPE,
    rel_pe_features,
    rel_pe_table,
    shared_source,
    takes_kernel,
)
from prosim_torch.ops.fourier import FourierEmbeddingFix
from prosim_torch.ops.fused_stack import fused_two_site_stack, pack_site_weights
from prosim_torch.ops.mlp import MLP, ContextGating
from prosim_torch.ops.neighbors import neighbor_topk
from prosim_torch.utils.geometry import wrap_angle


class PolicyRelPE(nn.Module):
    def __init__(self, hidden_dim, num_layers, num_heads, head_dim, max_neigh,
                 agent_radius, map_radius, edge_func, learnable_pe, pe_num_freq,
                 motion_k, pred_steps, state_dim, pred_mode="anchor", cluster_goals=None,
                 use_ped_cycl=True, context_goal=False, context_emd=True,
                 context_pose_emb=False, not_use_map=False, fused_stack=False,
                 goal_recon_head=False, dropout=0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.max_neigh = max_neigh
        self.agent_radius = agent_radius
        self.map_radius = map_radius
        self.edge_func = edge_func
        self.motion_k = motion_k
        self.pred_steps = pred_steps
        self.state_dim = state_dim
        self.pred_mode = pred_mode
        self.use_ped_cycl = use_ped_cycl
        self.context_goal = context_goal
        self.context_emd = context_emd
        self.context_pose_emb = context_pose_emb
        self.not_use_map = not_use_map
        self.learnable_pe = learnable_pe
        self.fused_stack = fused_stack
        if context_goal:
            self.goal_encoder = MLP([hidden_dim if context_pose_emb else 2, hidden_dim],
                                    dtype=dtype)
            if context_pose_emb:
                self.goal_pose_pe = FourierEmbeddingFix(num_pos_feats=hidden_dim // 2)
            if context_emd:
                self.context_fuse = MLP([2 * hidden_dim, hidden_dim], dtype=dtype)
        self.a2p_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq, dtype=dtype)
        self.m2p_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq, dtype=dtype)
        for i in range(num_layers):
            for site in ("a2p", "m2p"):
                self.add_module(f"{site}_{i}", GatedNeighborAttention(
                    hidden_dim, num_heads, head_dim, bipartite=True, dropout=dropout,
                    dtype=dtype))
        out_dim = pred_steps * state_dim
        if pred_mode == "vel_pred":  # aux head: initial velocity (reference: act_decoder.py:51-52)
            self.vel_head = MLP([hidden_dim, hidden_dim, hidden_dim // 2, 2],
                                ret_before_act=True, dtype=dtype)
        elif pred_mode == "goal_pred":  # aux head: goal xy + logit (act_decoder.py:55-57)
            self.goal_head = MLP([hidden_dim, 3], ret_before_act=True, dtype=dtype)
        elif pred_mode == "mlp":
            self.motion_head = MLP([hidden_dim, hidden_dim, hidden_dim // 2, motion_k * out_dim],
                                   ret_before_act=True, dtype=dtype)
        else:  # anchor / cluster (reference: act_decoder.py:65-74)
            if pred_mode == "cluster":
                self.cluster_mlp = MLP([hidden_dim, hidden_dim], dtype=dtype)
                self.cluster_goal_pe = FourierEmbeddingFix(num_pos_feats=hidden_dim // 2)
                # the K goal anchors [K, 2]: a constant of the model, not a
                # parameter (the JAX module's attribute)
                self.register_buffer("cluster_goals", torch.as_tensor(
                    np.asarray(cluster_goals, np.float32)), persistent=False)
            else:
                num_types = 3 if use_ped_cycl else 1
                self.motion_anchors = nn.Embedding(motion_k * num_types, hidden_dim)
            self.cg_decode = ContextGating(3, hidden_dim, dtype)
            self.motion_head = MLP([hidden_dim, hidden_dim, hidden_dim // 2, out_dim],
                                   ret_before_act=True, dtype=dtype)
        self.goal_recon_head = goal_recon_head
        if goal_recon_head:  # goal reconstruction from the policy embedding
            self.pred_mlp = MLP([hidden_dim, hidden_dim, hidden_dim // 2, 2], ret_before_act=True,
                                dtype=dtype)

    def forward(self, policy_emd: dict, scene: SceneTokens, agent_pos, agent_ori,
                agent_mask, agent_type, packed=None, deterministic: bool = True,
                generator=None) -> dict:
        """packed: `pack_fused()` of this policy, made once per forward by the
        caller; packed here when it is None and the fused stack runs."""
        x_p = self._attn_fuse(self._extract_context(policy_emd), scene, agent_pos, agent_ori,
                              agent_mask, packed, deterministic, generator)
        return self._compute_traj(x_p, policy_emd, agent_type)

    def _extract_context(self, policy_emd: dict):
        """The stack's query rows [B, N, D] (prosim_tpu/models/policy.py:135-146)."""
        ctx = []
        if self.context_goal and "goal" in policy_emd:
            goal = policy_emd["goal"]
            if self.context_pose_emb:
                goal = self.goal_pose_pe(goal)
            ctx.append(self.goal_encoder(goal))
        if self.context_emd:
            ctx.append(policy_emd["emd"])
        if len(ctx) > 1:
            return self.context_fuse(torch.cat(ctx, dim=-1))
        return ctx[0]

    def uses_fused_stack(self) -> bool:
        return self.fused_stack and not self.learnable_pe and not self.not_use_map

    def pack_fused(self):
        """Both sites' packed weights for the fused stack, or None when the
        layer loop runs."""
        if not self.uses_fused_stack():
            return None
        return tuple(pack_site_weights(self, site, self.dtype) for site in ("a2p", "m2p"))

    def site_graphs(self, scene: SceneTokens, pos, mask):
        """The a2p and m2p neighbor graphs ((idx, valid) each) at the agents'
        positions (taken as f32)."""
        m = scene.num_map
        pos = pos.float()
        radius = self.edge_func == "radius"
        obs_pos, map_pos = scene.pos[:, m:].contiguous(), scene.pos[:, :m].contiguous()
        obs_mask, map_mask = scene.mask[:, m:].contiguous(), scene.mask[:, :m].contiguous()
        a2p = neighbor_topk(pos, obs_pos, mask, obs_mask, k=self.max_neigh,
                            radius=self.agent_radius if radius else None)
        m2p = neighbor_topk(pos, map_pos, mask, map_mask, k=self.max_neigh,
                            radius=self.map_radius if radius else None)
        return a2p, m2p

    def _attn_fuse(self, x_p, scene: SceneTokens, pos, ori, mask, packed=None,
                   deterministic=True, generator=None):
        graphs = self.site_graphs(scene, pos, mask)
        if self.uses_fused_stack() and takes_kernel(deterministic):
            wa, wm = packed if packed is not None else self.pack_fused()
            return fused_two_site_stack(x_p, *self.fused_tables(scene, pos, ori, graphs), wa, wm,
                                        num_heads=self.num_heads, head_dim=self.head_dim)
        return self.layer_loop(x_p, scene, pos, ori, graphs, deterministic, generator)

    def fused_tables(self, scene: SceneTokens, pos, ori, graphs):
        """The fused stack's (x_src, idx, feats, valid) tables of both sites."""
        m = scene.num_map
        srcs = ((scene.obs_tokens, scene.pos[:, m:], scene.ori[:, m:]),
                (scene.map_tokens, scene.pos[:, :m], scene.ori[:, :m]))
        tables = []
        for (tokens, src_pos, src_ori), (idx, valid) in zip(srcs, graphs):
            feats = rel_pe_features(pos, ori, src_pos, src_ori, idx)
            # the stack expands the reference's 4-feature fixed PE itself;
            # re-append the duplicated rel_ori_vec feature
            feats = torch.cat([feats, feats[..., 2:3]], dim=-1)
            tables.append((tokens, idx, feats, valid))
        return tables

    def layer_loop(self, x_p, scene: SceneTokens, pos, ori, graphs, deterministic=True,
                   generator=None):
        """The interleaved per-layer a2p/m2p stack."""
        (a2p_idx, a2p_valid), (m2p_idx, m2p_valid) = graphs
        m = scene.num_map
        obs_pos, obs_ori = scene.pos[:, m:], scene.ori[:, m:]
        map_pos, map_ori = scene.pos[:, :m], scene.ori[:, :m]
        a2p_z = rel_pe_table(pos, ori, obs_pos, obs_ori, a2p_idx, self.a2p_pe, deterministic)
        m2p_z = rel_pe_table(pos, ori, map_pos, map_ori, m2p_idx, self.m2p_pe, deterministic)
        # the normalized (in training, gathered) source rows are
        # layer-constant within a replan step and shared by every layer
        a2p_src = shared_source(scene.obs_tokens, a2p_idx, a2p_valid, deterministic)
        m2p_src = shared_source(scene.map_tokens, m2p_idx, m2p_valid, deterministic)
        drop = dict(deterministic=deterministic, generator=generator)
        for i in range(self.num_layers):
            x_p = getattr(self, f"a2p_{i}")(
                x_p, scene.obs_tokens, a2p_idx, a2p_valid, a2p_z, **a2p_src, **drop)
            x_m = getattr(self, f"m2p_{i}")(
                x_p, scene.map_tokens, m2p_idx, m2p_valid, m2p_z, **m2p_src, **drop)
            x_p = x_p if self.not_use_map else x_m
        return x_p

    def _compute_traj(self, pred_feat, policy_emd: dict, agent_type) -> dict:
        """pred_feat [B, N, D] -> motion_pred [B, N, K, S, state_dim], or an
        aux head's output."""
        if self.pred_mode == "vel_pred":
            return {"init_vel_pred": self.vel_head(pred_feat)}
        if self.pred_mode == "goal_pred":
            return {"goal_pred": self.goal_head(pred_feat)}
        B, N, _ = pred_feat.shape
        K, S = self.motion_k, self.pred_steps
        dev = pred_feat.device
        if self.pred_mode == "mlp":
            motion = self.motion_head(pred_feat).reshape(B, N, K, S, self.state_dim)
        else:
            if self.pred_mode == "cluster":
                # fixed Fourier PE of the goal anchors, shared by every agent
                # (reference: act_decoder.py:69-73,104-106)
                goals_pe = self.cluster_goal_pe(self.cluster_goals.to(self.dtype))
                anchor_emb = self.cluster_mlp(goals_pe).expand(B, N, K, self.hidden_dim)
            else:
                # per-type anchor bank: anchor id = (type - 1) * K + k
                if self.use_ped_cycl:
                    type_base = (agent_type.long().clamp_min(1) - 1) * K
                else:
                    type_base = torch.zeros_like(agent_type, dtype=torch.long)
                anchor_ids = type_base[..., None] + torch.arange(K, device=dev)
                anchor_emb = self.motion_anchors(anchor_ids).to(self.dtype)  # [B, N, K, D]
            ones = torch.ones((B, N, K), dtype=torch.bool, device=dev)
            pred_emd, _ = self.cg_decode(anchor_emb, pred_feat, ones)
            motion = self.motion_head(pred_emd).reshape(B, N, K, S, self.state_dim)

        # integrate deltas within the chunk (reference: act_decoder.py:117-121)
        traj = torch.cumsum(motion[..., :2], dim=-2)
        head = wrap_angle(torch.cumsum(motion[..., 2:3], dim=-2))
        motion_pred = torch.cat([traj, head, motion[..., 3:]], dim=-1)
        motion_prob = torch.ones((B, N, K), dtype=motion_pred.dtype, device=dev)
        result = {"motion_pred": motion_pred, "motion_prob": motion_prob}
        if self.goal_recon_head:
            result["reconst_pred"] = self.pred_mlp(policy_emd["emd"])
        return result


def build_policy(config, dtype=torch.float32) -> PolicyRelPE:
    mc = config.MODEL
    ad = mc.POLICY.ACT_DECODER
    attn = ad.ATTN
    state_dim = len(config.DATASET.FORMAT.TARGET.ELEMENTS.split(","))
    if ad.TRAJ.PRED_GMM:
        state_dim += 3
    cluster_goals = None
    if ad.TRAJ.PRED_MODE == "cluster":
        cluster_goals = np.load(ad.TRAJ.CLUSTER_PATH).astype(np.float32)
        if cluster_goals.shape[0] != ad.TRAJ.K:
            raise ValueError(
                f"cluster file has {cluster_goals.shape[0]} goals but TRAJ.K={ad.TRAJ.K}")
    return PolicyRelPE(
        hidden_dim=mc.HIDDEN_DIM,
        num_layers=attn.NUM_LAYER,
        num_heads=attn.NUM_HEAD,
        head_dim=attn.FF_DIM,
        max_neigh=attn.MAX_NUM_NEIGH,
        agent_radius=attn.AGENT_RADIUS,
        map_radius=attn.MAP_RADIUS,
        edge_func=mc.REL_POS_EDGE_FUNC,
        learnable_pe=attn.LEARNABLE_PE,
        pe_num_freq=attn.PE_NUM_FREQ,
        motion_k=ad.TRAJ.K,
        pred_steps=config.DATASET.FORMAT.TARGET.STEPS,
        state_dim=state_dim,
        pred_mode=ad.TRAJ.PRED_MODE,
        cluster_goals=cluster_goals,
        use_ped_cycl=config.DATASET.USE_PED_CYCLIST,
        context_goal=ad.CONTEXT.GOAL,
        context_emd=ad.CONTEXT.EMD,
        context_pose_emb=ad.CONTEXT.USE_POSE_EMB,
        not_use_map=attn.NOT_USE_MAP,
        fused_stack=attn.FUSED_STACK,
        goal_recon_head=config.LOSS.ROLLOUT_TRAJ.USE_GOAL_PRED_LOSS,
        dropout=attn.DROPOUT,
        dtype=dtype,
    )
