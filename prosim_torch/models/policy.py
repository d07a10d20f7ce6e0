"""Policy action decoder (port of prosim_tpu/models/policy.py).

Queries sit at the agents' current rollout positions and cross-attend to
agent observation tokens (a2p) and map tokens (m2p) with rel-PE; the
anchor-conditioned context-gating head emits K-mode [steps, state_dim]
action deltas, cumsum-integrated within the chunk. The a2p/m2p stack runs
either as the interleaved per-layer loop or, with FUSED_STACK, as one call
of the fused two-site stack per replan step (ops/fused_stack.py, one CUDA
kernel on the card), under the JAX package's conditions: fixed rel-PE and
the map site in use. The port is eval-only, so the JAX package's training
and TPU-backend terms do not apply. The 'anchor' head and the goal-reconstruction
head (`pred_mlp`, LOSS.ROLLOUT_TRAJ.USE_GOAL_PRED_LOSS) are ported; the other
heads and goal context are still to be ported (ROADMAP.md queue A3).
"""

import torch
from torch import nn

from prosim_torch.data.batch import SceneTokens
from prosim_torch.ops.attention import (
    GatedNeighborAttention,
    RelPE,
    _norm_stats,
    normalize_rel_pe,
    rel_pe_features,
)
from prosim_torch.ops.fused_stack import fused_two_site_stack, pack_site_weights
from prosim_torch.ops.mlp import MLP, ContextGating
from prosim_torch.ops.neighbors import neighbor_topk
from prosim_torch.utils.geometry import wrap_angle


class PolicyRelPE(nn.Module):
    def __init__(self, hidden_dim, num_layers, num_heads, head_dim, max_neigh,
                 agent_radius, map_radius, edge_func, learnable_pe, pe_num_freq,
                 motion_k, pred_steps, state_dim, use_ped_cycl=True, not_use_map=False,
                 fused_stack=False, goal_recon_head=False):
        super().__init__()
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
        self.use_ped_cycl = use_ped_cycl
        self.not_use_map = not_use_map
        self.learnable_pe = learnable_pe
        self.fused_stack = fused_stack
        self.a2p_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq)
        self.m2p_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq)
        for i in range(num_layers):
            for site in ("a2p", "m2p"):
                self.add_module(f"{site}_{i}", GatedNeighborAttention(
                    hidden_dim, num_heads, head_dim, bipartite=True))
        num_types = 3 if use_ped_cycl else 1
        self.motion_anchors = nn.Embedding(motion_k * num_types, hidden_dim)
        self.cg_decode = ContextGating(3, hidden_dim)
        self.motion_head = MLP(
            [hidden_dim, hidden_dim, hidden_dim // 2, pred_steps * state_dim],
            ret_before_act=True,
        )
        self.goal_recon_head = goal_recon_head
        if goal_recon_head:  # goal reconstruction from the policy embedding
            self.pred_mlp = MLP([hidden_dim, hidden_dim, hidden_dim // 2, 2], ret_before_act=True)

    def forward(self, policy_emd: dict, scene: SceneTokens, agent_pos, agent_ori,
                agent_mask, agent_type, packed=None) -> dict:
        """packed: `pack_fused()` of this policy, made once per forward by the
        caller; packed here when it is None and the fused stack runs."""
        x_p = self._attn_fuse(policy_emd["emd"], scene, agent_pos, agent_ori, agent_mask, packed)
        result = self._compute_traj(x_p, agent_type)
        if self.goal_recon_head:
            result["reconst_pred"] = self.pred_mlp(policy_emd["emd"])
        return result

    def uses_fused_stack(self) -> bool:
        return self.fused_stack and not self.learnable_pe and not self.not_use_map

    def pack_fused(self):
        """Both sites' packed weights for the fused stack, or None when the
        layer loop runs."""
        if not self.uses_fused_stack():
            return None
        return pack_site_weights(self, "a2p"), pack_site_weights(self, "m2p")

    def site_graphs(self, scene: SceneTokens, pos, mask):
        """The a2p and m2p neighbor graphs ((idx, valid) each) at the agents'
        positions."""
        m = scene.num_map
        radius = self.edge_func == "radius"
        obs_pos, map_pos = scene.pos[:, m:].contiguous(), scene.pos[:, :m].contiguous()
        obs_mask, map_mask = scene.mask[:, m:].contiguous(), scene.mask[:, :m].contiguous()
        a2p = neighbor_topk(pos, obs_pos, mask, obs_mask, k=self.max_neigh,
                            radius=self.agent_radius if radius else None)
        m2p = neighbor_topk(pos, map_pos, mask, map_mask, k=self.max_neigh,
                            radius=self.map_radius if radius else None)
        return a2p, m2p

    def _attn_fuse(self, x_p, scene: SceneTokens, pos, ori, mask, packed=None):
        graphs = self.site_graphs(scene, pos, mask)
        if self.uses_fused_stack():
            wa, wm = packed if packed is not None else self.pack_fused()
            return fused_two_site_stack(x_p, *self.fused_tables(scene, pos, ori, graphs), wa, wm,
                                        num_heads=self.num_heads, head_dim=self.head_dim)
        return self.layer_loop(x_p, scene, pos, ori, graphs)

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

    def layer_loop(self, x_p, scene: SceneTokens, pos, ori, graphs):
        """The interleaved per-layer a2p/m2p stack."""
        (a2p_idx, a2p_valid), (m2p_idx, m2p_valid) = graphs
        m = scene.num_map
        obs_pos, obs_ori = scene.pos[:, m:], scene.ori[:, m:]
        map_pos, map_ori = scene.pos[:, :m], scene.ori[:, :m]
        a2p_pe = self.a2p_pe(rel_pe_features(pos, ori, obs_pos, obs_ori, a2p_idx))
        m2p_pe = self.m2p_pe(rel_pe_features(pos, ori, map_pos, map_ori, m2p_idx))
        # the normalized source rows are layer-constant within a replan step
        # and shared by every layer of the stack
        a2p_src = _norm_stats(scene.obs_tokens)
        m2p_src = _norm_stats(scene.map_tokens)
        a2p_z = normalize_rel_pe(a2p_pe, self.hidden_dim)
        m2p_z = normalize_rel_pe(m2p_pe, self.hidden_dim)
        for i in range(self.num_layers):
            x_p = getattr(self, f"a2p_{i}")(
                x_p, scene.obs_tokens, a2p_idx, a2p_valid, a2p_z, src_normed=a2p_src)
            x_m = getattr(self, f"m2p_{i}")(
                x_p, scene.map_tokens, m2p_idx, m2p_valid, m2p_z, src_normed=m2p_src)
            x_p = x_p if self.not_use_map else x_m
        return x_p

    def _compute_traj(self, pred_feat, agent_type) -> dict:
        """pred_feat [B, N, D] -> motion_pred [B, N, K, S, state_dim]."""
        B, N, _ = pred_feat.shape
        K, S = self.motion_k, self.pred_steps
        # per-type anchor bank: anchor id = (type - 1) * K + k
        if self.use_ped_cycl:
            type_base = (agent_type.long().clamp_min(1) - 1) * K
        else:
            type_base = torch.zeros_like(agent_type, dtype=torch.long)
        anchor_ids = type_base[..., None] + torch.arange(K, device=pred_feat.device)
        anchor_emb = self.motion_anchors(anchor_ids)  # [B, N, K, D]
        ones = torch.ones((B, N, K), dtype=torch.bool, device=pred_feat.device)
        pred_emd, _ = self.cg_decode(anchor_emb, pred_feat, ones)
        motion = self.motion_head(pred_emd).reshape(B, N, K, S, self.state_dim)

        # integrate deltas within the chunk (reference: act_decoder.py:117-121)
        traj = torch.cumsum(motion[..., :2], dim=-2)
        head = wrap_angle(torch.cumsum(motion[..., 2:3], dim=-2))
        motion_pred = torch.cat([traj, head, motion[..., 3:]], dim=-1)
        motion_prob = torch.ones((B, N, K), dtype=motion_pred.dtype, device=motion_pred.device)
        return {"motion_pred": motion_pred, "motion_prob": motion_prob}


def build_policy(config) -> PolicyRelPE:
    mc = config.MODEL
    ad = mc.POLICY.ACT_DECODER
    attn = ad.ATTN
    if ad.TRAJ.PRED_MODE != "anchor":
        raise NotImplementedError(
            f"TRAJ.PRED_MODE={ad.TRAJ.PRED_MODE!r} is not ported yet (see ROADMAP.md queue A3)")
    if ad.CONTEXT.GOAL or not ad.CONTEXT.EMD:
        raise NotImplementedError("goal context is not ported yet (see ROADMAP.md queue A3)")
    state_dim = len(config.DATASET.FORMAT.TARGET.ELEMENTS.split(","))
    if ad.TRAJ.PRED_GMM:
        state_dim += 3
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
        use_ped_cycl=config.DATASET.USE_PED_CYCLIST,
        not_use_map=attn.NOT_USE_MAP,
        fused_stack=attn.FUSED_STACK,
        goal_recon_head=config.LOSS.ROLLOUT_TRAJ.USE_GOAL_PRED_LOSS,
    )
