"""Policy-embedding decoder (port of prosim_tpu/models/decoder.py).

Per layer, prompts self-attend over neighboring prompts (p2p, no
self-loops) then cross-attend to nearby scene tokens (s2p), with rel-PE;
optional K-way goal heads. With deterministic=False (training) the
attention layers drop out at MODEL.DECODER.ATTN.DROPOUT. The layers and
heads compute in `dtype`; positions and graphs stay f32.
"""

import torch
from torch import nn

from prosim_torch.data.batch import Prompt, SceneTokens
from prosim_torch.ops.attention import (
    GatedNeighborAttention,
    RelPE,
    rel_pe_table,
    shared_source,
)
from prosim_torch.ops.mlp import MLP
from prosim_torch.ops.neighbors import neighbor_topk


class SymCoordDecoder(nn.Module):
    def __init__(self, hidden_dim, num_layers, num_heads, head_dim, max_neigh,
                 prompt_radius, scene_radius, edge_func, learnable_pe,
                 pe_num_freq, goal_pred=False, goal_k=32, dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.max_neigh = max_neigh
        self.prompt_radius = prompt_radius
        self.scene_radius = scene_radius
        self.edge_func = edge_func
        self.goal_pred = goal_pred
        self.goal_k = goal_k
        self.p2p_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq, dtype=dtype)
        self.s2p_pe = RelPE(hidden_dim, learnable_pe, pe_num_freq, dtype=dtype)
        for i in range(num_layers):
            self.add_module(f"p2p_{i}", GatedNeighborAttention(
                hidden_dim, num_heads, head_dim, bipartite=False, dropout=dropout, dtype=dtype))
            self.add_module(f"s2p_{i}", GatedNeighborAttention(
                hidden_dim, num_heads, head_dim, bipartite=True, dropout=dropout, dtype=dtype))
        if goal_pred:
            self.goal_prob_head = MLP([hidden_dim, hidden_dim // 2, goal_k], ret_before_act=True,
                                      dtype=dtype)
            self.goal_point_head = MLP([hidden_dim, hidden_dim // 2, goal_k * 2],
                                       ret_before_act=True, dtype=dtype)

    def forward(self, scene: SceneTokens, prompt: Prompt, prompt_emb, deterministic: bool = True,
                generator=None) -> dict:
        """prompt_emb [B, N, D] -> dict with 'emd' [B, N, D] (+ goal heads)."""
        radius = self.edge_func == "radius"
        p2p_idx, p2p_valid = neighbor_topk(
            prompt.pos, prompt.pos, prompt.mask, prompt.mask, k=self.max_neigh,
            radius=self.prompt_radius if radius else None, exclude_self=True,
        )
        p2p_z = rel_pe_table(prompt.pos, prompt.ori, prompt.pos, prompt.ori, p2p_idx,
                             self.p2p_pe, deterministic)
        s2p_idx, s2p_valid = neighbor_topk(
            prompt.pos, scene.pos, prompt.mask, scene.mask, k=self.max_neigh,
            radius=self.scene_radius if radius else None,
        )
        s2p_z = rel_pe_table(prompt.pos, prompt.ori, scene.pos, scene.ori, s2p_idx,
                             self.s2p_pe, deterministic)
        # scene tokens are layer-constant here: normalize (and in training
        # gather) them once for the stack
        s2p_src = shared_source(scene.tokens, s2p_idx, s2p_valid, deterministic)
        x_p = prompt_emb
        drop = dict(deterministic=deterministic, generator=generator)
        for i in range(self.num_layers):
            x_p = getattr(self, f"p2p_{i}")(
                x_p, x_p, p2p_idx, p2p_valid, p2p_z, **drop)
            x_p = getattr(self, f"s2p_{i}")(
                x_p, scene.tokens, s2p_idx, s2p_valid, s2p_z, **s2p_src, **drop)
        x_p = torch.where(prompt.mask[..., None], x_p, 0.0)

        result = {"emd": x_p}
        if self.goal_pred:
            result["goal_prob"] = torch.where(
                prompt.mask[..., None], self.goal_prob_head(x_p), 0.0)
            gp = self.goal_point_head(x_p).reshape(*x_p.shape[:-1], self.goal_k, 2)
            result["goal_point"] = torch.where(prompt.mask[..., None, None], gp, 0.0)
        return result


def build_decoder(config, dtype=torch.float32) -> SymCoordDecoder:
    mc = config.MODEL
    attn = mc.DECODER.ATTN
    return SymCoordDecoder(
        hidden_dim=mc.HIDDEN_DIM,
        num_layers=attn.NUM_LAYER,
        num_heads=attn.NUM_HEAD,
        head_dim=attn.FF_DIM,
        max_neigh=attn.MAX_NUM_NEIGH,
        prompt_radius=attn.PROMPT_RADIUS,
        scene_radius=attn.SCENE_RADIUS,
        edge_func=mc.REL_POS_EDGE_FUNC,
        learnable_pe=attn.LEARNABLE_PE,
        pe_num_freq=attn.PE_NUM_FREQ,
        goal_pred=mc.DECODER.GOAL_PRED.ENABLE,
        goal_k=mc.DECODER.GOAL_PRED.K,
        dropout=attn.DROPOUT,
        dtype=dtype,
    )
