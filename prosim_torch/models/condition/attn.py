"""GNN condition attention: inject condition embeddings into prompt tokens
(port of prosim_tpu/models/condition/attn.py:GNNConditionAttn).

Condition embeddings land in a dense [B, N, N] edge matrix keyed by prompt
indices (the diagonal for unary conditions, (src, tgt) and (tgt, src) for
binary ones), are pooled across condition types, summed with a fixed
relative PE between the two agents, and serve as edge features of gated
attention over the prompt tokens; the result is added onto the prompt
embedding of every valid agent.

The JAX package scatter-adds into the matrix (`.at[].add(mode="drop")`).
Several conditions may hit one cell, and a CUDA scatter-add sums with
atomics in an order that changes from run to run, so here each type's
matrix is a product of one-hot matrices ([B, C, N] per index, the dropped
index N giving a zero row): deterministic, and exact wherever one
condition hits a cell.
"""

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from prosim_torch.data.batch import Condition, Prompt
from prosim_torch.ops.attention import (
    GatedNeighborAttention,
    RelPE,
    normalize_rel_pe,
    rel_pe_features,
)


def _one_hot(idx, valid, N: int):
    """[B, C] prompt indices -> [B, C, N] f32 one-hot rows, zero for invalid
    conditions and for indices outside [0, N)."""
    tgt = torch.where(valid & (idx >= 0) & (idx < N), idx, N).long()
    return F.one_hot(tgt, N + 1)[..., :N].float()


def _cell_hits(cond: Condition, N: int):
    """(one-hot of the source index, of the target index or None for unary
    types, hits [B, N, N]: the conditions of this type per edge cell)."""
    s = _one_hot(cond.prompt_idx[..., 0], cond.mask, N)
    if cond.prompt_idx.shape[-1] == 1:
        return s, None, torch.einsum("bci,bcj->bij", s, s)
    t = _one_hot(cond.prompt_idx[..., 1], cond.mask, N)
    return s, t, torch.einsum("bci,bcj->bij", s, t) + torch.einsum("bci,bcj->bij", t, s)


def condition_edge_mask(conditions: Dict[str, Condition], cond_types, prompt_mask):
    """The GNN's edge mask [B, N, N]: cells hit by a condition of one of
    `cond_types` (text types have no cells), between valid prompt agents."""
    N = prompt_mask.shape[1]
    hit = torch.zeros((prompt_mask.shape[0], N, N), dtype=torch.bool, device=prompt_mask.device)
    for t in cond_types:
        if isinstance(conditions.get(t), Condition):
            hit |= _cell_hits(conditions[t], N)[2] > 0
    return hit & prompt_mask[:, :, None] & prompt_mask[:, None, :]


class GNNConditionAttn(nn.Module):
    def __init__(self, hidden_dim: int, num_layers: int, num_heads: int, head_dim: int,
                 pool: str = "mean"):
        super().__init__()
        if pool not in ("mean", "max"):
            raise ValueError(f"unknown condition pool '{pool}'")
        self.num_layers = num_layers
        self.pool = pool
        self.rel_pe = RelPE(hidden_dim, learnable_pe=False, fold_dup=False)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", GatedNeighborAttention(
                hidden_dim, num_heads, head_dim, bipartite=False))

    def forward(self, cond_embs: Dict[str, torch.Tensor], conditions: Dict[str, Condition],
                prompt_emb, prompt: Prompt):
        """cond_embs: type -> [B, C, D] (unary) or [B, C, 2D] (binary);
        prompt_emb [B, N, D] -> [B, N, D]."""
        B, N, D = prompt_emb.shape
        if not cond_embs:
            return prompt_emb
        acc = None    # sum (mean pool) or running max (max pool) over types
        n_hit = 0.0   # types hitting each cell
        for ctype, emb in sorted(cond_embs.items()):
            s, t, hits = _cell_hits(conditions[ctype], N)
            if t is None:
                attr = torch.einsum("bci,bcj,bcd->bijd", s, s, emb[..., :D])
            else:
                attr = (torch.einsum("bci,bcj,bcd->bijd", s, t, emb[..., :D])
                        + torch.einsum("bci,bcj,bcd->bijd", t, s, emb[..., D:]))
            hit = hits > 0
            if self.pool == "mean":
                acc = attr if acc is None else acc + attr
            else:
                attr = torch.where(hit[..., None], attr, -torch.inf)
                acc = attr if acc is None else torch.maximum(acc, attr)
            n_hit = n_hit + hit.float()
        if self.pool == "mean":
            pooled = acc / n_hit.clamp_min(1)[..., None]
        else:
            pooled = torch.where((n_hit > 0)[..., None], acc, 0.0)
        edge_mask = condition_edge_mask(conditions, cond_embs, prompt.mask)

        all_idx = torch.arange(N, dtype=torch.int32, device=prompt_emb.device).expand(B, N, N)
        pe_in = rel_pe_features(prompt.pos, prompt.ori, prompt.pos, prompt.ori, all_idx)
        edge_z = normalize_rel_pe(pooled + self.rel_pe(pe_in), D)  # [B, N, N, D]
        x = prompt_emb
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, x, all_idx, edge_mask, edge_z)
        return torch.where(prompt.mask[..., None], prompt_emb + x, prompt_emb)
