"""Evaluation metrics (port of prosim_tpu/train/metrics.py).

Functional equivalents of the reference torchmetrics
(reference: prosim/metrics/motion_pred.py:10-199, metrics/base.py:16-63):
masked ADE/FDE/minADE/minFDE over per-step chunk predictions, closed-form
rollout ADE over the full horizon, and per-condition-type ADE breakdowns.

Each metric update returns {name: (sum, count)} pairs; accumulate across
batches with `merge_metric_states`, then divide with `compute_metrics`.
"""

from typing import Dict, Tuple

import torch

from prosim_torch.core.registry import registry
from prosim_torch.train.losses import _pick, _prompt_mask, rollout_traj


def _masked_sum_count(err, mask):
    return torch.where(mask, err, 0.0).sum(), mask.sum()


def chunk_ade_fde(pred, prob, tgt, tgt_valid):
    """pred [B,N,T,K,S,D], prob [B,N,T,K], tgt [B,N,T,S,D], tgt_valid same.

    Returns dict of (sum, count) for ade/fde/min_ade/min_fde.
    """
    pos_valid = tgt_valid[..., :2].all(-1)  # [B,N,T,S]
    dist = torch.linalg.vector_norm(pred[..., :2] - tgt[:, :, :, None, :, :2], dim=-1)  # [B,N,T,K,S]
    dist = torch.where(pos_valid[:, :, :, None], dist, 0.0)
    steps = pos_valid.sum(-1).clamp_min(1)  # [B,N,T]

    ade_k = dist.sum(-1) / steps[..., None]  # [B,N,T,K]
    # fde at the last valid step
    arange = torch.arange(pos_valid.shape[-1], device=pos_valid.device)
    last = torch.where(pos_valid, arange, -1).amax(-1).clamp_min(0)  # [B,N,T]
    fde_k = dist.gather(-1, last[..., None, None].expand(*dist.shape[:-1], 1))[..., 0]

    top = prob.argmax(dim=-1)  # [B,N,T]
    ade = ade_k.gather(-1, top[..., None])[..., 0]
    fde = fde_k.gather(-1, top[..., None])[..., 0]
    pair_valid = pos_valid.any(-1)

    return {
        "ade": _masked_sum_count(ade, pair_valid),
        "fde": _masked_sum_count(fde, pair_valid),
        "min_ade": _masked_sum_count(ade_k.amin(-1), pair_valid),
        "min_fde": _masked_sum_count(fde_k.amin(-1), pair_valid),
    }


@registry.register_metric(name="pair_traj_pred")
def pair_traj_pred_update(batch, output, config) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Update for the main metric set (reference: motion_pred.py:109-199)."""
    io = batch.io_pairs
    pred = output["motion_pred"].permute(1, 2, 0, 3, 4, 5)  # [B,N,T,K,S,D]
    prob = output["motion_prob"].permute(1, 2, 0, 3)
    tgt = io.tgt.permute(0, 2, 1, 3, 4)
    tgt_valid = io.tgt_valid.permute(0, 2, 1, 3, 4)
    pair_mask = io.mask.permute(0, 2, 1) & batch.prompt.mask[:, :, None]
    tgt_valid = tgt_valid & pair_mask[..., None, None]
    tgt = torch.where(tgt_valid, tgt, 0.0)

    metrics = chunk_ade_fde(pred, prob, tgt, tgt_valid)

    # closed-form rollout ADE over the full horizon
    rollout_steps = config.ROLLOUT.POLICY.REPLAN_FREQ
    pred_sel = _pick(pred, prob.argmax(dim=-1), 3)
    if pred_sel.shape[-1] == tgt.shape[-1] + 3:
        # PRED_GMM layout [x, y, h, gmm(3), vel?] - drop the gmm columns
        pred_sel = torch.cat([pred_sel[..., :3], pred_sel[..., 6:]], dim=-1)
    pred_sel = torch.where(tgt_valid, pred_sel, 0.0)
    tgt_rt = rollout_traj(tgt, rollout_steps)
    pred_rt = rollout_traj(pred_sel, rollout_steps)
    B, N = pair_mask.shape[:2]
    step_valid = tgt_valid[..., :rollout_steps, :2].all(-1).reshape(B, N, -1)
    rdist = torch.linalg.vector_norm(tgt_rt[..., :2] - pred_rt[..., :2], dim=-1)
    rd = torch.where(step_valid, rdist, 0.0).sum(-1) / step_valid.sum(-1).clamp_min(1)
    agent_valid = step_valid.any(-1)
    metrics["rollout_ade"] = _masked_sum_count(rd, agent_valid)

    # per-condition-type rollout ADE
    for ctype, c in (batch.conditions or {}).items():
        metrics[f"rollout_ade_{ctype}"] = _masked_sum_count(rd, agent_valid & _prompt_mask(c))
    return metrics


def merge_metric_states(states):
    """Sum (sum, count) pairs across batches."""
    out = {}
    for st in states:
        for k, (s, c) in st.items():
            out[k] = (out[k][0] + s, out[k][1] + c) if k in out else (s, c)
    return out


def compute_metrics(state):
    return {k: float(s) / max(float(c), 1.0) for k, (s, c) in state.items()}


@registry.register_metric(name="debug")
def debug_metric_update(batch, output, config):
    """No-op metric (reference: prosim/metrics/base.py:66)."""
    return {"count": (torch.tensor(0.0), torch.tensor(1.0))}


@registry.register_metric(name="ego_traj_pred")
def ego_traj_pred_update(batch, output, config):
    """Ego-only ADE/FDE (reference: motion_pred.py:77). Ego occupies target
    slot 0 by construction of the formatter."""
    state = pair_traj_pred_update(batch, output, config)
    return {f"ego_{k}": v for k, v in state.items() if "rollout" not in k}


@registry.register_metric(name="all_traj_pred")
def all_traj_pred_update(batch, output, config):
    """All-agent ADE/FDE over chunk predictions (reference: motion_pred.py:88)."""
    return pair_traj_pred_update(batch, output, config)
