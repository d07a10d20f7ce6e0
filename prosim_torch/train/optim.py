"""Optimizers, LR schedules, per-group LR scaling and gradient clipping (port
of prosim_tpu/train/optim.py).

The reference's training recipe (reference: prosim/models/base.py:13-132,
225-318): AdamW/Adam/SGD, linear-warmup + cos^2-annealing schedule,
global-norm gradient clipping at TRAIN.GRAD_CLIP, and parameter groups with
scaled LRs for LoRA / adapter / goal-pred / condition-transformer
parameters, picked by the same name predicates as the JAX package's.

The update is optax's, step for step:
  * the schedules are the JAX package's functions of the update count, in
    float32, and a LambdaLR stepped after each update hands the first
    update schedule(0) (0 during warmup), as optax does;
  * weight decay acts on every parameter of a group (optax's adamw here has
    no mask: biases and LayerNorm affines decay too);
  * `clip_grad_norm` is optax.clip_by_global_norm: g / |g| * max only where
    |g| >= max (torch's clip_grad_norm_ adds 1e-6 to the norm);
  * a group at scale 0 (GOAL_MODEL_LR_SCALE 0.0) has lr 0, so neither the
    Adam step nor the decay moves it; the LoRA leaves ('lora') train at
    TEXT.LLM.LORA_LR_SCALE and the text adapters ('adapter') at
    TEXT.LLM.ADAPTER_LR_SCALE times the base LR;
  * the frozen Llama body ('llm_frozen', optax.set_to_zero in the JAX
    package) is in no group, and `build_optimizer` sets requires_grad False
    on it, as the reference does (reference: base.py:94): its gradients are
    never computed and so never counted in the clip norm. The JAX package
    chains clip_by_global_norm before multi_transform, so its norm counts
    the body's gradients (only their update is dropped); at Llama3-8B width
    those are ~7.5 B values computed only to be counted. This divergence of
    the frozen JAX package is stated in ROADMAP.md (C); the port's tests
    hold it to a JAX oracle that zeroes the 'llm_frozen' gradients before
    the JAX package's own update.
"""

import math
from typing import Callable, Dict, List

import numpy as np
import torch

GROUPS = ("model", "lora", "adapter", "goal_pred", "cond")


def warmup_cos2_schedule(base_lr: float, warmup_steps: int, total_steps: int) -> Callable:
    """eta_t = eta_max * cos^2((t - warm) / (total - warm) * pi/2) after a
    linear warmup (reference: base.py:49-59), in float32 as the JAX
    package computes it."""
    f32 = np.float32

    def schedule(step):
        warm = f32(warmup_steps)
        t = f32(step)
        lin = t / max(warm, f32(1.0))
        cosf = (t - warm) / max(f32(total_steps) - warm, f32(1.0))
        ann = np.cos(cosf * f32(math.pi / 2)) ** 2
        return float(f32(base_lr) * max(lin if t < warm else ann, f32(0.0)))

    return schedule


def piecewise_constant_schedule(init_value: float, boundaries_and_scales: Dict[int, float]):
    """optax.piecewise_constant_schedule: init_value times every scale whose
    boundary the count has reached."""
    def schedule(step):
        v = np.float32(init_value)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if step >= threshold:
                v = v * np.float32(scale)
        return float(v)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int):
    """optax.cosine_decay_schedule with alpha 0."""
    f32 = np.float32

    def schedule(step):
        count = min(f32(step), f32(decay_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / f32(decay_steps)))
        return float(f32(init_value) * decay)

    return schedule


def _group_of(path: str, config) -> str:
    """The parameter group of a '/'-joined parameter path."""
    if "lora" in path:
        return "lora"
    if "prompt_to_llm" in path or "llm_to_cond" in path or "ln_prompt" in path:
        return "adapter"
    if "/llm/" in path or path.endswith("/llm") or path.startswith("llm/"):
        # the Llama BODY: frozen, trained only through its LoRA leaves
        # (reference: base.py:94 named_parameters filter)
        return "llm_frozen"
    if "pred_mlp" in path or "goal_prob_head" in path or "goal_point_head" in path:
        return "goal_pred"
    if "condition_transformer" in path:
        return "cond"
    return "model"


GROUP_SCALE_KEYS = {
    "model": lambda c: 1.0,
    "lora": lambda c: c.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.LORA_LR_SCALE,
    "adapter": lambda c: c.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.ADAPTER_LR_SCALE,
    "goal_pred": lambda c: c.LOSS.ROLLOUT_TRAJ.GOAL_MODEL_LR_SCALE,
    "cond": lambda c: c.MODEL.CONDITION_TRANSFORMER.LR_SCALE,
}


def group_lrs(config) -> Dict[str, float]:
    """Each group's peak LR. With TRAIN.LR == 0 the main model is frozen
    while the special groups train at a 1e-3 base (reference: base.py:108-110)."""
    base_lr = config.TRAIN.LR if config.TRAIN.LR > 0 else 1e-3
    return {g: config.TRAIN.LR if g == "model" else base_lr * GROUP_SCALE_KEYS[g](config)
            for g in GROUPS}


def make_schedule(config, lr: float) -> Callable:
    sched_cfg = config.TRAIN.SCHEDULER
    if sched_cfg.TYPE == "LinearWarmupCosineAnnealingLR":
        return warmup_cos2_schedule(lr, sched_cfg.WARMUP_STEPS, sched_cfg.MAX_STEPS)
    if sched_cfg.TYPE == "MultiStepLR":
        milestones = getattr(sched_cfg, "MILESTONES", [])
        return piecewise_constant_schedule(
            lr, {int(s): 0.1 for s in milestones} or {sched_cfg.MAX_STEPS // 2: 0.1})
    if sched_cfg.TYPE == "CosineAnnealingLR":
        return cosine_decay_schedule(lr, sched_cfg.MAX_STEPS)
    return lambda step: float(np.float32(lr))


def param_groups(model: torch.nn.Module, config) -> Dict[str, List[torch.nn.Parameter]]:
    """{group: parameters}, 'llm_frozen' included; names are matched with
    '/' for '.', the flax path of each parameter."""
    groups = {g: [] for g in GROUPS + ("llm_frozen",)}
    for name, p in model.named_parameters():
        groups[_group_of(name.replace(".", "/"), config)].append(p)
    return groups


def build_optimizer(config, model: torch.nn.Module):
    """(optimizer, scheduler): one param group per non-empty group, its
    'lr' driven by the scheduler from that group's schedule; step the
    scheduler after each optimizer step. Freezes the 'llm_frozen'
    parameters (requires_grad False)."""
    lrs = group_lrs(config)
    groups = param_groups(model, config)
    for p in groups["llm_frozen"]:
        p.requires_grad_(False)
    names = [g for g in GROUPS if groups[g]]
    # initial lr 1: LambdaLR's factor is then the group's schedule value itself
    pg = [{"params": groups[g], "lr": 1.0, "name": g} for g in names]
    opt_name = config.TRAIN.OPTIMIZER.lower()
    if opt_name == "adamw":
        optimizer = torch.optim.AdamW(pg, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=config.TRAIN.WEIGHT_DECAY)
    elif opt_name == "adam":
        optimizer = torch.optim.Adam(pg, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    elif opt_name == "sgd":
        optimizer = torch.optim.SGD(pg, lr=1.0)
    else:
        raise KeyError(f"unknown optimizer {config.TRAIN.OPTIMIZER}")
    scheds = [make_schedule(config, lrs[g]) for g in names]
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, scheds)
    return optimizer, scheduler


@torch.no_grad()
def clip_grad_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm over the .grad of `params`, in place and
    without a host sync; returns the global norm (optax.global_norm) before
    clipping. A parameter without a .grad (the frozen Llama body, which has
    requires_grad False) is not counted: the norm is the JAX package's with
    the 'llm_frozen' gradients taken as zero (module docstring)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    if max_norm and max_norm > 0:
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
