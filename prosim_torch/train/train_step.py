"""Train and eval steps (port of prosim_tpu/train/train_step.py)."""

import torch

from prosim_torch.train.losses import loss_func_dict
from prosim_torch.train.optim import clip_grad_norm


def make_train_step(model, optimizer, scheduler, config):
    """Returns train_step(batch, seed) -> losses: the train-mode forward, the
    loss times TASK.MOTION_PRED.WEIGHT, backward, the global gradient norm
    (reported before clipping, over every parameter that has a gradient;
    the frozen Llama body, requires_grad False, has none),
    clipping at TRAIN.GRAD_CLIP, one optimizer update and one scheduler step.
    A parameter the loss does not reach gets a zero gradient, so it decays
    as optax decays every leaf."""
    loss_fn_impl = loss_func_dict[config.TASK.MOTION_PRED.LOSS]
    task_weight = config.TASK.MOTION_PRED.WEIGHT
    trained = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(batch, seed: int):
        optimizer.zero_grad(set_to_none=True)
        output = model.forward_train(batch, seed)
        losses = loss_fn_impl(batch, output, config)
        (losses["full_loss"] * task_weight).backward()
        for p in trained:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = clip_grad_norm(model.parameters(), config.TRAIN.GRAD_CLIP)
        optimizer.step()
        scheduler.step()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_norm"] = grad_norm
        return losses

    return train_step


def make_eval_step(model, config):
    """Returns eval_step(batch, generator) -> (losses, metric state, output):
    one eval-mode ('val') forward under inference mode."""
    from prosim_torch.train.metrics import pair_traj_pred_update

    loss_fn_impl = loss_func_dict[config.TASK.MOTION_PRED.LOSS]

    @torch.inference_mode()
    def eval_step(batch, generator=None):
        output = model(batch, mode="val", generator=generator)
        losses = loss_fn_impl(batch, output, config)
        metrics = pair_traj_pred_update(batch, output, config)
        return losses, metrics, output

    return eval_step
