"""Train and eval steps (port of prosim_tpu/train/train_step.py)."""

from typing import Optional

import torch

from prosim_torch.parallel.mesh import (Mesh, all_reduce_grads, all_reduce_sum,
                                        data_parallel, global_counts)
from prosim_torch.train.losses import loss_func_dict
from prosim_torch.train.optim import clip_grad_norm


def make_train_step(model, optimizer, scheduler, config, mesh: Optional[Mesh] = None):
    """Returns train_step(batch, seed) -> losses: the train-mode forward, the
    loss times TASK.MOTION_PRED.WEIGHT, backward, the global gradient norm
    (reported before clipping, over every parameter that has a gradient;
    the frozen Llama body, requires_grad False, has none),
    clipping at TRAIN.GRAD_CLIP, one optimizer update and one scheduler step.
    A parameter the loss does not reach gets a zero gradient, so it decays
    as optax decays every leaf.

    Data-parallel (a `mesh` over an initialized process group):
    `batch` is this rank's rows of the global batch; the losses divide by
    counts over the global batch (`global_counts`), the gradients are summed
    over the ranks before the norm and the clip, and the returned losses
    are the global batch's, the same on every rank. Each rank draws its
    dropout masks from `seed` and its rank (rank 0 from `seed` itself)."""
    loss_fn_impl = loss_func_dict[config.TASK.MOTION_PRED.LOSS]
    task_weight = config.TASK.MOTION_PRED.WEIGHT
    trained = [p for g in optimizer.param_groups for p in g["params"]]

    def train_step(batch, seed: int):
        optimizer.zero_grad(set_to_none=True)
        if data_parallel(mesh):
            seed = _rank_seed(seed, mesh.data_index)
        with global_counts(mesh):
            output = model.forward_train(batch, seed)
            losses = loss_fn_impl(batch, output, config)
            (losses["full_loss"] * task_weight).backward()
        for p in trained:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        all_reduce_grads(trained, mesh)  # a no-op off the data-parallel path
        grad_norm = clip_grad_norm(model.parameters(), config.TRAIN.GRAD_CLIP)
        optimizer.step()
        scheduler.step()
        losses = {k: v.detach() for k, v in losses.items()}
        losses = all_reduce_sum(losses, mesh)
        losses["grad_norm"] = grad_norm
        return losses

    return train_step


def _rank_seed(seed: int, rank: int) -> int:
    """The seed rank `rank` draws its dropout masks from: `seed` on rank 0,
    another 62-bit seed made from (seed, rank) on the others."""
    if rank == 0:
        return seed
    return int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(
        (seed * 1_000_003 + rank) % 2**63)))


def make_eval_step(model, config, mesh: Optional[Mesh] = None):
    """Returns eval_step(batch, generator) -> (losses, metric state, output):
    one eval-mode ('val') forward under inference mode. Data-parallel, the
    forward and the losses run inside `global_counts`, so the losses (the
    model's own aux terms, such as the prompt-mask loss, too) are this
    rank's share of the global batch's, and the metric state is this rank's
    (sum, count) pairs: the caller sums both over the ranks."""
    from prosim_torch.train.metrics import pair_traj_pred_update

    loss_fn_impl = loss_func_dict[config.TASK.MOTION_PRED.LOSS]

    @torch.inference_mode()
    def eval_step(batch, generator=None):
        with global_counts(mesh):
            output = model(batch, mode="val", generator=generator)
            losses = loss_fn_impl(batch, output, config)
        metrics = pair_traj_pred_update(batch, output, config)
        return losses, metrics, output

    return eval_step
