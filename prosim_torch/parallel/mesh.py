"""Process groups and data sharding (port of prosim_tpu/parallel/mesh.py), on
torch.distributed.

The JAX package runs SPMD over a `jax.sharding.Mesh` with two axes: `data`
(scenes; XLA inserts the gradient all-reduce for the replicated params) and
`model` (reserved for tensor-parallel sharding of the Llama). The port runs
one process per card (a rank) and keeps the same vocabulary:

  data  - every rank holds the whole model and optimizer state (`replicate`
          broadcasts rank 0's) and takes its rows of each global batch
          (`shard_batch`). After the backward, `all_reduce_grads` sums the
          gradients over the ranks in one flat f32 buffer. The losses divide
          their masked sums by counts over the GLOBAL batch, as the JAX
          losses do on the sharded batch: inside `global_counts()`,
          `global_count` sums each count over the ranks, so each rank's loss
          is its share of the global loss and the summed gradient is the
          global batch's gradient.
  model - not ported: the JAX package declares the axis and annotates no
          array with it, so `make_mesh` refuses NUM_MODEL > 1 (ROADMAP.md).

Why a sum of gradients after `backward()` and not DistributedDataParallel:
DDP averages per-rank gradients, which is the global gradient only when
every rank holds as many valid agents as every other; it hooks parameters
as their gradients arrive, and here parameters the loss does not reach get
zero gradients after the backward (train/train_step.py), the frozen Llama
body has none, and the remat recomputes run inside the backward. One flat
all-reduce after the backward has none of these interactions and costs one
collective a step.

All SceneBatch tensors lead with the scene axis but the per-batch constant
io_pairs.t_indices, which stays whole.
"""

import contextlib
import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

ROADMAP_MODEL_AXIS = ("the model axis (tensor-parallel Llama) is not ported: the JAX package "
                      "declares it and shards nothing on it (ROADMAP.md queue A)")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: str = "cuda",
                         timeout: Optional[datetime.timedelta] = None) -> int:
    """Join the process group of a multi-process run (the JAX package's
    `jax.distributed.initialize` rendezvous). Configured by the arguments,
    or COORDINATOR_ADDRESS ("host:port") with WORLD_SIZE and RANK, or
    torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK. NCCL on the
    card, gloo when `device` is "cpu"; on the card each process takes the
    card LOCAL_RANK (else its rank modulo the cards).

    No-op when nothing is configured. A failed rendezvous raises: it never
    degrades into N independent runs that all think they are rank 0.
    Returns the process count."""
    env = os.environ
    address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if dist.is_initialized():
        return dist.get_world_size()
    if not address and not env.get("MASTER_ADDR"):
        return 1
    backend = "gloo" if str(device) == "cpu" else "nccl"
    kwargs = {} if timeout is None else {"timeout": timeout}
    if address:
        world = num_processes if num_processes is not None else int(env["WORLD_SIZE"])
        rank = process_id if process_id is not None else int(env["RANK"])
        init = address if "://" in address else f"tcp://{address}"
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kwargs)
    else:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return dist.get_world_size()


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


process_index = _rank  # jax.process_index: 0 without a process group


def process_local_scene_indices(num_scenes: int, process_index: Optional[int] = None,
                                process_count: Optional[int] = None) -> list:
    """Deterministic strided shard of the global scene list for this
    process (the lock-free replacement for the reference farm's touch-file
    claims, reference: rollout/distributed_utils.py:151-158)."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    return list(range(pi, num_scenes, pc))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data x model layout of the processes: rank r is data index
    r // model, model index r % model (the JAX Mesh's row-major layout)."""

    data: int
    model: int = 1
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def shape(self) -> dict:
        return {self.data_axis: self.data, self.model_axis: self.model}

    @property
    def data_index(self) -> int:
        return _rank() // self.model


def make_mesh(num_data: int = -1, num_model: int = 1, devices: Optional[list] = None,
              data_axis: str = "data", model_axis: str = "model") -> Mesh:
    """The (num_data, num_model) layout over `devices` (one per process;
    default: the process group). -1 puts every process on the data axis."""
    n = len(devices) if devices is not None else _world()
    if num_model > 1:
        raise NotImplementedError(f"PARALLEL.NUM_MODEL={num_model}: {ROADMAP_MODEL_AXIS}")
    if num_data == -1:
        num_data = n // num_model
    if num_data * num_model != n:
        raise ValueError(f"mesh {num_data}x{num_model} does not cover {n} devices")
    return Mesh(num_data, num_model, data_axis, model_axis)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor's dim 0 lives: split over `axis` of `mesh` in equal
    contiguous shares, or whole on every rank (axis None)."""

    mesh: Mesh
    axis: Optional[str] = None

    def rows(self, n: int) -> slice:
        """This rank's rows of a dim 0 of size n."""
        if self.axis is None:
            return slice(0, n)
        shares = self.mesh.shape[self.axis]
        if n % shares:
            raise ValueError(f"a batch of {n} scenes does not split over {shares} data shares")
        k = n // shares
        return slice(self.mesh.data_index * k, (self.mesh.data_index + 1) * k)


def batch_sharding(mesh: Mesh, data_axis: str = "data") -> Sharding:
    """Shard dim 0 (scenes) over the data axis; everything else whole."""
    return Sharding(mesh, data_axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch, mesh: Mesh, data_axis: str = "data"):
    """This rank's rows of a global SceneBatch: dim 0 of every scene-leading
    tensor split over `data`; per-batch constants (t_indices) stay whole.
    Every rank is given the whole global batch (the JAX package's
    multi-process contract, where each process passes its own share, is
    not the port's)."""
    if mesh.shape[data_axis] == 1:
        return batch
    rows = batch_sharding(mesh, data_axis).rows(int(batch.prompt.mask.shape[0]))
    return batch.map_batch_leaves(lambda x: x[rows])


def _tensors(obj):
    if isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, torch.optim.Optimizer):
        for state in obj.state.values():
            yield from _tensors(state)
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Every rank takes rank 0's values of `obj` (a module's parameters and
    buffers, an optimizer's state, or a tree of tensors), in place."""
    if data_parallel(mesh):
        for t in _tensors(obj):
            dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=0)
    return obj


@torch.no_grad()
def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum the .grad of `params` over the data axis, in one flat f32 buffer
    (every trained parameter of the port is f32)."""
    if not data_parallel(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_reduce_sum(values: dict, mesh: Optional[Mesh]) -> dict:
    """{name: scalar tensor} summed over the ranks, in one collective; as
    they are off the data-parallel path."""
    if not data_parallel(mesh) or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    return dict(zip(keys, flat.unbind()))


def data_parallel(mesh: Optional[Mesh]) -> bool:
    """Whether a step on `mesh` runs the data-parallel path: the process
    group is up (at world size 1 every collective is the identity, and the
    path still runs)."""
    return mesh is not None and dist.is_initialized()


_GLOBAL = {"on": False}


@contextlib.contextmanager
def global_counts(mesh: Optional[Mesh] = None):
    """Inside this block `global_count` sums each count over the ranks (a
    data-parallel step: every rank enters it, and the counts of one step are
    taken in the same order on every rank)."""
    on = data_parallel(mesh)
    prev, _GLOBAL["on"] = _GLOBAL["on"], on
    try:
        yield
    finally:
        _GLOBAL["on"] = prev


def global_count(mask) -> torch.Tensor:
    """mask.sum() over the global batch, at least 1: the JAX package's
    jnp.clip(mask.sum(), 1, None) on the sharded batch. Outside
    `global_counts()`, or in one process, the count of this batch."""
    c = mask.sum()
    if _GLOBAL["on"]:
        dist.all_reduce(c)
    return c.clamp_min(1)
