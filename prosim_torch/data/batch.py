"""Padded, static-shape batch containers as dataclasses of tensors.

Same fields, shapes and shape legend as prosim_tpu/data/batch.py:
  B - scenes in batch            L - map polyline slots (PAD.NUM_LANES)
  P - points per polyline        A - all-agent obs slots (PAD.NUM_OBS_AGENTS)
  N - policy agent slots (PAD.NUM_AGENTS)
  Th - history steps             R - replan steps (rollout)
  T - io-pair time indices       S - predicted steps per chunk
  C - per-type condition slots

`from_numpy` builds a container from numpy arrays (nested dicts for
SceneBatch); `.to(device)` moves every tensor. The data pipeline's
single-scene batches (data/formatter.py) are the same containers with numpy
leaves; `tree_map`, `tree_leaves_with_path` and `to_tensors` walk and convert
either kind (dataclass fields in order, dict keys sorted, None skipped: the
order jax.tree gives the JAX package's containers). `SceneBatch.conditions` maps
each condition type to a `Condition`, or for a text type ('*OneText') to a
dict of tensors (input_ids, token_mask, agent_slot_ids, prompt_mask and
read_positions, from data/text_conditions.py).
"""

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch


def _to(x, device):
    if isinstance(x, (torch.Tensor, _Tensors)):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x


class _Tensors:
    """Mixin for dataclasses whose fields are tensors (or nested containers)."""

    def to(self, device):
        return dataclasses.replace(
            self, **{f.name: _to(getattr(self, f.name), device)
                     for f in dataclasses.fields(self) if f.init}
        )

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_numpy(cls, arrays: dict):
        out = {}
        for f in dataclasses.fields(cls):
            if f.name not in arrays:
                continue
            v = arrays[f.name]
            sub = _NESTED.get((cls.__name__, f.name))
            if v is None:
                out[f.name] = None
            elif sub is not None:
                out[f.name] = v if isinstance(v, sub) else sub.from_numpy(v)
            else:
                out[f.name] = torch.from_numpy(np.ascontiguousarray(v))
        return cls(**out)


@dataclasses.dataclass
class MapInputs(_Tensors):
    vectors: torch.Tensor  # [B, L, P, C_map]
    mask: torch.Tensor     # [B, L, P] bool valid points
    pos: torch.Tensor      # [B, L, 2] lane frame centers (scene frame)
    ori: torch.Tensor      # [B, L] lane frame headings

    @property
    def token_mask(self):
        return self.mask.any(dim=-1)


@dataclasses.dataclass
class ObsInputs(_Tensors):
    feat: torch.Tensor  # [B, A, Th, C_obs], zeros where invalid
    mask: torch.Tensor  # [B, A, Th] bool
    pos: torch.Tensor   # [B, A, 2]
    ori: torch.Tensor   # [B, A]

    @property
    def token_mask(self):
        return self.mask.any(dim=-1)


@dataclasses.dataclass
class Prompt(_Tensors):
    feat: torch.Tensor        # [B, N, C_prompt]
    mask: torch.Tensor        # [B, N] bool
    pos: torch.Tensor         # [B, N, 2]
    ori: torch.Tensor         # [B, N]
    agent_type: torch.Tensor  # [B, N] int32 (1 vehicle / 2 pedestrian / 3 cyclist)
    obs_index: torch.Tensor   # [B, N] int32 slot in ObsInputs (-1 pad)
    extent: torch.Tensor      # [B, N, 2]
    goal_point: torch.Tensor  # [B, N, 2]


@dataclasses.dataclass
class IOPairs(_Tensors):
    tgt: torch.Tensor
    tgt_valid: torch.Tensor
    goal: torch.Tensor
    pos: torch.Tensor
    ori: torch.Tensor
    mask: torch.Tensor
    agent_type: torch.Tensor
    init_vel: torch.Tensor
    extent: torch.Tensor
    full_traj_xy: torch.Tensor
    full_traj_valid: torch.Tensor
    t_indices: torch.Tensor  # [T] per-batch constant (no scene axis)


@dataclasses.dataclass
class FutObs(_Tensors):
    """GT observations of ALL agents at each replan step; slot r=0 unused."""

    feat: torch.Tensor       # [B, R, A, Th, C_obs]
    mask: torch.Tensor       # [B, R, A, Th]
    pos: torch.Tensor        # [B, R, A, 2]
    ori: torch.Tensor        # [B, R, A]
    obs_index: torch.Tensor  # [B, R, N] int32


@dataclasses.dataclass
class RoadEdges(_Tensors):
    """Oriented road-edge segments in the scene frame, the drivable area on
    the LEFT of each segment direction (the layout the offroad loss reads)."""

    pts: torch.Tensor    # [B, E, 2] segment starts
    nxt: torch.Tensor    # [B, E, 2] segment ends
    valid: torch.Tensor  # [B, E] bool


@dataclasses.dataclass
class Condition(_Tensors):
    """One prompt-condition type, fixed-C padded."""

    feat: torch.Tensor         # [B, C, F] type-specific features
    mask: torch.Tensor         # [B, C] bool
    prompt_idx: torch.Tensor   # [B, C, 1 or 2] int32 indices into prompt slots
    prompt_mask: torch.Tensor  # [B, N] bool - which agents this condition covers


def _conditions_from_numpy(arrays: dict) -> dict:
    """{type: arrays} -> {type: Condition, or for '*OneText' a dict of tensors}."""
    out = {}
    for ctype, v in arrays.items():
        if "OneText" in ctype:
            out[ctype] = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in v.items()}
        else:
            out[ctype] = v if isinstance(v, Condition) else Condition.from_numpy(v)
    return out


@dataclasses.dataclass
class SceneBatch(_Tensors):
    init_map: MapInputs
    init_obs: ObsInputs
    prompt: Prompt
    io_pairs: Optional[IOPairs] = None
    fut_obs: Optional[FutObs] = None
    road_edges: Optional[RoadEdges] = None
    conditions: Dict[str, Union[Condition, Dict[str, torch.Tensor]]] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def from_numpy(cls, arrays: dict):
        arrays = dict(arrays)
        conditions = _conditions_from_numpy(arrays.pop("conditions", None) or {})
        return super().from_numpy(arrays).replace(conditions=conditions)

    @property
    def batch_size(self):
        return self.init_obs.feat.shape[0]

    def map_batch_leaves(self, fn):
        """Apply fn to every tensor whose dim 0 is the scene axis
        (io_pairs.t_indices is the one per-batch constant)."""

        def sub(c):
            if c is None:
                return None
            if isinstance(c, torch.Tensor):
                return fn(c)
            if isinstance(c, dict):
                return {k: sub(v) for k, v in c.items()}
            return c.replace(**{
                f.name: getattr(c, f.name) if f.name == "t_indices" else sub(getattr(c, f.name))
                for f in dataclasses.fields(c)
            })

        return self.replace(**{f.name: sub(getattr(self, f.name))
                               for f in dataclasses.fields(self)})


_NESTED = {
    ("SceneBatch", "init_map"): MapInputs,
    ("SceneBatch", "init_obs"): ObsInputs,
    ("SceneBatch", "prompt"): Prompt,
    ("SceneBatch", "io_pairs"): IOPairs,
    ("SceneBatch", "fut_obs"): FutObs,
    ("SceneBatch", "road_edges"): RoadEdges,
}


def _children(node):
    """[(key, child)] of a container (dataclass fields in order, dict keys
    sorted), or None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return None


def tree_map(fn, tree, *rest):
    """fn over the leaves of one or more containers of the same structure,
    called in canonical leaf order (None stays None; dicts keep their key
    order); raises ValueError where the structures differ."""
    if tree is None:
        if any(r is not None for r in rest):
            raise ValueError("tree_map: None against a value")
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or set(r) != set(tree) for r in rest):
            raise ValueError(f"tree_map: dict keys differ from {sorted(tree)}")
        out = {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in kids}  # sorted: leaf order
        return {k: out[k] for k in tree}
    if any(type(r) is not type(tree) for r in rest):
        raise ValueError(f"tree_map: {type(tree).__name__} against another type")
    return type(tree)(**{k: tree_map(fn, v, *(getattr(r, k) for r in rest)) for k, v in kids})


def tree_leaves_with_path(tree, prefix=()):
    """[(path, leaf)] in canonical order; a path is a tuple of field names
    and dict keys."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += tree_leaves_with_path(v, prefix + (k,))
    return out


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_structure(tree):
    """A hashable description of the containers and their keys (not the
    leaves)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return "*"
    return (type(tree).__name__, tuple((k, tree_structure(v)) for k, v in kids))


def tree_unflatten(like, leaves):
    """A container shaped like `like` holding `leaves` in canonical order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def narrow_dtype(dt) -> np.dtype:
    """int64 -> int32 and float64 -> float32, the dtypes the model takes
    (the JAX package's device_put narrows the same way under disabled x64)."""
    dt = np.dtype(dt)
    return {np.dtype(np.int64): np.dtype(np.int32),
            np.dtype(np.float64): np.dtype(np.float32)}.get(dt, dt)


def to_tensors(tree, device):
    """Host numpy leaves -> tensors on `device`, dtypes narrowed; always a
    copy, so the result never aliases the source arrays (on the CPU too)."""
    def leaf(x):
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=narrow_dtype(np.asarray(x).dtype)))
        return t.to(device, copy=True)

    return tree_map(leaf, tree)


@dataclasses.dataclass
class SceneTokens(_Tensors):
    """Map tokens followed by obs tokens on a fixed [B, L + A] grid."""

    tokens: torch.Tensor  # [B, L + A, D]
    pos: torch.Tensor     # [B, L + A, 2]
    ori: torch.Tensor     # [B, L + A]
    mask: torch.Tensor    # [B, L + A] bool
    num_map: int

    @property
    def map_tokens(self):
        return self.tokens[:, : self.num_map]

    @property
    def obs_tokens(self):
        return self.tokens[:, self.num_map :]

    def replace_obs(self, obs_tokens, obs_pos, obs_ori, obs_mask):
        m = self.num_map
        return SceneTokens(
            tokens=torch.cat([self.tokens[:, :m], obs_tokens], dim=1),
            pos=torch.cat([self.pos[:, :m], obs_pos], dim=1),
            ori=torch.cat([self.ori[:, :m], obs_ori], dim=1),
            mask=torch.cat([self.mask[:, :m], obs_mask], dim=1),
            num_map=m,
        )
