"""Parameters: flax param trees into torch modules, and seeded random init.

The port's module names mirror the flax names, so a flax tree (nested dicts
of numpy arrays) maps leaf by leaf onto a `state_dict`:
  Dense      kernel [in, out] -> weight [out, in]   (bias -> bias)
  LayerNorm  scale / bias     -> weight / bias      (also prenorm_* affines)
  Embed      embedding        -> weight
  RMSNorm    scale            -> weight
  other leaves (FourierEmbedding.freqs, tag_params, the Llama's
  embed_tokens, lora_embed_a/b and each LoraDense's lora_a/lora_b) keep
  their name and flax layout.
A boxed leaf (flax's `Partitioned`, for the Llama's sharded weights) is
unboxed first.

`init_params` draws seeded random weights; a submodule that has its own
initialiser (the Llama's `init_weights`, which draws on the model's device,
so a Llama3-8B model is initialised on the card) is left to it.
"""

from typing import Dict, Mapping

import numpy as np
import torch

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "unbox"):  # a boxed leaf (flax Partitioned)
            v = v.unbox()
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def flax_to_state_dict(flax_params: Mapping) -> Dict[str, np.ndarray]:
    """Flax param tree -> {dotted torch name: array in torch layout}."""
    out = {}
    for path, leaf in _flatten(flax_params).items():
        name = path[-1]
        if name == "kernel":
            if leaf.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense kernel")
            leaf = leaf.T
        key = ".".join(path[:-1] + (_RENAME.get(name, name),))
        if key in out:
            raise KeyError(f"two flax leaves map onto {key}")
        out[key] = np.array(leaf, order="C")  # a writable copy
    return out


def load_flax_params(module: torch.nn.Module, flax_params: Mapping) -> None:
    """Copy a flax param tree into `module`. Raises on any leaf left unmapped
    on either side and on any shape mismatch."""
    src = flax_to_state_dict(flax_params)
    own = module.state_dict()
    missing = sorted(set(own) - set(src))
    unused = sorted(set(src) - set(own))
    if missing or unused:
        raise KeyError(f"unmapped parameters: torch-only {missing}, flax-only {unused}")
    for k, v in src.items():
        if tuple(own[k].shape) != v.shape:
            raise ValueError(f"{k}: torch shape {tuple(own[k].shape)} vs flax {v.shape}")
    module.load_state_dict(
        {k: torch.from_numpy(v).to(own[k].device, own[k].dtype) for k, v in src.items()},
        strict=True,
    )


@torch.no_grad()
def init_params(module: torch.nn.Module, seed: int) -> None:
    """Seeded random weights: Linear weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    biases 0, norm affines (1, 0), embeddings and other tensors N(0, 1). A
    submodule with an `init_weights(seed)` method (the Llama) initialises
    its own parameters, with a seed of its own."""
    owners = [(name, m) for name, m in module.named_modules() if hasattr(m, "init_weights")]
    for i, (_, m) in enumerate(owners):
        m.init_weights(seed + 1 + i)
    skip = tuple(name + "." if name else "" for name, _ in owners)
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if name.startswith(skip):
            continue
        leaf_owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(leaf_owner, torch.nn.Linear) and leaf == "weight":
            bound = p.shape[1] ** -0.5
            val = (torch.rand(p.shape, generator=gen) * 2 - 1) * bound
        elif isinstance(leaf_owner, torch.nn.Embedding) or leaf == "freqs":
            val = torch.randn(p.shape, generator=gen)
        elif leaf == "weight":
            val = torch.ones(p.shape)
        else:
            val = torch.zeros(p.shape)
        p.copy_(val.to(p.device, p.dtype))
