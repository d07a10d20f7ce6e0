"""prosim_torch: the PyTorch + CUDA port of prosim_tpu for NVIDIA Hopper.

The JAX package `prosim_tpu` is the reference; this package keeps its module
layout and names so each counterpart sits at the same path. It imports
neither JAX nor anything of `prosim_tpu`.

This slice covers the unconditioned closed-loop rollout in eval mode: the
scene encoder, prompt encoder, decoder and policy, the replan loop, and the
two hand-written CUDA kernels on that path (`ops/neighbors.py`,
`ops/edge_attn.py`, sources under `csrc/`). Entry points run on the card
unless the caller passes `device="cpu"`. Training, prompt conditions and the
fused policy stack are still to be ported (see ROADMAP.md).
"""

__version__ = "0.1.0"

from prosim_torch.config import get_config  # noqa: F401
