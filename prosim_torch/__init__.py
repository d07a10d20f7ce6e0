"""prosim_torch: the PyTorch + CUDA port of prosim_tpu for NVIDIA Hopper.

The JAX package `prosim_tpu` is the reference; this package keeps its module
layout and names so each counterpart sits at the same path. It imports
neither JAX nor anything of `prosim_tpu`.

The port covers the closed-loop rollout: the scene encoder, prompt
encoder, decoder and policy (its a2p/m2p stack as the layer loop or, with
FUSED_STACK, the fused two-site stack), prompt conditions and the Llama
text path, the replan loop and the M-replica rollout (`rollout/`), with the
hand-written CUDA kernels on that path (`ops/neighbors.py`,
`ops/edge_attn.py`, `ops/fused_stack.py`, `ops/flash_attn.py`, sources
under `csrc/`); the network body in bf16 (`ProSim(config, device,
dtype)`); and closed-loop imitation training (`train/`) of
configs/no_text.yaml and of configs/with_text.yaml, in f32 or with the
body in bf16, on one device or data-parallel over processes
(`parallel/mesh.py` on torch.distributed), whose causal attention has its
backward as a CUDA kernel too; the host data pipeline (`data/`);
the weights (`utils/safetensors_io.py`, the HF Llama and tokenizer
loaders, `utils/checkpoint_convert.py`) and the serving entry points: the
WOSAC farm (`rollout/runner.py`, `wosac.py`, `wosac_metrics.py`), the demo
API (`demo/api.py`), the plots (`viz/`) and the CLI (`main.py`); and the
modes no shipped config reaches: the MLP map and obs encoders, the 'mlp'
obs-update fusion and ATTN_UPDATE's re-attention, the policy's goal
context and its 'mlp', 'cluster', 'vel_pred' and 'goal_pred' heads, and the
QA probe with the Llama's LM head. Entry points run on the card unless the
caller passes `device="cpu"`. The port does all that the JAX package does
except shard the Llama over a `model` mesh axis, where the JAX package
declares the axis and shards nothing (ROADMAP.md).
"""

__version__ = "0.1.0"

from prosim_torch.config import get_config  # noqa: F401
