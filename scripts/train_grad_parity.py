#!/usr/bin/env python3
"""Per-leaf gradient agreement of prosim_torch's training loss with the JAX
package's, on the CPU in f32.

Run from the repository root (JAX on the CPU, torch for the CPU suffice):
    JAX_PLATFORMS=cpu python3 scripts/train_grad_parity.py [--replan 1 2] [--seeds 0 1 2 3]
configs/no_text.yaml at the widths of tests/test_torch_train.py (SMALL_OPTS,
every dropout rate 0, B=2). For each number of replan steps R and each seed
(weights, batch and JAX key), both packages take jax.value_and_grad /
backward of the train step's loss on the same weights and batch. Per leaf it
prints the port's error as a share of the JAX gradient's largest magnitude
("err") and how far the JAX gradient itself moves when every weight is
scaled by 1 + 1e-7 N(0, 1) ("own"): the closed loop's own conditioning.
Prints, per (R, seed), the worst leaves by err and the count of leaves above
1e-4.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

from prosim_tpu.config import get_config as jax_get_config  # noqa: E402
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic  # noqa: E402
from prosim_tpu.models.prosim import ProSim as JaxProSim  # noqa: E402
from prosim_tpu.train import losses as jlosses  # noqa: E402
from prosim_torch.config import get_config  # noqa: E402
from prosim_torch.data.synthetic import make_synthetic_batch  # noqa: E402
from prosim_torch.models.prosim import ProSim  # noqa: E402
from prosim_torch.train import losses as tlosses  # noqa: E402
from prosim_torch.utils.params import flax_to_state_dict, load_flax_params  # noqa: E402

NO_TEXT = os.path.join(ROOT, "configs/no_text.yaml")
OPTS = [
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1", "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1", "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "2", "MODEL.DECODER.ATTN.FF_DIM", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "2", "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "4", "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.SCENE_ENCODER.ATTN.DROPOUT", "0.0", "MODEL.DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.POLICY.ACT_DECODER.ATTN.DROPOUT", "0.0", "MODEL.CONDITION_TRANSFORMER.DROPOUT", "0.0",
]


def readings(replan: int, seed: int):
    """{leaf: (err, own)} for one R and seed."""
    jcfg, tcfg = jax_get_config(NO_TEXT, OPTS), get_config(NO_TEXT, OPTS)
    kw = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6, num_replan=replan)
    jm = JaxProSim(jcfg)
    jb = jax_synthetic(jcfg, seed=seed, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jb)
    loss_impl = jlosses.loss_func_dict[jcfg.TASK.MOTION_PRED.LOSS]

    def loss_fn(p, b, k):
        return loss_impl(b, jm.forward(p, b, "train", k), jcfg)["full_loss"] \
            * jcfg.TASK.MOTION_PRED.WEIGHT

    grad = jax.jit(jax.grad(loss_fn))
    key = jax.random.PRNGKey(seed + 1)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, grad(params, jb, key)))
    noisy = jax.tree.map(
        lambda x: x * (1 + 1e-7 * jax.random.normal(jax.random.PRNGKey(x.size), x.shape)), params)
    own = flax_to_state_dict(jax.tree.map(np.asarray, grad(noisy, jb, key)))
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    tb = make_synthetic_batch(tcfg, seed=seed, device="cpu", **kw)
    out = tm.forward_train(tb, seed=0)
    (tlosses.paired_mse_k(tb, out, tcfg)["full_loss"] * tcfg.TASK.MOTION_PRED.WEIGHT).backward()
    res = {}
    for name, p in tm.named_parameters():
        scale = max(np.abs(ref[name]).max(), 1e-30)
        res[name] = (float(np.abs(p.grad.numpy() - ref[name]).max() / scale),
                     float(np.abs(own[name] - ref[name]).max() / scale))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replan", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--top", type=int, default=5)
    args = ap.parse_args()
    for replan in args.replan:
        for seed in args.seeds:
            res = readings(replan, seed)
            worst = sorted(res.items(), key=lambda kv: -kv[1][0])
            above = sum(err > 1e-4 for err, _ in res.values())
            print(f"R={replan} seed={seed}: {len(res)} leaves, {above} above 1e-4; "
                  f"largest own movement {max(o for _, o in res.values()):.3e}")
            for name, (err, own) in worst[:args.top]:
                print(f"  {name:70s} err {err:.3e}  own {own:.3e}")


if __name__ == "__main__":
    main()
