#!/usr/bin/env python3
"""How far prosim_torch's WOSAC farm drifts from the JAX package's over the
80-step horizon, on the CPU in f32: the reading behind the full-horizon
cases of tests/test_torch_farm.py and tests/test_torch_demo.py.

Run from the repository root (JAX on the CPU, torch for the CPU suffice):
    JAX_PLATFORMS=cpu python3 scripts/farm_horizon_parity.py [--scales 1 0.5 0.25] [--eager]
Both farms roll out 2 scenes of the test farm's synthetic cache (womd_synth
-> womd_ingest, 4 scenes, seed 7) at the test's widths (tests/
test_torch_farm.py OPTS, TOP_K=1, M=2, sampler off) with the same weights:
the JAX init, every weight matrix (every leaf of two or more axes) scaled
by each of --scales. Per scene and scale it prints the largest |dx|, |dy|
between the two farms' npz trajectories in each replan step of 10 steps.
--eager also runs the JAX farm under jax.disable_jit() (about 2 minutes,
most of it compiling each primitive once).
"""

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402

import test_torch_farm as farm  # noqa: E402
from prosim_tpu.rollout import runner as jrunner  # noqa: E402
from prosim_torch.models.prosim import ProSim  # noqa: E402
from prosim_torch.rollout import runner as trunner  # noqa: E402
from prosim_torch.utils.params import load_flax_params  # noqa: E402
from torch_data_common import build_cache, scale_weight_matrices  # noqa: E402


def drift(got_dir, ref_dir):
    """{scene: [max |dxy| of each replan step]} between two farms' npz files."""
    out = {}
    for g, r in zip(farm._npz(got_dir), farm._npz(ref_dir)):
        a, b = np.load(g), np.load(r)
        d = np.maximum(np.abs(a["center_x"] - b["center_x"]),
                       np.abs(a["center_y"] - b["center_y"]))  # [M, N, T]
        out[os.path.basename(g)] = [float(d[..., k:k + 10].max())
                                    for k in range(0, d.shape[-1], 10)]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scales", type=float, nargs="+", default=[1.0, 0.5, 0.25])
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args()
    root = tempfile.mkdtemp(prefix="farm_horizon_")
    cache = build_cache(root, n_scenes=4, n_shards=2)[1]
    jcfg, tcfg, jm, params, _ = farm._models(farm.OPTS)
    modes = [("jit", False)] + ([("eager", True)] if args.eager else [])
    for scale in args.scales:
        p = scale_weight_matrices(params, scale) if scale != 1.0 else params
        tm = ProSim(tcfg, device="cpu")
        load_flax_params(tm, p)
        got = trunner.run_rollout_eval(tcfg, cache, out_dir=f"{root}/port{scale}", m=farm.M,
                                       model=tm, max_scenes=2, goal_sampler="off",
                                       compute_metrics=False, device="cpu")
        for mode, eager in modes:
            kw = dict(out_dir=f"{root}/jax{scale}{mode}", m=farm.M, params=p, model=jm,
                      max_scenes=2, goal_sampler="off", compute_metrics=False)
            if eager:
                with jax.disable_jit():
                    ref = jrunner.run_rollout_eval(jcfg, cache, **kw)
            else:
                ref = jrunner.run_rollout_eval(jcfg, cache, **kw)
            for scene, per_step in drift(got, ref).items():
                print(f"scale {scale} JAX {mode} {scene}: max |dxy| per replan step (m) "
                      + " ".join(f"{v:.1e}" for v in per_step), flush=True)


if __name__ == "__main__":
    main()
