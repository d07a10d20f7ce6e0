"""The port's interactive demo API and plots against prosim_tpu's, on the
CPU, on a synthetic cache written by the port: InteractiveSim's condition
rows after each control call equal the JAX API's, and its closed loop is
within 1e-4 m of JAX's at TOP_K=1 over its first two replan steps, and over
all 80 with every weight matrix scaled by 1/4 (tests/test_torch_farm.py says
why); the figures of both packages from the
same scene are the same PNG bytes; Trainer.visualization_callback and the
demo's plot/animate write their files.
"""

import os

import jax
import numpy as np
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.demo.api import InteractiveSim as JaxSim
from prosim_tpu.viz import plots as jplots
from prosim_torch.config import get_config
from prosim_torch.demo.api import InteractiveSim
from prosim_torch.models.prosim import ProSim
from prosim_torch.utils.params import load_flax_params
from prosim_torch.viz import plots as tplots
from torch_data_common import (REPO, SMALL, assert_trees_equal, build_cache,
                               scale_weight_matrices)

DEMO = os.path.join(REPO, "configs", "waymo_demo.yaml")
OPTS = SMALL + [
    "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1",
    "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.CONDITION_TRANSFORMER.NLAYER", "1",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "4",
    "MODEL.DECODER.ATTN.FF_DIM", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "4",
    "MODEL.CONDITION_TRANSFORMER.FF_DIM", "4",
    "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS", "32",
    "PROMPT.CONDITION.TYPES",
    "['goal','v_action_tag','v2v_tag','drag_point','llm_text_OneText']",
]
# the closed loops are compared over their first two replan steps at the
# drawn weights, and over the whole horizon with the weight matrices scaled
# by FULL_HORIZON_SCALE: at the drawn weights the loop doubles any rounding
# difference each replan step (tests/test_torch_farm.py)
STEPS = 20
FULL_HORIZON_SCALE = 0.25


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """(JAX sim, port sim) on scene 0 of one cache, with the same weights."""
    cache = build_cache(str(tmp_path_factory.mktemp("demo")), n_scenes=2, n_shards=1)[1]
    jcfg, tcfg = jax_get_config(DEMO, OPTS), get_config(DEMO, OPTS)
    js = JaxSim(jcfg, cache)
    js.load_scene(0)  # draws the weights
    js.params = jax.tree.map(np.asarray, js.params)
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, js.params)
    ts = InteractiveSim(tcfg, cache, model=tm, device="cpu")
    ts.load_scene(0)
    return js, ts


def _controls(sim):
    sim.set_goal(1, (25.0, 0.0))
    sim.set_goal(2, (10.0, -3.0))
    sim.set_goal(1, (30.0, 1.0))  # reuses agent 1's row
    sim.set_drag_points(3, [(2.0, 0.0), (6.0, 1.0), (12.0, 3.0)])
    sim.set_action_tag(2, "Stopping")
    sim.set_action_tag(2, "LeftTurn", interval=(0, 40))  # the same agent: updated in place
    sim.set_v2v_tag(1, 3, "Following")
    sim.set_text("slow down and yield", agents=[0, 2])


def _traj_close(out_t, out_j, mask, steps=STEPS):
    got = out_t["rollout_traj"].numpy()[mask]
    want = np.asarray(out_j["rollout_traj"])[mask]
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got[:, :steps], want[:, :steps], atol=1e-4, rtol=0)


def test_interactive_sim_matches_jax(sims):
    js, ts = sims
    assert_trees_equal(ts.batch.conditions, js.batch.conditions)
    mask = np.asarray(js.batch.prompt.mask)
    out1 = ts.rollout()
    _traj_close(out1, js.rollout(), mask)

    _controls(js)
    _controls(ts)
    assert_trees_equal(ts.batch.conditions, js.batch.conditions)
    goal = ts.batch.conditions["goal"]
    assert int(goal.mask.sum()) == int(np.asarray(js.batch.conditions["goal"].mask).sum())
    with pytest.raises(ValueError, match="unknown tag"):
        ts.set_action_tag(2, "NotATag")
    out2 = ts.rollout()
    _traj_close(out2, js.rollout(), mask)
    assert float((out2["rollout_traj"] - out1["rollout_traj"]).abs().max()) > 1e-4
    # the same generator seed gives the same rollout, bit for bit
    again = ts.rollout(torch.Generator().manual_seed(0))
    assert torch.equal(again["rollout_traj"], ts.rollout(torch.Generator().manual_seed(0))[
        "rollout_traj"])

    # the whole horizon, under the controls, at scaled weights
    drawn = js.params
    scaled = scale_weight_matrices(drawn, FULL_HORIZON_SCALE)
    try:
        js.params = scaled
        load_flax_params(ts.model, scaled)
        out_j = js.rollout()
        assert np.asarray(out_j["rollout_traj"]).shape[2] == 80
        _traj_close(ts.rollout(), out_j, mask, steps=None)
    finally:
        js.params = drawn
        load_flax_params(ts.model, drawn)

    ts.clear_conditions()
    js.clear_conditions()
    assert ts.batch.conditions == {}


def test_plots_match_jax_and_demo_files(sims, tmp_path):
    """Both packages draw the same figures from the same scene and rollout
    (PNG bytes equal); plot, animate and the comparison panels write files."""
    import matplotlib.pyplot as plt

    js, ts = sims
    out = {k: v.numpy() for k, v in ts.rollout().items() if torch.is_tensor(v)}
    for name, draw in (
        ("scene", lambda p, b: p.save_scene_png(b, str(tmp_path / f"{id(p)}s.png"),
                                                output=out, show_goals=True)),
        ("compare", lambda p, b: p.save_comparison_png(b, out, str(tmp_path / f"{id(p)}c.png"))),
    ):
        got, want = draw(tplots, ts.batch), draw(jplots, js.batch)
        assert open(got, "rb").read() == open(want, "rb").read(), name
    _controls(js)
    _controls(ts)
    fig = tplots.plot_batch_prompts(ts.batch, texts=["<A0> slows down."])
    fig_j = jplots.plot_batch_prompts(js.batch, texts=["<A0> slows down."])
    paths = [str(tmp_path / "pt.png"), str(tmp_path / "pj.png")]
    fig.savefig(paths[0])
    fig_j.savefig(paths[1])
    plt.close(fig)
    plt.close(fig_j)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()

    assert os.path.getsize(ts.plot(str(tmp_path / "sim.png"), ts.rollout())) > 1000
    assert os.path.getsize(ts.animate(str(tmp_path / "sim.gif"), stride=10)) > 1000
    K = 3
    gp = torch.randn(1, ts.batch.prompt.mask.shape[1], K, 2) * 10
    assert os.path.getsize(tplots.plot_goal_heatmap(
        ts.batch, gp, torch.randn(gp.shape[:3]), str(tmp_path / "heat.png"), sigma=2.0,
        bins=40)) > 1000
    from prosim_torch.data.trajdata_cache import list_scenes, load_scene

    scene = load_scene(ts.ds.cache_dir, "waymo_train", list_scenes(ts.ds.cache_dir,
                                                                   "waymo_train")[0])
    fig = tplots.plot_full_map(scene, show_ids=True)
    fig.savefig(str(tmp_path / "map.png"))
    plt.close(fig)
    assert os.path.getsize(tmp_path / "map.png") > 1000


def test_trainer_visualization_callback(sims, tmp_path):
    from prosim_torch.train.trainer import Trainer

    _, ts = sims
    cfg = get_config(DEMO, OPTS + ["EXPERIMENT_DIR", str(tmp_path)])
    trainer = Trainer(cfg, model=ts.model)
    rec = trainer.visualization_callback(ts.batch, ts.rollout(), make_gif=True)
    for key in ("vis/val_rollout", "vis/val_rollout_gif"):
        assert os.path.getsize(rec[key]) > 1000, key
    with open(trainer.log_path) as f:
        assert "vis/val_rollout" in f.read()
