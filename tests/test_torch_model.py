"""prosim_torch as a whole against prosim_tpu: config, synthetic data, the
param converter, the closed-loop forward and the M-replica rollout, on the
CPU in f32 with TOP_K=1 (the argmax mode pick, so no RNG stream is
involved). Rollout tolerance: 1e-3 m, the bar the JAX package was held to
against its torch reference; per-module tolerances are in test_torch_ops.py.
"""

import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_torch.config import get_config
from prosim_torch.data.synthetic import make_synthetic_batch, synthetic_arrays
from prosim_torch.models.prosim import ProSim
from prosim_torch.utils.params import flax_to_state_dict, load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_OPTS = [
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "2",
    "MODEL.DECODER.ATTN.NUM_LAYER", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "2",
    "MODEL.HIDDEN_DIM", "32",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "4",
    "MODEL.DECODER.ATTN.FF_DIM", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "4",
    "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "8",
]
# the fused two-site policy stack; on the CPU the JAX package runs its XLA
# layer loop for it (prosim_tpu/models/policy.py), the port its fused stack
FUSED = ["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"]
BATCH_KW = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6, num_replan=2)
ROLLOUT_TOL = dict(atol=1e-3, rtol=0)
# the demo configuration: goal, v_action_tag, drag_point and OneText
# conditions, the tiny Llama (TEXT.LLM.ARCH auto without weights) with LoRA
DEMO = "configs/waymo_demo.yaml"


def _pair(opts, seed=0, yaml=None):
    """JAX model, params and batch; the port's model carrying those params,
    and its batch from the same seed."""
    path = os.path.join(REPO, yaml) if yaml else None
    jcfg, tcfg = jax_get_config(path, opts), get_config(path, opts)
    jm = JaxProSim(jcfg)
    jb = jax_synthetic(jcfg, seed=seed, **BATCH_KW)
    params = jm.init(jax.random.PRNGKey(0), jb)
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    tb = make_synthetic_batch(tcfg, seed=seed, device="cpu", **BATCH_KW)
    return jm, params, jb, tm, tb


def _host(tree):
    """A JAX result as numpy arrays. JAX dispatches asynchronously on the CPU;
    a torch computation that ran while a JAX one was still in flight came out
    sporadically imprecise (~2e-5 instead of ~2e-7, about one process in 40),
    so every reference is on the host before the port's side runs."""
    return jax.tree.map(np.asarray, tree)


def _valid_close(got, ref, mask, **tol):
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], **tol)


# ------------------------------------------------------------- the package

def test_package_imports_no_jax():
    """Importing every module of prosim_torch loads no jax, flax or prosim_tpu,
    and no loaded module's file lies under prosim_tpu/ (a top-level import
    such as `import vectorized_map_pb2` resolving to the JAX package's file
    would show here)."""
    code = (
        "import os, pkgutil, sys, importlib, prosim_torch\n"
        "for m in pkgutil.walk_packages(prosim_torch.__path__, 'prosim_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'prosim_tpu'))\n"
        "assert not bad, bad\n"
        "tpu = os.path.join(os.path.abspath('prosim_tpu'), '')\n"
        "files = {n: os.path.abspath(getattr(m, '__file__', None) or '') for n, m in list(sys.modules.items())}\n"
        "under = sorted(n for n, f in files.items() if f.startswith(tpu))\n"
        "assert not under, under\n"
        "print(len([n for n in sys.modules if n.startswith('prosim_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 40  # every module was imported


def test_entry_points_default_to_cuda():
    from prosim_torch.data.dataset import ProSimImitationDataset
    from prosim_torch.data.batch import to_tensors
    from prosim_torch.data.loader import PackedTransfer, SlabCollator, pipelined_batches, \
        sequential_batches
    from prosim_torch.data.scene_bank import DeviceSceneBank, banked_batches
    from prosim_torch.parallel.mesh import initialize_multihost
    from prosim_torch.train.trainer import Trainer

    for fn in (ProSim.__init__, make_synthetic_batch, Trainer.__init__,
               ProSimImitationDataset.get_scene_batch, ProSimImitationDataset.batches,
               PackedTransfer.__init__, SlabCollator.__init__, pipelined_batches,
               sequential_batches, DeviceSceneBank.__init__, banked_batches,
               initialize_multihost):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("opts", [
    ["PARALLEL.NUM_MODEL", "2"],
    ["MODEL.POLICY.ACT_DECODER.TRAJ.PRED_MODE", "cluster"],
])
def test_unported_options_raise(opts):
    """What the port cannot serve raises: a `model` mesh axis (make_mesh,
    pointing at ROADMAP.md; the JAX package declares the axis and shards
    nothing on it), and a 'cluster' policy without its goals file, with the
    JAX package's FileNotFoundError. Every other mode builds
    (tests/test_torch_modes.py)."""
    cfg = get_config(opts=SMALL_OPTS + opts)
    if cfg.PARALLEL.NUM_MODEL > 1:
        from prosim_torch.parallel.mesh import make_mesh

        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make_mesh(num_model=cfg.PARALLEL.NUM_MODEL, devices=["cpu"] * 2)
        return
    with pytest.raises(FileNotFoundError):
        JaxProSim(jax_get_config(opts=SMALL_OPTS + opts))
    with pytest.raises(FileNotFoundError):
        ProSim(cfg, device="cpu")


def test_train_mode_raises():
    """mode="train" runs (tests/test_torch_train.py holds it against JAX) and
    keeps the autograd graph; it raises where it cannot run: through the
    eval-only `rollout` entry point, and with an unknown TRAIN.REMAT_POLICY."""
    cfg = get_config(opts=SMALL_OPTS)
    model = ProSim(cfg, device="cpu")
    batch = make_synthetic_batch(cfg, device="cpu", **BATCH_KW)
    out = model(batch, mode="train")
    assert out["motion_pred"].requires_grad
    scene, policy_emd = model.prepare(batch)
    with pytest.raises(ValueError, match="forward_train"):
        model.rollout(batch, scene, policy_emd, mode="train")
    model = ProSim(get_config(opts=SMALL_OPTS + ["TRAIN.REMAT_POLICY", "some"]), device="cpu")
    with pytest.raises(ValueError, match="REMAT_POLICY"):
        model(batch, mode="train")


@pytest.mark.parametrize("yaml,opts", [
    (None, []),
    ("configs/waymo_demo.yaml", SMALL_OPTS),
    ("configs/no_text.yaml", ["ROLLOUT.POLICY.TOP_K", "3", "TRAIN.LR", "3e-4"]),
])
def test_config_same_keys_and_values(yaml, opts):
    path = os.path.join(REPO, yaml) if yaml else None
    assert get_config(path, opts).to_dict() == jax_get_config(path, opts).to_dict()


@pytest.mark.parametrize("yaml,seed", [(None, 0), (None, 5), (DEMO, 0), (DEMO, 3)])
def test_synthetic_batch_same_arrays(yaml, seed):
    path = os.path.join(REPO, yaml) if yaml else None
    cfg = get_config(path, SMALL_OPTS)
    jb = jax_synthetic(jax_get_config(path, SMALL_OPTS), seed=seed, **BATCH_KW)
    arrays = synthetic_arrays(cfg, seed=seed, **BATCH_KW)
    tb = make_synthetic_batch(cfg, seed=seed, device="cpu", **BATCH_KW)
    conditions = arrays.pop("conditions")
    assert sorted(conditions) == sorted(jb.conditions) == sorted(tb.conditions)
    assert bool(conditions) == bool(yaml)
    pairs = [((group, name), a, getattr(getattr(jb, group), name), getattr(getattr(tb, group), name))
             for group, fields in arrays.items() for name, a in fields.items()]
    for ctype, fields in conditions.items():
        for name, a in fields.items():
            ref, got = jb.conditions[ctype], tb.conditions[ctype]
            ref, got = (ref[name], got[name]) if "OneText" in ctype else (
                getattr(ref, name), getattr(got, name))
            pairs.append(((ctype, name), a, ref, got))
    for where, a, ref, got in pairs:
        ref, got = np.asarray(ref), got.numpy()
        assert got.dtype == ref.dtype, where
        np.testing.assert_array_equal(got, ref, err_msg=str(where))
        np.testing.assert_array_equal(a, ref)


@pytest.mark.parametrize("yaml", [None, DEMO])
def test_converter_maps_every_leaf_once(yaml):
    """Every flax leaf lands on one torch parameter of the same shape; with
    the demo configuration that covers the condition transformer and the
    Llama (its sharded leaves come boxed)."""
    path = os.path.join(REPO, yaml) if yaml else None
    opts = SMALL_OPTS + ["MODEL.DECODER.GOAL_PRED.ENABLE", "True"]
    jm = JaxProSim(jax_get_config(path, opts))
    params = jm.init(jax.random.PRNGKey(0), jax_synthetic(jm.config, **BATCH_KW))
    n_leaves = len(jax.tree.leaves(params))
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params))
    model = ProSim(get_config(path, opts), device="cpu")
    own = model.state_dict()
    assert len(sd) == n_leaves == len(own)
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(own[k].shape) == v.shape, k
    # a dense kernel lands transposed
    k = params["policy"]["motion_head"]["dense_0"]["kernel"]
    np.testing.assert_array_equal(sd["policy.motion_head.dense_0.weight"], np.asarray(k).T)
    # leaves left over on either side are refused
    broken = jax.tree.map(np.asarray, params)
    broken["policy"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        load_flax_params(model, broken)
    del broken["policy"]["extra"], broken["policy"]["motion_anchors"]
    with pytest.raises(KeyError):
        load_flax_params(model, broken)


# ------------------------------------------------------------ the slice

@pytest.mark.parametrize("yaml,opts", [
    (None, []),
    (None, ["MODEL.DECODER.GOAL_PRED.ENABLE", "True", "MODEL.DECODER.GOAL_PRED.K", "4"]),
    (None, ["MODEL.PARITY.REFERENCE_STEP_ENV_FRAME", "True"]),
    (None, ["MODEL.POLICY.ACT_DECODER.TRAJ.PRED_VEL", "False"]),
    pytest.param(None, FUSED, id="fused_stack"),
    pytest.param(DEMO, [], id="text_conditions_policy_decoder"),
    pytest.param(DEMO, ["MODEL.CONDITION_TRANSFORMER.CONDITION_LOCATIONS", "['prompt_encoder']"],
                 id="text_conditions_prompt_encoder"),
])
def test_forward_val_matches_jax(yaml, opts):
    jm, params, jb, tm, tb = _pair(SMALL_OPTS + opts, yaml=yaml)
    ref = _host(jax.jit(lambda p, b, k: jm.forward(p, b, "val", k))(params, jb, jax.random.PRNGKey(7)))
    out = tm(tb, mode="val")
    mask = np.asarray(jb.prompt.mask)
    assert out["rollout_traj"].shape == ref["rollout_traj"].shape
    assert out["motion_pred"].shape == ref["motion_pred"].shape
    _valid_close(out["rollout_traj"], ref["rollout_traj"], mask, **ROLLOUT_TOL)
    _valid_close(out["rollout_vel"], ref["rollout_vel"], mask, **ROLLOUT_TOL)
    np.testing.assert_array_equal(out["init_pos"].numpy(), ref["init_pos"])
    for key in ("goal_prob", "goal_point", "select_idx", "reconst_pred"):
        assert (key in out) == (key in ref), key
        if key in ref:
            np.testing.assert_allclose(out[key].numpy(), ref[key], atol=1e-4)
    assert ("prompt_loss_aux" in out) == ("prompt_loss_aux" in ref)
    if "prompt_loss_aux" in ref:
        np.testing.assert_allclose(float(out["prompt_loss_aux"]["prompt_mask_pred_loss"]),
                                   float(ref["prompt_loss_aux"]["prompt_mask_pred_loss"]),
                                   rtol=1e-5)


def test_parallel_rollout_matches_jax():
    _parallel_rollout_vs_jax(SMALL_OPTS)


def test_parallel_rollout_fused_stack_matches_jax():
    _parallel_rollout_vs_jax(SMALL_OPTS + FUSED)


def _parallel_rollout_vs_jax(opts):
    from prosim_tpu.rollout.rollout import parallel_rollout as jax_parallel_rollout
    from prosim_torch.rollout.rollout import parallel_rollout

    jm, params, jb, tm, tb = _pair(opts, seed=2)
    ref = _host(jax.jit(lambda p, b, k: jax_parallel_rollout(jm, p, b, 2, k))(
        params, jb, jax.random.PRNGKey(3)))
    out = parallel_rollout(tm, tb, 2)
    mask = np.repeat(np.asarray(jb.prompt.mask), 2, axis=0)
    assert out["rollout_traj"].shape == ref["rollout_traj"].shape
    _valid_close(out["rollout_traj"], ref["rollout_traj"], mask, **ROLLOUT_TOL)
    # with the argmax mode pick the two replicas of a scene agree
    rt = out["rollout_traj"].view(2, 2, *out["rollout_traj"].shape[1:])
    torch.testing.assert_close(rt[:, 0], rt[:, 1])


def test_world_frame_and_sim_metrics_match_jax():
    from prosim_tpu.rollout import rollout as jr
    from prosim_torch.rollout import rollout as tr

    rng = np.random.default_rng(4)
    # T a multiple of 8: prosim_tpu's crash metric pads time to blocks of 8
    # with every agent at one point, which reads as a crash (ROADMAP.md queue C)
    B, N, T = 2, 5, 24
    th = rng.normal(size=(B, N, T)).astype(np.float32)
    traj = np.concatenate([rng.normal(size=(B, N, T, 2)) * 3,
                           np.sin(th)[..., None], np.cos(th)[..., None]], -1).astype(np.float32)
    output = dict(rollout_traj=traj, init_pos=(rng.normal(size=(B, N, 2)) * 10).astype(np.float32),
                  init_heading=rng.normal(size=(B, N)).astype(np.float32))
    center_xy = rng.normal(size=(B, 2)).astype(np.float32)
    center_h = rng.normal(size=(B,)).astype(np.float32)
    ref = _host(jr.rollout_to_world(output, None, center_xy, center_h))
    got = tr.rollout_to_world({k: torch.from_numpy(v) for k, v in output.items()}, None,
                              torch.from_numpy(center_xy), torch.from_numpy(center_h))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-5)

    extents = (np.abs(rng.normal(size=(B, N, 2))) * 4 + 1).astype(np.float32)
    mask = rng.random((B, N)) > 0.2
    goals = ref[:, :, 7, :2] + 0.5
    jm = _host(jr.crash_and_goal_metrics(ref, extents, mask, goals))
    tmx = tr.crash_and_goal_metrics(got, torch.from_numpy(extents), torch.from_numpy(mask),
                                    torch.from_numpy(goals))
    for k in ("crash_rate", "goal_reach_rate"):
        assert float(tmx[k]) == pytest.approx(float(jm[k]), abs=1e-6), k


def test_select_k_emd_matches_jax():
    """Picking 1 of K goal-conditioned embeddings (the [B, N, K, D] branch),
    with TOP_K=1 so the pick is the first maximum of goal_prob."""
    rng = np.random.default_rng(6)
    B, N, K, D = 2, 5, 4, 8
    emd = {
        "emd": rng.normal(size=(B, N, K, D)).astype(np.float32),
        "goal_prob": np.round(rng.normal(size=(B, N, K)), 1).astype(np.float32),  # with ties
        "goal_point": rng.normal(size=(B, N, K, 2)).astype(np.float32),
    }
    jm = JaxProSim(jax_get_config(opts=SMALL_OPTS))
    ref = _host(jm.select_k_emd({k: jax.numpy.asarray(v) for k, v in emd.items()}, None, "val",
                                jax.random.PRNGKey(0)))
    tm = ProSim(get_config(opts=SMALL_OPTS), device="cpu")
    got = tm.select_k_emd({k: torch.from_numpy(v) for k, v in emd.items()}, None, "val", None)
    for key in ("select_idx", "emd", "goal"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key])
