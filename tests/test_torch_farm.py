"""The port's WOSAC farm against prosim_tpu's, on the CPU, on one synthetic
cache written by the port (womd_synth -> womd_ingest): the packaging,
realism metrics and constant-velocity baseline (numpy copies: equal), the
farm of both packages with the same weights (npz trajectories within 1e-4
m, per-scene metrics within 1e-5 relative, at TOP_K=1; the goal-sampler
path with the JAX farm's picks injected), worker sharding, resume and the
failure budget, the trainer's rollout request served by the farm, and the
CLI's data_debug and rollout run types.
"""

import glob
import inspect
import json
import os

import jax
import numpy as np
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_tpu.rollout import baseline as jbase
from prosim_tpu.rollout import runner as jrunner
from prosim_tpu.rollout import wosac as jwosac
from prosim_tpu.rollout import wosac_metrics as jmetrics
from prosim_torch.config import get_config
from prosim_torch.models.prosim import ProSim
from prosim_torch.rollout import baseline as tbase
from prosim_torch.rollout import runner as trunner
from prosim_torch.rollout import wosac as twosac
from prosim_torch.rollout import wosac_metrics as tmetrics
from prosim_torch.utils.params import load_flax_params
from torch_data_common import ENV, SMALL, build_cache, scale_weight_matrices

MODEL_SMALL = [
    "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1",
    "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "4",
    "MODEL.DECODER.ATTN.FF_DIM", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "4",
    "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "8",
    "ROLLOUT.POLICY.TOP_K", "1",
    "PROMPT.CONDITION.TYPES", "[]",
]
OPTS = SMALL + MODEL_SMALL
GOAL_HEADS = ["MODEL.DECODER.GOAL_PRED.ENABLE", "True"]
M = 2


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return build_cache(str(tmp_path_factory.mktemp("farm")), n_scenes=4, n_shards=2)[1]


def _models(opts, scale=1.0):
    jcfg, tcfg = jax_get_config(opts=opts), get_config(opts=opts)
    jm = JaxProSim(jcfg)
    from prosim_tpu.data.synthetic import make_synthetic_batch

    params = jm.init(jax.random.PRNGKey(0), make_synthetic_batch(
        jcfg, batch_size=1, num_lanes=8, num_obs_agents=6, num_agents=4, num_replan=2))
    params = jax.tree.map(np.asarray, params)
    if scale != 1.0:
        params = scale_weight_matrices(params, scale)
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, params)
    return jcfg, tcfg, jm, params, tm


def _npz(out_dir):
    return sorted(glob.glob(os.path.join(out_dir, "*.npz")))


def _assert_farms_close(got_dir, ref_dir, n, steps):
    got, ref = _npz(got_dir), _npz(ref_dir)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert len(got) == n
    for g, r in zip(got, ref):
        a, b = np.load(g), np.load(r)
        assert str(a["scenario_id"]) == str(b["scenario_id"])
        np.testing.assert_array_equal(a["object_ids"], b["object_ids"])
        np.testing.assert_array_equal(a["center_z"], b["center_z"])
        for k in ("center_x", "center_y", "heading"):
            assert a[k].shape == b[k].shape and a[k].shape[-1] == steps
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, rtol=0, err_msg=k)


# -------------------------------------------------------------- numpy copies

def test_wosac_packaging_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    world = rng.normal(size=(3, 4, 5, 3)) * 10
    oid, z = [7, 8, -1, 121], [0.5, 1.0, 1.5, 2.0]
    sr_t = twosac.ScenarioRollouts("env/s", twosac.joint_scenes_from_rollout(world, oid, z))
    sr_j = jwosac.ScenarioRollouts("env/s", jwosac.joint_scenes_from_rollout(world, oid, z))
    twosac.validate_scenario_rollouts(sr_t, num_rollouts=3, steps=5)
    for d, mod, sr in (("t", twosac, sr_t), ("j", jwosac, sr_j)):
        os.makedirs(tmp_path / d)
        mod.save_rollouts_npz(sr, str(tmp_path / d / "env__s.npz"))
    back = twosac.load_rollouts_npz(str(tmp_path / "t" / "env__s.npz"))
    ref = jwosac.load_rollouts_npz(str(tmp_path / "j" / "env__s.npz"))
    assert back.scenario_id == ref.scenario_id and len(back.joint_scenes) == 3
    for a, b in zip(back.joint_scenes, ref.joint_scenes):
        assert a.object_ids == b.object_ids
        for f in ("center_x", "center_y", "center_z", "heading"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="joint scenes"):
        twosac.validate_scenario_rollouts(sr_t, num_rollouts=4, steps=5)
    bad = np.array(world)
    bad[0, 0, 0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        twosac.validate_scenario_rollouts(twosac.ScenarioRollouts(
            "x", twosac.joint_scenes_from_rollout(bad, oid, z)), num_rollouts=3, steps=5)
    mt = json.load(open(twosac.package_submission(str(tmp_path / "t"), str(tmp_path / "pt"),
                                                  method_name="m")))
    mj = json.load(open(jwosac.package_submission(str(tmp_path / "j"), str(tmp_path / "pj"),
                                                  method_name="m")))
    assert mt == mj and mt["num_scenarios"] == 1


def test_wosac_metrics_match_jax():
    rng = np.random.default_rng(1)
    N, T, Mr = 5, 30, 4
    t = np.arange(T) * 0.1
    log = np.zeros((N, T, 3))
    for n in range(N):
        log[n, :, 0] = rng.uniform(3, 12) * t
        log[n, :, 1] = n * 4.0
    ext = np.tile([[4.5, 2.0]], (N, 1))
    sim = log[None] + rng.normal(scale=0.3, size=(Mr, N, T, 3)) * [1, 1, 0.02]
    valid = rng.random((N, T)) > 0.1
    seg = (rng.normal(size=(40, 2)) * 20, rng.normal(size=(40, 2)) * 20)
    got = tmetrics.scenario_metrics(sim, log, ext, road_segments=seg, valid=valid)
    want = jmetrics.scenario_metrics(sim, log, ext, road_segments=seg, valid=valid)
    assert got == want
    assert tmetrics.aggregate_scenarios([got, got]) == jmetrics.aggregate_scenarios([want, want])
    assert tmetrics.CHALLENGE_CONFIG == {k: tmetrics.FeatureConfig(**v.__dict__)
                                         for k, v in jmetrics.CHALLENGE_CONFIG.items()}


@pytest.mark.parametrize("case", range(8))
def test_sparse_distances_match_jax_full_matrices(case):
    """The port's realism metrics compute the nearest-box and nearest-lane
    distances on the pairs that can hold them; each equals the minimum over
    the JAX package's full pairwise matrices bit for bit, in f32 and f64:
    overlaps, touching and far-apart boxes, zero extents, agents parked at
    the 1e7 m sentinel, NaN rows; then scenario_metrics of a 48-agent
    scene equal as a whole."""
    rng = np.random.default_rng(case)
    N, T = int(rng.integers(2, 48)), int(rng.integers(1, 12))
    xy = rng.normal(size=(N, T, 2)) * [3, 10, 50, 1e4][case % 4] + (1e4 if case % 3 == 0 else 0)
    h = rng.uniform(-np.pi, np.pi, (N, T))
    ext = np.abs(rng.normal(size=(N, 2)) * 2 + [4.5, 2.0])
    ext[0] *= case % 2
    xy[1, 0], h[1, 0] = xy[0, 0] + [ext[0, 0] / 2 + ext[1, 0] / 2, 0], h[0, 0]  # touching
    park = rng.random(N) < 0.3 * (case % 2)
    xy[park] = 1e7 * (1 + np.arange(N))[park, None, None]
    if case == 5:
        xy[2, -1, 0] = np.nan
    for dt in (np.float64, np.float32):
        x, hh, e = xy.astype(dt), h.astype(dt), ext.astype(dt)
        full = jmetrics._pair_box_distance(x, hh, e)
        full[np.eye(N, dtype=bool)] = np.inf
        np.testing.assert_array_equal(tmetrics._nearest_box_distance(x, hh, e), full.min(1))
    lanes = np.cumsum(rng.normal(size=(int(rng.integers(2, 300)), 2)) * 4, 0).astype(np.float32)
    q = rng.normal(size=(int(rng.integers(1, 500)), 2)) * 40 + lanes.mean(0)
    np.testing.assert_array_equal(
        tmetrics._nearest_segment_dist(q, lanes[:-1], lanes[1:]),
        jmetrics._point_segment_dist(q[None], lanes[None, :-1], lanes[None, 1:])[0])
    if case == 0:
        N, T, Mr = 48, 40, 3
        log = np.cumsum(rng.normal(size=(N, T, 3)) * [0.8, 0.8, 0.02], 1)
        log[..., :2] += rng.uniform(-40, 40, (N, 1, 2))
        sim = log[None] + rng.normal(scale=0.3, size=(Mr, N, T, 3)) * [1, 1, 0.02]
        valid = rng.random((N, T)) > 0.1
        seg = (lanes[:-1], lanes[1:])
        e = np.tile([[4.5, 2.0]], (N, 1))
        assert (tmetrics.scenario_metrics(sim, log, e, road_segments=seg, valid=valid)
                == jmetrics.scenario_metrics(sim, log, e, road_segments=seg, valid=valid))


def test_constant_velocity_baseline_matches_jax(cache):
    from prosim_torch.data.trajdata_cache import list_scenes, load_scene

    scene = load_scene(cache, ENV, list_scenes(cache, ENV)[0])
    rows = list(range(min(6, len(scene.agent_names))))
    for noise in (0.01, 0.0):
        np.testing.assert_array_equal(
            tbase.constant_velocity_rollout(scene, 10, rows, 20, 3, noise_scale=noise, seed=2),
            jbase.constant_velocity_rollout(scene, 10, rows, 20, 3, noise_scale=noise, seed=2))
    opts = OPTS + ["ROLLOUT.SAMPLE_NUM", "4"]
    assert (tbase.run_constant_velocity_eval(get_config(opts=opts), cache, max_scenes=2)
            == jbase.run_constant_velocity_eval(jax_get_config(opts=opts), cache, max_scenes=2))


# -------------------------------------------------------------------- farm

# At the default init the closed loop doubles any rounding difference each
# replan step. On scene 0 of this cache the farms differ by 7.6e-6 m over
# the first replan step and by 4.0e-3 m at step 80 with the JAX farm
# jitted, 9.2e-3 m with it run eagerly (jax.disable_jit): the difference
# starts in the f32 trajectory arithmetic both packages keep, where XLA's
# and PyTorch's sin, cos and fused products differ by an ulp, so no JAX
# mode is a full-horizon reference at these weights. Each parity test
# therefore compares the first two replan steps at the default init, and
# all 80 steps with every weight matrix scaled by FULL_HORIZON_SCALE, where
# the loop damps rounding instead (3.6e-5 m at step 80).
# scripts/farm_horizon_parity.py prints these readings.
PARITY = ["ROLLOUT.POLICY.MAX_STEPS", "20"]
FULL_HORIZON_SCALE = 0.25
HORIZONS = [(PARITY, 1.0, 20), ([], FULL_HORIZON_SCALE, 80)]  # (opts, weight scale, steps)


def test_farm_matches_jax(cache, tmp_path):
    """Both farms on the same cache and weights, sampler off: the npz
    trajectories within 1e-4 m and each scene's metrics within 1e-5
    relative, over two replan steps at the default init and over the whole
    horizon at scaled weights (HORIZONS); the port records each scene's host
    ms by stage."""
    for h, (opts, scale, steps) in enumerate(HORIZONS):
        jcfg, tcfg, jm, params, tm = _models(OPTS + opts, scale)
        ref = jrunner.run_rollout_eval(jcfg, cache, out_dir=str(tmp_path / f"jax{h}"), m=M,
                                       params=params, model=jm, max_scenes=2,
                                       goal_sampler="off")
        got = trunner.run_rollout_eval(tcfg, cache, out_dir=str(tmp_path / f"port{h}"), m=M,
                                       model=tm, max_scenes=2, goal_sampler="off", device="cpu")
        _assert_farms_close(got, ref, 2, steps)
        for g in sorted(glob.glob(os.path.join(got, "*.metrics.json"))):
            a, b = json.load(open(g)), json.load(open(os.path.join(ref, os.path.basename(g))))
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=k)
        timing = json.load(open(os.path.join(got, "timing_w0.json")))
        assert len(timing) == 2 and all(
            set(r) >= {"format_ms", "rollout_ms", "package_ms", "metrics_ms", "total_ms"}
            for r in timing)
        assert os.path.exists(os.path.join(got, "wosac_metrics.json"))


def test_farm_sampler_matches_jax_with_injected_picks(cache, tmp_path, monkeypatch):
    """goal_sampler='on' (goal heads on): each scene's replica goals picked
    as the JAX farm picks them (its key for scene idx, fold_in(PRNGKey(SEED),
    idx), split as parallel_rollout_with_sampler splits it), over both
    HORIZONS."""
    orig = trunner.parallel_rollout_with_sampler
    for h, (opts, scale, steps) in enumerate(HORIZONS):
        jcfg, tcfg, jm, params, tm = _models(OPTS + opts + GOAL_HEADS, scale)
        ref = jrunner.run_rollout_eval(jcfg, cache, out_dir=str(tmp_path / f"jax{h}"), m=M,
                                       params=params, model=jm, max_scenes=2,
                                       goal_sampler="on", compute_metrics=False)
        N = tcfg.DATASET.FORMAT.PAD.NUM_AGENTS
        k_eff = min(3, tcfg.MODEL.DECODER.GOAL_PRED.K)
        picks = [torch.from_numpy(np.array(jax.random.randint(
            jax.random.split(jax.random.fold_in(jax.random.PRNGKey(jcfg.SEED), idx), 4)[2],
            (1, M, N), 0, k_eff))) for idx in range(2)]
        monkeypatch.setattr(trunner, "parallel_rollout_with_sampler",
                            lambda *a, **kw: orig(*a, **kw, picks=picks.pop(0)))
        got = trunner.run_rollout_eval(tcfg, cache, out_dir=str(tmp_path / f"port{h}"), m=M,
                                       model=tm, max_scenes=2, goal_sampler="on",
                                       compute_metrics=False, device="cpu")
        assert picks == []
        _assert_farms_close(got, ref, 2, steps)


def test_farm_sharding_resume_and_failures(cache, tmp_path, monkeypatch):
    """Workers 0 and 1 of 2 write the W=1 run's files bit for bit (each
    scene's generator depends on (SEED, idx) alone); skip_existing reruns
    nothing and keeps the aggregate; a failing scene is skipped, unless
    it exceeds max_failures."""
    _, tcfg, _, _, tm = _models(OPTS + ["ROLLOUT.POLICY.TOP_K", "3"])
    kw = dict(m=M, model=tm, device="cpu")
    one = trunner.run_rollout_eval(tcfg, cache, out_dir=str(tmp_path / "w1"), **kw)
    two = str(tmp_path / "w2")
    for w in (0, 1):
        trunner.run_rollout_eval(tcfg, cache, out_dir=two, worker_id=w, num_workers=2, **kw)
    assert len(_npz(one)) == 4
    assert [os.path.basename(p) for p in _npz(two)] == [os.path.basename(p) for p in _npz(one)]
    for a, b in zip(_npz(one), _npz(two)):
        za, zb = np.load(a), np.load(b)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    a0 = [json.load(open(os.path.join(two, f"timing_w{w}.json"))) for w in (0, 1)]
    assert [len(t) for t in a0] == [2, 2]

    calls = []
    orig = trunner._rollout_one_scene
    monkeypatch.setattr(trunner, "_rollout_one_scene",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    agg = json.load(open(os.path.join(one, "wosac_metrics.json")))
    trunner.run_rollout_eval(tcfg, cache, out_dir=one, skip_existing=True, **kw)
    assert calls == []
    assert json.load(open(os.path.join(one, "wosac_metrics.json"))) == agg

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(trunner, "_rollout_one_scene", boom)
    out = trunner.run_rollout_eval(tcfg, cache, out_dir=str(tmp_path / "r2"), max_scenes=2, **kw)
    assert _npz(out) == []
    with pytest.raises(RuntimeError, match="injected"):
        trunner.run_rollout_eval(tcfg, cache, out_dir=str(tmp_path / "r3"), max_scenes=2,
                                 max_failures=0, **kw)
    with pytest.raises(ValueError, match="GOAL_PRED"):
        trunner.run_rollout_eval(tcfg, cache, out_dir=str(tmp_path / "r4"), goal_sampler="on",
                                 **kw)


def test_rollout_request_roundtrip(cache, tmp_path):
    """Trainer.submit_rollout_request writes a checkpoint and a request with
    the JAX package's fields; serve_rollout_requests claims it, restores
    the checkpoint over a fresh init and writes the rollouts
    (reference: callbacks.py:373-399)."""
    from prosim_torch.train.trainer import Trainer, find_latest_checkpoint

    opts = OPTS + ["EXPERIMENT_DIR", str(tmp_path), "ROLLOUT_REQUEST_PATH",
                   str(tmp_path / "requests"), "ROLLOUT.SAMPLE_NUM", str(M)]
    cfg = get_config(opts=opts)
    trainer = Trainer(cfg, device="cpu")
    trainer.setup(seed=9)
    req_path = trainer.submit_rollout_request(epoch=3)
    req = json.load(open(req_path))
    assert set(req) == {"ckpt_path", "exp_folder", "time_str", "epoch", "global_step", "m"}
    assert os.path.isfile(req["ckpt_path"]) and req["m"] == M
    assert find_latest_checkpoint(trainer.run_dir) is not None

    restored = trunner.restore_eval_params(cfg, req["ckpt_path"], device="cpu")
    own = trainer.model.state_dict()
    assert all(torch.equal(v, own[k]) for k, v in restored.state_dict().items())

    n = trunner.serve_rollout_requests(cfg, cache, once=True, max_scenes=1,
                                       compute_metrics=False, device="cpu")
    assert n == 1
    out_dir = os.path.join(req["exp_folder"], "rollouts_ep3")
    assert len(_npz(out_dir)) == 1
    assert not os.path.exists(req_path)  # claimed (renamed), not left for other workers
    assert trunner.serve_rollout_requests(cfg, cache, once=True, device="cpu") == 0


def test_cli_data_debug_and_rollout(cache, tmp_path, capsys):
    from prosim_torch.main import run_exp

    opts = OPTS + ["EXPERIMENT_DIR", str(tmp_path), "ROLLOUT.SAMPLE_NUM", str(M),
                   "TRAIN.BATCH_SIZE", "2"]
    run_exp("data_debug", None, opts, cache, device="cpu")
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("batch ")]
    assert len(lines) == 2 and all("B=2" in l for l in lines)
    run_exp("rollout", None, opts, cache, device="cpu")
    cfg = get_config(opts=opts)
    out = os.path.join(str(tmp_path), cfg.EXPERIMENT_NAME, "rollouts")
    assert len(_npz(out)) == 4
    assert os.path.exists(os.path.join(out, "wosac_metrics.json"))


def test_cli_train_and_eval(cache, tmp_path, capsys):
    """run_exp's train (one epoch through Trainer.fit, a checkpoint) and eval
    run types on the cache, on the CPU."""
    from prosim_torch.main import run_exp

    opts = OPTS + ["EXPERIMENT_DIR", str(tmp_path), "TRAIN.BATCH_SIZE", "2",
                   "VAL.BATCH_SIZE", "2", "MAX_EPOCHES", "1", "ROLLOUT.ENABLE", "False"]
    run_exp("train", None, opts, cache, device="cpu")
    run_dir = os.path.join(str(tmp_path), get_config(opts=opts).EXPERIMENT_NAME)
    assert os.path.isfile(os.path.join(run_dir, "ckpt_last.pt"))
    run_exp("eval", None, opts, cache, device="cpu")
    assert "'full_loss'" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(run_dir, "val_metrics.npy"))


def test_serving_entry_points_default_to_cuda():
    from prosim_torch.demo.api import InteractiveSim
    from prosim_torch.main import main, run_exp

    for fn in (trunner.run_rollout_eval, trunner.restore_eval_params,
               trunner.serve_rollout_requests, InteractiveSim.__init__, run_exp):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert "--device" in inspect.getsource(main)
