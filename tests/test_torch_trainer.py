"""prosim_torch's trainer and M-replica validation rollout on the CPU: the
replica sim metrics and the goal sampler against prosim_tpu's, the sampler
rollout against prosim_tpu's at TOP_K=1 (picks injected: the RNG streams
cannot match), and the trainer itself (fit, evaluate, rollout_callback,
checkpoints and an exact resume). configs/no_text.yaml at the widths of
tests/test_trainer.py. Tolerances: metrics and conditions 1e-5, the
sampler rollout within 1e-5 of its largest magnitude.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_tpu.rollout import rollout as jr
from prosim_torch.config import get_config
from prosim_torch.data.synthetic import make_synthetic_batch
from prosim_torch.models.prosim import ProSim
from prosim_torch.rollout import rollout as tr
from prosim_torch.train.trainer import Trainer, find_latest_checkpoint
from prosim_torch.utils.params import load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_TEXT = os.path.join(REPO, "configs/no_text.yaml")
SMALL_OPTS = [  # tests/test_trainer.py's SMALL_OPTS without its text condition
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1",
    "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "2",
    "MODEL.DECODER.ATTN.FF_DIM", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "2",
    "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "4",
]
GOAL_HEADS = ["MODEL.DECODER.GOAL_PRED.ENABLE", "True", "MODEL.DECODER.GOAL_PRED.K", "4"]
BATCH_KW = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6, num_replan=2)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _scaled_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got.detach().numpy() - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------- replica sim metrics

def _replica_inputs(seed, B, m, N, T):
    rng = np.random.default_rng(seed)
    th = rng.normal(size=(B * m, N, T)).astype(np.float32)
    traj = np.concatenate([np.cumsum(rng.normal(size=(B * m, N, T, 2)), 2),
                           np.sin(th)[..., None], np.cos(th)[..., None]], -1).astype(np.float32)
    output = dict(rollout_traj=traj,
                  init_pos=(rng.normal(size=(B * m, N, 2)) * 5).astype(np.float32),
                  init_heading=rng.normal(size=(B * m, N)).astype(np.float32),
                  agent_mask=np.repeat(rng.random((B, N)) > 0.2, m, axis=0))
    batch = dict(mask=output["agent_mask"][::m].copy(),
                 full_traj_xy=np.cumsum(rng.normal(size=(B, N, T + 3, 2)), 2).astype(np.float32),
                 full_traj_valid=rng.random((B, N, T + 3)) > 0.1,
                 extent=(np.abs(rng.normal(size=(B, N, 2))) * 3 + 1).astype(np.float32),
                 goal_point=(rng.normal(size=(B, N, 2)) * 8).astype(np.float32))
    return output, batch


def _ns_batch(arrays, conv):
    return SimpleNamespace(
        prompt=SimpleNamespace(mask=conv(arrays["mask"]), extent=conv(arrays["extent"]),
                               goal_point=conv(arrays["goal_point"])),
        io_pairs=SimpleNamespace(full_traj_xy=conv(arrays["full_traj_xy"]),
                                 full_traj_valid=conv(arrays["full_traj_valid"])))


def test_replica_rollout_metrics_match_jax():
    output, batch = _replica_inputs(0, B=2, m=3, N=7, T=80)
    ref = _host(jax.jit(lambda o, b: jr.replica_rollout_metrics(o, _ns_batch(b, jnp.asarray), 3))(
        output, batch))
    got = tr.replica_rollout_metrics({k: torch.from_numpy(v) for k, v in output.items()},
                                     _ns_batch(batch, torch.from_numpy), 3)
    assert set(got) == set(ref) == {"min_ade", "mean_ade", "crash_rate", "goal_reach_rate"}
    for k, v in ref.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    assert float(got["min_ade"]) < float(got["mean_ade"])


def test_crash_rate_counts_only_real_steps():
    """T = 20: the JAX package pads time to a multiple of 8 with every agent
    at one point, so every agent reads as crashed (1.0); five of the eight
    agents really touch another one (0.625)."""
    N, T = 8, 20
    xy = np.stack([np.stack([np.full(T, 100.0 * i), np.zeros(T)], -1) for i in range(N)])
    xy[1, 5] = xy[0, 5] + 0.5          # 0 and 1 touch at t = 5
    xy[3, 12] = xy[2, 12] + [0.3, 0]   # 2 and 3 touch at t = 12
    xy[4, 19] = xy[3, 19] + [0, 0.2]   # 3 and 4 touch at t = 19, the last step
    traj = np.concatenate([xy, np.zeros((N, T, 1)), np.ones((N, T, 1))], -1)[None]
    output = dict(rollout_traj=traj.astype(np.float32), init_pos=np.zeros((1, N, 2), np.float32),
                  init_heading=np.zeros((1, N), np.float32), agent_mask=np.ones((1, N), bool))
    batch = dict(mask=np.ones((1, N), bool), full_traj_xy=np.zeros((1, N, T, 2), np.float32),
                 full_traj_valid=np.ones((1, N, T), bool),
                 extent=np.full((1, N, 2), [4.0, 2.0], np.float32),
                 goal_point=np.full((1, N, 2), 1e4, np.float32))
    got = tr.replica_rollout_metrics({k: torch.from_numpy(v) for k, v in output.items()},
                                     _ns_batch(batch, torch.from_numpy), 1)
    ref = _host(jr.replica_rollout_metrics(output, _ns_batch(batch, jnp.asarray), 1))
    assert float(got["crash_rate"]) == 0.625
    assert float(ref["crash_rate"]) == 1.0


def test_sample_goal_conditions_match_jax_with_injected_picks():
    rng = np.random.default_rng(1)
    B, N, K, m, top_k = 2, 5, 6, 3, 4
    gp = (rng.normal(size=(B, N, K, 2)) * 8).astype(np.float32)
    gp[0, 0, :] = 1.0  # within stop_smooth: snaps to the origin
    prob = np.round(rng.normal(size=(B, N, K)), 1).astype(np.float32)  # with ties
    mask = rng.random((B, N)) > 0.3
    key = jax.random.PRNGKey(5)
    ref = _host(jr.sample_goal_conditions(jnp.asarray(gp), jnp.asarray(prob), jnp.asarray(mask), m,
                                          key, top_k=top_k))
    picks = np.array(jax.random.randint(key, (B, m, N), 0, top_k))  # JAX's own draw
    got = tr.sample_goal_conditions(torch.from_numpy(gp), torch.from_numpy(prob),
                                    torch.from_numpy(mask), m, top_k=top_k,
                                    picks=torch.from_numpy(picks))
    for f in ("feat", "mask", "prompt_idx", "prompt_mask"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f), rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    assert (got.feat[0, 0, :2] == 0).all()
    drawn = tr.sample_goal_conditions(torch.from_numpy(gp), torch.from_numpy(prob),
                                      torch.from_numpy(mask), m, torch.Generator().manual_seed(0))
    assert drawn.feat.shape == (B * m, N, 3)


@pytest.mark.parametrize("opts", [
    pytest.param([], id="policy_decoder"),
    pytest.param(["MODEL.CONDITION_TRANSFORMER.CONDITION_LOCATIONS", "['prompt_encoder']"],
                 id="prompt_encoder"),
])
def test_parallel_rollout_with_sampler_matches_jax(opts):
    opts = SMALL_OPTS + GOAL_HEADS + opts
    jcfg, tcfg = jax_get_config(NO_TEXT, opts), get_config(NO_TEXT, opts)
    jm = JaxProSim(jcfg)
    jb = jax_synthetic(jcfg, seed=3, **BATCH_KW)
    params = jm.init(jax.random.PRNGKey(0), jb)
    m, top_k, key = 3, 2, jax.random.PRNGKey(9)
    ref = _host(jax.jit(lambda p, b, k: jr.parallel_rollout_with_sampler(
        jm, p, b, m, k, jm, p, top_k=top_k))(params, jb, key))
    B, N = jb.prompt.mask.shape
    picks = np.array(jax.random.randint(jax.random.split(key, 4)[2], (B, m, N), 0, top_k))
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, _host(params))
    tb = make_synthetic_batch(tcfg, seed=3, device="cpu", **BATCH_KW)
    got = tr.parallel_rollout_with_sampler(tm, tb, m, tm, top_k=top_k,
                                           picks=torch.from_numpy(picks))
    mask = np.repeat(np.asarray(jb.prompt.mask), m, axis=0)
    for k in ("rollout_traj", "motion_pred", "goal_point"):
        assert got[k].shape == ref[k].shape, k
    assert _scaled_err(got["rollout_traj"][torch.from_numpy(mask)],
                       ref["rollout_traj"][mask]) <= 1e-5


# ------------------------------------------------------------------ trainer

def _trainer(tmp, extra=(), name="run"):
    cfg = get_config(NO_TEXT, SMALL_OPTS + [
        "EXPERIMENT_DIR", str(tmp), "EXPERIMENT_NAME", name, "CHECKPOINT_INTERVAL", "1",
        "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.BATCH_SIZE", "2", *extra])
    trainer = Trainer(cfg, device="cpu")
    trainer.setup()
    return trainer


def _batches(cfg, seeds):
    return [make_synthetic_batch(cfg, seed=s, device="cpu", **BATCH_KW) for s in seeds]


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_fit_two_steps_moves_params_and_logs_every_term(tmp_path):
    trainer = _trainer(tmp_path)
    batches = _batches(trainer.config, (0, 1))
    p0 = _params(trainer.model)
    trainer.fit(lambda: iter(batches), max_steps=2)
    assert trainer.step == 2
    p1 = _params(trainer.model)
    moved = {n: float((p1[n] - p0[n]).abs().max()) for n in p0}
    assert max(moved.values()) > 0
    # GOAL_MODEL_LR_SCALE 0.0: the goal-reconstruction head does not move
    assert all(v == 0.0 for n, v in moved.items() if "pred_mlp" in n)
    recs = [json.loads(l) for l in open(trainer.log_path)]
    train = [r for r in recs if "train/full_loss" in r]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["train/full_loss"]) and np.isfinite(r["train/grad_norm"])
               for r in train)
    assert "train/rollout_vel_loss" in train[-1] and "train/uncond_goal" in train[-1]
    assert os.path.isfile(os.path.join(trainer.run_dir, "ckpt_last.pt"))


def test_resume_from_last_is_bitwise_the_uninterrupted_run(tmp_path):
    """Dropout at its default 0.1: the per-step seeds and the optimizer and
    scheduler state come back with the checkpoint."""
    full = _trainer(tmp_path, name="full")
    batches = _batches(full.config, (2, 3, 4))
    full.fit(batches)
    first = _trainer(tmp_path, name="cut")
    first.fit(batches[:1])
    resumed = _trainer(tmp_path, ["LOAD_CHECKPOINT_TRAINER", "True"], name="cut")
    assert resumed.step == 1
    resumed.fit(batches[1:])
    assert resumed.step == full.step == 3
    a, b = _params(full.model), _params(resumed.model)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)
    assert full.scheduler.last_epoch == resumed.scheduler.last_epoch == 3
    assert find_latest_checkpoint(resumed.run_dir).endswith("ckpt_last.pt")


def test_evaluate_and_rollout_callback_are_finite(tmp_path):
    trainer = _trainer(tmp_path, GOAL_HEADS + ["ROLLOUT.ENABLE", "True"])
    batches = _batches(trainer.config, (5,))
    metrics = trainer.evaluate(batches, save_tag="val")
    assert np.isfinite(metrics["full_loss"]) and np.isfinite(metrics["rollout_ade"])
    dump = np.load(os.path.join(trainer.run_dir, "val_metrics.npy"), allow_pickle=True).item()
    assert dump["metrics"]["full_loss"] == metrics["full_loss"]
    for m in (1, 3):  # m = 3 takes the goal sampler (GOAL_PRED on)
        out = trainer.rollout_callback(batches, m=m)
        assert set(out) == {"min_ade", "mean_ade", "crash_rate", "goal_reach_rate"}
        assert all(np.isfinite(v) for v in out.values())
    assert out["min_ade"] <= out["mean_ade"]
    # fit's validation hook runs both
    trainer.fit(batches, val_batches=batches)
    recs = [json.loads(l) for l in open(trainer.log_path)]
    assert any("rollout/min_ade" in r for r in recs[-3:]) and any("val/ade" in r for r in recs)


def test_checkpoint_helpers(tmp_path):
    sd = {"policy.a2p_0.to_q.weight": 1, "ct.text_attn.llm.layers_0.q_proj.weight": 2,
          "ct.text_attn.llm.layers_0.q_proj.lora_a": 3, "ct.text_attn.llm.lora_embed_b": 4,
          "ct.text_attn.prompt_to_llm.weight": 5}
    assert Trainer._strip_frozen_llm(sd) == {k: v for k, v in sd.items() if v != 2}
    assert find_latest_checkpoint(str(tmp_path)) is None
    trainer = _trainer(tmp_path)
    trainer.save_checkpoint("best")
    assert find_latest_checkpoint(trainer.run_dir).endswith("ckpt_best.pt")
    batch = _batches(trainer.config, (0,))[0]
    path = trainer._dump_error_batch(batch, {"full_loss": torch.tensor(float("nan"))})
    dumped = np.load(path)
    assert "batch.prompt.mask" in dumped and np.isnan(dumped["loss/full_loss"])
    trace = trainer.profile(batch, steps=1)
    assert os.path.getsize(trace) > 0
