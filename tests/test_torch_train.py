"""prosim_torch's training path against prosim_tpu's, on the CPU in f32:
the train-mode forward, the losses (paired_mse_k with its goal, offroad and
collision branches, the k-way step loss, GMM NLL), the metrics, gradients
against jax.value_and_grad of the JAX train step's loss, the optimizer
against optax (schedules, clipping, groups), remat and the kernel guards.

configs/no_text.yaml at the widths of tests/test_trainer.py's SMALL_OPTS,
with every dropout rate 0 where the two are compared (the JAX and torch RNG
streams cannot match). Tolerances: outputs within 1e-5 of each output's
largest magnitude, loss terms 1e-5 relative, gradients 1e-4 of each leaf's
largest magnitude (see test_gradients_match_jax for the closed loop's own
conditioning), parameters 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_tpu.train import losses as jlosses
from prosim_tpu.train import metrics as jmetrics
from prosim_tpu.train import optim as joptim
from prosim_tpu.train import safety_losses as jsafety
from prosim_torch.config import get_config
from prosim_torch.data.batch import RoadEdges, SceneBatch
from prosim_torch.data.synthetic import make_synthetic_batch, synthetic_arrays
from prosim_torch.models.prosim import ProSim
from prosim_torch.train import losses as tlosses
from prosim_torch.train import metrics as tmetrics
from prosim_torch.train import optim as toptim
from prosim_torch.train import safety_losses as tsafety
from prosim_torch.train.train_step import make_train_step
from prosim_torch.utils.params import flax_to_state_dict, init_params, load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_TEXT = os.path.join(REPO, "configs/no_text.yaml")
# tests/test_trainer.py's SMALL_OPTS without its text condition
SMALL_OPTS = [
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
NO_DROPOUT = [
    "MODEL.SCENE_ENCODER.ATTN.DROPOUT", "0.0",
    "MODEL.DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.POLICY.ACT_DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.CONDITION_TRANSFORMER.DROPOUT", "0.0",
]
BATCH_KW = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6, num_replan=2)
OUT_TOL = 1e-5    # of the output's largest magnitude
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4   # of the leaf's largest magnitude
PARAM_TOL = 1e-5
UPD_TOL = 1e-2   # of the leaf's largest update


def _host(tree):
    """A JAX result as numpy arrays, on the host before the port's side runs
    (see tests/test_torch_model.py:_host)."""
    return jax.tree.map(np.asarray, tree)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scaled_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(_np(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _configs(opts):
    return jax_get_config(NO_TEXT, opts), get_config(NO_TEXT, opts)


def _jax_side(num_replan, noisy=False):
    """The JAX side once: params, batch, the train step's loss, its terms,
    the forward's outputs and the gradients; with noisy=True the gradients
    again at the params perturbed by 1e-7 relative (the closed loop's own
    conditioning)."""
    opts = SMALL_OPTS + NO_DROPOUT
    jcfg, tcfg = _configs(opts)
    jm = JaxProSim(jcfg)
    jb = jax_synthetic(jcfg, seed=0, **dict(BATCH_KW, num_replan=num_replan))
    params = jm.init(jax.random.PRNGKey(0), jb)
    loss_impl = jlosses.loss_func_dict[jcfg.TASK.MOTION_PRED.LOSS]

    def loss_fn(p, b, k):  # make_train_step's loss_fn, with the output kept
        out = jm.forward(p, b, "train", k)
        terms = loss_impl(b, out, jcfg)
        return terms["full_loss"] * jcfg.TASK.MOTION_PRED.WEIGHT, (terms, out)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    key = jax.random.PRNGKey(1)
    (_, (terms, out)), grads = _host(vg(params, jb, key))
    side = dict(jcfg=jcfg, tcfg=tcfg, jm=jm, jb=jb, params=params, vg=vg, key=key,
                terms=terms, out=out, grads=grads, num_replan=num_replan)
    if noisy:
        perturbed = jax.tree.map(
            lambda x: x * (1 + 1e-7 * jax.random.normal(jax.random.PRNGKey(x.size), x.shape)),
            params)
        side["grads_noisy"] = _host(vg(perturbed, jb, key)[1])
    return side


@pytest.fixture(scope="module")
def ref():
    """The JAX side at the batch's R=2 replan steps."""
    return _jax_side(BATCH_KW["num_replan"], noisy=True)


@pytest.fixture(scope="module")
def ref1():
    """The JAX side at one replan step: no step's rounding feeds the next
    step's inputs."""
    return _jax_side(1)


def _port_grads(side):
    """The port's train-mode forward, loss and backward on a JAX side's params
    and batch."""
    tm = ProSim(side["tcfg"], device="cpu")
    load_flax_params(tm, _host(side["params"]))
    tb = make_synthetic_batch(side["tcfg"], seed=0, device="cpu",
                              **dict(BATCH_KW, num_replan=side["num_replan"]))
    out = tm.forward_train(tb, seed=0)
    terms = tlosses.paired_mse_k(tb, out, side["tcfg"])
    (terms["full_loss"] * side["tcfg"].TASK.MOTION_PRED.WEIGHT).backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    return dict(tm=tm, tb=tb, out=out, terms=terms, grads=grads)


@pytest.fixture(scope="module")
def port(ref):
    return _port_grads(ref)


# ---------------------------------------------------------------- the model

def test_train_forward_matches_jax(ref, port):
    for key in ("motion_pred", "motion_prob", "rollout_traj", "rollout_vel", "reconst_pred"):
        assert port["out"][key].shape == ref["out"][key].shape, key
        assert _scaled_err(port["out"][key], ref["out"][key]) <= OUT_TOL, key
    assert port["out"]["motion_pred"].requires_grad


def test_loss_terms_match_jax(ref, port):
    assert set(port["terms"]) == set(ref["terms"])
    for k, v in ref["terms"].items():
        np.testing.assert_allclose(_np(port["terms"][k]), v, rtol=LOSS_RTOL, atol=0, err_msg=k)
    # the goal-reconstruction loss is on in no_text (GOAL_WEIGHT 0 keeps it
    # out of full_loss) and so are the per-condition breakdowns
    assert {"uncond_goal", "goal_loss_all", "conditional_goal_rollout_pos_loss"} <= set(ref["terms"])


def _worst_grad_leaf(ref_grads, grads, bound_of=lambda name: GRAD_TOL):
    ref_sd = flax_to_state_dict(ref_grads)
    assert set(ref_sd) == set(grads)
    worst = (0.0, None, None)
    for name, g in grads.items():
        assert g is not None, f"{name} got no gradient"
        err = _scaled_err(g, ref_sd[name])
        if err / bound_of(name) > worst[0]:
            worst = (err / bound_of(name), name, err)
    return worst


def test_gradients_match_jax_without_feedback(ref1):
    """At one replan step (no step feeds its rounding into the next step's
    inputs) every leaf within the flat GRAD_TOL of its largest magnitude."""
    worst = _worst_grad_leaf(ref1["grads"], _port_grads(ref1)["grads"])
    assert worst[0] <= 1.0, f"worst leaf {worst[1]}: error {worst[2]:.3e} of its max"


def test_gradients_match_jax(ref, port):
    """At R=2 replan steps the closed loop feeds step 0's rounding into step
    1's inputs, and the gradient is discontinuous in them (ReLU kinks, the
    huber branch): at some leaves the JAX package's own gradient moves by
    more than GRAD_TOL of its largest when its weights move by 1e-7
    relative (to 2.5e-4 at this seed, 9.1e-4 at seed 3: PERF.md, by
    scripts/train_grad_parity.py). So each leaf is held to max(GRAD_TOL,
    twice that movement of its own); test_gradients_match_jax_without_feedback
    holds every leaf to GRAD_TOL."""
    ref_sd = flax_to_state_dict(ref["grads"])
    noisy_sd = flax_to_state_dict(ref["grads_noisy"])
    own = {n: _scaled_err(noisy_sd[n], ref_sd[n]) for n in ref_sd}
    worst = _worst_grad_leaf(ref["grads"], port["grads"], lambda n: max(GRAD_TOL, 2 * own[n]))
    assert worst[0] <= 1.0, (f"worst leaf {worst[1]}: error {worst[2]:.3e} of its max, "
                             f"the JAX package's own movement {own[worst[1]]:.3e}")


def test_select_k_emd_train_picks_the_mode_nearest_the_logged_goal():
    """prosim_tpu/models/prosim.py:221-224: argmin of the distance to
    io_pairs.goal[:, 0], ties to the lower index."""
    from types import SimpleNamespace

    rng = np.random.default_rng(3)
    B, N, K, D = 2, 5, 4, 8
    gp = rng.normal(size=(B, N, K, 2)).astype(np.float32)
    gp[0, 1, 3] = gp[0, 1, 1]  # a tie
    emd = {"emd": rng.normal(size=(B, N, K, D)).astype(np.float32),
           "goal_prob": rng.normal(size=(B, N, K)).astype(np.float32), "goal_point": gp}
    goal = rng.normal(size=(B, 3, N, 2)).astype(np.float32)
    goal[0, 0, 1] = gp[0, 1, 1]
    jcfg, tcfg = _configs(SMALL_OPTS)
    jref = _host(JaxProSim(jcfg).select_k_emd(
        {k: jnp.asarray(v) for k, v in emd.items()},
        SimpleNamespace(io_pairs=SimpleNamespace(goal=jnp.asarray(goal))), "train", None))
    got = ProSim(tcfg, device="cpu").select_k_emd(
        {k: torch.from_numpy(v) for k, v in emd.items()},
        SimpleNamespace(io_pairs=SimpleNamespace(goal=torch.from_numpy(goal))), "train", None)
    assert int(got["select_idx"][0, 1]) == 1
    for key in ("select_idx", "emd", "goal"):
        np.testing.assert_array_equal(got[key].numpy(), jref[key])


def test_remat_policies_give_the_same_gradients():
    """TRAIN.REMAT_POLICY full and dots against none, at dropout 0.1: each
    checkpointed region rebuilds its dropout generator from its seed, so
    the recompute draws the same masks."""
    grads = {}
    for pol in ("none", "full", "dots"):
        cfg = get_config(NO_TEXT, SMALL_OPTS + ["TRAIN.REMAT_POLICY", pol])
        model = ProSim(cfg, device="cpu")
        init_params(model, seed=0)
        batch = make_synthetic_batch(cfg, seed=1, device="cpu", **BATCH_KW)
        out = model.forward_train(batch, seed=5)
        tlosses.paired_mse_k(batch, out, cfg)["full_loss"].backward()
        grads[pol] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    assert len(grads["none"]) > 100
    for pol in ("full", "dots"):
        assert set(grads[pol]) == set(grads["none"])
        for n, g in grads["none"].items():
            torch.testing.assert_close(grads[pol][n], g, rtol=1e-6, atol=1e-6, msg=f"{pol}: {n}")


def test_dropout_draws_from_its_generator():
    from prosim_torch.ops.attention import dropout

    x = torch.ones(200_000)
    a = dropout(x, 0.1, torch.Generator().manual_seed(4))
    b = dropout(x, 0.1, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.9))
    assert dropout(x, 0.0, None) is x


def test_train_mode_differs_from_eval_only_by_dropout():
    """At dropout 0 the train-mode forward equals the eval forward (TOP_K 1,
    no goal heads); at the default 0.1 it does not, and its seed decides."""
    cfg = get_config(NO_TEXT, SMALL_OPTS + NO_DROPOUT)
    model = ProSim(cfg, device="cpu")
    init_params(model, seed=0)
    batch = make_synthetic_batch(cfg, seed=2, device="cpu", **BATCH_KW)
    with torch.no_grad():
        train = model.forward_train(batch, seed=1)
    val = model(batch, mode="val")
    torch.testing.assert_close(train["rollout_traj"], val["rollout_traj"], rtol=1e-5, atol=1e-5)
    cfg = get_config(NO_TEXT, SMALL_OPTS)
    model = ProSim(cfg, device="cpu")
    init_params(model, seed=0)
    with torch.no_grad():
        a, b, c = (model.forward_train(batch, seed=s)["motion_pred"] for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


# -------------------------------------------------------------- kernel guards

def test_kernel_wrappers_refuse_inputs_that_require_grad():
    from prosim_torch.ops.edge_attn import edge_attn_core
    from prosim_torch.ops.fused_stack import fused_two_site_stack

    B, S, Q, K, H, D = 1, 5, 3, 4, 2, 8
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(B, S, D, generator=g), torch.randint(0, S, (B, Q, K), generator=g,
                                                             dtype=torch.int32),
            torch.randn(B, Q, K, 6, generator=g), torch.randn(B, Q, H, D, generator=g),
            torch.randn(B, Q, H, 6, generator=g), torch.ones(B, Q, K, dtype=torch.bool)]
    edge_attn_core(*args, 0.5)  # nothing requires grad
    args[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        edge_attn_core(*args, 0.5)
    with torch.no_grad():
        edge_attn_core(*args, 0.5)
    x = torch.randn(B, Q, D, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_two_site_stack(x, (args[0], args[1], None, args[5]), (args[0], args[1], None,
                                                                     args[5]),
                             [], [], num_heads=H, head_dim=4)


# --------------------------------------------------------------- the losses

def _loss_inputs(seed, D, R=2, K=2, road_edges=False):
    """Random motion outputs [R, B, N, K, S, D] and a synthetic batch, for
    both packages."""
    jcfg, tcfg = _configs(SMALL_OPTS)
    rng = np.random.default_rng(seed)
    kw = dict(BATCH_KW, num_replan=R)
    arrays = synthetic_arrays(tcfg, seed=seed, **kw)
    jb = jax_synthetic(jcfg, seed=seed, **kw)
    B, N = arrays["prompt"]["mask"].shape
    S = jcfg.DATASET.FORMAT.TARGET.STEPS
    out = {"motion_pred": (rng.normal(size=(R, B, N, K, S, D)) * 2).astype(np.float32),
           "motion_prob": rng.normal(size=(R, B, N, K)).astype(np.float32)}
    if road_edges:
        E = 12
        pts = (rng.normal(size=(B, E, 2)) * 20).astype(np.float32)
        edges = dict(pts=pts, nxt=pts + (rng.normal(size=(B, E, 2)) * 5).astype(np.float32),
                     valid=rng.random((B, E)) > 0.2)
        arrays["road_edges"] = edges
        from prosim_tpu.data.batch import RoadEdges as JaxRoadEdges

        jb = jb.replace(road_edges=JaxRoadEdges(**{k: jnp.asarray(v) for k, v in edges.items()}))
    tb = SceneBatch.from_numpy(arrays)
    return jb, tb, out


@pytest.mark.parametrize("opts", [
    pytest.param([], id="rollout"),
    pytest.param(["LOSS.ROLLOUT_TRAJ.USE_OFFROAD_LOSS", "True",
                  "LOSS.ROLLOUT_TRAJ.USE_COLLISION_LOSS", "True"], id="safety_centerline"),
    pytest.param(["LOSS.ROLLOUT_TRAJ.USE_OFFROAD_LOSS", "True",
                  "LOSS.ROLLOUT_TRAJ.USE_COLLISION_LOSS", "True",
                  "LOSS.ROLLOUT_TRAJ.COLLISION_VEHICLE_ONLY", "False",
                  "DATASET.USE_WAYMO_ROAD_EDGE", "True"], id="safety_road_edges"),
    pytest.param(["LOSS.ROLLOUT_TRAJ.ENABLE", "False", "LOSS.STEP_TRAJ.POS_WEIGHT", "1.0",
                  "LOSS.STEP_TRAJ.HEAD_WEIGHT", "1.0", "LOSS.STEP_TRAJ.CLS_WEIGHT", "1.0",
                  "LOSS.STEP_TRAJ.VEL_WEIGHT", "1.0"], id="step_k_way"),
    pytest.param(["MODEL.POLICY.ACT_DECODER.TRAJ.PRED_GMM", "True"], id="rollout_gmm"),
    pytest.param(["MODEL.POLICY.ACT_DECODER.TRAJ.PRED_GMM", "True", "LOSS.ROLLOUT_TRAJ.ENABLE",
                  "False", "LOSS.STEP_TRAJ.POS_WEIGHT", "1.0"], id="step_k_way_gmm"),
])
def test_paired_mse_k_branches_match_jax(opts):
    jcfg, tcfg = _configs(SMALL_OPTS + opts)
    D = 5 + 3 * jcfg.MODEL.POLICY.ACT_DECODER.TRAJ.PRED_GMM
    jb, tb, out = _loss_inputs(7, D, road_edges=True)
    ref = _host(jax.jit(lambda b, o: jlosses.paired_mse_k(b, o, jcfg))(jb, out))
    got = tlosses.paired_mse_k(tb, {k: torch.from_numpy(v) for k, v in out.items()}, tcfg)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(_np(got[k]), v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    if "safety" in opts.__repr__():
        assert {"rollout_offroad_loss", "rollout_collision_loss"} <= set(ref)
        assert float(ref["rollout_collision_loss"]) > 0


def test_goal_losses_match_jax():
    """goal_recon_loss (a text condition marks the conditioned agents) and
    goal_prob_pred_loss with CLS_WEIGHT and the spread regulariser on."""
    opts = SMALL_OPTS + ["LOSS.GOAL_DIST_PRED.ENABLE", "True", "LOSS.GOAL_DIST_PRED.VAR_WEIGHT",
                         "0.5"]
    jcfg, tcfg = _configs(opts)
    jb, tb, out = _loss_inputs(8, 5)
    rng = np.random.default_rng(9)
    B, N = tb.prompt.mask.shape
    extra = {"goal_point": (rng.normal(size=(B, N, 4, 2)) * 30).astype(np.float32),
             "goal_prob": rng.normal(size=(B, N, 4)).astype(np.float32),
             "reconst_pred": (rng.normal(size=(2, B, N, 2)) * 30).astype(np.float32)}
    pm = rng.random((B, N)) > 0.5
    jb = jb.replace(conditions={**jb.conditions, "goal_OneText": {"prompt_mask": jnp.asarray(pm)}})
    tb = tb.replace(conditions={**tb.conditions, "goal_OneText": {"prompt_mask": torch.from_numpy(pm)}})
    out.update(extra)
    ref = _host(jax.jit(lambda b, o: jlosses.paired_mse_k(b, o, jcfg))(jb, out))
    got = tlosses.paired_mse_k(tb, {k: torch.from_numpy(v) for k, v in out.items()}, tcfg)
    assert {"goal_dist_all", "goal_dist_neg_logvar", "cond_goal", "uncond_goal"} <= set(ref)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(_np(got[k]), v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


def test_safety_losses_match_jax_on_hand_built_edges():
    """A square road of four edges (drivable area on their left) and agents
    inside, across and outside it; the signed distance, both offroad losses
    and the collision loss with and without the logged-trajectory mask."""
    sq = np.array([[0, 0], [40, 0], [40, 40], [0, 40]], np.float32)
    pts = np.stack([sq, sq])                                   # [B=2, E=4, 2]
    nxt = np.roll(pts, -1, axis=1)
    valid = np.array([[True] * 4, [True, True, True, False]])
    xy = np.array([[[20, 20], [39, 20], [45, 20], [20, 20.5]],
                   [[5, 5], [-3, 10], [20, 41], [6, 5.5]]], np.float32)  # [B, N=4, 2]
    T = 30
    rng = np.random.default_rng(11)
    traj = np.concatenate([xy[:, :, None] + np.linspace(0, 1, T, dtype=np.float32)[:, None]
                           * rng.normal(size=(2, 4, 1, 2)).astype(np.float32),
                           rng.normal(size=(2, 4, T, 1)).astype(np.float32)], -1)
    ext = np.abs(rng.normal(size=(2, 4, 2)) * 2 + 3).astype(np.float32)
    mask = np.array([[True, True, True, True], [True, True, True, False]])
    types = np.array([[1, 1, 2, 1], [1, 1, 1, 1]], np.int32)
    gt = (traj + rng.normal(size=traj.shape).astype(np.float32) * 0.5).astype(np.float32)
    J, Tt = jnp.asarray, torch.from_numpy

    sd_ref = _host(jax.jit(jax.vmap(jsafety.signed_distance_to_edges))(J(xy), J(pts), J(nxt),
                                                                        J(valid)))
    sd = tsafety.signed_distance_to_edges(Tt(xy), Tt(pts), Tt(nxt), Tt(valid))
    np.testing.assert_allclose(sd.numpy(), sd_ref, rtol=1e-6, atol=1e-5)
    assert sd[0, 0] < 0 < sd[0, 2]  # inside the square, outside it
    np.testing.assert_allclose(
        tsafety.box_corners(Tt(xy), Tt(traj[:, :, 0, 2]), Tt(ext)).numpy(),
        _host(jax.jit(jsafety.box_corners)(J(xy), J(traj[:, :, 0, 2]), J(ext))), rtol=1e-6,
        atol=1e-5)
    cases = [
        ("offroad_loss", dict(t_sample=10), dict(t_sample=10)),
        ("offroad_loss", dict(t_sample=3, margin=1.0, gt_offroad=J(mask[:, ::-1].copy())),
         dict(t_sample=3, margin=1.0, gt_offroad=Tt(mask[:, ::-1].copy()))),
        ("offroad_loss_centerline", dict(margin=3.0), dict(margin=3.0)),
        ("offroad_loss_centerline", dict(margin=1.0, gt_traj_xyh=J(gt), t_sample=4),
         dict(margin=1.0, gt_traj_xyh=Tt(gt), t_sample=4)),
    ]
    for fn, jkw, tkw in cases:
        ref = float(jax.jit(lambda *a, kw=jkw: getattr(jsafety, fn)(*a, **kw))(
            J(traj), J(ext), J(mask), J(pts), J(nxt), J(valid)))
        got = float(getattr(tsafety, fn)(Tt(traj), Tt(ext), Tt(mask), Tt(pts), Tt(nxt), Tt(valid),
                                         **tkw))
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-6), (fn, jkw.keys())
    for kw in (dict(), dict(vehicle_only=False, k=2, threshold=0.5), dict(gt_traj_xyh="gt")):
        jkw = {k: (J(gt) if v == "gt" else v) for k, v in kw.items()}
        tkw = {k: (Tt(gt) if v == "gt" else v) for k, v in kw.items()}
        ref = float(jax.jit(lambda *a, kw=jkw: jsafety.collision_loss(*a, **kw))(
            J(traj), J(ext), J(mask), J(types)))
        got = float(tsafety.collision_loss(Tt(traj), Tt(ext), Tt(mask), agent_types=Tt(types),
                                           **tkw))
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-6), kw
        assert "gt_traj_xyh" in kw or got > 0  # agents 0 and 3 of scene 0 overlap


def test_rollout_traj_and_gmm_nll_match_jax():
    rng = np.random.default_rng(12)
    chunks = rng.normal(size=(2, 3, 4, 10, 5)).astype(np.float32)
    np.testing.assert_allclose(tlosses.rollout_traj(torch.from_numpy(chunks), 10).numpy(),
                               _host(jax.jit(jlosses.rollout_traj, static_argnums=1)(chunks, 10)),
                               rtol=1e-5, atol=1e-5)
    tgt, pred = rng.normal(size=(2, 7, 2)).astype(np.float32)
    gmm = (rng.normal(size=(7, 3)) * 3).astype(np.float32)  # clipped log-stds and rho
    np.testing.assert_allclose(
        tlosses.gmm_nll(*map(torch.from_numpy, (tgt, pred, gmm))).numpy(),
        np.asarray(jlosses.gmm_nll(*map(jnp.asarray, (tgt, pred, gmm)))), rtol=1e-5, atol=1e-6)


def test_metrics_match_jax():
    jcfg, tcfg = _configs(SMALL_OPTS)
    jb, tb, out = _loss_inputs(13, 5, K=3)
    ref = _host(jax.jit(lambda b, o: jmetrics.pair_traj_pred_update(b, o, jcfg))(jb, out))
    got = tmetrics.pair_traj_pred_update(tb, {k: torch.from_numpy(v) for k, v in out.items()},
                                         tcfg)
    assert set(got) == set(ref) and "rollout_ade_goal" in got
    for k, (s, c) in ref.items():
        assert float(got[k][1]) == float(c), k
        assert float(got[k][0]) == pytest.approx(float(s), rel=1e-5), k
    merged = tmetrics.merge_metric_states([got, got])
    assert tmetrics.compute_metrics(merged) == pytest.approx(
        jmetrics.compute_metrics(jmetrics.merge_metric_states([ref, ref])), rel=1e-5)
    ego = tmetrics.ego_traj_pred_update(tb, {k: torch.from_numpy(v) for k, v in out.items()}, tcfg)
    assert set(ego) == {f"ego_{k}" for k in ("ade", "fde", "min_ade", "min_fde")}


# ------------------------------------------------------------- the optimizer

def test_schedules_match_optax():
    warm, total, lr = 25, 400, 3e-4
    cases = [
        (toptim.warmup_cos2_schedule(lr, warm, total), joptim.warmup_cos2_schedule(lr, warm, total),
         (0, 1, warm - 1, warm, warm + 1, total // 2, total)),
        (toptim.piecewise_constant_schedule(lr, {100: 0.1, 300: 0.1}),
         optax.piecewise_constant_schedule(lr, {100: 0.1, 300: 0.1}), (0, 99, 100, 299, 300, 400)),
        (toptim.cosine_decay_schedule(lr, total), optax.cosine_decay_schedule(lr, total),
         (0, 1, total // 3, total, total + 5)),
    ]
    for ours, theirs, steps in cases:
        for s in steps:
            assert ours(s) == pytest.approx(float(theirs(s)), rel=1e-6, abs=0), s
    assert toptim.warmup_cos2_schedule(lr, warm, total)(0) == 0.0


@pytest.mark.parametrize("scale", [0.01, 30.0], ids=["below", "above"])
def test_clipping_matches_optax(scale):
    rng = np.random.default_rng(14)
    arrays = [(rng.normal(size=s) * scale).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(0.5).update([jnp.asarray(a) for a in arrays], None)
    params = [torch.nn.Parameter(torch.zeros(a.shape)) for a in arrays]
    for p, a in zip(params, arrays):
        p.grad = torch.from_numpy(a.copy())
    norm = toptim.clip_grad_norm(params, 0.5)
    assert float(norm) == pytest.approx(float(optax.global_norm(arrays)), rel=1e-6)
    assert (float(norm) > 0.5) == (scale > 1)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6, atol=0)


def test_param_groups_match_jax_labels(ref):
    """Each parameter's group is the JAX package's label of its leaf; the
    group LRs follow no_text's scales (cond x10, goal_pred x0)."""
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: joptim._group_of("/".join(str(getattr(k, "key", k)) for k in path),
                                         ref["jcfg"]), _host(ref["params"]))
    tm = ProSim(ref["tcfg"], device="cpu")
    groups = toptim.param_groups(tm, ref["tcfg"])
    by_param = {id(p): g for g, ps in groups.items() for p in ps}
    jlabel = {}
    for path, label in jax.tree_util.tree_leaves_with_path(labels):
        keys = [str(getattr(k, "key", k)) for k in path]
        jlabel[".".join(keys[:-1])] = label
    for name, p in tm.named_parameters():
        assert by_param[id(p)] == jlabel[name.rsplit(".", 1)[0]], name
    assert {g for g, ps in groups.items() if ps} == {"model", "cond", "goal_pred"}
    lrs = toptim.group_lrs(ref["tcfg"])
    assert lrs["cond"] == pytest.approx(10 * lrs["model"]) and lrs["goal_pred"] == 0.0


def _adamw_steps(ref, opts, grads_seq):
    """Two AdamW updates with the given gradients in both packages; returns
    (JAX params, torch model)."""
    jcfg, tcfg = _configs(SMALL_OPTS + NO_DROPOUT + opts)
    params = ref["params"]
    opt = joptim.build_optimizer(jcfg, params)
    state = opt.init(params)
    update = jax.jit(opt.update)
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, _host(params))
    topt, sched = toptim.build_optimizer(tcfg, tm)
    for grads in grads_seq:
        updates, state = update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        sd = flax_to_state_dict(grads)
        for n, p in tm.named_parameters():
            p.grad = torch.from_numpy(sd[n].copy())
        toptim.clip_grad_norm(tm.parameters(), tcfg.TRAIN.GRAD_CLIP)
        topt.step()
        sched.step()
    return _host(params), tm


def _assert_params_close(jparams, tm, tol):
    sd = flax_to_state_dict(jparams)
    worst = max(((float(np.abs(p.detach().numpy() - sd[n]).max()), n)
                 for n, p in tm.named_parameters()))
    assert worst[0] <= tol, f"worst leaf {worst[1]}: {worst[0]:.3e}"


def test_adamw_steps_match_optax_at_full_lr(ref):
    """The same gradients through both optimizers for two steps at the full
    LR from the first step (WARMUP_STEPS 0): the update math, group scales,
    decay of every leaf and clipping (the gradient's norm is ~10x GRAD_CLIP),
    with the goal_pred group frozen at GOAL_MODEL_LR_SCALE 0."""
    g = ref["grads"]
    jparams, tm = _adamw_steps(ref, ["TRAIN.SCHEDULER.WARMUP_STEPS", "0"],
                               [g, jax.tree.map(lambda x: -0.5 * x, g)])
    _assert_params_close(jparams, tm, PARAM_TOL)
    start = flax_to_state_dict(_host(ref["params"]))
    moved = {n: float(np.abs(p.detach().numpy() - start[n]).max()) for n, p in tm.named_parameters()}
    assert all(v == 0.0 for n, v in moved.items() if "pred_mlp" in n)
    assert all(v > 0 for n, v in moved.items() if "pred_mlp" not in n and "weight" in n)


def _optax_moments(state, params):
    """optax's Adam moments (mu, nu) merged over the groups' masked trees,
    by torch parameter name."""
    merged = {}
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    adam = [s for s in jax.tree.leaves(state, is_leaf=is_adam) if is_adam(s)]
    for field in ("mu", "nu"):
        trees = [getattr(s, field) for s in adam]
        merged[field] = flax_to_state_dict(jax.tree.map(
            lambda _, *leaves: np.asarray(next(x for x in leaves
                                               if not isinstance(x, optax.MaskedNode))),
            _host(params), *trees, is_leaf=lambda x: isinstance(x, optax.MaskedNode)))
    return merged


@pytest.mark.parametrize("warmup,steps", [(1, 2), (0, 1)], ids=["warmup1", "warmup0"])
def test_two_train_steps_match_jax(ref1, warmup, steps):
    """Train steps end to end: make_train_step (backward, zero-filled
    gradients, clipping, the AdamW update, then the scheduler step) against
    jax.value_and_grad of the JAX loss and optax, at one replan step (whose
    gradients are held to the flat GRAD_TOL).

    WARMUP_STEPS 1, two steps: the first update takes schedule(0) = 0 and
    moves no parameter at all (a scheduler stepped before the optimizer
    would hand it schedule(1), the full LR); the second runs at the full LR
    with Adam's moments of both gradients. WARMUP_STEPS 0, one step: the
    first update runs at the full LR and moves the parameters.

    After each step: the loss; the gradient norm; Adam's moments, which hold
    the clipped gradients the optimizer was given (a step that skipped
    clipping is off by the clip factor), within GRAD_TOL of each leaf's
    largest (2 GRAD_TOL for the second moment, their squares); and each
    leaf's update p - p0 within UPD_TOL of the leaf's largest JAX update and
    within PARAM_TOL absolute. Adam's first full-LR update is LR * sign(g)
    per element, so the update is compared where the JAX gradient is above
    GRAD_TOL of the leaf's largest, the bound the gradients are held to (a
    correct port may give either sign below it); that rule leaves out no
    whole leaf. (A second full-LR step after a first one is not compared:
    those sign flips move cond-group elements by 2 x 10 LR, and the second
    gradient moves with them.)"""
    jcfg, tcfg = _configs(SMALL_OPTS + NO_DROPOUT + ["TRAIN.SCHEDULER.WARMUP_STEPS", str(warmup)])
    params = ref1["params"]
    opt = joptim.build_optimizer(jcfg, params)
    state = opt.init(params)
    update = jax.jit(opt.update)
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, _host(params))
    topt, sched = toptim.build_optimizer(tcfg, tm)
    step = make_train_step(tm, topt, sched, tcfg)
    tb = make_synthetic_batch(tcfg, seed=0, device="cpu", **dict(BATCH_KW, num_replan=1))
    p0 = flax_to_state_dict(_host(params))
    floor = {}  # elements whose JAX gradient is at or below GRAD_TOL of the leaf's largest
    for i in range(steps):
        (loss, _), grads = ref1["vg"](params, ref1["jb"], ref1["key"])
        g = flax_to_state_dict(_host(grads))
        for n, x in g.items():
            below = np.abs(x) <= GRAD_TOL * np.abs(x).max()
            floor[n] = floor.get(n, below) | below
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        got = step(tb, 0)
        assert float(got["full_loss"]) == pytest.approx(float(loss), rel=LOSS_RTOL), i
        assert float(got["grad_norm"]) == pytest.approx(float(optax.global_norm(grads)), rel=1e-4)
        moments = _optax_moments(state, params)
        pj = flax_to_state_dict(_host(params))
        worst = (0.0, None)
        for n, p in tm.named_parameters():
            st = topt.state[p]
            for field, mine, tol in (("mu", st["exp_avg"], GRAD_TOL),
                                     ("nu", st["exp_avg_sq"], 2 * GRAD_TOL)):
                err = _scaled_err(mine, moments[field][n])
                assert err <= tol, f"step {i} {field} {n}: {err:.3e}"
            mine, theirs = p.detach().numpy() - p0[n], pj[n] - p0[n]
            if warmup == 1 and i == 0:
                assert not mine.any() and not theirs.any(), n  # schedule(0) = 0
            elif "pred_mlp" in n or not theirs.any():
                # the goal_pred group at GOAL_MODEL_LR_SCALE 0, and zero
                # leaves (biases) that the loss does not reach
                assert not mine.any() and not theirs.any(), n
            else:
                diff = np.abs(mine - theirs)[~floor[n]]
                err = float(diff.max(initial=0.0) / np.abs(theirs).max())
                if err > worst[0]:
                    worst = (err, n)
                assert diff.max(initial=0.0) <= PARAM_TOL, f"step {i} {n}: {diff.max():.3e}"
        assert worst[0] <= UPD_TOL, \
            f"step {i}: worst leaf {worst[1]}: {worst[0]:.3e} of its largest update"


def test_road_edges_ride_in_the_batch():
    arrays = synthetic_arrays(get_config(NO_TEXT, SMALL_OPTS), seed=0, **BATCH_KW)
    arrays["road_edges"] = dict(pts=np.zeros((2, 3, 2), np.float32),
                                nxt=np.ones((2, 3, 2), np.float32),
                                valid=np.array([[True, False, True]] * 2))
    batch = SceneBatch.from_numpy(arrays)
    assert isinstance(batch.road_edges, RoadEdges)
    assert batch.to("cpu").road_edges.valid.dtype == torch.bool
    half = batch.map_batch_leaves(lambda x: x[:1])
    assert half.road_edges.pts.shape == (1, 3, 2)
    assert SceneBatch.from_numpy({k: v for k, v in arrays.items() if k != "road_edges"}) \
        .road_edges is None
