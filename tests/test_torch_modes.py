"""The modes no shipped configuration reaches, prosim_torch against
prosim_tpu on the CPU in f32: the MLP map and obs encoders and their masked
pool, the 'mlp' obs-update fusion and ATTN_UPDATE's re-attention, the
policy's goal context and its 'mlp', 'cluster', 'vel_pred' and 'goal_pred'
heads. The same seeds, the flax params carried across by load_flax_params,
TOP_K=1 and dropout 0, as tests/test_torch_model.py:_pair. Tolerances:
closed loops within 1e-4 m over 2 replan steps, modules within 1e-5,
gradients within 1e-4 of each leaf's largest magnitude.

The synthetic batches' map vectors are N(0, 1) in every channel; the MLP map
encoder reads channels 4 and 5 as the lane type and the traffic-light state
(embedding rows 0-3, the light shifted by +1), where an id out of range
gives NaN rows in both packages. So its batches carry the formatter's
ranges there: types 0-3, lights -1-2 (`_with_map_ids`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data.batch import SceneTokens as JaxSceneTokens
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
from prosim_tpu.models import scene_encoder as jse
from prosim_tpu.models.policy import PolicyRelPE as JaxPolicy
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_tpu.train import losses as jlosses
from prosim_torch.config import get_config
from prosim_torch.data.batch import SceneTokens
from prosim_torch.data.synthetic import make_synthetic_batch
from prosim_torch.models import scene_encoder as tse
from prosim_torch.models.policy import PolicyRelPE, build_policy
from prosim_torch.models.prosim import ProSim
from prosim_torch.train import losses as tlosses
from prosim_torch.utils.params import flax_to_state_dict, init_params, load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_TEXT = os.path.join(REPO, "configs/no_text.yaml")
SMALL_OPTS = [  # tests/test_torch_train.py's widths: one layer a stack
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
ROLLOUT_TOL = dict(atol=1e-4, rtol=0)
GRAD_TOL = 1e-4  # of the leaf's largest magnitude

MLP_ENC = ["MODEL.SCENE_ENCODER.MAP_TYPE", "mlp", "MODEL.SCENE_ENCODER.OBS_TYPE", "mlp"]
FUSION = ["MODEL.OBS_UPDATE.FUSION", "mlp"]
ATTN_UPDATE = ["MODEL.OBS_UPDATE.ATTN_UPDATE", "True"]
GOAL = ["MODEL.POLICY.ACT_DECODER.CONTEXT.GOAL", "True"]
POSE_EMB = ["MODEL.POLICY.ACT_DECODER.CONTEXT.USE_POSE_EMB", "True"]
FUSED = ["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"]
GOALS = np.array([[10.0, 0.0], [0.0, 10.0], [-10.0, 0.0], [0.0, -10.0]], np.float32)


def _pools(map_pool, obs_pool):
    return MLP_ENC + ["MODEL.MAP_ENCODER.MLP.POOL", map_pool,
                      "MODEL.OBS_ENCODER.MLP.POOL", obs_pool]


def _cluster(path, k=len(GOALS)):
    return ["MODEL.POLICY.ACT_DECODER.TRAJ.PRED_MODE", "cluster",
            "MODEL.POLICY.ACT_DECODER.TRAJ.CLUSTER_PATH", path,
            "MODEL.POLICY.ACT_DECODER.TRAJ.K", str(k)]


def _host(tree):
    """A JAX result as numpy arrays, on the host before the port's side runs
    (see tests/test_torch_model.py:_host)."""
    return jax.tree.map(np.asarray, tree)


def _map_ids(shape, seed):
    """Lane types 0-3 and traffic-light states -1-2, the formatter's ranges."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, shape).astype(np.float32),
            rng.integers(-1, 3, shape).astype(np.float32))


def _with_map_ids(jb, tb, seed=0):
    vec = np.array(jb.init_map.vectors)
    vec[..., 4], vec[..., 5] = _map_ids(vec.shape[:-1], seed)
    jb = jb.replace(init_map=jb.init_map.replace(vectors=jnp.asarray(vec)))
    tb = tb.replace(init_map=tb.init_map.replace(vectors=torch.from_numpy(vec)))
    return jb, tb


def _flax_tree(shapes, sd, prefix=()):
    """The flax param tree of `shapes` (jax.eval_shape of an init) filled
    from a torch state_dict: the inverse of utils/params.py's mapping."""
    out = {}
    for k, v in shapes.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out[k] = _flax_tree(v, sd, path)
            continue
        a = sd[".".join(path[:-1] + ({"kernel": "weight", "scale": "weight",
                                       "embedding": "weight"}.get(k, k),))]
        out[k] = jnp.asarray(a.T if k == "kernel" else a)
        assert out[k].shape == v.shape, path
    return out


def _pair(opts, seed=0, yaml=None, **batch_kw):
    """JAX model, params and batch; the port's model carrying those params,
    and its batch from the same seed, with the map ids in range. The weights
    are the port's seeded init_params draw, laid out as the JAX init's tree
    (jax.eval_shape: an XLA:CPU compile of each JAX init would cost ~10 s)
    and carried back by load_flax_params, which checks that every leaf
    maps onto one parameter of the same shape."""
    jcfg, tcfg = jax_get_config(yaml, opts), get_config(yaml, opts)
    kw = dict(BATCH_KW, **batch_kw)
    jm = JaxProSim(jcfg)
    jb, tb = _with_map_ids(jax_synthetic(jcfg, seed=seed, **kw),
                           make_synthetic_batch(tcfg, seed=seed, device="cpu", **kw), seed)
    tm = ProSim(tcfg, device="cpu")
    init_params(tm, seed=0)
    shapes = jax.eval_shape(jm._init_impl, jax.random.PRNGKey(0), jb)
    params = _flax_tree(shapes, {k: v.numpy() for k, v in tm.state_dict().items()})
    load_flax_params(tm, _host(params))
    return jm, params, jb, tm, tb


# ------------------------------------------------------------- the modules

def test_masked_pool_matches_jax():
    """Invalid entries never count; an empty row pools to 0 ('mean') or to
    the -1e9 fill ('max'); an unknown pool raises."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 5, 6)).astype(np.float32)
    m = rng.random((3, 4, 5)) > 0.4
    m[0, 0] = False  # an empty row
    for pool in ("mean", "max"):
        ref = np.asarray(jse._masked_pool(jnp.asarray(x), jnp.asarray(m), pool))
        got = tse._masked_pool(torch.from_numpy(x), torch.from_numpy(m), pool).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6, err_msg=pool)
    assert (tse._masked_pool(torch.from_numpy(x), torch.from_numpy(m), "mean")[0, 0] == 0).all()
    assert (tse._masked_pool(torch.from_numpy(x), torch.from_numpy(m), "max")[0, 0] == -1e9).all()
    with pytest.raises(ValueError, match="pool"):
        tse._masked_pool(torch.from_numpy(x), torch.from_numpy(m), "sum")


@pytest.mark.parametrize("pool", ["max", "mean", "none"])
def test_mlp_encoders_match_jax(pool):
    """MapEncoderMLP and ObsEncoderMLP as modules: the map's ids in range,
    and one id out of range in each table, which gives NaN rows as flax's
    nn.Embed does; an id in [-4, 0) counts from the end of the table."""
    from prosim_tpu.data.batch import MapInputs as JaxMap
    from prosim_torch.data.batch import MapInputs

    rng = np.random.default_rng(1)
    B, L, P, A, Th, C, D = 2, 5, 7, 4, 11, 9, 16
    vec = rng.normal(size=(B, L, P, 6)).astype(np.float32)
    vec[..., 4], vec[..., 5] = _map_ids((B, L, P), 1)
    vec[0, 1, 2, 4], vec[1, 0, 0, 4], vec[0, 2, 3, 5] = 5.0, -3.0, 3.0  # NaN, from the end, NaN
    mmask = rng.random((B, L, P)) > 0.3
    mmask[0, 1, 2] = mmask[1, 0, 0] = mmask[0, 2, 3] = True
    arrays = dict(vectors=vec, mask=mmask, pos=np.zeros((B, L, 2), np.float32),
                  ori=np.zeros((B, L), np.float32))
    feat = rng.normal(size=(B, A, Th, C)).astype(np.float32)
    smask = rng.random((B, A, Th)) > 0.2
    smask[0, 1] = False
    map_pool = "max" if pool == "none" else pool
    jmap = jse.MapEncoderMLP(D, pool=map_pool)
    jobs = jse.ObsEncoderMLP(D, in_dim=C, hist_steps=Th, pool=pool)
    jm_in = JaxMap(**{k: jnp.asarray(v) for k, v in arrays.items()})
    pm = jmap.init(jax.random.PRNGKey(0), jm_in)
    po = jobs.init(jax.random.PRNGKey(1), jnp.asarray(feat), jnp.asarray(smask))
    ref_map = _host(jmap.apply(pm, jm_in))
    ref_obs = _host(jobs.apply(po, jnp.asarray(feat), jnp.asarray(smask)))

    tmap, tobs = tse.MapEncoderMLP(D, map_pool), tse.ObsEncoderMLP(D, C, Th, pool)
    load_flax_params(tmap, _host(pm["params"]))
    load_flax_params(tobs, _host(po["params"]))
    with torch.no_grad():
        got_map = tmap(MapInputs(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
        got_obs = tobs(torch.from_numpy(feat), torch.from_numpy(smask))
    for got, ref in ((got_map, ref_map), (got_obs, ref_obs)):
        np.testing.assert_array_equal(got[1].numpy(), ref[1])
        assert np.array_equal(np.isnan(got[0].numpy()), np.isnan(ref[0]))
        np.testing.assert_allclose(got[0].numpy(), ref[0], atol=1e-5, rtol=1e-5)
    assert np.isnan(ref_map[0]).any()  # the NaN rows are pooled in


def test_update_obs_gradients_match_jax():
    """update_obs with FUSION 'mlp' and ATTN_UPDATE in training (the
    differentiable branch, dropout 0): the new tokens and the gradients of a
    loss on them, with respect to every leaf of the scene encoder and the
    old tokens, within 1e-5 and 1e-4 of each one's largest magnitude."""
    opts = SMALL_OPTS + NO_DROPOUT + FUSION + ATTN_UPDATE
    jm, params, jb, tm, tb = _pair(opts)
    pse = params["scene_encoder"]
    se = jm.scene_encoder
    rng = np.random.default_rng(2)
    fo = jax.tree.map(lambda x: x[:, 1], jb.fut_obs)
    scene = jax.jit(lambda p: se.apply({"params": p}, jb.init_obs, jb.init_map))(pse)
    w = rng.normal(size=scene.tokens.shape).astype(np.float32)

    def jloss(p, tokens):
        s = JaxSceneTokens(tokens=tokens, pos=scene.pos, ori=scene.ori, mask=scene.mask,
                           num_map=scene.num_map)
        out = se.apply({"params": p}, s, fo.feat, fo.mask, fo.pos, fo.ori, False,
                       method="update_obs", rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out.tokens * w), out.tokens

    (_, ref_tokens), (ref_gp, ref_gt) = _host(
        jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(pse, scene.tokens))

    enc = tm.scene_encoder
    tokens = torch.from_numpy(np.array(scene.tokens)).requires_grad_(True)
    ts = SceneTokens(tokens=tokens, pos=torch.from_numpy(np.array(scene.pos)),
                     ori=torch.from_numpy(np.array(scene.ori)),
                     mask=torch.from_numpy(np.array(scene.mask)), num_map=scene.num_map)
    tfo = tb.fut_obs
    out = enc.update_obs(ts, tfo.feat[:, 1], tfo.mask[:, 1], tfo.pos[:, 1], tfo.ori[:, 1],
                         deterministic=False, generator=torch.Generator().manual_seed(0))
    (out.tokens * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.tokens.detach().numpy(), ref_tokens,
                               atol=1e-5 * np.abs(ref_tokens).max(), rtol=0)
    ref_sd = flax_to_state_dict(ref_gp)
    got = dict(enc.named_parameters())
    for name, p in got.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        ref = ref_sd[name]
        assert np.abs(g - ref).max() <= GRAD_TOL * max(np.abs(ref).max(), 1e-30), name
    for name in ("obs_update_mlp.dense_0.weight", "a2a_0.to_q.weight", "s2s_0.to_v.weight"):
        assert np.abs(ref_sd[name]).max() > 0, name
    np.testing.assert_allclose(tokens.grad.numpy(), ref_gt, atol=GRAD_TOL * np.abs(ref_gt).max(),
                               rtol=0)


@pytest.mark.parametrize("mode,key,dim", [("vel_pred", "init_vel_pred", 2),
                                          ("goal_pred", "goal_pred", 3)])
def test_policy_aux_heads_match_jax(mode, key, dim):
    """The aux heads at the policy level, as tests/test_model.py runs them
    (with goal context here): only their output, no motion_pred; and
    build_policy builds them."""
    B, N, L, A, D = 1, 4, 8, 6, 16
    rng = np.random.default_rng(0)
    arr = dict(tokens=rng.normal(size=(B, L + A, D)).astype(np.float32),
               pos=(rng.normal(size=(B, L + A, 2)) * 20).astype(np.float32),
               ori=rng.normal(size=(B, L + A)).astype(np.float32),
               mask=np.ones((B, L + A), bool))
    emd = {"emd": rng.normal(size=(B, N, D)).astype(np.float32),
           "goal": (rng.normal(size=(B, N, 2)) * 10).astype(np.float32)}
    pose = [(rng.normal(size=(B, N, 2)) * 5).astype(np.float32),
            rng.normal(size=(B, N)).astype(np.float32), np.ones((B, N), bool),
            np.ones((B, N), np.int32)]
    kw = dict(hidden_dim=D, num_layers=1, num_heads=2, head_dim=4, max_neigh=4,
              agent_radius=100.0, map_radius=100.0, edge_func="knn", learnable_pe=False,
              pe_num_freq=4, motion_k=1, pred_steps=5, state_dim=3, pred_mode=mode,
              context_goal=True)
    jpol = JaxPolicy(**kw)
    jargs = ({k: jnp.asarray(v) for k, v in emd.items()},
             JaxSceneTokens(**{k: jnp.asarray(v) for k, v in arr.items()}, num_map=L),
             *map(jnp.asarray, pose))
    params = jax.jit(jpol.init)(jax.random.PRNGKey(0), *jargs)
    ref = _host(jax.jit(jpol.apply)(params, *jargs))
    tpol = PolicyRelPE(**kw)
    load_flax_params(tpol, _host(params["params"]))
    with torch.no_grad():
        got = tpol({k: torch.from_numpy(v) for k, v in emd.items()},
                   SceneTokens(**{k: torch.from_numpy(v) for k, v in arr.items()}, num_map=L),
                   *map(torch.from_numpy, pose))
    assert set(got) == set(ref) == {key}
    assert got[key].shape == (B, N, dim)
    np.testing.assert_allclose(got[key].numpy(), ref[key], atol=1e-5, rtol=1e-5)
    cfg = get_config(opts=SMALL_OPTS + ["MODEL.POLICY.ACT_DECODER.TRAJ.PRED_MODE", mode])
    assert hasattr(build_policy(cfg), "vel_head" if mode == "vel_pred" else "goal_head")


# ------------------------------------------------------------ closed loops

NO_EMD = GOAL + POSE_EMB + ["MODEL.POLICY.ACT_DECODER.CONTEXT.EMD", "False"]


@pytest.mark.parametrize("opts", [
    # each XLA:CPU compile of a JAX model costs ~15 s, so every mode rides
    # in one of five models: every MLP encoder pool, the fusion, the
    # re-attention, each head and each goal context once
    pytest.param(_pools("max", "max") + FUSION + GOAL, id="mlp_max_fusion_goal"),
    pytest.param(_pools("mean", "mean") + ATTN_UPDATE + [
        "MODEL.POLICY.ACT_DECODER.TRAJ.PRED_MODE", "mlp", "MODEL.POLICY.ACT_DECODER.TRAJ.K", "3"],
        id="mlp_mean_attn_update_pred_mlp"),
    pytest.param(_pools("max", "none") + ["cluster"] + GOAL + POSE_EMB,
                 id="mlp_obs_none_cluster_goal_pose_emb"),
    pytest.param(NO_EMD, id="goal_context_no_emd"),
    # the port's fused stack (its plain version on the CPU) against the JAX
    # package's layer loop, which it runs off the TPU
    pytest.param(GOAL + POSE_EMB + FUSED, id="goal_context_fused_stack"),
])
def test_forward_val_matches_jax(opts, tmp_path):
    """The closed loop over 2 replan steps within 1e-4 m of the jitted JAX
    ProSim.forward(..., 'val'), with the motion_pred shape; a cluster file
    of K+1 goals raises ValueError in both packages.

    With the goal's pose embedding in the policy's queries
    (CONTEXT.USE_POSE_EMB) the first replan step is held to 1e-4 m and the
    second to 2e-4 m. The second step's obs history is rebuilt from the
    first step's positions, and its velocity and acceleration features are
    their differences over DT = 0.1 s, so a position's rounding enters them
    x10 and x100; the pose embedding's sines of goals 40 m out make the
    policy sensitive to it. Measured at seed 0: the port's policy alone
    within 3.2e-6 of 3.7 of the JAX policy on equal inputs, its scene tokens
    within 2.4e-6 of 4.9, the first step within 3e-5 m, the second 1.3e-4
    to 1.9e-4 m; the JAX package's own eager and jitted forwards differ by
    3.9e-5 m at the second step."""
    if "cluster" in opts:
        path = str(tmp_path / "k_goals.npy")
        np.save(path, GOALS)
        i = opts.index("cluster")
        opts = opts[:i] + _cluster(path) + opts[i + 1:]
        for build in (lambda o: ProSim(get_config(opts=o), device="cpu"),
                      lambda o: JaxProSim(jax_get_config(opts=o))):
            with pytest.raises(ValueError, match="TRAJ.K"):
                build(SMALL_OPTS + _cluster(path, len(GOALS) + 1))
    jm, params, jb, tm, tb = _pair(SMALL_OPTS + opts)
    ref = _host(jax.jit(lambda p, b, k: jm.forward(p, b, "val", k))(params, jb,
                                                                      jax.random.PRNGKey(7)))
    out = tm(tb, mode="val")
    mask = np.asarray(jb.prompt.mask)
    assert out["motion_pred"].shape == ref["motion_pred"].shape
    traj = out["rollout_traj"].numpy()[mask]
    assert np.isfinite(traj).all()
    err = np.abs(traj - ref["rollout_traj"][mask]).max(axis=(0, 2)).reshape(2, -1).max(axis=1)
    vel = np.abs(out["rollout_vel"].numpy() - ref["rollout_vel"])[mask].max()
    bars = (1e-4, 2e-4) if "MODEL.POLICY.ACT_DECODER.CONTEXT.USE_POSE_EMB" in opts else (1e-4, 1e-4)
    assert err[0] <= bars[0] and err[1] <= bars[1] and vel <= bars[1], (err, vel)


# --------------------------------------------------------------- gradients

def test_gradients_match_jax(tmp_path):
    """The train loss's gradients at R=1, the port's backward against
    jax.value_and_grad, every leaf within 1e-4 of its largest magnitude, on
    one model with the 'mlp' fusion, ATTN_UPDATE, the cluster head and the
    goal context with its pose embedding. At one replan step update_obs never
    runs (the obs update comes before the second step's policy), so the
    fusion's and the re-attention's gradients are exactly zero in both
    packages here; test_update_obs_gradients_match_jax holds them."""
    path = str(tmp_path / "k_goals.npy")
    np.save(path, GOALS)
    opts = (SMALL_OPTS + NO_DROPOUT + FUSION + ATTN_UPDATE + _cluster(path) + GOAL + POSE_EMB
            + ["TRAIN.REMAT_POLICY", "none"])  # the same gradients, a third of the compile
    jm, params, jb, tm, tb = _pair(opts, yaml=NO_TEXT, num_replan=1)
    jcfg, tcfg = jm.config, tm.config
    loss_impl = jlosses.loss_func_dict[jcfg.TASK.MOTION_PRED.LOSS]

    def loss_fn(p):
        return loss_impl(jb, jm.forward(p, jb, "train", jax.random.PRNGKey(1)),
                         jcfg)["full_loss"] * jcfg.TASK.MOTION_PRED.WEIGHT

    loss, grads = _host(jax.jit(jax.value_and_grad(loss_fn))(params))
    ref = flax_to_state_dict(grads)
    terms = tlosses.paired_mse_k(tb, tm.forward_train(tb, seed=0), tcfg)
    got = terms["full_loss"] * tcfg.TASK.MOTION_PRED.WEIGHT
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    params_t = dict(tm.named_parameters())
    assert set(ref) == set(params_t)
    for name, p in params_t.items():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(ref[name]).max(), 1e-30)
        assert np.abs(g - ref[name]).max() <= GRAD_TOL * scale, name
    for name in ("policy.goal_encoder.dense_0.weight", "policy.context_fuse.dense_0.weight",
                 "policy.cluster_mlp.dense_0.weight"):
        assert np.abs(ref[name]).max() > 0, name
