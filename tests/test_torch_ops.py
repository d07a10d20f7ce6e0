"""prosim_torch ops and modules against their prosim_tpu (flax) twins.

Inputs come from numpy with a fixed seed and go through both packages; flax
params are carried into torch by prosim_torch.utils.params. Everything runs
in f32 on the CPU, where the port's kernel wrappers take their plain
versions. Tolerance: 1e-5 absolute and relative unless a test says otherwise
(f32 rounding of sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_torch.utils.params import load_flax_params

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _host(tree):
    """A JAX result as numpy arrays. JAX dispatches asynchronously on the CPU;
    a torch computation that ran while a JAX one was still in flight came out
    sporadically imprecise (~2e-5 instead of ~2e-7, about one process in 40),
    so every reference is on the host before the port's side runs."""
    return jax.tree.map(np.asarray, tree)


def _close(a, b, **tol):
    np.testing.assert_allclose(_np(a), _np(b), **(tol or TOL))


def _pair(flax_mod, torch_mod, *args, method=None):
    """Init the flax module on args, copy its params into the torch module.
    Returns (flax params, flax output)."""
    variables = flax_mod.init(jax.random.PRNGKey(0), *args, method=method)
    params = variables.get("params", {})
    if params:
        # perturb the default-initialized affines so they are exercised
        params = jax.tree.map(
            lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)
        load_flax_params(torch_mod, jax.tree.map(np.asarray, params))
    out = flax_mod.apply({"params": params}, *args, method=method)
    return params, _host(out)


RNG = np.random.default_rng(0)


def _randn(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ geometry

@pytest.mark.parametrize("fn,nargs", [
    ("wrap_angle", 1), ("rotate_2d", 2), ("angle_between_2d_vectors", 2),
    ("heading_from_sincos", 1), ("rel_traj_to_last_step", 1),
    ("rel_vel_to_last_step", 2), ("integrate_delta_traj", 4),
    ("transform_to_frame", 3), ("transform_from_frame", 3),
])
def test_geometry(fn, nargs):
    from prosim_tpu.utils import geometry as jg
    from prosim_torch.utils import geometry as tg

    shapes = {
        "wrap_angle": [(4, 7)],
        "rotate_2d": [(4, 7, 2), (4, 7)],
        "angle_between_2d_vectors": [(4, 7, 2), (4, 7, 2)],
        "heading_from_sincos": [(4, 7, 2)],
        "rel_traj_to_last_step": [(3, 13, 4)],
        "rel_vel_to_last_step": [(3, 13, 4), (3, 13, 2)],
        "integrate_delta_traj": [(3, 10, 2), (3, 10), (3, 2), (3,)],
        "transform_to_frame": [(4, 7, 2), (4, 7, 2), (4, 7)],
        "transform_from_frame": [(4, 7, 2), (4, 7, 2), (4, 7)],
    }[fn]
    assert len(shapes) == nargs
    args = [_randn(*s, scale=3.0) for s in shapes]
    ref = _host(getattr(jg, fn)(*[jnp.asarray(a) for a in args]))
    got = getattr(tg, fn)(*[_t(a) for a in args])
    if isinstance(ref, tuple):
        for r, g in zip(ref, got):
            _close(g, r)
    else:
        _close(got, ref)


# ------------------------------------------------------------------- mlp etc

@pytest.mark.parametrize("ret_before_act,without_norm", [(False, False), (True, False), (True, True)])
def test_mlp(ret_before_act, without_norm):
    from prosim_tpu.ops.mlp import MLP as JMLP
    from prosim_torch.ops.mlp import MLP

    x = _randn(3, 5, 6)
    dims = [6, 16, 12, 8]
    tm = MLP(dims, ret_before_act=ret_before_act, without_norm=without_norm)
    _, ref = _pair(JMLP(dims, ret_before_act=ret_before_act, without_norm=without_norm), tm, x)
    _close(tm(_t(x)), ref)


def test_context_gating():
    from prosim_tpu.ops.mlp import ContextGating as JCG
    from prosim_torch.ops.mlp import ContextGating

    tokens, ctx = _randn(2, 3, 4, 16), _randn(2, 3, 16)
    mask = RNG.random((2, 3, 4)) > 0.3
    tm = ContextGating(3, 16)
    _, (ref_tok, ref_ctx) = _pair(JCG(3, 16), tm, tokens, ctx, mask)
    tok, c = tm(_t(tokens), _t(ctx), _t(mask))
    _close(tok, ref_tok)
    _close(c, ref_ctx)


def test_fourier_fix():
    from prosim_tpu.ops.fourier import FourierEmbeddingFix as JF
    from prosim_torch.ops.fourier import FourierEmbeddingFix

    # dist-like inputs up to ~30 m, angles within +-pi
    x = np.concatenate([np.abs(_randn(64, 1, scale=10.0)), _randn(64, 2)], -1)
    ref = _host(JF(num_pos_feats=8).apply({}, jnp.asarray(x)))
    _close(FourierEmbeddingFix(num_pos_feats=8)(_t(x)), ref)


def test_fourier_learnable():
    from prosim_tpu.ops.fourier import FourierEmbedding as JF
    from prosim_torch.ops.fourier import FourierEmbedding

    x = _randn(5, 7, 3)
    tm = FourierEmbedding(3, 16, 4)
    _, ref = _pair(JF(3, 16, 4), tm, x)
    _close(tm(_t(x)), ref)


def test_pointnet():
    from prosim_tpu.ops.pointnet import PointNetPolylineEncoder as JP
    from prosim_torch.ops.pointnet import PointNetPolylineEncoder

    x = _randn(2, 6, 9, 11)
    x[0, 1, 2, 3] = np.nan  # masked-out NaNs must not leak
    mask = RNG.random((2, 6, 9)) > 0.3
    mask[0, 1, 2] = False
    mask[1, 4] = False  # an empty polyline
    tm = PointNetPolylineEncoder(11, 16, 3, 5)
    _, ref = _pair(JP(11, 16, 3, 5), tm, x, mask)
    _close(tm(_t(x), _t(mask)), ref)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("dup_tail", [0, 4])
def test_norm_stats(dup_tail):
    from prosim_tpu.ops.attention import _norm_stats as jn
    from prosim_torch.ops.attention import _norm_stats

    x = _randn(3, 5, 12, scale=2.0)
    _close(_norm_stats(_t(x), dup_tail=dup_tail), jn(jnp.asarray(x), dup_tail=dup_tail))


def test_fold_pe_tail():
    from prosim_tpu.ops.attention import _fold_pe_tail as jf
    from prosim_torch.ops.attention import _fold_pe_tail

    w = _randn(16, 6)
    _close(_fold_pe_tail(_t(w), 4), jf(jnp.asarray(w), 4), atol=0, rtol=0)


def _graph(B=2, Q=5, S=9, K=4):
    idx = RNG.integers(0, S, size=(B, Q, K)).astype(np.int32)
    return dict(
        dst_pos=_randn(B, Q, 2, scale=10.0), dst_ori=_randn(B, Q),
        src_pos=_randn(B, S, 2, scale=10.0), src_ori=_randn(B, S),
        idx=idx, valid=RNG.random((B, Q, K)) > 0.3,
    )


def test_rel_pe_features():
    from prosim_tpu.ops.attention import rel_pe_features as jr
    from prosim_torch.ops.attention import rel_pe_features

    g = _graph()
    args = [g[k] for k in ("dst_pos", "dst_ori", "src_pos", "src_ori", "idx")]
    _close(rel_pe_features(*map(_t, args)), jr(*map(jnp.asarray, args)))


def test_site_gather():
    """The JAX package's per-site gathers (normalized source features,
    neighbor positions and orientations) against the port's: the edge
    core's plain version gathers the normalized source rows by idx, and
    rel_pe_features gathers pos/ori."""
    from prosim_tpu.ops.attention import site_gather as js
    from prosim_torch.ops.attention import _norm_stats, _pos_ori_table
    from prosim_torch.ops.neighbors import gather_neighbors

    g = _graph()
    x = _randn(2, 9, 16)
    ref = _host(js(jnp.asarray(x), jnp.asarray(g["src_pos"]), jnp.asarray(g["src_ori"]),
                   jnp.asarray(g["idx"])))
    idx = _t(g["idx"])
    po = gather_neighbors(_pos_ori_table(_t(g["src_pos"]), _t(g["src_ori"])), idx)
    got = (gather_neighbors(_norm_stats(_t(x)), idx), po[..., :2], po[..., 2])
    for a, b in zip(got, ref):
        _close(a, b)


@pytest.mark.parametrize("learnable,fold_dup", [(False, True), (False, False), (True, True)])
def test_rel_pe(learnable, fold_dup):
    from prosim_tpu.ops.attention import RelPE as JR
    from prosim_torch.ops.attention import RelPE

    feats = np.concatenate([np.abs(_randn(2, 5, 4, 1, scale=10.0)), _randn(2, 5, 4, 2)], -1)
    tm = RelPE(16, learnable, 4, fold_dup=fold_dup)
    _, ref = _pair(JR(16, learnable, 4, fold_dup=fold_dup), tm, feats)
    _close(tm(_t(feats)), ref)


@pytest.mark.parametrize("bipartite,shared_gather,folded", [
    (False, False, True), (True, False, True), (True, True, True), (True, True, False),
])
def test_gated_neighbor_attention(bipartite, shared_gather, folded):
    from prosim_tpu.ops.attention import GatedNeighborAttention as JG
    from prosim_tpu.ops.attention import gather_src_features as jgather
    from prosim_torch.ops.attention import GatedNeighborAttention, _norm_stats, normalize_rel_pe

    D, H, hd = 16, 4, 4
    g = _graph(B=2, Q=5, S=9, K=6)
    x_dst, x_src = _randn(2, 5, D), _randn(2, 9, D)
    if not bipartite:
        x_src = x_dst
        g["idx"] = RNG.integers(0, 5, size=(2, 5, 6)).astype(np.int32)
    g["valid"][0, 2] = False  # a destination with no valid neighbor
    d_pe = 3 * D // 4 if folded else D
    rel_pe = _randn(2, 5, 6, d_pe)
    jm = JG(hidden_dim=D, num_heads=H, head_dim=hd, bipartite=bipartite,
            pe_full_dim=D if folded else 0)
    tm = GatedNeighborAttention(D, H, hd, bipartite=bipartite, pe_dim=D)
    args = [x_dst, x_src, g["idx"], g["valid"], rel_pe]
    params = jm.init(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    kw, tkw = {}, {}
    if shared_gather:
        kw["src_gathered"] = _host(jgather(jnp.asarray(x_src), jnp.asarray(g["idx"])))
        tkw["src_normed"] = _norm_stats(_t(x_src))
    ref = _host(jm.apply({"params": params}, *args, **kw))
    got = tm(*map(_t, args[:4]), normalize_rel_pe(_t(rel_pe), D), **tkw)
    _close(got, ref)


# ------------------------------------------------------------------- models

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
    "MODEL.DECODER.GOAL_PRED.ENABLE", "True",
    "MODEL.DECODER.GOAL_PRED.K", "4",
]


@pytest.fixture(scope="module")
def stage():
    """The JAX model's stages on one synthetic batch, and the port's
    counterparts carrying the same params."""
    from prosim_tpu.config import get_config as jget
    from prosim_tpu.data.synthetic import make_synthetic_batch as jsynth
    from prosim_tpu.models.prosim import ProSim as JProSim
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim

    kw = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6, num_replan=2, seed=3)
    jcfg, tcfg = jget(opts=SMALL_OPTS), get_config(opts=SMALL_OPTS)
    jm, jb = JProSim(jcfg), jsynth(jcfg, **kw)
    params = jm.init(jax.random.PRNGKey(0), jb)
    params = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    tb = make_synthetic_batch(tcfg, device="cpu", **kw)
    return dict(jm=jm, jb=jb, params=params, tm=tm, tb=tb)


def _scene_close(got, ref):
    assert got.num_map == ref.num_map
    for k in ("tokens", "pos", "ori", "mask"):
        _close(getattr(got, k), getattr(ref, k))


def test_scene_encoder(stage):
    jm, p, jb, tm, tb = stage["jm"], stage["params"], stage["jb"], stage["tm"], stage["tb"]
    ref = _host(jax.jit(jm.encode_scene)(p, jb))
    with torch.inference_mode():
        got = tm.scene_encoder(tb.init_obs, tb.init_map)
    _scene_close(got, ref)


def test_scene_encoder_update_obs(stage):
    jm, p, jb, tm, tb = stage["jm"], stage["params"], stage["jb"], stage["tm"], stage["tb"]

    @jax.jit
    def ref_fn(p, jb):
        fo = jb.fut_obs
        return jm.scene_encoder.apply(
            {"params": p["scene_encoder"]}, jm.encode_scene(p, jb), fo.feat[:, 1],
            fo.mask[:, 1], fo.pos[:, 1], fo.ori[:, 1], method="update_obs")

    ref = _host(ref_fn(p, jb))
    tfo = tb.fut_obs
    with torch.inference_mode():
        scene = tm.scene_encoder(tb.init_obs, tb.init_map)
        got = tm.scene_encoder.update_obs(
            scene, tfo.feat[:, 1], tfo.mask[:, 1], tfo.pos[:, 1], tfo.ori[:, 1])
    _scene_close(got, ref)


def test_prompt_encoder(stage):
    jm, p, jb, tm, tb = stage["jm"], stage["params"], stage["jb"], stage["tm"], stage["tb"]
    ref = _host(jm.encode_prompt(p, jb))
    with torch.inference_mode():
        got = tm.prompt_encoder(tb.prompt)
    _close(got, ref)


def test_decoder_with_goal_heads(stage):
    jm, p, jb, tm, tb = stage["jm"], stage["params"], stage["jb"], stage["tm"], stage["tb"]

    @jax.jit
    def ref_fn(p, jb):
        return jm.generate_policy(p, jb, jm.encode_scene(p, jb), jm.encode_prompt(p, jb))[0]

    ref = _host(ref_fn(p, jb))
    with torch.inference_mode():
        tscene = tm.scene_encoder(tb.init_obs, tb.init_map)
        got = tm.decoder(tscene, tb.prompt, tm.prompt_encoder(tb.prompt))
    for k in ("emd", "goal_prob", "goal_point"):
        _close(got[k], ref[k])


def test_policy(stage):
    jm, p, jb, tm, tb = stage["jm"], stage["params"], stage["jb"], stage["tm"], stage["tb"]

    @jax.jit
    def ref_fn(p, jb):
        scene, emd, _ = jm.prepare(p, jb, "val", jax.random.PRNGKey(1))
        pr = jb.prompt
        return jm.policy.apply(
            {"params": p["policy"]}, emd, scene, pr.pos, pr.ori, pr.mask, pr.agent_type)

    ref = _host(ref_fn(p, jb))
    with torch.inference_mode():
        tscene, temd = tm.prepare(tb, "val")
        tp = tb.prompt
        got = tm.policy(temd, tscene, tp.pos, tp.ori, tp.mask, tp.agent_type)
    _close(got["motion_pred"], ref["motion_pred"])
    _close(got["motion_prob"], ref["motion_prob"])
