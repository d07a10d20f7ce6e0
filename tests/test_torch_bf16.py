"""The bf16 network body: prosim_torch's `ProSim(config, device, dtype)`
against prosim_tpu's `ProSim(config, dtype)`, on the CPU, with the kernels'
plain versions.

bf16 cannot be held to the f32 bars (the JAX package's own bf16 rollout
moves by up to ~0.8 m from its f32 rollout at these sizes), so each
comparison uses the 2x rule the port applies to B4's bf16 instantiation:

    max |port_bf16 - ref_f32| <= 2 * max |jax_bf16 - ref_f32| + atol

over the valid entries, where ref_f32 is the JAX package in f32 (the f32
plain stack for B3) and both bf16 sides get the same inputs and weights
(flax params carried across by load_flax_params). `atol` is stated per
test: 1e-3 for module outputs of unit scale, 1e-3 m for rollouts. The B2
plain version rounds where the TPU kernel rounds, so it is held tighter:
within 2 bf16 ulps (2 * 2**-8) of each output's largest magnitude of the
interpreted Pallas kernel.

The JAX bf16 programs are compiled with XLA's excess precision off
(`xla_allow_excess_precision`, on by default on the CPU), so each bf16
operation rounds once, as the program states it and as the port's eager
ops round; with it on, XLA:CPU keeps f32 intermediates inside its fused
bf16 chains. JAX compiles are shared through module-scoped fixtures: one
init, and one f32 and one bf16 program per configuration.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data.batch import SceneTokens as JSceneTokens
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_tpu.ops import fused_stack as jfs
from prosim_tpu.ops.attention import gather_src_features as jax_gather
from prosim_tpu.ops.edge_attn import edge_attn_core as jax_edge_attn_core
from prosim_torch.config import get_config
from prosim_torch.data.batch import SceneTokens
from prosim_torch.data.synthetic import make_synthetic_batch
from prosim_torch.models.prosim import ProSim
from prosim_torch.ops import edge_attn as tea
from prosim_torch.ops import fused_stack as tfs
from prosim_torch.utils.params import load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = "configs/waymo_demo.yaml"
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
GOAL = ["MODEL.DECODER.GOAL_PRED.ENABLE", "True", "MODEL.DECODER.GOAL_PRED.K", "4"]
FUSED = ["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"]
BATCH_KW = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6, num_replan=2)
MODULE_ATOL = 1e-3
ROLLOUT_ATOL = 1e-3  # m
BF16_ULP = 2.0 ** -8


def _host(tree):
    """A JAX result as numpy arrays, on the host before the port runs."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _run(bits, fn, *args):
    """jit fn and run it on args; the bf16 programs round every operation."""
    opts = {} if bits == 32 else {"xla_allow_excess_precision": False}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)(*args)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _two_x(got, ref16, ref32, mask=None, atol=MODULE_ATOL, what=""):
    """The 2x rule over the entries selected by `mask` (all if None)."""
    got, ref16, ref32 = (np.asarray(a, np.float64) for a in (got, ref16, ref32))
    if mask is not None:
        got, ref16, ref32 = got[mask], ref16[mask], ref32[mask]
    assert np.isfinite(got).all(), what
    err_port = np.abs(got - ref32).max()
    err_jax = np.abs(ref16 - ref32).max()
    assert err_port <= 2 * err_jax + atol, (what, err_port, err_jax)
    return err_port, err_jax


def _dtypes(tree):
    """The dtypes of a JAX result's leaves."""
    return jax.tree.map(lambda a: jnp.dtype(a.dtype), tree)


def _same_dtype(t, jax_dtype, what):
    want = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.int32): torch.int32, jnp.dtype(bool): torch.bool}[jax_dtype]
    assert t.dtype == want, (what, t.dtype, jax_dtype)


class Case:
    """JAX models in f32 and bf16 sharing one flax param tree, the port's
    models in f32 and bf16 carrying it, and each package's batch from one
    seed."""

    def __init__(self, yaml, opts, params=None, seed=0):
        path = os.path.join(REPO, yaml) if yaml else None
        self.jcfg, self.tcfg = jax_get_config(path, opts), get_config(path, opts)
        self.jm = {32: JaxProSim(self.jcfg), 16: JaxProSim(self.jcfg, jnp.bfloat16)}
        self.jb = jax_synthetic(self.jcfg, seed=seed, **BATCH_KW)
        if params is None:
            params = _host(self.jm[32].init(jax.random.PRNGKey(0), self.jb))
        self.params = params
        self.tm = {}
        for bits, dt in ((32, torch.float32), (16, torch.bfloat16)):
            self.tm[bits] = ProSim(self.tcfg, device="cpu", dtype=dt)
            load_flax_params(self.tm[bits], params)
        self.tb = make_synthetic_batch(self.tcfg, seed=seed, device="cpu", **BATCH_KW)
        self._forward = {}

    def forward(self, bits):
        """JAX forward(mode="val") of the f32 or bf16 model: (outputs on the
        host, their dtypes)."""
        if bits not in self._forward:
            m = self.jm[bits]
            out = _run(bits, lambda p, b, k: m.forward(p, b, "val", k), self.params, self.jb,
                       jax.random.PRNGKey(7))
            self._forward[bits] = _host(out), _dtypes(out)
        return self._forward[bits]


def _without_goal_heads(params):
    params = dict(params)
    params["decoder"] = {k: v for k, v in params["decoder"].items()
                         if k not in ("goal_prob_head", "goal_point_head")}
    return params


@pytest.fixture(scope="module")
def goal_case():
    """SMALL_OPTS with the decoder's goal heads: the per-module tests."""
    return Case(None, SMALL_OPTS + GOAL)


@pytest.fixture(scope="module")
def loop_case(goal_case):
    """SMALL_OPTS (the layer loop), with goal_case's params minus the goal
    heads: the argmax goal pick could flip between two bf16 runs."""
    return Case(None, SMALL_OPTS, params=_without_goal_heads(goal_case.params))


@pytest.fixture(scope="module")
def fused_case(loop_case):
    """FUSED_STACK=True. The JAX package runs its layer loop for it off the
    TPU, so its references are loop_case's."""
    case = Case(None, SMALL_OPTS + FUSED, params=loop_case.params)
    case._forward = loop_case._forward
    return case


@pytest.fixture(scope="module")
def demo_case():
    """configs/waymo_demo.yaml at SMALL_OPTS: goal, tag, drag-point and
    OneText conditions, the f32 tiny() Llama with LoRA."""
    return Case(DEMO, SMALL_OPTS)


# ------------------------------------------------------------- the modules

def _jax_modules(case, bits, up):
    """Each module of the JAX model `bits` on the same upstream values (the
    f32 chain's, cast to the model dtype where the real chain hands over
    model-dtype tensors)."""
    m = case.jm[bits]
    dt = m.dtype

    def run(p, b, up):
        out = {"scene_encoder": m.encode_scene(p, b).tokens,
               "prompt_encoder": m.prompt_encoder.apply({"params": p["prompt_encoder"]}, b.prompt)}
        scene = JSceneTokens(tokens=up["tokens"].astype(dt), pos=up["pos"], ori=up["ori"],
                             mask=up["mask"], num_map=up["num_map"])
        dec = m.decoder.apply({"params": p["decoder"]}, scene, b.prompt,
                              up["prompt_emb"].astype(dt))
        out.update({f"decoder_{k}": v for k, v in dec.items()})
        pr = b.prompt
        pol = m.policy.apply({"params": p["policy"]}, {"emd": up["emd"].astype(dt)}, scene,
                             pr.pos.astype(dt), pr.ori.astype(dt), pr.mask, pr.agent_type)
        out["policy_step"] = pol["motion_pred"]
        if m.condition_transformers:
            ct = m.condition_transformers["policy_decoder"]
            emd, aux = ct.apply({"params": p["condition_transformer_policy_decoder"]},
                                b.conditions, up["emd"].astype(dt), b.prompt)
            out["condition_transformer"] = emd
            out["condition_transformer_aux"] = aux["prompt_mask_pred_loss"]
        return out

    num_map = up.pop("num_map")
    res = _run(bits, lambda p, b, u: run(p, b, dict(u, num_map=num_map)), case.params, case.jb, up)
    up["num_map"] = num_map
    return _host(res), _dtypes(res)


def _port_modules(case, up):
    m = case.tm[16]
    dt = torch.bfloat16
    b = case.tb
    t = {k: torch.from_numpy(np.array(v)) for k, v in up.items() if k != "num_map"}
    with torch.inference_mode():
        out = {"scene_encoder": m.scene_encoder(b.init_obs, b.init_map).tokens,
               "prompt_encoder": m.prompt_encoder(b.prompt)}
        scene = SceneTokens(tokens=t["tokens"].to(dt), pos=t["pos"], ori=t["ori"], mask=t["mask"],
                            num_map=up["num_map"])
        dec = m.decoder(scene, b.prompt, t["prompt_emb"].to(dt))
        out.update({f"decoder_{k}": v for k, v in dec.items()})
        pr = b.prompt
        out["policy_step"] = m.policy({"emd": t["emd"].to(dt)}, scene, pr.pos.to(dt),
                                      pr.ori.to(dt), pr.mask, pr.agent_type)["motion_pred"]
        if m.condition_locations:
            emd, aux = m.condition_transformer_policy_decoder(b.conditions, t["emd"].to(dt),
                                                              b.prompt)
            out["condition_transformer"] = emd
            out["condition_transformer_aux"] = aux["prompt_mask_pred_loss"]
    return out


def _module_results(case):
    if not hasattr(case, "_modules"):
        m = case.jm[32]

        @jax.jit
        def chain(p, b):
            scene = m.encode_scene(p, b)
            prompt_emb = m.encode_prompt(p, b)
            emd = m.decoder.apply({"params": p["decoder"]}, scene, b.prompt, prompt_emb)["emd"]
            return dict(tokens=scene.tokens, pos=scene.pos, ori=scene.ori, mask=scene.mask,
                        prompt_emb=prompt_emb, emd=emd)

        up = _host(chain(case.params, case.jb))
        up["num_map"] = int(case.jb.init_map.pos.shape[1])
        r32, _ = _jax_modules(case, 32, up)
        r16, dtypes = _jax_modules(case, 16, up)
        case._modules = (r32, r16, dtypes, _port_modules(case, up))
    return case._modules


# masks of the valid entries of each module's output
def _module_mask(case, name, shape):
    b = case.jb
    if name == "scene_encoder":
        mask = np.concatenate([np.asarray(b.init_map.token_mask),
                               np.asarray(b.init_obs.mask).any(-1)], 1)
    elif name == "condition_transformer_aux":
        return None
    else:
        mask = np.asarray(b.prompt.mask)
    return np.broadcast_to(mask.reshape(mask.shape + (1,) * (len(shape) - mask.ndim)), shape)


@pytest.mark.parametrize("name", ["scene_encoder", "prompt_encoder", "decoder_emd",
                                  "decoder_goal_prob", "decoder_goal_point", "policy_step"])
def test_module_bf16_two_x_rule(goal_case, name):
    r32, r16, dtypes, got = _module_results(goal_case)
    _same_dtype(got[name], dtypes[name], name)
    assert tuple(got[name].shape) == r32[name].shape, name
    _two_x(_np(got[name]), r16[name], r32[name], _module_mask(goal_case, name, r32[name].shape),
           what=name)


@pytest.mark.parametrize("name", ["condition_transformer", "condition_transformer_aux"])
def test_condition_transformer_bf16_two_x_rule(demo_case, name):
    r32, r16, dtypes, got = _module_results(demo_case)
    _same_dtype(got[name], dtypes[name], name)
    _two_x(_np(got[name]), r16[name], r32[name], _module_mask(demo_case, name, r32[name].shape),
           what=name)


# ------------------------------------------------------------ the kernels

def _edge_inputs(seed, B=2, Q=16, S=20, K=24, D=32, Dp=24, H=4, empty=((0, 3), (1, 15))):
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    x_src_n = bf(rng.normal(size=(B, S, D)))
    z_r = bf(rng.normal(size=(B, Q, K, Dp)))
    qx = bf(rng.normal(size=(B, Q, H, D)) * 0.5)
    qp = bf(rng.normal(size=(B, Q, H, Dp)) * 0.5)
    idx = rng.integers(0, S, (B, Q, K)).astype(np.int32)
    valid = rng.random((B, Q, K)) > 0.3
    for b, q in empty:
        valid[b, q] = False
    idx = np.where(valid, idx, -1).astype(np.int32)  # arbitrary where invalid
    return x_src_n, torch.from_numpy(idx), z_r, qx, qp, torch.from_numpy(valid)


def test_edge_attn_plain_bf16_matches_pallas_interpret():
    """B2's plain version in bf16 against the TPU kernel run in interpret
    mode in bf16 on the same gathered rows: the same rounding points, so
    within 2 bf16 ulps of each output's largest magnitude; rows with no
    valid edge exactly zero."""
    x_src_n, idx, z_r, qx, qp, valid = _edge_inputs(0)
    scale = 8 ** -0.5
    with torch.inference_mode():
        got = tea.edge_attn_core(x_src_n, idx, z_r, qx, qp, valid, scale)
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    safe = np.where(valid.numpy(), idx.numpy(), 0)
    x_g = jnp.asarray(x_src_n.float().numpy()[np.arange(2)[:, None, None], safe], jnp.bfloat16)
    ref = _host(jax_edge_attn_core(x_g, j(z_r), j(qx), j(qp), jnp.asarray(valid.numpy()), scale,
                                   interpret=True))
    for name, g, r in zip(("agg_x", "agg_z", "attn_sum"), got, ref):
        assert g.dtype == torch.bfloat16, name
        assert tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(_np(g), r, atol=2 * BF16_ULP * np.abs(r).max(), rtol=0,
                                   err_msg=name)
    for b, q in ((0, 3), (1, 15)):
        assert not _np(got[0])[b, q].any() and not _np(got[2])[b, q].any()


def test_edge_attn_rounds_where_tpu_kernel_does():
    """The bf16 plain version is not the f32 one rounded at the end: it
    rounds the scores and weights, as the TPU kernel does."""
    x_src_n, idx, z_r, qx, qp, valid = _edge_inputs(1)
    with torch.inference_mode():
        got = tea.edge_attn_core(x_src_n, idx, z_r, qx, qp, valid, 0.35)[0]
        f32 = tea.edge_attn_core(x_src_n.float(), idx, z_r.float(), qx.float(), qp.float(), valid,
                                 0.35)[0]
    assert not torch.equal(got, f32.to(torch.bfloat16))
    err = (got.float() - f32).abs().max().item()
    assert 0 < err <= 4 * BF16_ULP * f32.abs().max().item()


def test_kernel_wrappers_refuse_mixed_and_other_dtypes(goal_case):
    """A value tensor in another dtype than the rest, or a dtype that the
    kernels have no instantiation of, raises a TypeError on any device:
    nothing is cast to reach an instantiation."""
    x_src_n, idx, z_r, qx, qp, valid = _edge_inputs(2)
    for bad in ((x_src_n, idx, z_r.float(), qx, qp),
                (x_src_n.half(), idx, z_r.half(), qx.half(), qp.half())):
        with pytest.raises(TypeError, match="edge_attn_core"):
            tea.edge_attn_core(*bad, valid, 0.5)
    policy = goal_case.tm[16].policy
    x, tables = _fused_inputs(4, D=policy.hidden_dim)
    tt = [tuple(torch.from_numpy(a) for a in t) for t in tables]
    w16 = [tfs.pack_site_weights(policy, s, torch.bfloat16) for s in ("a2p", "m2p")]
    kw = dict(num_heads=policy.num_heads, head_dim=policy.head_dim)
    bf = [(s.to(torch.bfloat16), i, f, v) for s, i, f, v in tt]
    for bad_x, bad_tables, bad_w in (
            (torch.from_numpy(x), bf, w16),                                  # f32 x_p, bf16 rest
            (torch.from_numpy(x).half(), bf, w16),                           # no f16 kernel
            (torch.from_numpy(x).to(torch.bfloat16), tt, w16),               # f32 sources
            (torch.from_numpy(x).to(torch.bfloat16),
             [(s, i, f.to(torch.bfloat16), v) for s, i, f, v in bf], w16)):  # feats stay f32
        with pytest.raises(TypeError, match="fused_two_site_stack"), torch.inference_mode():
            tfs.fused_two_site_stack(bad_x, *bad_tables, *bad_w, **kw)


def _fused_inputs(seed, B=2, N=8, Sa=12, Ka=5, Sm=24, Km=7, D=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    tables = []
    for S, K in ((Sa, Ka), (Sm, Km)):
        src = rng.normal(size=(B, S, D)).astype(np.float32)
        idx = rng.integers(0, S, (B, N, K)).astype(np.int32)
        valid = rng.random((B, N, K)) > 0.2
        valid[0, 3] = False
        v = rng.uniform(-np.pi, np.pi, (B, N, K))
        feats = np.stack([rng.uniform(0, 50, (B, N, K)), rng.uniform(-np.pi, np.pi, (B, N, K)),
                          v, v], -1).astype(np.float32)
        tables.append((src, idx, feats, valid))
    return x, tables


def test_fused_stack_plain_bf16_two_x_rule(goal_case):
    """B3's plain version with bf16 inputs and weights packed in bf16
    against the TPU kernel in interpret mode with pack_site_weights(...,
    bfloat16), both by the 2x rule against the f32 plain version, on the
    goal case's (random-init) policy layers."""
    policy = goal_case.tm[16].policy
    p = goal_case.params["policy"]
    L, H, hd, D = policy.num_layers, policy.num_heads, policy.head_dim, policy.hidden_dim
    x, tables = _fused_inputs(3, D=D)
    tt = [tuple(torch.from_numpy(a) for a in t) for t in tables]
    bf = torch.bfloat16
    with torch.inference_mode():
        w32 = [tfs.pack_site_weights(policy, s) for s in ("a2p", "m2p")]
        w16 = [tfs.pack_site_weights(policy, s, bf) for s in ("a2p", "m2p")]
        for w in w16:
            assert all(t.dtype == bf for t in w)
        ref32 = tfs.fused_two_site_stack(torch.from_numpy(x), *tt, *w32, num_heads=H, head_dim=hd)
        got = tfs.fused_two_site_stack(
            torch.from_numpy(x).to(bf), *[(s.to(bf), i, f, v) for s, i, f, v in tt], *w16,
            num_heads=H, head_dim=hd)
    assert got.dtype == bf
    jt = [(jax_gather(jnp.asarray(src, jnp.bfloat16), jnp.asarray(idx)), jnp.asarray(feats),
           jnp.asarray(valid, jnp.float32)) for src, idx, feats, valid in tables]
    ref16 = _host(jfs.fused_two_site_stack(
        jnp.asarray(x, jnp.bfloat16), jt[0], jt[1],
        jfs.pack_site_weights(p, "a2p", L, H, hd, jnp.bfloat16),
        jfs.pack_site_weights(p, "m2p", L, H, hd, jnp.bfloat16),
        num_layers=L, num_heads=H, head_dim=hd, pe_dim=D, q_tile=8, interpret=True))
    _two_x(_np(got), ref16, ref32.numpy(), what="fused stack")


# ------------------------------------------------------------- the slice

def _slice_checks(case, out):
    ref32, _ = case.forward(32)
    ref16, dtypes = case.forward(16)
    mask = np.asarray(case.jb.prompt.mask)
    assert sorted(out) == sorted(ref16)
    for key, dt in dtypes.items():
        if isinstance(dt, dict):
            for k2, d2 in dt.items():
                _same_dtype(out[key][k2], d2, f"{key}.{k2}")
        else:
            _same_dtype(out[key], dt, key)
    np.testing.assert_array_equal(out["init_pos"].numpy(), ref16["init_pos"])
    errs = {}
    for key in ("rollout_traj", "rollout_vel"):
        assert tuple(out[key].shape) == ref32[key].shape
        errs[key] = _two_x(out[key].numpy(), ref16[key], ref32[key], mask, ROLLOUT_ATOL, key)
    return errs


def test_slice_layer_loop_bf16(loop_case):
    out = loop_case.tm[16](loop_case.tb, mode="val")
    _slice_checks(loop_case, out)


def test_slice_fused_stack_bf16(fused_case):
    assert fused_case.tm[16].policy.uses_fused_stack()
    before = tfs.fused_two_site_stack.launches
    out = fused_case.tm[16](fused_case.tb, mode="val")
    assert tfs.fused_two_site_stack.launches == before  # the CPU runs the plain version
    _slice_checks(fused_case, out)


def test_slice_waymo_demo_bf16(demo_case):
    out = demo_case.tm[16](demo_case.tb, mode="val")
    _slice_checks(demo_case, out)
    ref32, ref16 = demo_case.forward(32)[0], demo_case.forward(16)[0]
    loss = lambda o: float(o["prompt_loss_aux"]["prompt_mask_pred_loss"])  # noqa: E731
    _two_x(np.array(loss(out)), np.array(loss(ref16)), np.array(loss(ref32)), what="prompt loss")


# ------------------------------------------------------------- the model

def test_default_is_f32_and_params_stay_f32(goal_case):
    tm32 = ProSim(goal_case.tcfg, device="cpu")
    assert tm32.dtype == torch.float32
    assert goal_case.tm[16].dtype == torch.bfloat16
    for model in (tm32, goal_case.tm[16]):
        assert {p.dtype for p in model.parameters()} == {torch.float32}
    # the same weights: the bridge is the f32 one
    sd32, sd16 = goal_case.tm[32].state_dict(), goal_case.tm[16].state_dict()
    assert all(torch.equal(sd32[k], sd16[k]) for k in sd32)


def test_bf16_training_runs_and_edge_kernel_refuses_grad(goal_case):
    """bf16 training runs (tests/test_torch_bf16_train.py holds it against
    the JAX package): the train-mode forward keeps the bf16 body and its
    autograd graph. What still raises in it is the eval-only edge-core
    kernel, which has no backward: its wrapper refuses bf16 inputs that
    require grad, so training takes the differentiable branch."""
    out = goal_case.tm[16](goal_case.tb, mode="train")
    assert out["motion_pred"].dtype == torch.bfloat16 and out["motion_pred"].requires_grad
    x_src_n, idx, z_r, qx, qp, valid = _edge_inputs(0)
    with pytest.raises(RuntimeError, match="no backward"):
        tea.edge_attn_core(x_src_n, idx, z_r, qx.requires_grad_(True), qp, valid, 8 ** -0.5)
