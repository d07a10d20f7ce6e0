"""The port's prompt-condition modules against prosim_tpu's, on the CPU in
f32: each condition encoder, the GNN condition attention (duplicate
targets, a binary type, both pools) and the condition transformer with the
tiny Llama and with the bag-of-tokens text attention. Inputs come from
numpy with fixed seeds; flax params (perturbed, so norm affines and LoRA B
factors are non-trivial) are carried into torch. Tolerance 1e-5: f32 sums
taken in another order (the port sums duplicate condition targets with a
one-hot product, the JAX package with a scatter-add).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.data.batch import Condition as JCondition
from prosim_tpu.data.batch import Prompt as JPrompt
from prosim_torch.data.batch import Condition, Prompt
from prosim_torch.utils.params import load_flax_params

TOL = dict(atol=1e-5, rtol=1e-5)
B, N, C, D = 2, 7, 9, 32


def _host(tree):
    """A JAX result as numpy arrays, on the host before the port runs."""
    return jax.tree.map(np.asarray, tree)


def _pair(flax_mod, torch_mod, *args):
    """Init the flax module on args, perturb its params and copy them into
    the torch module. Returns the flax output on the host."""
    params = flax_mod.init(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)
    load_flax_params(torch_mod, _host(params))
    return _host(flax_mod.apply({"params": params}, *args))


def _cond_arrays(rng, ctype, dup=True):
    """One condition type's arrays; with dup, several conditions share a
    target agent (and, for the binary type, a pair)."""
    fdim = {"drag_point": 16}.get(ctype, 3)
    width = 2 if ctype == "v2v_tag" else 1
    mask = rng.random((B, C)) > 0.3
    idx = rng.integers(0, N, size=(B, C, width)).astype(np.int32)
    if dup:
        idx[:, 1] = idx[:, 0]
        mask[:, :2] = True
    if ctype == "drag_point":
        feat = rng.normal(size=(B, C, 8, 2)).astype(np.float32)
        feat[:, :, 5:] = np.nan  # NaN-padded sketch points
        feat = feat.reshape(B, C, 16)
    elif ctype in ("v_action_tag", "v2v_tag"):
        feat = np.stack([rng.integers(-1, 13, size=(B, C)),  # ids outside the bank clip
                         rng.integers(0, 80, size=(B, C)), rng.integers(0, 80, size=(B, C))],
                        -1).astype(np.float32)
    else:
        feat = rng.normal(size=(B, C, fdim)).astype(np.float32)
    pmask = np.zeros((B, N), bool)
    for b in range(B):
        pmask[b, idx[b, mask[b]].ravel()] = True
    return dict(feat=feat, mask=mask, prompt_idx=idx, prompt_mask=pmask)


def _prompt_arrays(rng):
    mask = rng.random((B, N)) > 0.2
    mask[:, :2] = True
    return dict(feat=rng.normal(size=(B, N, 7)).astype(np.float32), mask=mask,
                pos=(rng.normal(size=(B, N, 2)) * 20).astype(np.float32),
                ori=rng.normal(size=(B, N)).astype(np.float32),
                agent_type=rng.integers(1, 4, size=(B, N)).astype(np.int32),
                obs_index=np.tile(np.arange(N, dtype=np.int32), (B, 1)),
                extent=np.ones((B, N, 2), np.float32),
                goal_point=np.zeros((B, N, 2), np.float32))


def _both(arrays, jcls, tcls):
    return jcls(**{k: jnp.asarray(v) for k, v in arrays.items()}), tcls.from_numpy(arrays)


@pytest.mark.parametrize("ctype", ["goal", "v_action_tag", "v2v_tag", "drag_point"])
def test_condition_encoder_matches_jax(ctype):
    from prosim_tpu.models.condition import encoders as je
    from prosim_torch.models.condition import encoders as te

    rng = np.random.default_rng(len(ctype))
    jc, tc = _both(_cond_arrays(rng, ctype), JCondition, Condition)
    jm, tm = {
        "goal": (je.GoalConditionEncoder(D), lambda: te.GoalConditionEncoder(D)),
        "v_action_tag": (je.VActionTagEncoder(D, 11), lambda: te.VActionTagEncoder(D, 11)),
        "v2v_tag": (je.V2VTagEncoder(D, 5, binary=True), lambda: te.V2VTagEncoder(D, 5)),
        "drag_point": (je.DragPointEncoder(D), lambda: te.DragPointEncoder(D)),
    }[ctype]
    tm = tm()
    ref = _pair(jm, tm, jc)
    with torch.no_grad():
        got = tm(tc)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_gnn_condition_attn_matches_jax(pool):
    """Two unary types and a binary one, with conditions sharing targets;
    the edge-matrix (B2's GNN site: Q = K = N, rel-PE at full width)."""
    from prosim_tpu.models.condition.attn import GNNConditionAttn as JGNN
    from prosim_torch.models.condition.attn import GNNConditionAttn, condition_edge_mask

    rng = np.random.default_rng(3)
    types = ["goal", "v_action_tag", "v2v_tag"]
    arrays = {t: _cond_arrays(rng, t) for t in types}
    embs = {t: rng.normal(size=(B, C, 2 * D if t == "v2v_tag" else D)).astype(np.float32)
            for t in types}
    prompt = _prompt_arrays(rng)
    emb = rng.normal(size=(B, N, D)).astype(np.float32)
    jconds = {t: JCondition(**{k: jnp.asarray(v) for k, v in a.items()}) for t, a in arrays.items()}
    tconds = {t: Condition.from_numpy(a) for t, a in arrays.items()}
    jp, tp = _both(prompt, JPrompt, Prompt)
    tm = GNNConditionAttn(D, 2, 4, 8, pool=pool)
    ref = _pair(JGNN(hidden_dim=D, num_layers=2, num_heads=4, head_dim=8, pool=pool),
                tm, {t: jnp.asarray(e) for t, e in embs.items()}, jconds, jnp.asarray(emb), jp)
    with torch.no_grad():
        got = tm({t: torch.from_numpy(e) for t, e in embs.items()}, tconds,
                 torch.from_numpy(emb), tp)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)

    # the edge mask: a cell is on where a valid condition hits it, between valid agents
    want = np.zeros((B, N, N), bool)
    for a in arrays.values():
        for b in range(B):
            for c in np.nonzero(a["mask"][b])[0]:
                s, t = a["prompt_idx"][b, c, 0], a["prompt_idx"][b, c, -1]
                want[b, s, t] = want[b, t, s] = True
    want &= prompt["mask"][:, :, None] & prompt["mask"][:, None, :]
    got_mask = condition_edge_mask(tconds, types, torch.from_numpy(prompt["mask"]))
    np.testing.assert_array_equal(got_mask.numpy(), want)


@pytest.mark.parametrize("text_attn", ["llama", "bow"])
def test_condition_transformer_matches_jax(text_attn):
    """The dispatcher from the config: the demo's condition types through
    the GNN, then the text type through the tiny Llama (the synthetic
    OneText condition) or the bag of tokens ([B, X, L] texts)."""
    from prosim_tpu.config import get_config as jax_get_config
    from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
    from prosim_tpu.models.condition.transformer import (
        build_condition_transformer as jax_build,
    )
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.condition.transformer import build_condition_transformer

    opts = ["PROMPT.CONDITION.TYPES", "['goal', 'v_action_tag', 'drag_point', 'llm_text_OneText']",
            "MODEL.HIDDEN_DIM", str(D), "MODEL.CONDITION_TRANSFORMER.NLAYER", "2",
            "MODEL.CONDITION_TRANSFORMER.FF_DIM", "4",
            "MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.TYPE", text_attn]
    kw = dict(batch_size=B, num_lanes=8, num_obs_agents=10, num_agents=N, num_replan=2, seed=4)
    jb = jax_synthetic(jax_get_config(opts=opts), **kw)
    tb = make_synthetic_batch(get_config(opts=opts), device="cpu", **kw)
    jconds, tconds = dict(jb.conditions), dict(tb.conditions)
    if text_attn == "bow":  # two texts per scene
        rng = np.random.default_rng(5)
        tc = {k: np.stack([v, v], 1) for k, v in _host(jb.conditions["llm_text_OneText"]).items()}
        tc["token_mask"][:, 1] &= rng.random(tc["token_mask"][:, 1].shape) > 0.5
        tc["prompt_mask"] = tc["prompt_mask"][:, 0]
        jconds["llm_text_OneText"] = {k: jnp.asarray(v) for k, v in tc.items()}
        tconds["llm_text_OneText"] = {k: torch.from_numpy(v) for k, v in tc.items()}
    emb = np.random.default_rng(6).normal(size=(B, N, D)).astype(np.float32)
    jm = jax_build(jax_get_config(opts=opts))
    tm = build_condition_transformer(get_config(opts=opts))
    ref, ref_aux = _pair(jm, tm, jconds, jnp.asarray(emb), jb.prompt)
    with torch.no_grad():
        got, aux = tm(tconds, torch.from_numpy(emb), tb.prompt)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert (aux is None) == (ref_aux is None)
    if aux is not None:
        np.testing.assert_allclose(float(aux["prompt_mask_pred_loss"]),
                                   float(ref_aux["prompt_mask_pred_loss"]), **TOL)
