"""prosim_torch's text-conditioned training against prosim_tpu's, on the CPU
in f32: the causal attention's gradient (the flash backward's plain twin and
the autograd Function around the kernel), the Llama's LoRA gradients with
and without per-block remat, LlamaTextAttn in training, two train steps of
configs/with_text.yaml through make_train_step against jax.value_and_grad +
the JAX package's own optimizer, fit with an exact auto-resume, and the
eval rollout under the f32 LoRA storage.

The frozen Llama body: the port sets requires_grad False on it (the
reference's semantics), so its gradients are neither computed nor counted
in the clip norm; the JAX package counts them in its clip norm
(clip_by_global_norm is chained before multi_transform) and drops only
their update. The JAX oracle here is the JAX package's `build_optimizer`
fed gradients whose 'llm_frozen' leaves are zeroed, which changes only the
clip norm (ROADMAP.md C).

LlamaConfig.tiny() and tests/test_torch_train.py's SMALL_OPTS, every
dropout rate 0 where the two packages are compared (their RNG streams
cannot match). Tolerances: attention gradients 1e-5 (f32 sums in another
order); the Llama's and the text attention's gradients 1e-5 of each leaf's
largest magnitude; train steps at test_two_train_steps_match_jax's bounds
(loss 1e-5 relative, gradients and Adam's moments 1e-4 of each leaf's
largest, updates 1e-5 absolute).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
from prosim_tpu.models.llm import llama as jllama
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_tpu.train import losses as jlosses
from prosim_tpu.train import optim as joptim
from prosim_torch.config import get_config
from prosim_torch.data.synthetic import make_synthetic_batch
from prosim_torch.models.llm import llama as tllama
from prosim_torch.models.prosim import ProSim
from prosim_torch.ops.flash_attn import (
    causal_attention,
    causal_attention_bwd_plain,
    causal_attention_fwd_plain,
    causal_attention_plain,
)
from prosim_torch.train import optim as toptim
from prosim_torch.train.losses import paired_mse_k
from prosim_torch.train.train_step import make_train_step
from prosim_torch.train.trainer import Trainer, find_latest_checkpoint
from prosim_torch.utils.params import flax_to_state_dict, init_params, load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WITH_TEXT = os.path.join(REPO, "configs/with_text.yaml")
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
    "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS", "32",
    "MODEL.CONDITION_TRANSFORMER.NLAYER", "1",
]
NO_DROPOUT = [
    "MODEL.SCENE_ENCODER.ATTN.DROPOUT", "0.0",
    "MODEL.DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.POLICY.ACT_DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.CONDITION_TRANSFORMER.DROPOUT", "0.0",
]
BATCH_KW = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6, num_replan=1)
ATTN_TOL = 1e-5    # abs and rel
LEAF_TOL = 1e-5    # of the leaf's largest magnitude
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4    # of the leaf's largest magnitude
PARAM_TOL = 1e-5
UPD_TOL = 1e-2     # of the leaf's largest update
LORA_LEAVES = ("lora_b", "lora_embed_b")  # zero at init; perturbed so every LoRA leaf gets a gradient


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _scaled_err(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _holed_mask(rng, B, T, n_text, n_block):
    """The tokenizer's layout: text of a random length, pad, then a block
    of n_block slots of which about half are on."""
    mask = np.zeros((B, T), bool)
    for b in range(B):
        mask[b, : rng.integers(1, n_text + 1)] = True
        mask[b, T - n_block:] = rng.random(n_block) > 0.5
    return mask


def _perturb_lora(params, scale=0.05):
    """Flax params with every zero-initialised LoRA factor set to noise."""
    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in LORA_LEAVES:
            return np.asarray(jax.random.normal(jax.random.PRNGKey(x.size), x.shape)) * scale
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("Hq,Hkv,D,T", [(4, 2, 16, 37), (8, 2, 32, 70), (4, 4, 16, 20),
                                        (4, 2, 16, 160)])
def test_causal_attention_grads_match_jax(Hq, Hkv, D, T):
    """dq, dk, dv of sum(out * g), g zero on pad rows (no reader of the
    Llama looks at a pad row), against jax.grad of the JAX dense path with
    k/v repeated per group inside it: causal_attention_bwd_plain, the
    autograd Function and autograd of the dense plain forward, all within
    ATTN_TOL on valid rows (dq) and valid keys (dk, dv). The plain backward
    and the Function give exact zeros on pad rows and pad keys, also with
    NaN in the pad rows of every input."""
    rng = np.random.default_rng(Hq * 1000 + T)
    B = 3
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    mask = _holed_mask(rng, B, T, T // 2, T // 4)
    g = (rng.normal(size=(B, T, Hq, D)) * mask[:, :, None, None]).astype(np.float32)
    scale = 1.0 / D ** 0.5
    cfg = jllama.LlamaConfig.tiny()
    rep = Hq // Hkv

    def jloss(q_, k_, v_):
        out = jllama._causal_attention(q_, jnp.repeat(k_, rep, axis=2), jnp.repeat(v_, rep, axis=2),
                                       jnp.asarray(mask), cfg, False)
        return (out * g).sum()

    ref = _host(jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    T_ = lambda a: torch.from_numpy(a)  # noqa: E731
    tq, tk, tv, tm, tg = T_(q), T_(k), T_(v), T_(mask), T_(g)
    out, lse = causal_attention_fwd_plain(tq, tk, tv, tm, scale)
    plain = causal_attention_bwd_plain(tq, tk, tv, out, lse, tg, tm, scale)

    def autograd(fn):
        xs = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        (fn(*xs, tm, scale) * tg).sum().backward()
        return [x.grad for x in xs]

    fn_grads = autograd(causal_attention)
    dense = autograd(causal_attention_plain)
    rows = (mask, mask, mask)
    for name, grads in (("bwd_plain", plain), ("Function", fn_grads), ("dense autograd", dense)):
        for i, (got, r, m) in enumerate(zip(grads, ref, rows)):
            np.testing.assert_allclose(got.numpy()[m], r[m], atol=ATTN_TOL, rtol=ATTN_TOL,
                                       err_msg=f"{name} d{'qkv'[i]}")
    for name, grads in (("bwd_plain", plain), ("Function", fn_grads)):
        assert all(float(x[~tm].abs().max()) == 0.0 for x in grads), name
    assert not bool(torch.isfinite(lse[~tm[:, None, :].expand_as(lse)]).any())

    # NaN in every pad row of every input reaches no gradient
    poison = lambda x: torch.where(tm[:, :, None, None], x, float("nan"))  # noqa: E731
    again = causal_attention_bwd_plain(poison(tq), poison(tk), poison(tv), poison(out), lse,
                                       poison(tg), tm, scale)
    for a, b in zip(again, plain):
        assert torch.equal(a, b)


def test_causal_attention_is_differentiable_only_under_grad():
    """Outside grad mode the forward is the plain dense path (eval numbers
    unchanged); with q requiring grad it is the Function, whose output
    equals the dense path on valid rows and is zero on pad rows."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 12, h, 16)).astype(np.float32))
               for h in (4, 2, 2))
    mask = torch.from_numpy(_holed_mask(rng, 2, 12, 6, 4))
    dense = causal_attention_plain(q, k, v, mask, 0.25)
    assert torch.equal(causal_attention(q, k, v, mask, 0.25), dense)
    out = causal_attention(q.requires_grad_(True), k, v, mask, 0.25)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "CausalAttentionBackward"
    assert torch.equal(out.detach()[mask], dense[mask]) and not out.detach()[~mask].any()
    with torch.no_grad():
        assert causal_attention(q, k, v, mask, 0.25).grad_fn is None


# -------------------------------------------------------------------- Llama

def _llama_inputs(seed, lora_rank=4):
    rng = np.random.default_rng(seed)
    jcfg = jllama.LlamaConfig.tiny(lora_rank=lora_rank)
    B, T, N = 2, 29, 5
    ids = rng.integers(0, jcfg.total_vocab, size=(B, T)).astype(np.int32)
    mask = _holed_mask(rng, B, T, 20, 6)
    slots = np.where(rng.random((B, T)) > 0.8, rng.integers(0, N, size=(B, T)), -1).astype(np.int32)
    agent = rng.normal(size=(B, N, jcfg.hidden_size)).astype(np.float32)
    g = (rng.normal(size=(B, T, jcfg.hidden_size)) * mask[..., None]).astype(np.float32)
    return jcfg, ids, mask, slots, agent, g


@pytest.fixture(scope="module")
def llama_ref():
    """JAX LlamaModel (tiny, LoRA 4, perturbed params) gradients of
    sum(hidden * g) with respect to its params and agent_embs, with
    nn.remat blocks off and on."""
    jcfg, ids, mask, slots, agent, g = _llama_inputs(3)
    out = {}
    for remat in (False, True):
        jm = jllama.LlamaModel(dataclasses.replace(jcfg, remat=remat))
        args = (jnp.asarray(ids), None, jnp.asarray(mask))
        params = jm.init(jax.random.PRNGKey(0), *args, agent_embs=jnp.asarray(agent),
                         agent_slot_ids=jnp.asarray(slots))["params"]
        params = jax.tree.map(
            lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)

        def loss(p, a):
            h = jm.apply({"params": p}, *args, agent_embs=a, agent_slot_ids=jnp.asarray(slots))
            return (h * g).sum()

        grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
        out[remat] = (_host(params), _host(grad(params, jnp.asarray(agent))))
    return out


def _port_llama_grads(params, remat):
    _, ids, mask, slots, agent, g = _llama_inputs(3)
    tm = tllama.LlamaModel(dataclasses.replace(tllama.LlamaConfig.tiny(lora_rank=4), remat=remat))
    load_flax_params(tm, params)
    for n, p in tm.named_parameters():
        p.requires_grad_("lora" in n)
    a = torch.from_numpy(agent).requires_grad_(True)
    h = tm(torch.from_numpy(ids), torch.from_numpy(mask), agent_embs=a,
           agent_slot_ids=torch.from_numpy(slots))
    (h * torch.from_numpy(g)).sum().backward()
    return {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}, a.grad, tm


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_llama_lora_grads_match_jax(llama_ref, remat):
    """Every LoRA leaf (q/k/v and the embedding, stored in f32) and
    agent_embs within LEAF_TOL of the JAX gradient; the frozen body gets
    none. Remat on is bitwise remat off."""
    params, (jgrads, jagent) = llama_ref[remat]
    grads, agent_grad, tm = _port_llama_grads(params, remat)
    ref = flax_to_state_dict(jgrads)
    lora = {n for n in ref if "lora" in n}
    assert set(grads) == lora and len(lora) == 2 + 2 * 3 * 2
    assert all(tm.get_parameter(n).dtype == torch.float32 for n in lora)
    for n in lora:
        assert float(grads[n].abs().max()) > 0, n
        assert _scaled_err(grads[n], ref[n]) <= LEAF_TOL, (n, _scaled_err(grads[n], ref[n]))
    assert _scaled_err(agent_grad, jagent) <= LEAF_TOL
    if remat:
        off, off_agent, _ = _port_llama_grads(params, False)
        assert torch.equal(agent_grad, off_agent)
        assert all(torch.equal(grads[n], off[n]) for n in lora)


def test_zero_injected_token_grads_explode_in_both_packages():
    """An <A{i}> token replaced by an exactly zero vector (an agent the text
    names but the batch does not hold, injected through zero-bias adapters
    at the seeded init) stays a zero row through every block; each
    RMSNorm's backward scales its gradient by 1/sqrt(eps), so the gradient
    into that row explodes with depth. The port's gradients follow the JAX
    package's there too: at 8 layers both are ~1e22 and agree within
    LEAF_TOL of the largest (at 32 layers both overflow to NaN, which is
    why chip_smoke.py's phase 8 draws ln_prompt's bias)."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(lora_rank=4), num_layers=8)
    rng = np.random.default_rng(0)
    B, T, N = 1, 12, 3
    ids = rng.integers(0, jcfg.total_vocab, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), bool)
    mask[0, 8:] = False
    slots = -np.ones((B, T), np.int32)
    slots[0, 0] = 0
    agent = rng.normal(size=(B, N, jcfg.hidden_size)).astype(np.float32)
    agent[0, 0] = 0.0
    g = (rng.normal(size=(B, T, jcfg.hidden_size)) * mask[..., None]).astype(np.float32)
    jm = jllama.LlamaModel(jcfg)
    args = (jnp.asarray(ids), None, jnp.asarray(mask))
    params = jm.init(jax.random.PRNGKey(0), *args, agent_embs=jnp.asarray(agent),
                     agent_slot_ids=jnp.asarray(slots))["params"]

    def loss(a):
        return (jm.apply({"params": params}, *args, agent_embs=a,
                         agent_slot_ids=jnp.asarray(slots)) * g).sum()

    ref = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(agent)))
    tm = tllama.LlamaModel(dataclasses.replace(tllama.LlamaConfig.tiny(lora_rank=4), num_layers=8))
    load_flax_params(tm, _host(params))
    a = torch.from_numpy(agent).requires_grad_(True)
    (tm(torch.from_numpy(ids), torch.from_numpy(mask), agent_embs=a,
        agent_slot_ids=torch.from_numpy(slots)) * torch.from_numpy(g)).sum().backward()
    assert np.abs(ref).max() > 1e20 and bool(torch.isfinite(a.grad).all())
    assert _scaled_err(a.grad, ref) <= LEAF_TOL


def test_llama_text_attn_train_matches_jax():
    """LlamaTextAttn under autograd: its output and prompt_mask_pred_loss,
    and the gradients of sum(out * g) + 1000 loss into prompt_to_llm,
    ln_prompt, llm_to_cond, mask_pred_head, the LoRA leaves and the
    incoming embeddings, against jax.grad of the flax module."""
    from prosim_tpu.data.batch import Prompt as JPrompt
    from prosim_tpu.data.text_conditions import build_one_text_condition
    from prosim_tpu.models.llm import tokenizer as jtok
    from prosim_tpu.models.llm.text_attn import LlamaTextAttn as JTextAttn
    from prosim_torch.data.batch import Prompt
    from prosim_torch.models.llm.text_attn import LlamaTextAttn

    rng = np.random.default_rng(11)
    B, N, D = 3, 6, 16
    texts = ["<A0> slows down. <A2> turns left.", "<A1> stops. <A1> waits.", "<A5> turns right."]
    pm = np.array([[f"<A{a}>" in t for a in range(N)] for t in texts])
    mask = rng.random((B, N)) > 0.2
    mask[:, 0] = True
    prompt = dict(feat=np.zeros((B, N, 7), np.float32), mask=mask,
                  pos=rng.normal(size=(B, N, 2)).astype(np.float32),
                  ori=rng.normal(size=(B, N)).astype(np.float32),
                  agent_type=np.ones((B, N), np.int32),
                  obs_index=np.tile(np.arange(N, dtype=np.int32), (B, 1)),
                  extent=np.ones((B, N, 2), np.float32), goal_point=np.zeros((B, N, 2), np.float32))
    tc = build_one_text_condition(jtok.ByteTokenizer(), texts, pm, max_len=40,
                                  use_prompt_token=True, agent_valid=mask)
    emb = rng.normal(size=(B, N, D)).astype(np.float32)
    g = rng.normal(size=(B, N, D)).astype(np.float32)
    jm = JTextAttn(hidden_dim=D, llm_config=jllama.LlamaConfig.tiny(lora_rank=16))
    jtc = {k: jnp.asarray(v) for k, v in tc.items()}
    jprompt = JPrompt(**{k: jnp.asarray(v) for k, v in prompt.items()})
    params = jm.init(jax.random.PRNGKey(0), jtc, jnp.asarray(emb), jprompt)["params"]
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)

    def jloss(p, e):
        out, aux = jm.apply({"params": p}, jtc, e, jprompt)
        return (out * g).sum() + 1000.0 * aux["prompt_mask_pred_loss"], (out, aux)

    (_, (ref_out, ref_aux)), (jgrads, jemb) = _host(jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(emb)))

    tm = LlamaTextAttn(D, tllama.LlamaConfig.tiny(lora_rank=16))
    load_flax_params(tm, _host(params))
    for n, p in tm.named_parameters():
        p.requires_grad_(not n.startswith("llm.") or "lora" in n)
    e = torch.from_numpy(emb).requires_grad_(True)
    out, aux = tm({k: torch.from_numpy(v) for k, v in tc.items()}, e, Prompt.from_numpy(prompt))
    ((out * torch.from_numpy(g)).sum() + 1000.0 * aux["prompt_mask_pred_loss"]).backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=1e-5, rtol=1e-5)
    assert float(aux["prompt_mask_pred_loss"].detach()) == pytest.approx(
        float(ref_aux["prompt_mask_pred_loss"]), rel=1e-5)
    ref = flax_to_state_dict(jgrads)
    trained = {n: p.grad for n, p in tm.named_parameters() if p.requires_grad}
    prefixes = ("prompt_to_llm", "ln_prompt", "llm_to_cond", "mask_pred_head")
    assert all(any(n.startswith(x) for n in trained) for x in prefixes)
    for n, grad in trained.items():
        assert grad is not None and float(grad.abs().max()) > 0, n
        assert _scaled_err(grad, ref[n]) <= LEAF_TOL, (n, _scaled_err(grad, ref[n]))
    assert _scaled_err(e.grad, jemb) <= LEAF_TOL


# --------------------------------------------------------------- train step

def _configs(opts):
    return jax_get_config(WITH_TEXT, opts), get_config(WITH_TEXT, opts)


@pytest.fixture(scope="module")
def ref():
    """The JAX side of configs/with_text.yaml at one replan step: params
    (LoRA B factors perturbed), batch, the jitted value_and_grad of the
    train step's loss, and the 'llm_frozen' label of each leaf."""
    jcfg, tcfg = _configs(SMALL_OPTS + NO_DROPOUT)
    jm = JaxProSim(jcfg)
    jb = jax_synthetic(jcfg, seed=0, **BATCH_KW)
    params = _perturb_lora(_host(jm.init(jax.random.PRNGKey(0), jb)))
    loss_impl = jlosses.loss_func_dict[jcfg.TASK.MOTION_PRED.LOSS]

    def loss_fn(p, b, k):  # the JAX make_train_step's loss_fn
        terms = loss_impl(b, jm.forward(p, b, "train", k), jcfg)
        return terms["full_loss"] * jcfg.TASK.MOTION_PRED.WEIGHT, terms

    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: joptim._group_of("/".join(str(getattr(k, "key", k)) for k in path), jcfg),
        params)
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    key = jax.random.PRNGKey(1)
    jax.block_until_ready(vg(params, jb, key))  # compiled here, once for every case
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, jb=jb, labels=labels, vg=vg, key=key)


def _zero_frozen(grads, labels):
    return jax.tree.map(lambda g, lab: jnp.zeros_like(g) if lab == "llm_frozen" else g,
                        grads, labels)


def _adam_moments(state, params):
    """optax's Adam moments merged over the groups by torch parameter name;
    NaN for the leaves of the set_to_zero group, which have none."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    is_masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    adam = [s for s in jax.tree.leaves(state, is_leaf=is_adam) if is_adam(s)]
    merged = {}
    for field in ("mu", "nu"):
        flat = {path: np.asarray(x) for s in adam
                for path, x in jax.tree_util.tree_leaves_with_path(getattr(s, field),
                                                                   is_leaf=is_masked)
                if not is_masked(x)}
        merged[field] = flax_to_state_dict(jax.tree_util.tree_map_with_path(
            lambda path, p: flat.get(path, np.full(p.shape, np.nan, np.float32)), params))
    return merged


@pytest.mark.parametrize("clip", ["clipped", "unclipped"])
def test_two_train_steps_match_jax(ref, clip):
    """make_train_step on configs/with_text.yaml (WARMUP_STEPS 1: the first
    update is schedule(0) = 0, the second runs at the full LR) against
    jax.value_and_grad + the JAX package's build_optimizer with the frozen
    body's gradients zeroed before the update. 'clipped': GRAD_CLIP 0.5 and
    a gradient norm far above it, so the clip acts; 'unclipped': GRAD_CLIP
    0, no clip in either package. After each step: the loss, the gradient norm (the frozen body not
    counted), Adam's moments of every trained leaf, and each leaf's update
    where the JAX gradient is above GRAD_TOL of the leaf's largest (see
    tests/test_torch_train.py::test_two_train_steps_match_jax). The frozen
    body carries no .grad and stays bitwise unchanged; the LoRA and adapter
    leaves train at their groups' LRs."""
    opts = SMALL_OPTS + NO_DROPOUT + ["TRAIN.SCHEDULER.WARMUP_STEPS", "1",
                                      "TRAIN.GRAD_CLIP", "0.5" if clip == "clipped" else "0.0"]
    jcfg, tcfg = _configs(opts)
    params = ref["params"]
    opt = joptim.build_optimizer(jcfg, params)
    state = opt.init(params)
    update = jax.jit(opt.update)
    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, params)
    topt, sched = toptim.build_optimizer(tcfg, tm)
    groups = toptim.param_groups(tm, tcfg)
    assert groups["lora"] and groups["adapter"] and groups["llm_frozen"]
    frozen = {n for n, p in tm.named_parameters() if any(p is q for q in groups["llm_frozen"])}
    assert all(not p.requires_grad for p in groups["llm_frozen"])
    names = {id(p): n for n, p in tm.named_parameters()}
    assert {g["name"] for g in topt.param_groups} >= {"lora", "adapter"}
    lrs = toptim.group_lrs(tcfg)
    llm_cfg = tcfg.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM
    assert lrs["lora"] == pytest.approx(tcfg.TRAIN.LR * llm_cfg.LORA_LR_SCALE)
    assert lrs["adapter"] == pytest.approx(tcfg.TRAIN.LR * llm_cfg.ADAPTER_LR_SCALE)
    step = make_train_step(tm, topt, sched, tcfg)
    tb = make_synthetic_batch(tcfg, seed=0, device="cpu", **BATCH_KW)
    p0 = {n: p.detach().clone() for n, p in tm.named_parameters()}
    j0 = flax_to_state_dict(params)
    floor = {}
    for i in range(2):
        (loss, _), grads = ref["vg"](params, ref["jb"], ref["key"])
        grads = _zero_frozen(grads, ref["labels"])
        g = flax_to_state_dict(_host(grads))
        for n, x in g.items():
            below = np.abs(x) <= GRAD_TOL * np.abs(x).max()
            floor[n] = floor.get(n, below) | below
        norm = float(optax.global_norm(grads))
        assert norm > 0.5 and (tcfg.TRAIN.GRAD_CLIP > 0) == (clip == "clipped")
        updates, state = update(grads, state, params)
        params = _host(optax.apply_updates(params, updates))
        got = step(tb, 0)
        assert float(got["full_loss"]) == pytest.approx(float(loss), rel=LOSS_RTOL), i
        assert float(got["prompt_mask_pred_loss"]) > 0
        assert float(got["grad_norm"]) == pytest.approx(norm, rel=1e-4), i
        moments = _adam_moments(state, params)
        pj = flax_to_state_dict(params)
        worst = (0.0, None)
        for n, p in tm.named_parameters():
            if n in frozen:
                assert p.grad is None and torch.equal(p.detach(), p0[n]), n
                assert np.array_equal(pj[n], j0[n]), n
                continue
            st = topt.state[p]
            for field, mine, tol in (("mu", st["exp_avg"], GRAD_TOL),
                                     ("nu", st["exp_avg_sq"], 2 * GRAD_TOL)):
                err = _scaled_err(mine, moments[field][n])
                assert err <= tol, f"step {i} {field} {n}: {err:.3e}"
            mine, theirs = p.detach().numpy() - j0[n], pj[n] - j0[n]
            if i == 0 or "pred_mlp" in n or not theirs.any():
                assert not mine.any() and not theirs.any(), (i, n)
                continue
            diff = np.abs(mine - theirs)[~floor[n]]
            err = float(diff.max(initial=0.0) / np.abs(theirs).max())
            if err > worst[0]:
                worst = (err, n)
            assert diff.max(initial=0.0) <= PARAM_TOL, f"step {i} {n}: {diff.max():.3e}"
        assert worst[0] <= UPD_TOL, f"step {i}: worst leaf {worst[1]}: {worst[0]:.3e}"
    moved = {names[id(p)] for grp in ("lora", "adapter") for p in groups[grp]
             if not torch.equal(p.detach(), p0[names[id(p)]])}
    assert {n for n in moved if "lora_b" in n} and {n for n in moved if "prompt_to_llm" in n}


def test_block_forwards_per_step_under_nested_remat():
    """A train step under REMAT_POLICY full runs each Llama block forward
    three times with per-block remat (the forward, prepare's recompute, the
    block's own recompute) and twice without; the gradients are bitwise
    the same. Every layer's q/k/v lora_b gets a non-zero gradient."""
    cfg = get_config(WITH_TEXT, SMALL_OPTS)
    batch = make_synthetic_batch(cfg, seed=4, device="cpu", **dict(BATCH_KW, num_replan=2))
    grads, counts = {}, {}
    for remat in (False, True):
        model = ProSim(cfg, device="cpu")
        init_params(model, seed=0)
        toptim.build_optimizer(cfg, model)
        llm = model.condition_transformer_policy_decoder.text_attn.llm
        llm.cfg = dataclasses.replace(llm.cfg, remat=remat)
        n = [0]
        for i in range(llm.cfg.num_layers):
            getattr(llm, f"layer_{i}").register_forward_pre_hook(
                lambda *_: n.__setitem__(0, n[0] + 1))
        out = model.forward_train(batch, seed=3)
        paired_mse_k(batch, out, cfg)["full_loss"].backward()
        counts[remat] = n[0] // llm.cfg.num_layers
        grads[remat] = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
        qkv = [k for k in grads[remat] if k.endswith(("q_proj.lora_b", "k_proj.lora_b",
                                                      "v_proj.lora_b"))]
        assert len(qkv) == 3 * llm.cfg.num_layers
        assert all(float(grads[remat][k].abs().max()) > 0 for k in qkv)
        assert not any(k.startswith("condition_transformer_policy_decoder.text_attn.llm.")
                       and "lora" not in k for k in grads[remat])
    assert counts == {False: 2, True: 3}
    assert set(grads[True]) == set(grads[False])
    assert all(torch.equal(grads[True][k], grads[False][k]) for k in grads[False])


# ------------------------------------------------------------------ trainer

def _trainer(tmp, extra=(), name="run"):
    cfg = get_config(WITH_TEXT, SMALL_OPTS + [
        "EXPERIMENT_DIR", str(tmp), "EXPERIMENT_NAME", name, "CHECKPOINT_INTERVAL", "1",
        "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.BATCH_SIZE", "2", *extra])
    trainer = Trainer(cfg, device="cpu")
    trainer.setup()
    return trainer


def test_fit_then_auto_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """configs/with_text.yaml through Trainer.fit: three steps in one run,
    against one step, then an auto-resume (LOAD_CHECKPOINT_TRAINER) from a
    checkpoint without the frozen body, then two steps: bitwise equal
    parameters and Adam state. The body is re-drawn from the seed, carries
    no .grad and never moves; the LoRA and adapter leaves move; every loss
    term is finite, prompt_mask_pred_loss among them."""
    import json

    full = _trainer(tmp_path, name="full")
    batches = [make_synthetic_batch(full.config, seed=s, device="cpu", **BATCH_KW)
               for s in (2, 3, 4)]
    # with_text.yaml's four condition types ride in every training batch
    assert set(batches[0].conditions) == set(full.config.PROMPT.CONDITION.TYPES) == {
        "llm_text_OneText", "goal", "v_action_tag", "drag_point"}
    body = {n: p.detach().clone() for n, p in full.model.named_parameters()
            if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in full.model.named_parameters()}
    assert body and all(".llm." in n and "lora" not in n for n in body)
    full.fit(batches, max_steps=3)  # max_steps: a log line every step
    first = _trainer(tmp_path, name="cut")
    first.fit(batches[:1], max_steps=1)
    ckpt = torch.load(find_latest_checkpoint(first.run_dir), weights_only=False)
    assert not set(body) & set(ckpt["model"])
    assert any("lora" in n for n in ckpt["model"])
    resumed = _trainer(tmp_path, ["LOAD_CHECKPOINT_TRAINER", "True"], name="cut")
    assert resumed.step == 1
    resumed.fit(batches[1:], max_steps=3)
    assert resumed.step == 3
    for n, p in full.model.named_parameters():
        q = resumed.model.get_parameter(n)
        assert torch.equal(p.detach(), q.detach()), n
        if n in body:
            assert p.grad is None and q.grad is None and torch.equal(p.detach(), body[n]), n
    sa, sb = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) for i in sa)
    moved = [n for n, p in full.model.named_parameters()
             if ("lora" in n or "prompt_to_llm" in n or "llm_to_cond" in n)
             and not torch.equal(p.detach(), start[n])]
    assert any("lora_embed" in n for n in moved) and any("q_proj.lora" in n for n in moved)
    assert any("llm_to_cond" in n for n in moved)
    recs = [json.loads(line) for line in open(full.log_path)]
    train = [r for r in recs if "train/full_loss" in r]
    assert train and all(np.isfinite(v) for r in train for k, v in r.items()
                         if k.startswith("train/"))
    assert all(r["train/prompt_mask_pred_loss"] > 0 for r in train)


# --------------------------------------------------------------------- eval

def test_f32_lora_storage_leaves_the_eval_rollout_bitwise_unchanged():
    """One flax tree of configs/with_text.yaml (LoRA B factors non-zero)
    carried into the port with the LoRA leaves stored in f32 (now) and in
    cfg.dtype (as before): the eval rollout is bitwise the same. And at a
    bf16 LoraLinear, f32 storage of bf16-exact factors gives the bf16
    storage's output bitwise (the cast at the product is exact)."""
    jcfg, tcfg = _configs(SMALL_OPTS)
    jm = JaxProSim(jcfg)
    params = _perturb_lora(_host(jm.init(jax.random.PRNGKey(2), jax_synthetic(
        jcfg, seed=1, **BATCH_KW))))
    batch = make_synthetic_batch(tcfg, seed=1, device="cpu", **dict(BATCH_KW, num_replan=2))
    outs = []
    for storage in ("f32", "cfg.dtype"):
        model = ProSim(tcfg, device="cpu")
        if storage == "cfg.dtype":
            llm = model.condition_transformer_policy_decoder.text_attn.llm
            for mod in llm.modules():
                for name, p in list(mod.named_parameters(recurse=False)):
                    if "lora" in name:
                        setattr(mod, name, torch.nn.Parameter(p.detach().to(llm.cfg.dtype)))
        load_flax_params(model, params)
        dtypes = {p.dtype for n, p in model.named_parameters() if "lora" in n}
        assert dtypes == {torch.float32}
        outs.append(model(batch, mode="val"))
    for key in ("rollout_traj", "motion_pred"):
        assert torch.equal(outs[0][key], outs[1][key]), key

    lin32 = tllama.LoraLinear(32, 24, lora_rank=4, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        lin32.weight.copy_(torch.randn(24, 32, generator=g))
        lin32.lora_a.copy_(torch.randn(32, 4, generator=g).bfloat16().float())
        lin32.lora_b.copy_(torch.randn(4, 24, generator=g).bfloat16().float())
    lin16 = tllama.LoraLinear(32, 24, lora_rank=4, dtype=torch.bfloat16)
    lin16.weight = lin32.weight
    lin16.lora_a = torch.nn.Parameter(lin32.lora_a.detach().bfloat16())
    lin16.lora_b = torch.nn.Parameter(lin32.lora_b.detach().bfloat16())
    x = torch.randn(5, 32, generator=g)
    assert torch.equal(lin32(x), lin16(x))
