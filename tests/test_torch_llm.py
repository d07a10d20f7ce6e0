"""The port's Llama text path against prosim_tpu's, on the CPU in f32 at
LlamaConfig.tiny(): the plain causal attention (the eager twin of the
flash-attention kernel) against the JAX dense path, the decoder, the host
tokenization and LlamaTextAttn. Inputs come from numpy with fixed seeds;
flax params (perturbed, so LoRA B factors and norm scales are non-trivial)
are carried into torch by prosim_torch.utils.params. Tolerance 1e-5: f32
sums taken in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.models.llm import llama as jllama
from prosim_tpu.models.llm import tokenizer as jtok
from prosim_torch.models.llm import llama as tllama
from prosim_torch.models.llm import tokenizer as ttok
from prosim_torch.utils.params import load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
MODES = ["none", "add", "concat", "concat_repeat", "concat_sep", "concat_semantic"]


def _host(tree):
    """A JAX result as numpy arrays, on the host before the port runs."""
    return jax.tree.map(np.asarray, tree)


def _perturbed_params(flax_mod, *args, **kw):
    params = flax_mod.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    return jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)


def _holed_mask(rng, B, T, n_text, n_block):
    """The tokenizer's layout: text of a random length, pad, then a block
    of n_block slots of which about half are on."""
    mask = np.zeros((B, T), bool)
    for b in range(B):
        mask[b, : rng.integers(1, n_text + 1)] = True
        mask[b, T - n_block:] = rng.random(n_block) > 0.5
    return mask


def _prompt_arrays(rng, B, N):
    mask = rng.random((B, N)) > 0.2
    mask[:, 0] = True
    return dict(feat=np.zeros((B, N, 7), np.float32), mask=mask,
                pos=rng.normal(size=(B, N, 2)).astype(np.float32),
                ori=rng.normal(size=(B, N)).astype(np.float32),
                agent_type=np.ones((B, N), np.int32),
                obs_index=np.tile(np.arange(N, dtype=np.int32), (B, 1)),
                extent=np.ones((B, N, 2), np.float32),
                goal_point=np.zeros((B, N, 2), np.float32))


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("Hq,Hkv,D,T", [(4, 2, 16, 37), (8, 2, 32, 70), (4, 4, 16, 20)])
def test_causal_attention_plain_matches_jax(Hq, Hkv, D, T):
    """GQA and a holed key mask; compared on the valid query rows (the rows
    the flash-attention kernel defines; it writes zeros on pad rows)."""
    from prosim_torch.ops.flash_attn import causal_attention

    rng = np.random.default_rng(Hq * 100 + T)
    B = 3
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    mask = _holed_mask(rng, B, T, T // 2, T // 4)
    rep = Hq // Hkv
    ref = _host(jllama._causal_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2), jnp.repeat(jnp.asarray(v), rep, axis=2),
        jnp.asarray(mask), jllama.LlamaConfig.tiny(), False))
    got = causal_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), 1.0 / D ** 0.5)
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], **TOL)


def test_causal_attention_plain_matches_jax_at_tiny_shape():
    """f32 at tiny()'s shape (head_dim 16, Hq 4, Hkv 2) and the demo's text
    layout (256 text slots + the 128-slot prompt block, T 384) with the
    tokenizer's holed mask: every row, pad rows included, within 1e-6."""
    from prosim_torch.ops.flash_attn import causal_attention_plain

    cfg = jllama.LlamaConfig.tiny()
    B, T, Hq, Hkv, D = 2, 384, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(384)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    mask = _holed_mask(rng, B, T, 256, 128)
    rep = Hq // Hkv
    ref = _host(jllama._causal_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2), jnp.repeat(jnp.asarray(v), rep, axis=2),
        jnp.asarray(mask), cfg, False))
    got = causal_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)), 1.0 / D ** 0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_demo_config_resolves_to_the_f32_tiny_llama():
    """configs/waymo_demo.yaml as shipped (TEXT.LLM.ARCH auto, no weights)
    gives both packages the f32 tiny() Llama with head_dim 16: on the card
    its attention is B4's f32 instantiation."""
    from prosim_tpu.config import get_config as jax_get_config
    from prosim_tpu.models.condition.transformer import _resolve_llm_config as jax_resolve
    from prosim_torch.config import get_config
    from prosim_torch.models.condition.transformer import build_condition_transformer

    path = os.path.join(REPO, "configs", "waymo_demo.yaml")
    ct = jax_get_config(path).MODEL.CONDITION_TRANSFORMER
    llm = ct.CONDITION_ENCODER.TEXT.LLM
    jcfg = jax_resolve(llm.ARCH, llm.WEIGHTS_PATH, ct.TEXT_ATTN.LORA.R if ct.TEXT_ATTN.LORA.ENABLE else 0)
    tcfg = build_condition_transformer(get_config(path)).text_attn.llm.cfg
    assert jcfg.dtype == jnp.float32 and tcfg.dtype == torch.float32
    assert jcfg.head_dim == tcfg.head_dim == 16
    assert (jcfg.num_heads, jcfg.num_kv_heads, jcfg.num_layers, jcfg.lora_rank) == (
        tcfg.num_heads, tcfg.num_kv_heads, tcfg.num_layers, tcfg.lora_rank)


# --------------------------------------------------------------- decoder

@pytest.mark.parametrize("lora_rank", [0, 4])
def test_llama_model_matches_jax(lora_rank):
    """Hidden states at the valid positions, with agent-token replacement
    and non-zero LoRA factors (q/k/v and the embedding)."""
    rng = np.random.default_rng(lora_rank)
    jcfg = jllama.LlamaConfig.tiny(lora_rank=lora_rank)
    B, T, N = 2, 29, 5
    ids = rng.integers(0, jcfg.total_vocab, size=(B, T)).astype(np.int32)
    mask = _holed_mask(rng, B, T, 20, 6)
    slots = np.where(rng.random((B, T)) > 0.8, rng.integers(0, N, size=(B, T)), -1).astype(np.int32)
    agent = rng.normal(size=(B, N, jcfg.hidden_size)).astype(np.float32)
    jm = jllama.LlamaModel(jcfg)
    args = (jnp.asarray(ids), None, jnp.asarray(mask))
    kw = dict(agent_embs=jnp.asarray(agent), agent_slot_ids=jnp.asarray(slots))
    params = _perturbed_params(jm, *args, **kw)
    ref = _host(jm.apply({"params": params}, *args, **kw))

    tm = tllama.LlamaModel(tllama.LlamaConfig.tiny(lora_rank=lora_rank))
    load_flax_params(tm, _host(params))
    if lora_rank:
        assert float(tm.lora_embed_b.detach().abs().min()) > 0
        assert float(tm.layer_0.q_proj.lora_b.detach().abs().min()) > 0
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask), agent_embs=torch.from_numpy(agent),
                 agent_slot_ids=torch.from_numpy(slots))
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], **TOL)


# ---------------------------------------------------------- tokenization

TEXTS = ["<A0> slows down. <A3> turns left.", "<A7> goes straight.\n<A1> stops.",
         "x" * 80 + " <A2> speeds up", "", "<A130> is not an agent here. <A4> keeps lane."]


@pytest.mark.parametrize("mode", MODES)
def test_one_text_condition_arrays_match_jax(mode):
    """Tokenizer, prompt block and OneText assembly give the JAX arrays:
    left truncation, agent tokens beyond N, each block layout, with the
    block over the addressed agents or over every valid agent."""
    from prosim_tpu.data import text_conditions as jtc
    from prosim_torch.data import text_conditions as ttc

    rng = np.random.default_rng(len(mode))
    B, N, L = len(TEXTS), 6, 48
    pm = rng.random((B, N)) > 0.6
    valid = rng.random((B, N)) > 0.3
    for use_text_prompt_mask in (False, True):
        kw = dict(max_len=L, use_prompt_token=True, agent_token_mode=mode,
                  use_text_prompt_mask=use_text_prompt_mask, agent_valid=valid)
        ref = jtc.build_one_text_condition(jtok.ByteTokenizer(), TEXTS, pm, **kw)
        got = ttc.build_one_text_condition(ttok.ByteTokenizer(), TEXTS, pm, **kw)
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
            assert got[key].dtype == ref[key].dtype, key
    # no prompt block, and prompt masks taken from the texts
    ref = jtok.tokenize_batch(jtok.ByteTokenizer(), TEXTS, L, N)
    got = ttok.tokenize_batch(ttok.ByteTokenizer(), TEXTS, L, N)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    instr = {11: "stop moving", 2: "<A2> turns right.", 5: "yield"}
    assert ttok.build_text_prompt(instr) == jtok.build_text_prompt(instr)
    pairs = [("<A1> stops.", 1), ("", 4), ("<A0> goes.", 0), ("<A9> far", 9)]
    rt, rm = jtc.concat_one_text(pairs, N, shuffle=True)
    gt, gm = ttc.concat_one_text(pairs, N, shuffle=True)
    assert gt == rt
    np.testing.assert_array_equal(gm, rm)


# ------------------------------------------------------------ text attn

@pytest.mark.parametrize("agent_token_mode", ["none", "add"])
@pytest.mark.parametrize("read_mode", ["read_positions", "scatter_back"])
def test_llama_text_attn_matches_jax(read_mode, agent_token_mode):
    """LlamaTextAttn's conditioned embeddings and prompt_mask_pred loss."""
    from prosim_tpu.data.batch import Prompt as JPrompt
    from prosim_tpu.data.text_conditions import build_one_text_condition
    from prosim_tpu.models.llm.text_attn import LlamaTextAttn as JTextAttn
    from prosim_torch.data.batch import Prompt
    from prosim_torch.models.llm.text_attn import LlamaTextAttn

    rng = np.random.default_rng(7)
    B, N, D = 3, 6, 16
    texts = ["<A0> slows down. <A2> turns left.", "<A1> stops. <A1> waits.", "<A5> turns right."]
    pm = np.zeros((B, N), bool)
    for b, t in enumerate(texts):
        for a in range(N):
            pm[b, a] = f"<A{a}>" in t
    prompt = _prompt_arrays(rng, B, N)
    tc = build_one_text_condition(jtok.ByteTokenizer(), texts, pm, max_len=40,
                                  use_prompt_token=read_mode == "read_positions",
                                  agent_token_mode=agent_token_mode, agent_valid=prompt["mask"])
    assert ("read_positions" in tc) == (read_mode == "read_positions")
    emb = rng.normal(size=(B, N, D)).astype(np.float32)
    jcfg = jllama.LlamaConfig.tiny()
    jm = JTextAttn(hidden_dim=D, llm_config=jcfg, agent_token_mode=agent_token_mode)
    jargs = ({k: jnp.asarray(v) for k, v in tc.items()}, jnp.asarray(emb),
             JPrompt(**{k: jnp.asarray(v) for k, v in prompt.items()}))
    params = _perturbed_params(jm, *jargs)
    ref, ref_aux = _host(jm.apply({"params": params}, *jargs))

    tm = LlamaTextAttn(D, tllama.LlamaConfig.tiny(), agent_token_mode=agent_token_mode)
    load_flax_params(tm, _host(params))
    with torch.no_grad():
        got, aux = tm({k: torch.from_numpy(v) for k, v in tc.items()}, torch.from_numpy(emb),
                      Prompt.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert float(np.abs(ref - emb).max()) > 1e-3  # the text moved some agents
    np.testing.assert_allclose(float(aux["prompt_mask_pred_loss"]),
                               float(ref_aux["prompt_mask_pred_loss"]), **TOL)
