"""The QA probe, prosim_torch against prosim_tpu on the CPU in f32: the
probe's batch (build_qa_batch, bit for bit), the Llama's LM head (logits at
LlamaConfig.tiny()), and LlamaTextAttnQA's qa_loss with its gradients with
respect to the agent embeddings, the LoRA leaves and prompt_to_llm, within
1e-5 relative (each gradient within 1e-5 of its largest magnitude). The
flax params are carried across by load_flax_params, with the LoRA B factors
drawn (they start at zero, which would leave the A factors no gradient).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.data.batch import Prompt as JaxPrompt
from prosim_tpu.models.llm import llama as jllama
from prosim_tpu.models.llm import text_attn as jtext
from prosim_tpu.models.llm import tokenizer as jtok
from prosim_torch.config import get_config
from prosim_torch.data.batch import Prompt
from prosim_torch.models.condition.text import NoTextAttn
from prosim_torch.models.condition.transformer import build_condition_transformer
from prosim_torch.models.llm import llama as tllama
from prosim_torch.models.llm import text_attn as ttext
from prosim_torch.models.llm import tokenizer as ttok
from prosim_torch.utils.params import flax_to_state_dict, load_flax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5


def _host(tree):
    """A JAX result as numpy arrays (see tests/test_torch_model.py:_host)."""
    return jax.tree.map(np.asarray, tree)


def _draw_lora_b(params, seed):
    """The params with every LoRA B factor drawn N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (
            rng.normal(0, 0.02, np.shape(v)).astype(np.float32)
            if k in ("lora_b", "lora_embed_b") else np.asarray(v)) for k, v in tree.items()}
    return walk(jax.tree.map(lambda x: x.unbox() if hasattr(x, "unbox") else x, params,
                             is_leaf=lambda x: hasattr(x, "unbox")))


@pytest.mark.parametrize("contextual,max_len", [(True, 128), (False, 128), (True, 70)])
def test_build_qa_batch_bitwise(contextual, max_len):
    """The same arrays as the JAX package from the same rng: every scene's
    queried agent (rng.choice over its valid agents, 0 where it has none),
    the tokens (70 cuts the answer short), the agent slots and the labels."""
    B, N = 4, 6
    valid = np.random.default_rng(3).random((B, N)) > 0.4
    valid[2] = False  # a scene with no valid agent
    gt = np.random.default_rng(1).normal(scale=10, size=(B, N, 2)).astype(np.float32)
    for tj, tt in ((jtok.ByteTokenizer(), ttok.ByteTokenizer()),
                   (jtok.ByteTokenizer(base_vocab=128256), ttok.ByteTokenizer(base_vocab=128256))):
        want = jtok.build_qa_batch(tj, gt, valid, max_len, np.random.default_rng(5),
                                   contextual=contextual)
        got = ttok.build_qa_batch(tt, gt, valid, max_len, np.random.default_rng(5),
                                  contextual=contextual)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (got["labels"] >= 0).any() and (got["labels"] == -100).any()


def test_llama_logits_match_jax():
    """LlamaModel(cfg, lm_head=True) with return_logits: the hidden states and
    the logits [B, T, total_vocab] within 1e-5 relative of the JAX model's
    at tiny(), on a mask with a hole; without the head the state dict has no
    lm_head."""
    cfg_j, cfg_t = jllama.LlamaConfig.tiny(lora_rank=2), tllama.LlamaConfig.tiny(lora_rank=2)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg_t.total_vocab, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 8:] = False
    jmodel = jllama.LlamaModel(cfg_j)
    params = _draw_lora_b(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), None,
                                      jnp.asarray(mask), return_logits=True)["params"], 2)
    hidden_j, logits_j = _host(jmodel.apply({"params": params}, jnp.asarray(ids), None,
                                            jnp.asarray(mask), return_logits=True))
    model = tllama.LlamaModel(cfg_t, lm_head=True)
    load_flax_params(model, params)
    with torch.no_grad():
        hidden, logits = model(torch.from_numpy(ids), torch.from_numpy(mask), return_logits=True)
    assert logits.shape == (2, 12, cfg_t.total_vocab) and logits.dtype == torch.float32
    for got, ref in ((hidden, hidden_j), (logits, logits_j)):
        np.testing.assert_allclose(got.numpy(), ref, atol=REL * np.abs(ref).max(), rtol=0)
    assert "lm_head" not in tllama.LlamaModel(cfg_t).state_dict()


def _prompts(B, N):
    z = dict(feat=np.zeros((B, N, 7), np.float32), mask=np.ones((B, N), bool),
             pos=np.zeros((B, N, 2), np.float32), ori=np.zeros((B, N), np.float32),
             agent_type=np.ones((B, N), np.int32), obs_index=np.zeros((B, N), np.int32),
             extent=np.zeros((B, N, 2), np.float32), goal_point=np.zeros((B, N, 2), np.float32))
    return (JaxPrompt(**{k: jnp.asarray(v) for k, v in z.items()}),
            Prompt(**{k: torch.from_numpy(v) for k, v in z.items()}))


def test_qa_text_attn_loss_and_gradients_match_jax():
    """LlamaTextAttnQA at tiny(): the embeddings come back unchanged; the
    qa_loss within 1e-5 relative, and its gradients with respect to the
    agent embeddings, every LoRA leaf and prompt_to_llm within 1e-5 of each
    one's largest magnitude (the frozen body's too)."""
    cfg_j, cfg_t = jllama.LlamaConfig.tiny(), tllama.LlamaConfig.tiny()
    D, B, N, L = 8, 2, 3, 64
    rng = np.random.default_rng(0)
    gt = rng.normal(scale=10, size=(B, N, 2)).astype(np.float32)
    qa = ttok.build_qa_batch(ttok.ByteTokenizer(), gt, np.ones((B, N), bool), L, rng)
    emb = rng.normal(size=(B, N, D)).astype(np.float32)
    jprompt, tprompt = _prompts(B, N)
    qa_j = {k: jnp.asarray(v) for k, v in qa.items()}
    attn = jtext.LlamaTextAttnQA(hidden_dim=D, llm_config=cfg_j)
    params = _draw_lora_b(attn.init(jax.random.PRNGKey(0), qa_j, jnp.asarray(emb),
                                    jprompt)["params"], 1)

    def loss_fn(p, e):
        return attn.apply({"params": p}, qa_j, e, jprompt)[1]["qa_loss"]

    loss_j, (g_params, g_emb) = _host(jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        params, jnp.asarray(emb)))

    module = ttext.LlamaTextAttnQA(D, cfg_t)
    load_flax_params(module, params)
    e = torch.from_numpy(emb).requires_grad_(True)
    out, aux = module({k: torch.from_numpy(v) for k, v in qa.items()}, e, tprompt)
    assert out is e and set(aux) == {"qa_loss"}
    aux["qa_loss"].backward()
    assert float(loss_j) > 0
    np.testing.assert_allclose(float(aux["qa_loss"].detach()), float(loss_j), rtol=REL)
    ref = flax_to_state_dict(g_params)
    got = dict(module.named_parameters())
    assert set(got) == set(ref)
    checked = []
    for name, p in got.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name],
                                   atol=REL * max(np.abs(ref[name]).max(), 1e-30), rtol=0,
                                   err_msg=name)
        if "lora" in name or name.startswith("prompt_to_llm"):
            assert np.abs(ref[name]).max() > 0, name
            checked.append(name)
    # q/k/v A and B per layer, the embedding's A and B, prompt_to_llm's 6 leaves
    assert len(checked) == 2 * 3 * cfg_t.num_layers + 2 + 6
    assert np.abs(g_emb).max() > 0
    np.testing.assert_allclose(e.grad.numpy(), g_emb, atol=REL * np.abs(g_emb).max(), rtol=0)


def test_llama_qa_builds_no_text_attn():
    """TEXT_ATTN.TYPE 'llama_qa' in the condition transformer builds
    NoTextAttn, as the JAX package's does (its probe is a module of its own)."""
    cfg = get_config(os.path.join(REPO, "configs", "waymo_demo.yaml"), [
        "MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.TYPE", "llama_qa"])
    ct = build_condition_transformer(cfg)
    assert isinstance(ct.text_attn, NoTextAttn)
