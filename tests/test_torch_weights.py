"""The port's weights against prosim_tpu's, on the CPU: the safetensors
reader against the `safetensors` package, the HF Llama loader against the
JAX loader (leaf by leaf, the LoRA draws bit for bit, the forward within
1e-5), TEXT.LLM.WEIGHTS_PATH through ProSim, HFTokenizer on the committed
fixture, and the reference-checkpoint converter against the JAX converter
followed by utils/params.py (bit for bit; the converted model's closed loop
within 1e-4 m of the JAX package's at TOP_K=1). Shards and checkpoints are
written by the tests; no file is downloaded.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data.synthetic import make_synthetic_batch as jax_synthetic
from prosim_tpu.models.llm import llama as jllama
from prosim_tpu.models.prosim import ProSim as JaxProSim
from prosim_tpu.utils import checkpoint_convert as jconv
from prosim_torch.config import get_config
from prosim_torch.data.synthetic import make_synthetic_batch
from prosim_torch.models.condition.transformer import load_text_llm_weights
from prosim_torch.models.llm import llama as tllama
from prosim_torch.models.prosim import ProSim
from prosim_torch.utils import checkpoint_convert as tconv
from prosim_torch.utils.params import flax_to_state_dict, init_params, load_flax_params
from prosim_torch.utils.safetensors_io import SafetensorsFile, save_file
from torch_checkpoint_synth import ref_mlp_sd, reference_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_tokenizer")
DEMO = os.path.join(REPO, "configs", "waymo_demo.yaml")
TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = [
    "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1",
    "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.CONDITION_TRANSFORMER.NLAYER", "1",
    "MODEL.SCENE_ENCODER.ATTN.NUM_HEAD", "2",
    "MODEL.DECODER.ATTN.NUM_HEAD", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_HEAD", "2",
    "MODEL.CONDITION_TRANSFORMER.NHEAD", "2",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "4",
    "MODEL.DECODER.ATTN.FF_DIM", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "4",
    "MODEL.CONDITION_TRANSFORMER.FF_DIM", "4",
    "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS", "16",
]
BATCH_KW = dict(batch_size=1, num_lanes=8, num_obs_agents=6, num_agents=4, num_replan=2)
LLM_KEY = "llm_text_OneText"


def _host(tree):
    """A JAX result as numpy arrays, on the host before the port runs."""
    return jax.tree.map(lambda x: np.asarray(getattr(x, "value", x)), tree,
                        is_leaf=lambda x: hasattr(x, "value"))


def _hf_tensors(cfg, seed=0):
    """HF-layout Llama weights for `cfg`, f32 numpy (tests/test_llm.py's layout)."""
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.head_dim
    rng = np.random.default_rng(seed)
    hf = {"model.embed_tokens.weight": rng.normal(size=(V, H)),
          "model.norm.weight": rng.normal(size=(H,))}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        hf[f"{p}.input_layernorm.weight"] = rng.normal(size=(H,))
        hf[f"{p}.post_attention_layernorm.weight"] = rng.normal(size=(H,))
        for proj, shape in (("q_proj", (cfg.num_heads * cfg.head_dim, H)), ("k_proj", (kv, H)),
                            ("v_proj", (kv, H)), ("o_proj", (H, cfg.num_heads * cfg.head_dim))):
            hf[f"{p}.self_attn.{proj}.weight"] = rng.normal(size=shape) * H ** -0.5
        hf[f"{p}.mlp.gate_proj.weight"] = rng.normal(size=(I, H)) * H ** -0.5
        hf[f"{p}.mlp.up_proj.weight"] = rng.normal(size=(I, H)) * H ** -0.5
        hf[f"{p}.mlp.down_proj.weight"] = rng.normal(size=(H, I)) * I ** -0.5
    return {k: v.astype(np.float32) for k, v in hf.items()}


def _write_shards(root, hf, n=2):
    """Two shards, the layers split across them (the HF hub's layout)."""
    from safetensors.numpy import save_file as np_save

    os.makedirs(root, exist_ok=True)
    keys = sorted(hf)
    for i in range(n):
        np_save({k: hf[k] for k in keys[i::n]},
                os.path.join(root, f"model-{i + 1:05d}-of-{n:05d}.safetensors"))
    return root


# ---------------------------------------------------------------- shards

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64])
def test_safetensors_reader_matches_package(tmp_path, dtype):
    from safetensors import safe_open
    from safetensors.torch import save_file as st_save

    g = torch.Generator().manual_seed(0)
    ts = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g),
          "c": torch.randn(2, 3, 4, generator=g)}
    ts = {k: (v * 100).to(dtype) for k, v in ts.items()}
    path = str(tmp_path / "x.safetensors")
    st_save(ts, path)
    f = SafetensorsFile(path)
    with safe_open(path, framework="pt") as ref:
        assert sorted(f.keys()) == sorted(ref.keys())
        for k in ref.keys():
            got, want = f.get_tensor(k), ref.get_tensor(k)
            assert got.dtype == want.dtype and torch.equal(got, want), k
    # and the writer's files read back through the package
    out = str(tmp_path / "y.safetensors")
    save_file(ts, out)
    with safe_open(out, framework="pt") as back:
        for k, v in ts.items():
            assert torch.equal(back.get_tensor(k), v), k


# ---------------------------------------------------------- Llama loader

def test_hf_llama_loader_matches_jax(tmp_path):
    """f32 shards: every leaf equals the JAX loader's after
    flax_to_state_dict (the LoRA draws and the body bit for bit, the agent
    rows' f32 mean within 1e-6), the tied LM head too, and the loaded
    LlamaModel's forward within 1e-5 of the JAX model's."""
    cfg_j = jllama.LlamaConfig.tiny(lora_rank=2)
    cfg_t = tllama.LlamaConfig.tiny(lora_rank=2)
    path = _write_shards(str(tmp_path), _hf_tensors(cfg_j))
    ref = _host(jllama.load_hf_llama_params(path, cfg_j, rng_seed=3, with_lm_head=True))
    ref_head = ref.pop("lm_head")
    want = flax_to_state_dict(ref)

    model = tllama.LlamaModel(cfg_t)
    model.init_weights(0)
    head = tllama.load_hf_llama_params(path, model, rng_seed=3, with_lm_head=True)
    got = model.state_dict()
    assert set(got) == set(want)
    V = cfg_t.vocab_size
    for k, v in want.items():
        g = got[k].numpy()
        if k == "embed_tokens":
            np.testing.assert_array_equal(g[:V], v[:V])
            np.testing.assert_allclose(g[V:], v[V:], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)
    np.testing.assert_array_equal(head.numpy()[:, :V], ref_head[:, :V])
    np.testing.assert_allclose(head.numpy(), ref_head, atol=1e-6, rtol=0)

    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg_t.total_vocab, size=(2, 12))
    mask = np.ones((2, 12), bool)
    mask[1, 8:] = False
    out_j = np.asarray(jllama.LlamaModel(cfg_j).apply(
        {"params": ref}, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)))
    with torch.no_grad():
        out_t = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out_t[mask], out_j[mask], **TOL)


def test_bf16_shards_load_in_both_packages_jax_means_in_bf16(tmp_path):
    """Released Llama3 shards are bf16. The port reads them bit for bit into
    a bf16 Llama. The JAX loader reads them too, as long as jax is imported
    (ml_dtypes registers bfloat16 with numpy; safetensors' numpy framework
    raises on bf16 without it), and its body leaves are the port's; but it
    takes the agent rows' mean in bf16 arithmetic (`w.mean` on a bfloat16
    array), where the port takes it in f32 and rounds once: the port's rows
    sit nearer the exact mean (a fault of the frozen JAX package,
    ROADMAP.md C)."""
    import dataclasses

    from safetensors.torch import save_file as st_save

    cfg_j = jllama.LlamaConfig.tiny(lora_rank=2)
    cfg_t = dataclasses.replace(tllama.LlamaConfig.tiny(lora_rank=2), dtype=torch.bfloat16)
    hf = {k: torch.from_numpy(v).bfloat16() for k, v in _hf_tensors(cfg_t).items()}
    st_save(hf, str(tmp_path / "model.safetensors"))
    model = tllama.LlamaModel(cfg_t)
    model.init_weights(0)
    tllama.load_hf_llama_params(str(tmp_path), model)
    V = cfg_t.vocab_size
    emb = hf["model.embed_tokens.weight"]
    assert torch.equal(model.embed_tokens[:V], emb)
    assert torch.equal(model.embed_tokens[V:],
                       emb.float().mean(0, keepdim=True).expand(cfg_t.num_agent_tokens, -1)
                       .bfloat16())
    assert model.layer_0.q_proj.lora_a.dtype == torch.float32

    ref = flax_to_state_dict(_host(jllama.load_hf_llama_params(str(tmp_path), cfg_j)))
    own = model.state_dict()
    for k, v in ref.items():
        if k != "embed_tokens":
            want = torch.from_numpy(v.astype(np.float32)).to(own[k].dtype)
            assert torch.equal(own[k], want), k
    exact = emb.double().mean(0)
    port_row = model.embed_tokens.detach()[V].double()
    port_err = float((port_row - exact).abs().max())
    jax_row = ref["embed_tokens"][V].astype(np.float64)
    jax_err = float(np.abs(jax_row - exact.numpy()).max())
    assert ref["embed_tokens"].dtype == np.float32 and not np.array_equal(
        jax_row, port_row.numpy())
    half_ulp = float(exact.abs().max()) * 2.0 ** -8
    assert port_err <= half_ulp < jax_err, (port_err, jax_err)


def test_llama_loader_refuses_missing_and_misfit_weights(tmp_path):
    cfg = tllama.LlamaConfig.tiny(lora_rank=0)
    hf = _hf_tensors(cfg)
    model = tllama.LlamaModel(cfg)
    with pytest.raises(FileNotFoundError):
        tllama.load_hf_llama_params(str(tmp_path), model)
    bad = dict(hf)
    del bad["model.layers.1.mlp.up_proj.weight"]
    _write_shards(str(tmp_path / "missing"), bad)
    with pytest.raises(KeyError, match="up_proj"):
        tllama.load_hf_llama_params(str(tmp_path / "missing"), model)
    bad = dict(hf, **{"model.norm.weight": np.ones(3, np.float32)})
    _write_shards(str(tmp_path / "misfit"), bad)
    with pytest.raises(ValueError, match="shape"):
        tllama.load_hf_llama_params(str(tmp_path / "misfit"), model)


def test_weights_path_through_prosim_matches_jax(tmp_path):
    """TEXT.LLM.WEIGHTS_PATH: load_text_llm_weights after init_params loads
    the shards into the port's Llama as JAX ProSim.init does (every llm
    leaf equal), a later
    load_flax_params still wins, and with the other weights shared the
    conditioned policy embedding is within 1e-5 of JAX's."""
    cfg_j = jllama.LlamaConfig.tiny(lora_rank=16)
    path = _write_shards(str(tmp_path / "w"), _hf_tensors(cfg_j, seed=4))
    opts = SMALL + ["PROMPT.CONDITION.TYPES", f"['{LLM_KEY}']",
                    "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.ARCH", "tiny",
                    "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.WEIGHTS_PATH", path]
    jcfg, tcfg = jax_get_config(opts=opts), get_config(opts=opts)
    jm = JaxProSim(jcfg)
    jb = jax_synthetic(jcfg, seed=2, **BATCH_KW)
    params = _host(jm.init(jax.random.PRNGKey(0), jb))
    j_emd = np.asarray(jax.jit(lambda p, b: jm.prepare(p, b, "val", jax.random.PRNGKey(1))[1]
                               ["emd"])(params, jb))

    tm = ProSim(tcfg, device="cpu")
    init_params(tm, seed=5)
    load_text_llm_weights(tcfg, tm)
    llm = "condition_transformer_policy_decoder.text_attn.llm."
    want = flax_to_state_dict(params)
    own = tm.state_dict()
    V = cfg_j.vocab_size
    for k, v in want.items():
        if k.startswith(llm):
            g = own[k].numpy()
            if k.endswith("embed_tokens"):
                g, v = g[:V], v[:V]
            np.testing.assert_array_equal(g, v, err_msg=k)
    # the rest of JAX's weights, the port's loaded Llama kept
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in want.items()
                        if not k.startswith(llm)}, strict=False)
    tb = make_synthetic_batch(tcfg, seed=2, device="cpu", **BATCH_KW)
    _, t_emd = tm.prepare(tb, "val")
    mask = np.asarray(jb.prompt.mask)
    np.testing.assert_allclose(t_emd["emd"].numpy()[mask], j_emd[mask], **TOL)
    # a later flax load wins over WEIGHTS_PATH
    load_flax_params(tm, jax.tree.map(lambda x: x * 0 + 1, params))
    assert float(tm.state_dict()[llm + "layer_0.q_proj.weight"].min()) == 1.0


# -------------------------------------------------------------- tokenizer

def test_hf_tokenizer_matches_jax():
    """HFTokenizer on the committed fixture: the same ids, agent ids and
    vocabulary as the JAX tokenizer, and ConditionGenerator builds it for
    TOKENIZER_PATH (reference: text_attns.py:122-155)."""
    from prosim_tpu.models.llm import tokenizer as jtok
    from prosim_torch.data.conditions import ConditionGenerator
    from prosim_torch.models.llm import tokenizer as ttok

    jt, tt = jtok.HFTokenizer(FIXTURE), ttok.HFTokenizer(FIXTURE)
    assert (tt.base_vocab, tt.vocab_size) == (jt.base_vocab, jt.vocab_size) == (384, 512)
    texts = [jtok.build_text_prompt({11: "stop moving", 12: "turn left"}),
             "<A0> follows <A127>, then <A3> yields.", "plain text without agents"]
    for text in texts:
        assert tt.encode(text) == jt.encode(text), text
    for i in (0, 1, 11, 127):
        assert tt.agent_token_id(i) == jt.agent_token_id(i) == tt.base_vocab + i
    want = jtok.tokenize_batch(jt, texts, max_len=24, num_agents=16)
    got = ttok.tokenize_batch(tt, texts, max_len=24, num_agents=16)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    cfg = get_config(DEMO, ["MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM."
                            "TOKENIZER_PATH", FIXTURE])
    tok = ConditionGenerator(cfg, "val").tokenizer()
    assert isinstance(tok, ttok.HFTokenizer)
    assert tok.encode(texts[0]) == jt.encode(texts[0])


# -------------------------------------------------------- checkpoint converter

ALL_TYPES = ["PROMPT.CONDITION.TYPES",
             f"['goal','v_action_tag','v2v_tag','drag_point','{LLM_KEY}']"]
A4 = ["MODEL.OBS_UPDATE.FUSION", "mlp", "MODEL.POLICY.ACT_DECODER.CONTEXT.GOAL", "True"]


def _a4_keys(cfg, rng):
    """Reference keys of modules the port does not build yet (A4): the 'mlp'
    obs-update fusion and the policy's goal context."""
    H = cfg.MODEL.HIDDEN_DIM
    sd = ref_mlp_sd("scene_encoder.obs_update_mlp", [2 * H, H, H], rng)
    sd.update(ref_mlp_sd("policy.act_decoder.goal_encoder", [2, H], rng))
    sd.update(ref_mlp_sd("policy.act_decoder.context_fuse", [2 * H, H], rng))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_converter_matches_jax_and_reports_a4_keys(tmp_path):
    """A reference state_dict of every module family (the demo architecture
    with all condition types, goal heads, v2v tags, the A4 modules and two
    keys no rule maps): the port's conversion equals JAX's
    convert_state_dict + flax_to_state_dict bit for bit, with the same
    unmapped keys; read from a .ckpt file too. Loaded into the port's
    model, every converted leaf lands shape-exact except the A4 modules',
    which come back as unloaded."""
    cfg = get_config(DEMO, SMALL + ALL_TYPES + [
        "MODEL.DECODER.GOAL_PRED.ENABLE", "True",
        "PROMPT.CONDITION.MOTION_TAG.USED_TAGS", "['Accelerate','LeftTurn','Following','Merging']"])
    rng = np.random.default_rng(7)
    sd = reference_state_dict(cfg, seed=3)
    a4 = _a4_keys(cfg, rng)
    sd.update(a4)
    sd["policy.act_decoder.no_such_head.weight"] = np.ones((2, 2), np.float32)
    sd["scene_encoder.a2a_attn_layers.0.no_such_norm.weight"] = np.ones(2, np.float32)

    params, unmapped_j = jconv.convert_state_dict(sd)
    want = flax_to_state_dict(params)
    got, unmapped = tconv.reference_to_state_dict(sd)
    assert unmapped == unmapped_j and len(unmapped) == 2
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    with pytest.raises(KeyError):
        tconv.reference_to_state_dict(sd, strict=True)

    path = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    from_file, unmapped_f = tconv.load_reference_checkpoint(path)
    assert unmapped_f == unmapped and set(from_file) == set(got)
    assert all(np.array_equal(from_file[k], got[k]) for k in got)

    model = ProSim(cfg, device="cpu")
    unloaded = tconv.load_converted(model, got)
    a4_port = set(tconv.reference_to_state_dict(a4)[0])
    assert set(unloaded) == a4_port and a4_port
    own = model.state_dict()
    for k, v in got.items():
        if k not in a4_port:
            assert torch.equal(own[k], torch.from_numpy(v)), k


def _merge(cur, new):
    """The JAX demo's non-strict merge of converted leaves into an init tree."""
    if not isinstance(cur, dict):
        return jnp.asarray(new, cur.dtype)
    return {k: _merge(v, new[k]) if k in new else v for k, v in cur.items()}


def test_converted_checkpoint_rollout_matches_jax():
    """configs/waymo_demo.yaml at small widths as shipped (TOP_K=1): strict
    conversion with zero unmapped keys, every converted leaf loaded, and the
    closed loop of the converted weights (the Llama body, absent from a
    checkpoint, shared from one init) within 1e-4 m of the JAX package's."""
    opts = SMALL
    jcfg, tcfg = jax_get_config(DEMO, opts), get_config(DEMO, opts)
    sd = reference_state_dict(tcfg, seed=11)
    got, unmapped = tconv.reference_to_state_dict(sd, strict=True)
    assert unmapped == []
    jm = JaxProSim(jcfg)
    jb = jax_synthetic(jcfg, seed=1, **BATCH_KW)
    init = _host(jm.init(jax.random.PRNGKey(0), jb))
    params = _merge(init, jconv.convert_state_dict(sd, strict=True)[0])
    # eager, op by op as the port runs: under jit XLA:CPU fuses the f32
    # chains (fma), and the closed loop at these N(0, 1) weights carries
    # that rounding to 1e-3 m in two replan steps
    ref = _host(jm.forward(params, jb, "val", jax.random.PRNGKey(1)))

    tm = ProSim(tcfg, device="cpu")
    load_flax_params(tm, init)
    assert tconv.load_converted(tm, got) == []
    out = tm(make_synthetic_batch(tcfg, seed=1, device="cpu", **BATCH_KW))
    mask = np.asarray(jb.prompt.mask)
    traj = out["rollout_traj"].numpy()[mask]
    assert np.isfinite(traj).all()
    np.testing.assert_allclose(traj, ref["rollout_traj"][mask], atol=1e-4, rtol=0)
