"""The port's condition generation against prosim_tpu's, on the CPU: the
motion-tag deriver and processing, the tag and goal texts, OneText
assembly, hard and soft priority masking, ConditionGenerator.generate for
every condition type of the shipped configs (and the other types the
generator builds), the released-LLM-text branch and the captions.

Scenes come from a synthetic WOMD cache (tests/torch_data_common.py). Both
packages get the same inputs and the same rng seeds; tolerance: exact (the
same numpy and the same draws in the same order).
"""

import os
import random

import numpy as np
import pytest
import torch

from prosim_torch.config import get_config
from prosim_torch.data import captions, motion_tags, text_conditions, trajdata_cache
from prosim_torch.data.batch import Condition
from prosim_torch.data.conditions import (ConditionGenerator, mask_priority_condition,
                                          mask_soft_priority_condition)
from prosim_torch.data.formatter import format_scene
from prosim_torch.models.llm.tokenizer import ByteTokenizer

from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data import captions as jcaptions
from prosim_tpu.data import motion_tags as jmotion_tags
from prosim_tpu.data import text_conditions as jtext_conditions
from prosim_tpu.data import trajdata_cache as jtrajdata_cache
from prosim_tpu.data.batch import Condition as JaxCondition
from prosim_tpu.data.conditions import ConditionGenerator as JaxConditionGenerator
from prosim_tpu.data.conditions import mask_priority_condition as jmask_priority_condition
from prosim_tpu.data.conditions import mask_soft_priority_condition as jmask_soft
from prosim_tpu.data.formatter import format_scene as jformat_scene
from prosim_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer

from torch_data_common import CONFIGS, ENV, SMALL, assert_trees_equal, build_cache, config_path

ALL_TYPES = ["goal", "v_action_tag", "v2v_tag", "drag_point", "llm_text_OneText",
             "motion_tag_OneText", "goal_OneText"]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    _, cache = build_cache(str(tmp_path_factory.mktemp("synth")))
    names = trajdata_cache.list_scenes(cache, ENV)
    return [(trajdata_cache.load_scene(cache, ENV, n), jtrajdata_cache.load_scene(cache, ENV, n))
            for n in names]


def _tags_equal(got, ref):
    assert [(t.tag, t.agents, t.interval, t.type) for t in got] == \
        [(t.tag, t.agents, t.interval, t.type) for t in ref]


# ------------------------------------------------------------ motion tags

def _random_tags(mod, rng, n=40):
    names = ["a", "b", "c"]
    vocab = list(mod.EXCLUSION_MAP)
    out = []
    for _ in range(n):
        s = int(rng.integers(0, 80))
        out.append(mod.MotionTag(vocab[int(rng.integers(len(vocab)))],
                                 (names[int(rng.integers(3))],), (s, s + int(rng.integers(1, 30)))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_tag_processing_matches_jax(seed):
    got = _random_tags(motion_tags, np.random.default_rng(seed))
    ref = _random_tags(jmotion_tags, np.random.default_rng(seed))
    _tags_equal(motion_tags.integrate_tags(got, 10), jmotion_tags.integrate_tags(ref, 10))
    _tags_equal(motion_tags.remove_short_tags(got, 10), jmotion_tags.remove_short_tags(ref, 10))
    _tags_equal(motion_tags.resolve_conflicts(got), jmotion_tags.resolve_conflicts(ref))
    _tags_equal(motion_tags.process_tags(got, 10, 10), jmotion_tags.process_tags(ref, 10, 10))
    _tags_equal(motion_tags.filter_to_interval(got, 10, 60),
                jmotion_tags.filter_to_interval(ref, 10, 60))


def test_derived_tags_match_jax(scenes):
    n_unary = n_binary = 0
    for scene, jscene in scenes:
        got = motion_tags.derive_motion_tags(scene.states, scene.valid, scene.agent_names)
        ref = jmotion_tags.derive_motion_tags(jscene.states, jscene.valid, jscene.agent_names)
        _tags_equal(got, ref)
        got2 = motion_tags.derive_v2v_tags(scene.states, scene.valid, scene.agent_names)
        ref2 = jmotion_tags.derive_v2v_tags(jscene.states, jscene.valid, jscene.agent_names)
        _tags_equal(got2, ref2)
        n_unary += len(got)
        n_binary += len(got2)
    assert n_unary > 50 and n_binary > 50
    assert [t.value for t in motion_tags.VActionTag] == [t.value for t in jmotion_tags.VActionTag]
    assert [t.name for t in motion_tags.V2VTag] == [t.name for t in jmotion_tags.V2VTag]


def test_tag_json_loader_matches_jax(tmp_path):
    import json

    path = tmp_path / "tags.json"
    path.write_text(json.dumps({"result": [
        {"tag": "LeftTurn", "agents": ["a"], "interval": [3, 40]},
        {"tag": "Following", "agents": ["a", "b"], "interval": [0, 20], "type": "binary"}]}))
    _tags_equal(motion_tags.load_tags_json(str(path)), jmotion_tags.load_tags_json(str(path)))


# ------------------------------------------------------------------ texts

def test_texts_and_one_text_match_jax(scenes):
    scene, _ = scenes[0]
    tags = motion_tags.process_tags(
        motion_tags.derive_motion_tags(scene.states, scene.valid, scene.agent_names), 10, 10)
    jtags = jmotion_tags.process_tags(
        jmotion_tags.derive_motion_tags(scene.states, scene.valid, scene.agent_names), 10, 10)
    names = scene.agent_names[:8]
    got = text_conditions.motion_tag_texts(tags, names, random.Random(3))
    ref = jtext_conditions.motion_tag_texts(jtags, names, random.Random(3))
    assert got == ref and len(got) > 3
    assert text_conditions.BUILTIN_TEMPLATES == jtext_conditions.BUILTIN_TEMPLATES
    goals = np.random.default_rng(0).normal(size=(8, 2)) * 30
    valid = np.arange(8) % 3 != 0
    assert text_conditions.goal_texts(goals, valid) == jtext_conditions.goal_texts(goals, valid)
    for shuffle in (False, True):
        text, pmask = text_conditions.concat_one_text(got, 8, shuffle, random.Random(1))
        jtext, jpmask = jtext_conditions.concat_one_text(ref, 8, shuffle, random.Random(1))
        assert text == jtext
        np.testing.assert_array_equal(pmask, jpmask)
    pm = np.zeros((2, 8), bool)
    pm[0, :3] = pm[1, 5] = True
    for mode in ("none", "concat", "concat_sep"):
        for text_mask in (False, True):
            kw = dict(max_len=64, use_prompt_token=True, agent_token_mode=mode,
                      use_text_prompt_mask=text_mask, agent_valid=valid[None].repeat(2, 0))
            assert_trees_equal(
                text_conditions.build_one_text_condition(ByteTokenizer(), [text, "<A5> stops."],
                                                         pm, **kw),
                jtext_conditions.build_one_text_condition(JaxByteTokenizer(),
                                                          [jtext, "<A5> stops."], pm, **kw))


# --------------------------------------------------------------- priority

def _rows(mask, pidx):
    return {"input": np.zeros((len(mask), 3), np.float32), "mask": np.asarray(mask, bool),
            "prompt_idx": np.asarray(pidx, np.int32)}


def _random_rows(rng):
    out = {}
    for ctype, width in (("goal", 1), ("v_action_tag", 1), ("v2v_tag", 2), ("drag_point", 1)):
        n = int(rng.integers(1, 6))
        out[ctype] = _rows(rng.random(n) > 0.2, rng.integers(0, 5, size=(n, width)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_priority_masks_match_jax(seed):
    order = ["v2v_tag", "v_action_tag", "goal", "drag_point"]
    scores = {"goal": 5.0, "drag_point": 1.0, "v_action_tag": 10.0, "v2v_tag": 10.0}
    for mask_fn, jmask_fn, args in ((mask_priority_condition, jmask_priority_condition, (order,)),
                                    (mask_soft_priority_condition, jmask_soft, (scores,))):
        got, ref = _random_rows(np.random.default_rng(seed)), _random_rows(
            np.random.default_rng(seed))
        extra = (np.random.default_rng(9),) if mask_fn is mask_soft_priority_condition else ()
        jextra = (np.random.default_rng(9),) if extra else ()
        got, ref = mask_fn(got, *args, *extra), jmask_fn(ref, *args, *jextra)
        assert_trees_equal(got, ref)


# -------------------------------------------------------------- generator

def _formatted(scene, jscene, cfg, jcfg, split):
    meta, jmeta = {}, {}
    base = format_scene(scene, cfg, 10, split, np.random.default_rng(0), meta)
    jbase = jformat_scene(jscene, jcfg, 10, split, np.random.default_rng(0), jmeta)
    return base, meta, jbase, jmeta


@pytest.mark.parametrize("yaml,opts", [(c, []) for c in CONFIGS[1:]] + [
    (None, ["PROMPT.CONDITION.TYPES", str(ALL_TYPES)]),
    (None, ["PROMPT.CONDITION.TYPES", str(ALL_TYPES), "PROMPT.CONDITION.USE_PRIORITY_MASK",
            "True"]),
    (None, ["PROMPT.CONDITION.TYPES", str(ALL_TYPES), "PROMPT.CONDITION.USE_PRIORITY_MASK",
            "True", "PROMPT.CONDITION.USE_SOFT_PRIORITY", "True",
            "PROMPT.CONDITION.SAMPLE_BEFORE_PRIORITY", "False"]),
    (None, ["PROMPT.CONDITION.TYPES", "['motion_tag_OneText', 'goal_OneText']",
            "PROMPT.CONDITION.OneText.USE_PLACEHOLDER", "True",
            "PROMPT.CONDITION.OneText.SHUFFLE_TEXT", "True"]),
    (None, ["PROMPT.CONDITION.TYPES", "['goal', 'drag_point']", "PROMPT.CONDITION.SAMPLE_MODE.VAL",
            "uniform", "PROMPT.CONDITION.SAMPLE_MODE.TRAIN", "fix", "PROMPT.CONDITION.MAX_COND_PER_SCENE",
            "3"]),
], ids=["no_text", "with_text", "waymo_demo", "all_types", "hard_priority", "soft_priority",
        "placeholder_shuffle", "uniform_quota"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_generate_matches_jax(scenes, yaml, opts, split):
    cfg = get_config(config_path(yaml), SMALL + opts)
    jcfg = jax_get_config(config_path(yaml), SMALL + opts)
    gen, jgen = ConditionGenerator(cfg, split), JaxConditionGenerator(jcfg, split)
    rows = 0
    for k, (scene, jscene) in enumerate(scenes):
        base, meta, jbase, jmeta = _formatted(scene, jscene, cfg, jcfg, split)
        got = gen.generate(scene, base, 10, agent_names_by_slot=meta["target_names"],
                           rng=np.random.default_rng(k))
        ref = jgen.generate(jscene, jbase, 10, agent_names_by_slot=jmeta["target_names"],
                            rng=np.random.default_rng(k))
        assert list(got) == list(ref) == [t for t in cfg.PROMPT.CONDITION.TYPES]
        assert all(isinstance(c, Condition) for t, c in got.items() if "OneText" not in t)
        assert_trees_equal(got, ref)
        rows += sum(int(np.asarray(c["token_mask"] if "OneText" in t else c.mask).sum())
                    for t, c in got.items())
    assert rows > 0
    # the tag cache serves a second pass with the same conditions
    k = 0
    base, meta, _, _ = _formatted(*scenes[k], cfg, jcfg, split)
    again = gen.generate(scenes[k][0], base, 10, agent_names_by_slot=meta["target_names"],
                         rng=np.random.default_rng(k))
    first = ConditionGenerator(cfg, split).generate(
        scenes[k][0], base, 10, agent_names_by_slot=meta["target_names"],
        rng=np.random.default_rng(k))
    assert_trees_equal(again, first, ref_is_jax=False)


def test_generate_takes_tensor_batches(scenes):
    """The generator reads a formatted batch whose leaves are tensors as it
    reads numpy ones."""
    from prosim_torch.data.batch import to_tensors

    cfg = get_config(config_path("configs/no_text.yaml"), SMALL)
    scene = scenes[1][0]
    meta = {}
    base = format_scene(scene, cfg, 10, "val", np.random.default_rng(0), meta)
    gen = ConditionGenerator(cfg, "val")
    a = gen.generate(scene, base, 10, meta["target_names"], rng=np.random.default_rng(2))
    b = gen.generate(scene, to_tensors(base, "cpu"), 10, meta["target_names"],
                     rng=np.random.default_rng(2))
    assert_trees_equal(a, b, ref_is_jax=False)


def test_tokenizer_path_raises_until_the_hf_loader_is_ported():
    """The HF loader is ported: TOKENIZER_PATH builds an HFTokenizer from a
    local directory (the committed fixture), and the ids of a motion-tag
    text equal the JAX generator's; a path with no tokenizer files raises
    the loader's own error."""
    from prosim_torch.models.llm.tokenizer import HFTokenizer

    def cfgs(path):
        opts = SMALL + ["PROMPT.CONDITION.TYPES", "['motion_tag_OneText']",
                        "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.TOKENIZER_PATH",
                        path]
        return get_config(opts=opts), jax_get_config(opts=opts)

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "tiny_tokenizer")
    cfg, jcfg = cfgs(fixture)
    tok = ConditionGenerator(cfg, "val").tokenizer()
    jtok = JaxConditionGenerator(jcfg, "val").tokenizer()
    assert isinstance(tok, HFTokenizer)
    text = "<A3> turns left. <A0> keeps speed."
    assert tok.encode(text) == jtok.encode(text)
    with pytest.raises((OSError, ValueError)):
        ConditionGenerator(cfgs("/some/dir")[0], "val").tokenizer()


@pytest.mark.parametrize("split", ["train", "val"])
def test_released_llm_texts_match_jax(scenes, tmp_path, split):
    """The prosim_instruct_520k branch: ego-(x, y)@t0 pickle -> scene id ->
    text file, <name5> -> <A{slot}> rewrite (reference: data_utils.py:626-642,
    condition_utils.py:245-282), on a tiny release written here."""
    import pickle

    scene, jscene = scenes[2]
    folder, ids_pkl = tmp_path / "texts", tmp_path / "ids.pkl"
    sub = split.upper()
    opts = SMALL + ["PROMPT.CONDITION.TYPES", "['llm_text_OneText', 'goal']",
                    f"PROMPT.CONDITION.LLM_TEXT.FOLDER.{sub}", str(folder),
                    f"PROMPT.CONDITION.LLM_TEXT.IDS_PKL.{sub}", str(ids_pkl)]
    cfg, jcfg = get_config(opts=opts), jax_get_config(opts=opts)
    base, meta, jbase, jmeta = _formatted(scene, jscene, cfg, jcfg, split)
    names = meta["target_names"]
    ego = scene.states[scene.ego_index, 0]
    sid = "scene_00042"
    with open(ids_pkl, "wb") as f:
        pickle.dump({(float(ego[0]), float(ego[1])): [sid]}, f)
    (folder / "42").mkdir(parents=True)
    (folder / "42" / f"{sid}_10_90_output.txt").write_text(
        f'1. "<{names[0][:5]}> drives toward the intersection."\n'
        f"2. <{names[1][:5]}> slows down behind <{names[0][:5]}>.\n"
        "3. <zzzzz> does something (unknown agent).\n")
    gen = ConditionGenerator(cfg, split)
    twv = gen._load_llm_texts(scene, names)
    assert twv == JaxConditionGenerator(jcfg, split)._load_llm_texts(jscene, names)
    assert twv[0] == ("<A0> drives toward the intersection.", 0)
    assert ("", 0) in twv and not any("unknown" in t for t, _ in twv)
    got = gen.generate(scene, base, 10, names, rng=np.random.default_rng(1))
    ref = JaxConditionGenerator(jcfg, split).generate(jscene, jbase, 10, jmeta["target_names"],
                                                      rng=np.random.default_rng(1))
    assert_trees_equal(got, ref)
    assert got["llm_text_OneText"]["prompt_mask"][0, :2].all()


# --------------------------------------------------------------- captions

def test_captions_match_jax():
    rng = np.random.default_rng(0)
    conds = {}
    for ctype, width in (("v_action_tag", 1), ("v2v_tag", 2), ("goal", 1), ("drag_point", 1)):
        tag_max = 10 if ctype == "v_action_tag" else 4
        feat = np.stack([rng.integers(0, tag_max + 1, (2, 5)), rng.integers(0, 40, (2, 5)),
                         rng.integers(40, 80, (2, 5))], -1).astype(np.float32)
        arrays = dict(feat=feat, mask=rng.random((2, 5)) > 0.4,
                      prompt_idx=rng.integers(0, 8, (2, 5, width)).astype(np.int32),
                      prompt_mask=np.ones((2, 8), bool))
        conds[ctype] = (Condition(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                        JaxCondition(**arrays))
    mask = np.array([[True], [False]])
    conds["motion_tag_OneText"] = (Condition(mask=torch.from_numpy(mask), feat=None,
                                             prompt_idx=None, prompt_mask=None),
                                   JaxCondition(mask=mask, feat=None, prompt_idx=None,
                                                prompt_mask=None))
    texts = ["Let <A2> speed up.", "<A1> stops."]
    for b in (0, 1):
        got = captions.batch_caption({k: v[0] for k, v in conds.items()}, b, texts)
        ref = jcaptions.batch_caption({k: v[1] for k, v in conds.items()}, b, texts)
        assert got == ref and "v2v_tag:" in got
