"""Condition generation: build per-type prompt conditions for a scene batch.

Host-side equivalent of the reference ConditionGenerator
(reference: prosim/dataset/condition_utils.py:126-1094) over padded arrays:

  goal         - each target agent's GT goal (local frame at t=0) + future
                 length (condition_utils.py:126-175)
  v_action_tag - (tag id, start, end) triples per tagged agent interval
                 (condition_utils.py:177-222); tags from the 520k JSON or the
                 built-in trajectory deriver
  drag_point   - subsampled noisy future xy with an optional random
                 consecutive subset (condition_utils.py:366-447)

Sampling policies fix/uniform/normal/none with per-scene and per-batch quotas
(condition_utils.py:645-748) and hard/soft priority masking across types
(condition_utils.py:866-972).

Port of prosim_tpu/data/conditions.py on the port's containers and
tokenizer: the same numpy draws in the same order, so one rng seed gives the
same conditions in both packages. A TOKENIZER_PATH needs the HF tokenizer
loader, which is not ported yet (ROADMAP.md queue A8): it raises.
"""

import os
import random
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from prosim_torch.data.batch import Condition, SceneBatch
from prosim_torch.data.motion_tags import (
    MotionTag,
    V2VTag,
    VActionTag,
    derive_motion_tags,
    derive_v2v_tags,
    filter_to_interval,
    process_tags,
)
from prosim_torch.models.llm.tokenizer import AGENT_TEMPLATE, ByteTokenizer, HFTokenizer
from prosim_torch.data.text_conditions import (
    build_one_text_condition,
    concat_one_text,
    goal_texts,
    motion_tag_texts,
)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pad_c(arr, C, fill=0):
    out = np.full((C,) + arr.shape[1:], fill, arr.dtype)
    n = min(len(arr), C)
    out[:n] = arr[:n]
    return out


def _row_agents(prompt_idx_row) -> List[int]:
    return [int(a) for a in np.atleast_1d(prompt_idx_row) if a >= 0]


def mask_priority_condition(all_cond: Dict[str, dict],
                            priority_order: List[str]) -> Dict[str, dict]:
    """Hard priority: each agent keeps only its highest-priority condition
    type; a row survives only if ALL its agents have this type as their best
    (reference: condition_utils.py:866-921). Types not listed rank below all
    listed ones. Mutates and returns all_cond."""
    n_prio = len(priority_order)

    def prio(ctype):
        return priority_order.index(ctype) if ctype in priority_order else n_prio

    best: Dict[int, int] = {}
    for ctype, d in all_cond.items():
        p = prio(ctype)
        for r in np.nonzero(d["mask"])[0]:
            for a in _row_agents(d["prompt_idx"][r]):
                best[a] = min(best.get(a, n_prio), p)
    for ctype, d in all_cond.items():
        p = prio(ctype)
        for r in np.nonzero(d["mask"])[0]:
            agents = _row_agents(d["prompt_idx"][r])
            if not all(best.get(a, n_prio) == p for a in agents):
                d["mask"][r] = False
                d["prompt_idx"][r] = -1
    return all_cond


def mask_soft_priority_condition(all_cond: Dict[str, dict],
                                 priority_scores: Dict[str, float],
                                 rng) -> Dict[str, float]:
    """Soft priority: when several rows target the same agent, keep one drawn
    with probability proportional to its type's score and mask the rest
    (reference: condition_utils.py:922-972 — agents are resolved in order and
    a later agent's draw may mask an earlier agent's kept row, as in the
    reference). Mutates and returns all_cond."""
    agent_rows: Dict[int, list] = {}
    for ctype, d in all_cond.items():
        for r in np.nonzero(d["mask"])[0]:
            for a in _row_agents(d["prompt_idx"][r]):
                agent_rows.setdefault(a, []).append((ctype, r))
    for a in sorted(agent_rows):
        rows = agent_rows[a]
        if len(rows) <= 1:
            continue
        p = np.asarray([float(priority_scores.get(ct, 1.0)) for ct, _ in rows])
        keep = int(rng.choice(len(rows), p=p / p.sum()))
        for i, (ct, r) in enumerate(rows):
            if i != keep:
                all_cond[ct]["mask"][r] = False
    return all_cond


class ConditionGenerator:
    def __init__(self, config, split: str = "train"):
        self.config = config
        self.cond_cfg = config.PROMPT.CONDITION
        self.split = split
        self.types = list(self.cond_cfg.TYPES)
        self.text_types = [t for t in self.types if "OneText" in t]
        self._tokenizer = None
        self._tag_cache: Dict[tuple, list] = {}
        self._tag_lock = threading.Lock()

    def tokenizer(self):
        if self._tokenizer is None:
            llm_cfg = self.config.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM
            if llm_cfg.TOKENIZER_PATH:
                self._tokenizer = HFTokenizer(llm_cfg.TOKENIZER_PATH,
                                              add_bos_eos=llm_cfg.ADD_BOS_EOS)
            else:
                # matches LlamaConfig.tiny() used when no weights are set
                self._tokenizer = ByteTokenizer(base_vocab=512, num_agent_tokens=128)
        return self._tokenizer

    # ------------------------------------------------------------- builders
    def goal_condition(self, batch_np: dict, rng) -> dict:
        """batch_np: per-scene dict with 'goal' [N,2] local goals, 'fut_len'
        [N], 'prompt_valid' [N]."""
        N = len(batch_np["prompt_valid"])
        inp = np.concatenate(
            [batch_np["goal"], batch_np["fut_len"][:, None].astype(np.float32)],
            axis=-1,
        )
        return {
            "input": inp.astype(np.float32),
            "mask": batch_np["prompt_valid"].copy(),
            "prompt_idx": np.arange(N, dtype=np.int32)[:, None],
        }

    def action_tag_condition(self, tags: List[MotionTag], agent_names: List[str],
                             rng) -> dict:
        used = [t for t in self.cond_cfg.MOTION_TAG.USED_TAGS
                if t in VActionTag.__members__]
        name_to_idx = {n: i for i, n in enumerate(agent_names)}
        rows, pidx = [], []
        for t in tags:
            if t.type != "unary" or t.tag not in used:
                continue
            if t.agents[0] not in name_to_idx:
                continue
            rows.append([VActionTag[t.tag].value, t.interval[0], t.interval[1]])
            pidx.append(name_to_idx[t.agents[0]])
        if not rows:
            return {
                "input": np.zeros((0, 3), np.float32),
                "mask": np.zeros((0,), bool),
                "prompt_idx": np.zeros((0, 1), np.int32),
            }
        return {
            "input": np.asarray(rows, np.float32),
            "mask": np.ones(len(rows), bool),
            "prompt_idx": np.asarray(pidx, np.int32)[:, None],
        }

    def v2v_tag_condition(self, tags: List[MotionTag], agent_names: List[str],
                          rng) -> dict:
        """Binary (pair) tag conditions: [tag id, start, end] rows with 2-wide
        prompt_idx (reference: condition_utils.py:317-364). Both agents must
        be prompt agents."""
        used = self._v2v_used_tags()
        name_to_idx = {n: i for i, n in enumerate(agent_names)}
        rows, pidx = [], []
        for t in tags:
            if t.type != "binary" or t.tag not in used:
                continue
            if any(a not in name_to_idx for a in t.agents[:2]):
                continue
            rows.append([V2VTag[t.tag].value, t.interval[0], t.interval[1]])
            pidx.append([name_to_idx[t.agents[0]], name_to_idx[t.agents[1]]])
        if not rows:
            return {
                "input": np.zeros((0, 3), np.float32),
                "mask": np.zeros((0,), bool),
                "prompt_idx": np.zeros((0, 2), np.int32),
            }
        return {
            "input": np.asarray(rows, np.float32),
            "mask": np.ones(len(rows), bool),
            "prompt_idx": np.asarray(pidx, np.int32),
        }

    def _v2v_used_tags(self) -> List[str]:
        """V2V names from USED_TAGS; when the config lists only unary tags
        (the common case - the reference default is unary-only), all pair
        tags are considered used."""
        v2v = [t for t in self.cond_cfg.MOTION_TAG.USED_TAGS
               if t in V2VTag.__members__]
        return v2v or list(V2VTag.__members__)

    def drag_point_condition(self, full_traj_xy, full_valid, prompt_valid, rng) -> dict:
        """full_traj_xy [N, T*S, 2] local-frame future; subsample and jitter."""
        d = self.cond_cfg.DRAG_POINT
        rate = d.SAMPLE_RATE
        pts = full_traj_xy[:, ::rate].copy()          # [N, P, 2]
        pv = full_valid[:, ::rate].copy()             # [N, P]
        N, P = pv.shape

        # random consecutive subset per agent
        if self.split.upper() == "TRAIN":
            for n in range(N):
                vi = np.nonzero(pv[n])[0]
                if len(vi) == 0:
                    continue
                lo, hi = vi[0], vi[-1]
                max_len = hi - lo + 1
                ln = rng.integers(1, max_len) if max_len > 1 else max_len
                st = rng.integers(lo, hi - ln + 2)
                keep = np.zeros(P, bool)
                keep[st:st + ln] = True
                pv[n] &= keep
        if d.NOISE_STD > 0:
            pts = pts + rng.normal(scale=d.NOISE_STD, size=pts.shape)

        pts[~pv] = np.nan
        valid = pv.any(-1) & prompt_valid
        flat = pts[:, :d.MAX_POINTS].reshape(N, -1).astype(np.float32)
        return {
            "input": flat,
            "mask": valid,
            "prompt_idx": np.arange(N, dtype=np.int32)[:, None],
        }

    # ------------------------------------------------------------- sampling
    def sample(self, data: dict, rng, quota_scene: Optional[int] = None) -> dict:
        mode = (self.cond_cfg.SAMPLE_MODE.TRAIN if self.split.upper() == "TRAIN"
                else self.cond_cfg.SAMPLE_MODE.VAL)
        shuffle = (self.cond_cfg.RANDOM_SAMPLE.TRAIN if self.split.upper() == "TRAIN"
                   else self.cond_cfg.RANDOM_SAMPLE.VAL)
        valid_idx = np.nonzero(data["mask"])[0]
        v = len(valid_idx)
        if mode == "none":
            n = v
        elif mode in ("fix", "fix_sample_rate"):  # reference spelling accepted
            n = int(v * self.cond_cfg.SAMPLE_RATE)
        elif mode == "uniform":
            n = int(rng.integers(0, v + 1))
        elif mode == "normal":
            rate = float(np.clip(rng.normal(self.cond_cfg.SAMPLE_RATE, 0.2), 0, 1))
            n = int(v * rate)
        else:
            raise ValueError(f"unknown sample mode {mode}")
        if quota_scene is not None:
            n = min(n, quota_scene)
        if n < v:
            sel = rng.choice(valid_idx, n, replace=False) if shuffle else valid_idx[:n]
            mask = np.zeros_like(data["mask"])
            mask[sel] = True
            data = dict(data)
            data["mask"] = data["mask"] & mask
        return data

    # ----------------------------------------------------------------- main
    def generate(self, scene, batch: SceneBatch, scene_ts: int,
                 agent_names_by_slot: Optional[List[str]] = None,
                 rng: Optional[np.random.Generator] = None,
                 tags: Optional[List[MotionTag]] = None) -> Dict[str, Condition]:
        """Build all configured condition types for a B=1 formatted batch."""
        rng = rng or np.random.default_rng(0)
        C = self.config.DATASET.FORMAT.PAD.NUM_CONDS
        N_pad = batch.prompt.mask.shape[1]
        prompt_valid = _np(batch.prompt.mask)[0]

        io = batch.io_pairs
        # future length per agent from io full_traj validity
        fut_valid = _np(io.full_traj_valid)[0]
        fut_len = np.where(fut_valid.any(-1),
                           fut_valid.shape[-1] - np.argmax(fut_valid[:, ::-1], -1), 0)
        per_scene = {
            "goal": _np(io.goal)[0, 0],
            "fut_len": fut_len,
            "prompt_valid": prompt_valid,
        }

        # tag-templated texts also need derived tags (the fallback when the
        # 520k release is absent), so derive for text types too
        needs_tags = any(
            t in ("v_action_tag", "v2v_tag", "motion_tag_OneText",
                  "llm_text_OneText")
            for t in self.types
        )
        if tags is None and needs_tags:
            mt_cfg = self.cond_cfg.MOTION_TAG
            fut_horizon = int(_np(io.t_indices)[-1]) + self.config.DATASET.FORMAT.TARGET.STEPS
            # tag derivation is a pure function of (scene, ts window) — no
            # rng — and it dominates host-side batch production (~28 of
            # 51 ms/scene profiled); cache it so re-visiting a scene (every
            # epoch, every bench iteration) only pays the sampling/masking
            # stages. Consumers never mutate MotionTag rows.
            ck = (scene.env_name, scene.name, scene_ts, fut_horizon)
            tags = self._tag_cache.get(ck)
            if tags is None:
                raw = derive_motion_tags(
                    scene.states, scene.valid, scene.agent_names,
                    dt=self.config.DATASET.MOTION.DT,
                    used_tags=mt_cfg.USED_TAGS,
                )
                if "v2v_tag" in self.types:
                    raw += derive_v2v_tags(
                        scene.states, scene.valid, scene.agent_names,
                        dt=self.config.DATASET.MOTION.DT,
                        used_tags=self._v2v_used_tags(),
                    )
                raw = filter_to_interval(raw, scene_ts, scene_ts + fut_horizon)
                tags = process_tags(
                    raw, mt_cfg.INTEGRATE_TOLERANCE, mt_cfg.MIN_DURATION)
                with self._tag_lock:
                    if len(self._tag_cache) > 256:
                        self._tag_cache.clear()
                    self._tag_cache[ck] = tags

        quota = self.cond_cfg.MAX_COND_PER_SCENE
        prng = random.Random(int(rng.integers(0, 2**31)))

        # ---- 1. build every configured type as a row dict (reference:
        # get_batch_condition builds all types before masking,
        # condition_utils.py:1061-1068). Text rows are (string, slot) pairs
        # in row form so they participate in priority masking.
        all_cond: Dict[str, dict] = {}
        for ctype in self.types:
            if ctype == "goal":
                data = self.goal_condition(per_scene, rng)
            elif ctype == "v_action_tag":
                if agent_names_by_slot is None:
                    continue
                data = self.action_tag_condition(tags or [], agent_names_by_slot, rng)
            elif ctype == "v2v_tag":
                if agent_names_by_slot is None:
                    continue
                data = self.v2v_tag_condition(tags or [], agent_names_by_slot, rng)
            elif ctype == "drag_point":
                data = self.drag_point_condition(
                    _np(io.full_traj_xy)[0],
                    fut_valid,
                    prompt_valid,
                    rng,
                )
            elif ctype == "motion_tag_OneText":
                twv = motion_tag_texts(tags or [], agent_names_by_slot or [], prng)
                data = self._text_rows(twv)
            elif ctype == "goal_OneText":
                data = self._text_rows(goal_texts(per_scene["goal"], prompt_valid))
            elif ctype == "llm_text_OneText":
                twv = self._load_llm_texts(scene, agent_names_by_slot)
                if twv is None:
                    # no released texts: fall back to templated tags so the
                    # text path stays exercised
                    twv = motion_tag_texts(tags or [], agent_names_by_slot or [], prng)
                data = self._text_rows(twv)
            else:
                continue
            all_cond[ctype] = data

        # ---- 2./3. sampling and joint priority masking, in the configured
        # order (reference: condition_utils.py:1070-1084)
        def sample_all():
            for ctype in all_cond:
                all_cond[ctype] = self.sample(all_cond[ctype], rng,
                                              quota_scene=quota)

        if self.cond_cfg.USE_PRIORITY_MASK:
            if self.cond_cfg.SAMPLE_BEFORE_PRIORITY:
                sample_all()
            if self.cond_cfg.USE_SOFT_PRIORITY:
                mask_soft_priority_condition(
                    all_cond, dict(self.cond_cfg.PRIORITY_SCORES), rng)
            else:
                mask_priority_condition(
                    all_cond, list(self.cond_cfg.PRIORITY_ORDER))
            if not self.cond_cfg.SAMPLE_BEFORE_PRIORITY:
                sample_all()
        else:
            sample_all()

        # ---- 4. emit Condition containers; OneText rows concatenate into a
        # single string after masking (reference: condition_utils.py:750-794)
        out: Dict[str, Condition] = {}
        llm_cfg = self.config.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM
        for ctype, data in all_cond.items():
            pm = np.zeros(N_pad, bool)
            for i in np.nonzero(data["mask"])[0]:
                for j in np.atleast_1d(data["prompt_idx"][i]):
                    if 0 <= j < N_pad:
                        pm[j] = True

            if "OneText" in ctype:
                twv = [(data["input"][i], int(data["prompt_idx"][i, 0]))
                       for i in np.nonzero(data["mask"])[0]]
                if self.cond_cfg.OneText.USE_PLACEHOLDER:
                    # ablation: strip semantic content, keep agent reference
                    # (reference: condition_utils.py:275-279)
                    twv = [
                        (f"{AGENT_TEMPLATE.format(s)} is there." if s >= 0
                         else "placeholder.", s)
                        for _, s in twv
                    ]
                text, pmask = concat_one_text(
                    twv, N_pad,
                    shuffle=self.cond_cfg.OneText.SHUFFLE_TEXT, rng=prng)
                out[ctype] = build_one_text_condition(
                    self.tokenizer(), [text], (pmask & prompt_valid)[None],
                    max_len=llm_cfg.MAX_TEXT_TOKENS,
                    use_prompt_token=llm_cfg.USE_PROMPT_TOKEN,
                    agent_token_mode=llm_cfg.AGENT_TOKEN_MODE,
                    use_text_prompt_mask=llm_cfg.USE_TEXT_PROMPT_MASK,
                    agent_valid=prompt_valid[None],
                )
            else:
                out[ctype] = Condition(
                    feat=_pad_c(data["input"], C)[None],
                    mask=_pad_c(data["mask"], C)[None],
                    prompt_idx=_pad_c(data["prompt_idx"], C, fill=-1)[None].astype(np.int32),
                    prompt_mask=(pm & prompt_valid)[None],
                )
        return out

    @staticmethod
    def _text_rows(twv) -> dict:
        """(text, slot) tuples -> a row dict so text types go through the same
        sampling/priority machinery as tensor conditions."""
        if not twv:
            return {
                "input": [],
                "mask": np.zeros((0,), bool),
                "prompt_idx": np.zeros((0, 1), np.int32),
            }
        return {
            "input": [t for t, _ in twv],
            "mask": np.ones(len(twv), bool),
            "prompt_idx": np.asarray([[s] for _, s in twv], np.int32),
        }

    _llm_ids_cache = None

    def _load_llm_texts(self, scene, agent_names_by_slot):
        """Released prosim_instruct_520k texts for this scene, rewritten to
        slot tokens (reference: data_utils.py:626-642 lookup,
        condition_utils.py:245-282 name -> <A{i}> rewrite). Returns a list of
        (text, slot) tuples -- one entry per addressed agent, with the text
        carried on the first -- or None when the release is not configured."""
        import pickle
        import re

        lt = self.cond_cfg.LLM_TEXT
        split = "train" if self.split.upper() == "TRAIN" else "val"
        folder = getattr(lt.FOLDER, split.upper())
        ids_pkl = getattr(lt.IDS_PKL, split.upper())
        if not folder or not ids_pkl or not os.path.exists(ids_pkl):
            return None

        if self._llm_ids_cache is None:
            with open(ids_pkl, "rb") as f:
                raw = pickle.load(f)
            # index by rounded ego-(x,y)@t0 so float32/float64 cache reads
            # still hit the pickle's keys
            self._llm_ids_cache = {
                (round(k[0], 3), round(k[1], 3)): v for k, v in raw.items()
            }

        ego = scene.states[scene.ego_index, 0]
        key = (round(float(ego[0]), 3), round(float(ego[1]), 3))
        hit = self._llm_ids_cache.get(key)
        if hit is None:
            return None
        sid = hit[0] if isinstance(hit, (list, tuple)) else hit
        path = os.path.join(
            folder, str(int(sid.split("_")[-1]) % 100), f"{sid}_10_90_output.txt"
        )
        if not os.path.exists(path):
            return None

        with open(path) as f:
            lines = [re.sub(r"^\d+\.\s*", "", ln).strip().replace('"', "")
                     for ln in f.readlines()]
        lines = [ln for ln in lines if ln]

        short_to_slot = {
            n[:5].lower(): s for s, n in enumerate(agent_names_by_slot or [])
        }
        out = []
        for text in lines:
            names = re.findall(r"<([a-zA-Z0-9]+)>", text)
            slots = []
            for name in names:
                s = short_to_slot.get(name.lower())
                if s is not None:
                    text = text.replace(f"<{name}>", AGENT_TEMPLATE.format(s))
                    slots.append(s)
            if names and not slots:
                continue  # none of the mentioned agents are prompt agents
            if slots:
                out.append((text, slots[0]))
                out.extend(("", s) for s in slots[1:])
        return out or None
