"""Interactive inference API (port of prosim_tpu/demo/api.py).

User-facing helpers mirroring the reference demo notebooks
(reference: prosim_demo/text_prompt_inference.ipynb cell 1 -
`text_control` / `modify_batch_condition` / plotting):

    sim = InteractiveSim(config, cache_dir)            # on the card
    sim.load_scene(0)
    sim.set_text("stop moving", agents=[11, 12])       # language control
    sim.set_goal(agent=3, xy=(40.0, 5.0))              # goal-point control
    sim.set_drag_points(agent=5, points=[...])         # route sketch
    sim.set_action_tag(agent=2, tag="LeftTurn")        # action-tag control
    sim.set_v2v_tag(1, 3, "Following")                 # pair-tag control
    out = sim.rollout()                                # closed loop, 8 s
    sim.plot("scene.png", out)

The model runs on `device` (default "cuda"); its randomness comes from an
explicit torch.Generator on that device. The condition rows each control
writes are built on the host, as in the JAX API, and moved to the device.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from prosim_torch.data.batch import Condition
from prosim_torch.data.dataset import ProSimImitationDataset
from prosim_torch.models.condition.transformer import load_text_llm_weights
from prosim_torch.models.prosim import ProSim
from prosim_torch.utils.params import init_params


def _host(x):
    return x.detach().cpu().numpy()


class InteractiveSim:
    def __init__(self, config, cache_dir: str, split: str = "val",
                 model: Optional[ProSim] = None, seed: int = 0, device="cuda"):
        """`model`: a built model whose weights are kept; without one, a model
        is built on `device` with weights drawn from `seed` (and the Llama
        weights of TEXT.LLM.WEIGHTS_PATH)."""
        self.config = config
        self.ds = ProSimImitationDataset(config, split, cache_dir)
        if model is None:
            model = ProSim(config, device=device)
            init_params(model, seed)
            load_text_llm_weights(config, model)
        self.model = model
        self.device = next(model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.batch = None

    # ------------------------------------------------------------- scenes
    def load_scene(self, idx: int):
        self.batch = self.ds.get_scene_batch(idx, device=self.device)
        return self.batch

    def load_checkpoint(self, path: str):
        """A released reference checkpoint (Lightning .ckpt), converted and
        merged non-strictly: parameters it lacks keep their values
        (reference loads strict=False, models/base.py:141-147). Returns the
        checkpoint keys that did not land in the model: unmapped by the
        converter, or of modules this model does not build."""
        from prosim_torch.utils.checkpoint_convert import load_converted, load_reference_checkpoint

        state, unmapped = load_reference_checkpoint(path)
        unmapped = unmapped + load_converted(self.model, state)
        if unmapped:
            print(f"note: {len(unmapped)} checkpoint keys not loaded")
        return unmapped

    def load_trainer_checkpoint(self, path: str):
        """A checkpoint written by Trainer.save_checkpoint (ckpt_*.pt).
        Non-strict: parameters absent from it (the stripped frozen Llama
        body) keep their values."""
        from prosim_torch.train.trainer import load_model_state

        load_model_state(self.model, path)

    # ----------------------------------------------------------- controls
    def _num_agents(self):
        return self.batch.prompt.mask.shape[1]

    def _cond_slots(self):
        return self.config.DATASET.FORMAT.PAD.NUM_CONDS

    def _rows(self, ctype: str, C: int, F: int, pidx_width: int, fill=0.0):
        """Host copies of the batch's `ctype` condition, or empty ones."""
        old = self.batch.conditions.get(ctype)
        if old is None:
            N = self._num_agents()
            return (np.full((1, C, F), fill, np.float32), np.zeros((1, C), bool),
                    -np.ones((1, C, pidx_width), np.int32), np.zeros((1, N), bool))
        return tuple(_host(t).copy() for t in (old.feat, old.mask, old.prompt_idx,
                                                old.prompt_mask))

    def _put(self, ctype: str, feat, mask, pidx, pmask):
        conds = dict(self.batch.conditions)
        conds[ctype] = Condition.from_numpy(
            {"feat": feat, "mask": mask, "prompt_idx": pidx, "prompt_mask": pmask}
        ).to(self.device)
        self.batch = self.batch.replace(conditions=conds)

    def set_text(self, text: str, agents: Sequence[int]):
        """Language control: '<Ai>'-reference the given agents
        (reference `text_control`)."""
        from prosim_torch.data.text_conditions import build_one_text_condition
        from prosim_torch.models.llm.tokenizer import AGENT_TEMPLATE

        gen = self.ds.cond_gen
        llm_cfg = self.config.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM
        if not any(AGENT_TEMPLATE.format(a) in text for a in agents):
            text = " ".join(AGENT_TEMPLATE.format(a) for a in agents) + " " + text
        N = self._num_agents()
        pmask = np.zeros((1, N), bool)
        pmask[0, list(agents)] = True
        tc = build_one_text_condition(
            gen.tokenizer(), [text], pmask, llm_cfg.MAX_TEXT_TOKENS,
            use_prompt_token=llm_cfg.USE_PROMPT_TOKEN,
            agent_token_mode=llm_cfg.AGENT_TOKEN_MODE,
            use_text_prompt_mask=llm_cfg.USE_TEXT_PROMPT_MASK,
            agent_valid=_host(self.batch.prompt.mask),
        )
        conds = dict(self.batch.conditions)
        conds["llm_text_OneText"] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                                     for k, v in tc.items()}
        self.batch = self.batch.replace(conditions=conds)

    def set_goal(self, agent: int, xy: Tuple[float, float]):
        """Goal-point control: (x, y) in the agent's local frame at t=0."""
        feat, mask, pidx, pmask = self._rows("goal", self._cond_slots(), 3, 1)
        slot = int(np.argmin(mask[0])) if not mask[0].all() else 0
        # reuse this agent's row when it already has a goal
        for c in np.nonzero(mask[0])[0]:
            if pidx[0, c, 0] == agent:
                slot = c
                break
        horizon = self.config.ROLLOUT.POLICY.MAX_STEPS
        feat[0, slot] = [xy[0], xy[1], float(horizon)]
        mask[0, slot] = True
        pidx[0, slot, 0] = agent
        pmask[0, agent] = True
        self._put("goal", feat, mask, pidx, pmask)

    def set_drag_points(self, agent: int, points: Sequence[Tuple[float, float]]):
        """Route-sketch control: waypoints in the agent's local frame."""
        P = self.config.PROMPT.CONDITION.DRAG_POINT.MAX_POINTS
        feat, mask, pidx, pmask = self._rows("drag_point", self._cond_slots(), P * 2, 1,
                                             fill=np.nan)
        slot = int(np.argmin(mask[0])) if not mask[0].all() else 0
        pts = np.full((P, 2), np.nan, np.float32)
        pts[: min(len(points), P)] = np.asarray(points)[:P]
        feat[0, slot] = pts.reshape(-1)
        mask[0, slot] = True
        pidx[0, slot, 0] = agent
        pmask[0, agent] = True
        self._put("drag_point", feat, mask, pidx, pmask)

    def _upsert_rows(self, ctype: str, feat_row: np.ndarray, agents: Sequence[int],
                     pidx_width: int):
        """Insert (or update, when the same agent set already has a row) one
        condition row of `ctype` (reference: the interactive option builders,
        condition_utils.py:796-863)."""
        feat, mask, pidx, pmask = self._rows(ctype, self._cond_slots(), len(feat_row),
                                             pidx_width)
        slot = int(np.argmin(mask[0])) if not mask[0].all() else 0
        for c in np.nonzero(mask[0])[0]:
            if (pidx[0, c] == np.asarray(agents)).all():
                slot = c
                break
        feat[0, slot] = feat_row
        mask[0, slot] = True
        pidx[0, slot] = np.asarray(agents, np.int32)
        for a in agents:
            pmask[0, a] = True
        self._put(ctype, feat, mask, pidx, pmask)

    def set_action_tag(self, agent: int, tag: str, interval: Optional[Tuple[int, int]] = None):
        """Action-tag control, e.g. set_action_tag(3, "LeftTurn")
        (reference: v_action_tag_condition_batch_from_option,
        condition_utils.py:825-860). Tags: see VActionTag."""
        from prosim_torch.data.motion_tags import VActionTag

        if tag not in VActionTag.__members__:
            raise ValueError(f"unknown tag {tag!r}; one of {list(VActionTag.__members__)}")
        if interval is None:
            interval = (0, self.config.ROLLOUT.POLICY.MAX_STEPS)
        row = np.asarray([VActionTag[tag].value, interval[0], interval[1]], np.float32)
        self._upsert_rows("v_action_tag", row, [agent], 1)

    def set_v2v_tag(self, agent_a: int, agent_b: int, tag: str,
                    interval: Optional[Tuple[int, int]] = None):
        """Pair-tag control, e.g. set_v2v_tag(3, 7, "Following"): agent_a
        performs `tag` relative to agent_b (reference pair vocabulary,
        motion_tag_utils.py). Tags: see V2VTag."""
        from prosim_torch.data.motion_tags import V2VTag

        if tag not in V2VTag.__members__:
            raise ValueError(f"unknown tag {tag!r}; one of {list(V2VTag.__members__)}")
        if interval is None:
            interval = (0, self.config.ROLLOUT.POLICY.MAX_STEPS)
        row = np.asarray([V2VTag[tag].value, interval[0], interval[1]], np.float32)
        self._upsert_rows("v2v_tag", row, [agent_a, agent_b], 2)

    def clear_conditions(self):
        self.batch = self.batch.replace(conditions={})

    # -------------------------------------------------------------- run
    def rollout(self, generator: Optional[torch.Generator] = None) -> Dict:
        """The closed loop on the current scene and conditions ('val' mode),
        drawing from `generator` (default: the sim's own)."""
        return self.model(self.batch, "val", generator or self.generator)

    def plot(self, path: str, output: Optional[Dict] = None, **kwargs) -> str:
        from prosim_torch.viz.plots import save_scene_png

        return save_scene_png(self.batch, path, output=output, **kwargs)

    def animate(self, path: str, output: Optional[Dict] = None, **kwargs) -> str:
        """Save a GIF animation of a rollout (runs one if not provided)."""
        from prosim_torch.viz.plots import save_rollout_gif

        if output is None:
            output = self.rollout()
        return save_rollout_gif(self.batch, output, path, **kwargs)
