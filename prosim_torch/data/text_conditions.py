"""Text condition generation: templated tag/goal texts and OneText assembly
(port of prosim_tpu/data/text_conditions.py; numpy only).

Host-side equivalents of the reference's text condition builders
(reference: prosim/dataset/condition_utils.py:449-545, 750-794): motion tags
are rendered through per-tag templates with `<A{i}>` agent references, goal
texts state target coordinates, and per-scene texts are concatenated into one
OneText string. Tokenization produces the static arrays LlamaTextAttn
consumes.

The reference's templates ship with the prosim_instruct_520k release; the
built-in paraphrase bank below covers the same tag vocabulary so text
prompting works without that download (pass `template_dict` to use released
templates)."""

import random
from typing import Dict, List, Optional

import numpy as np

from prosim_torch.data.motion_tags import MotionTag
from prosim_torch.models.llm.tokenizer import AGENT_TEMPLATE, append_prompt_block, tokenize_batch

BUILTIN_TEMPLATES: Dict[str, List[str]] = {
    "Accelerate": ["{agent_name} speeds up.", "{agent_name} accelerates."],
    "Decelerate": ["{agent_name} slows down.", "{agent_name} decelerates."],
    "KeepSpeed": ["{agent_name} keeps its speed.", "{agent_name} maintains a constant speed."],
    "Stopping": ["{agent_name} comes to a stop.", "{agent_name} is stopping."],
    "LeftLaneChange": ["{agent_name} changes to the left lane."],
    "RightLaneChange": ["{agent_name} changes to the right lane."],
    "KeepLane": ["{agent_name} stays in its lane."],
    "LeftTurn": ["{agent_name} turns left.", "{agent_name} makes a left turn."],
    "RightTurn": ["{agent_name} turns right.", "{agent_name} makes a right turn."],
    "Straight": ["{agent_name} goes straight.", "{agent_name} continues straight ahead."],
    "Parked": ["{agent_name} stays parked.", "{agent_name} remains parked."],
}


def motion_tag_texts(tags: List[MotionTag], agent_names_by_slot: List[str],
                     rng: Optional[random.Random] = None,
                     template_dict: Optional[Dict[str, List[str]]] = None) -> List[tuple]:
    """[(text, agent_slot)] with <A{slot}> references."""
    rng = rng or random.Random(0)
    templates = template_dict or BUILTIN_TEMPLATES
    name_to_slot = {n: i for i, n in enumerate(agent_names_by_slot)}
    out = []
    for t in tags:
        if t.type != "unary" or t.tag not in templates:
            continue
        slot = name_to_slot.get(t.agents[0])
        if slot is None:
            continue
        template = rng.choice(templates[t.tag])
        out.append((template.format(agent_name=AGENT_TEMPLATE.format(slot)), slot))
    return out


def goal_texts(goals_xy: np.ndarray, valid: np.ndarray) -> List[tuple]:
    """Per-agent goal statements (reference: condition_utils.py:514-543)."""
    out = []
    for slot in np.nonzero(valid)[0]:
        x, y = goals_xy[slot]
        out.append((f"{AGENT_TEMPLATE.format(slot)} goal point ({x:.2f}, {y:.2f})", int(slot)))
    return out


def concat_one_text(texts_with_slots: List[tuple], num_agents: int, shuffle: bool = False,
                    rng: Optional[random.Random] = None) -> tuple:
    """Join [(text, agent_slot)] into one scene prompt; returns
    (text, prompt_mask [N]) (reference: condition_utils.py:750-794). An
    entry with empty text only marks one more addressed agent (multi-agent
    520k texts carry the text on their first slot)."""
    rng = rng or random.Random(0)
    texts = list(texts_with_slots)
    if shuffle:
        rng.shuffle(texts)
    pmask = np.zeros(num_agents, bool)
    for _, slot in texts:
        if 0 <= slot < num_agents:
            pmask[slot] = True
    return "\n".join(t for t, _ in texts if t), pmask


def build_one_text_condition(tokenizer, texts: List[str], prompt_masks: np.ndarray,
                             max_len: int, use_prompt_token: bool = True,
                             agent_token_mode: str = "none",
                             use_text_prompt_mask: bool = False,
                             agent_valid: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Tokenize OneText strings ([B] texts, prompt_masks [B, N]). With
    use_prompt_token, append the per-agent prompt block and its read
    positions; the block covers all valid agents (agent_valid [B, N]) unless
    use_text_prompt_mask restricts it to the addressed set or no validity is
    given (reference: text_attns.py:166-170, 261-345)."""
    cond = tokenize_batch(tokenizer, texts, max_len, prompt_masks.shape[1], prompt_masks)
    if use_prompt_token:
        if use_text_prompt_mask or agent_valid is None:
            block = cond["prompt_mask"]
        else:
            block = np.asarray(agent_valid, bool)
        cond = append_prompt_block(cond, tokenizer, agent_token_mode, block_mask=block)
    return cond
