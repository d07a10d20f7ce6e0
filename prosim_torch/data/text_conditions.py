"""OneText assembly (port of the two functions of
prosim_tpu/data/text_conditions.py that the rollout's text path needs):
join per-agent texts into one scene prompt, and tokenize scene prompts into
the static arrays that LlamaTextAttn consumes."""

import random
from typing import Dict, List, Optional

import numpy as np

from prosim_torch.models.llm.tokenizer import append_prompt_block, tokenize_batch


def concat_one_text(texts_with_slots: List[tuple], num_agents: int, shuffle: bool = False,
                    rng: Optional[random.Random] = None) -> tuple:
    """Join [(text, agent_slot)] into one scene prompt; returns
    (text, prompt_mask [N]) (reference: condition_utils.py:750-794). An
    entry with empty text only marks one more addressed agent."""
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
