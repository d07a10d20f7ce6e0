"""Host-side text tokenization for the LLM conditioning path (port of
prosim_tpu/models/llm/tokenizer.py: the byte tokenizer, batch tokenization,
the prompt-token block and the prompt builder).

The device path needs static [B, L] int arrays; all string handling happens
here. Agent references use the `<A{i}>` template (reference:
prosim/dataset/text_utils.py:1-2; 128 agent tokens appended to the
vocabulary, no BOS/EOS for the demo configuration). Two tokenizers:
  * HFTokenizer - a Llama3 tokenizer loaded through `transformers` from a
    local directory (TEXT.LLM.TOKENIZER_PATH; no network), with the
    reference's ids. `transformers` is imported when one is built, and only
    on a host that has it: the card's machine does not.
  * ByteTokenizer - dependency-free (UTF-8 bytes plus the agent tokens).
"""

import re
from typing import Dict, List, Optional

import numpy as np

AGENT_TEMPLATE = "<A{}>"
MAX_AGENT_NUM = 128
_AGENT_RE = re.compile(r"<A(\d+)>")


class ByteTokenizer:
    """UTF-8 byte-level tokenizer; agent token <A{i}> -> base_vocab + i."""

    def __init__(self, base_vocab: int = 512, num_agent_tokens: int = MAX_AGENT_NUM):
        self.base_vocab = base_vocab
        self.num_agent_tokens = num_agent_tokens

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        for m in _AGENT_RE.finditer(text):
            ids.extend(b % self.base_vocab for b in text[pos:m.start()].encode())
            ids.append(self.base_vocab + int(m.group(1)) % self.num_agent_tokens)
            pos = m.end()
        ids.extend(b % self.base_vocab for b in text[pos:].encode())
        return ids

    def agent_token_id(self, i: int) -> int:
        return self.base_vocab + i


class HFTokenizer:
    """Llama3 tokenizer via transformers from a local directory, extended
    with the 128 <A{i}> tokens (the reference's added-token layout: agent
    token i gets id base_vocab + i)."""

    def __init__(self, path: str, num_agent_tokens: int = MAX_AGENT_NUM,
                 add_bos_eos: bool = False):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.base_vocab = len(self.tok)
        self.num_agent_tokens = num_agent_tokens
        self.tok.add_special_tokens({"additional_special_tokens": [
            AGENT_TEMPLATE.format(i) for i in range(num_agent_tokens)]})
        self.add_bos_eos = add_bos_eos

    @property
    def vocab_size(self):
        return self.base_vocab + self.num_agent_tokens

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=self.add_bos_eos)

    def agent_token_id(self, i: int) -> int:
        return self.tok.convert_tokens_to_ids(AGENT_TEMPLATE.format(i))


def tokenize_batch(tokenizer, texts: List[str], max_len: int, num_agents: int,
                   prompt_masks: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Texts -> static arrays: input_ids [B, L], token_mask [B, L],
    agent_slot_ids [B, L] (agent index at <A{i}> positions else -1),
    prompt_mask [B, N] (the given masks, else the agents the texts name)."""
    B = len(texts)
    ids = np.zeros((B, max_len), np.int32)
    mask = np.zeros((B, max_len), bool)
    slots = -np.ones((B, max_len), np.int32)
    pmask = (prompt_masks.astype(bool) if prompt_masks is not None
             else np.zeros((B, num_agents), bool))
    base = tokenizer.base_vocab
    for b, text in enumerate(texts):
        # left truncation: an overlong prompt keeps its tail
        # (reference: text_attns.py:128-130)
        enc = tokenizer.encode(text)[-max_len:]
        n = len(enc)
        ids[b, :n] = enc
        mask[b, :n] = True
        for j, t in enumerate(enc):
            a = t - base
            if 0 <= a < num_agents:
                slots[b, j] = a
                if prompt_masks is None:
                    pmask[b, a] = True
    return {"input_ids": ids, "token_mask": mask, "agent_slot_ids": slots, "prompt_mask": pmask}


def build_text_prompt(agent_instructions: Dict[int, str]) -> str:
    """Compose a OneText scene prompt from per-agent instructions, e.g.
    {11: 'stop moving'} -> '<A11> stop moving.'."""
    lines = []
    for idx, instr in agent_instructions.items():
        token = AGENT_TEMPLATE.format(idx)
        if token not in instr:
            instr = f"{token} {instr}"
        lines.append(instr if instr.endswith(".") else instr + ".")
    return "\n".join(lines)


_BLOCK_WIDTH = {"none": 1, "add": 1, "concat": 2, "concat_repeat": 3,
                "concat_sep": 4, "concat_semantic": 4}


def append_prompt_block(cond: Dict[str, np.ndarray], tokenizer, mode: str = "none",
                        block_mask: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Append the prompt-token block after the text tokens (reference:
    text_attns.py:261-345): one group of width w per agent slot, laid out by
    `mode` -- 'none' [emb], 'add' [name+emb], 'concat' [name, emb],
    'concat_repeat' [name, emb, name], 'concat_sep' [name, '|', emb, ';'],
    'concat_semantic' [name, 'is', emb, ','].

    The position carrying the agent embedding gets agent_slot_ids = agent
    index; `read_positions` [B, N] is where each agent's output hidden state
    is read (-1 for agents outside the block). `block_mask` [B, N] selects
    the agents that get a group (default: the condition's prompt_mask); the
    other groups stay masked, so the block has holes."""
    if mode not in _BLOCK_WIDTH:
        raise ValueError(f"unknown agent_token_mode '{mode}'")
    w = _BLOCK_WIDTH[mode]
    ids, mask, slots = cond["input_ids"], cond["token_mask"], cond["agent_slot_ids"]
    pmask = cond["prompt_mask"] if block_mask is None else np.asarray(block_mask)
    B, L = ids.shape
    N = pmask.shape[1]

    sep1 = sep2 = 0
    if mode == "concat_sep":
        sep1, sep2 = tokenizer.encode("|")[0], tokenizer.encode(";")[0]
    elif mode == "concat_semantic":
        sep1, sep2 = tokenizer.encode("is")[0], tokenizer.encode(",")[0]

    ids2 = np.concatenate([ids, np.zeros((B, w * N), np.int32)], axis=1)
    mask2 = np.concatenate([mask, np.zeros((B, w * N), bool)], axis=1)
    slots2 = np.concatenate([slots, -np.ones((B, w * N), np.int32)], axis=1)
    read = -np.ones((B, N), np.int32)
    emb_at = {"none": 0, "add": 0, "concat": 1, "concat_repeat": 1,
              "concat_sep": 2, "concat_semantic": 2}[mode]
    for b in range(B):
        for n in range(N):
            if not pmask[b, n]:
                continue
            p = L + w * n
            name_id = tokenizer.agent_token_id(n)
            group = {1: [name_id], 2: [name_id, name_id], 3: [name_id] * 3,
                     4: [name_id, sep1, name_id, sep2]}[w]
            ids2[b, p:p + w] = group
            slots2[b, p + emb_at] = n
            read[b, n] = p + emb_at
            mask2[b, p:p + w] = True
    out = dict(cond)
    out.update(input_ids=ids2, token_mask=mask2, agent_slot_ids=slots2, read_positions=read)
    return out
