"""Condition transformer: dispatcher over condition types (port of
prosim_tpu/models/condition/transformer.py).

The configured types split into non-text types, each encoded and fused
into the prompt tokens by the GNN condition attention, and text ('*OneText')
types, whose first one goes through the text attention afterwards
(reference: prosim/models/condition_transformer/base.py:6-61). Module names
mirror the flax ones (`encoders_<type>`, `cond_attn`, `text_attn`). With
deterministic=False the GNN's layers drop out at
MODEL.CONDITION_TRANSFORMER.DROPOUT; the text attention has no dropout, as
in the JAX package. ProSim calls the transformer deterministic in training
too, the JAX package's quirk (ROADMAP.md C), and its text branch trains
through the Llama's LoRA leaves and the text adapters. `dtype` goes to
every encoder, the GNN and the text attention; the Llama keeps the dtype
of its LlamaConfig, as in the JAX package.
"""

from typing import Dict

import torch
from torch import nn

from prosim_torch.data.batch import Prompt
from prosim_torch.data.motion_tags import V2VTag, VActionTag
from prosim_torch.models.condition.attn import GNNConditionAttn
from prosim_torch.models.condition.encoders import (
    DragPointEncoder,
    GoalConditionEncoder,
    V2VTagEncoder,
    VActionTagEncoder,
)
from prosim_torch.models.condition.text import BagOfTokensTextAttn, NoTextAttn
from prosim_torch.models.llm.llama import LlamaConfig, load_hf_llama_params
from prosim_torch.models.llm.text_attn import LlamaTextAttn


class ConditionTransformer(nn.Module):
    def __init__(self, hidden_dim: int, cond_types: tuple, text_types: tuple, num_layers: int,
                 num_heads: int, head_dim: int, pool: str = "mean", use_temporal_pe: bool = True,
                 text_attn_type: str = "none", llm_config: LlamaConfig = None,
                 text_prompt_mask_pred: bool = True, replace_agent_token: bool = True,
                 agent_token_mode: str = "none", use_prompt_token: bool = True,
                 drag_num_points: int = 8, drag_pre_layers: int = 1, drag_mlp_layers: int = 3,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cond_types = tuple(cond_types)
        self.text_types = tuple(text_types)
        for t in self.cond_types:
            if t == "goal":
                enc = GoalConditionEncoder(hidden_dim, use_temporal_pe, dtype)
            elif t == "v_action_tag":
                # the bank is indexed by the full enum's tag value, so the id
                # space stays stable under USED_TAGS subsets
                enc = VActionTagEncoder(hidden_dim, len(VActionTag), use_temporal_pe, dtype)
            elif t == "v2v_tag":
                enc = V2VTagEncoder(hidden_dim, len(V2VTag), use_temporal_pe, dtype)
            elif t == "drag_point":
                enc = DragPointEncoder(hidden_dim, drag_num_points, drag_pre_layers,
                                       drag_mlp_layers, dtype)
            else:
                raise KeyError(f"unknown condition type '{t}'")
            self.add_module(f"encoders_{t}", enc)
        if self.cond_types:
            self.cond_attn = GNNConditionAttn(hidden_dim, num_layers, num_heads, head_dim, pool,
                                              dropout, dtype)
        if self.text_types:
            if text_attn_type == "llama":
                self.text_attn = LlamaTextAttn(
                    hidden_dim, llm_config, replace_agent_token=replace_agent_token,
                    agent_token_mode=agent_token_mode, use_prompt_token=use_prompt_token,
                    prompt_mask_pred=text_prompt_mask_pred, dtype=dtype)
            elif text_attn_type == "bow":
                self.text_attn = BagOfTokensTextAttn(hidden_dim, dtype=dtype)
            else:
                self.text_attn = NoTextAttn()

    def forward(self, conditions: Dict, prompt_emb, prompt: Prompt, deterministic: bool = True,
                generator=None):
        """prompt_emb [B, N, D] -> (prompt_emb', text aux losses or None)."""
        cond_embs = {t: getattr(self, f"encoders_{t}")(conditions[t])
                     for t in self.cond_types if t in conditions}
        if cond_embs:
            prompt_emb = self.cond_attn(cond_embs, conditions, prompt_emb, prompt,
                                        deterministic, generator)
        aux = None
        if self.text_types:
            t = self.text_types[0]
            if isinstance(conditions.get(t), dict):
                prompt_emb, aux = self.text_attn(conditions[t], prompt_emb, prompt)
        return prompt_emb, aux


def _resolve_llm_config(arch: str, weights_path: str, lora_rank: int) -> LlamaConfig:
    """'tiny', or 'auto' without weights -> LlamaConfig.tiny(); otherwise
    (with a WEIGHTS_PATH, 'auto' means the released model) the Llama3-8B
    widths."""
    if arch == "tiny" or (arch == "auto" and not weights_path):
        return LlamaConfig.tiny(lora_rank=lora_rank)
    return LlamaConfig.llama3_8b(lora_rank=lora_rank)


def build_condition_transformer(config, dtype=torch.float32) -> ConditionTransformer:
    ct = config.MODEL.CONDITION_TRANSFORMER
    llm = ct.CONDITION_ENCODER.TEXT.LLM
    types = list(config.PROMPT.CONDITION.TYPES)
    text_types = tuple(t for t in types if "OneText" in t)
    text_attn_type = ct.TEXT_ATTN.TYPE if text_types else "none"
    llm_config = None
    if text_attn_type == "llama":
        llm_config = _resolve_llm_config(llm.ARCH, llm.WEIGHTS_PATH,
                                         ct.TEXT_ATTN.LORA.R if ct.TEXT_ATTN.LORA.ENABLE else 0)
    return ConditionTransformer(
        hidden_dim=config.MODEL.HIDDEN_DIM,
        cond_types=tuple(t for t in types if "OneText" not in t),
        text_types=text_types,
        num_layers=ct.NLAYER,
        num_heads=ct.NHEAD,
        head_dim=ct.FF_DIM,
        pool=ct.COND_POOL_FUNC,
        use_temporal_pe=ct.USE_TEMPORAL_ENCODING,
        text_attn_type=text_attn_type,
        llm_config=llm_config,
        text_prompt_mask_pred=llm.PROMPT_LOSS.PROMPT_MASK_PRED,
        replace_agent_token=llm.REPLACE_AGENT_TOKEN,
        agent_token_mode=llm.AGENT_TOKEN_MODE,
        use_prompt_token=llm.USE_PROMPT_TOKEN,
        drag_num_points=config.PROMPT.CONDITION.DRAG_POINT.MAX_POINTS,
        drag_pre_layers=ct.CONDITION_ENCODER.DRAG_POINTS.NUM_PRE_LAYERS,
        drag_mlp_layers=ct.CONDITION_ENCODER.DRAG_POINTS.NUM_MLP_LAYERS,
        dropout=ct.DROPOUT,
        dtype=dtype,
    )


def load_text_llm_weights(config, model) -> None:
    """With TEXT.LLM.WEIGHTS_PATH set, load the HF Llama weights into every
    condition transformer's Llama of `model` (port of
    prosim_tpu/models/condition/transformer.py load_text_llm_weights): the
    frozen body from the shards, the LoRA leaves drawn afresh, the same in
    each transformer, as the JAX ProSim.init does after its draw
    (prosim_tpu/models/prosim.py:80-85). Callers run it right after
    utils/params.py init_params, so a later load_flax_params or checkpoint
    load still wins."""
    path = config.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.WEIGHTS_PATH
    if not path:
        return
    for m in model.modules():
        if isinstance(m, ConditionTransformer) and isinstance(
                getattr(m, "text_attn", None), LlamaTextAttn):
            load_hf_llama_params(path, m.text_attn.llm)
