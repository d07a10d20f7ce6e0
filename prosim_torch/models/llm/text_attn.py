"""Llama text conditioning: natural-language prompts -> per-agent residuals
(port of prosim_tpu/models/llm/text_attn.py:LlamaTextAttn), eval mode.

  1. project the policy embeddings D -> hidden with `prompt_to_llm` + LN;
  2. token embeddings with each <A{i}> token replaced by (or, in 'add'
     mode, summed with) agent i's projected embedding;
  3. one decoder forward over the batch of texts;
  4. read each agent's hidden state at its prompt-block slot
     (`read_positions`), or average it over the agent's <A{i}> tokens in the
     text (the scatter-back), project it back with `llm_to_cond` and add it
     onto the addressed agents' embeddings;
  5. the `prompt_mask_pred` head's BCE against the addressed-agent mask,
     returned as {'prompt_mask_pred_loss': ...}.

The QA probe (the JAX package's LlamaTextAttnQA) is training-only and is
left for later (ROADMAP.md queue A8).
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from prosim_torch.data.batch import Prompt
from prosim_torch.models.llm.llama import LlamaConfig, LlamaModel
from prosim_torch.ops.mlp import MLP, LayerNorm


class LlamaTextAttn(nn.Module):
    def __init__(self, hidden_dim: int, llm_config: LlamaConfig, replace_agent_token: bool = True,
                 agent_token_mode: str = "none", use_prompt_token: bool = True,
                 prompt_mask_pred: bool = True):
        super().__init__()
        self.replace_agent_token = replace_agent_token
        self.agent_token_mode = agent_token_mode
        self.use_prompt_token = use_prompt_token
        self.prompt_mask_pred = prompt_mask_pred
        H = llm_config.hidden_size
        self.llm = LlamaModel(llm_config)
        self.prompt_to_llm = MLP([hidden_dim, hidden_dim, H], ret_before_act=True)
        self.ln_prompt = LayerNorm(H)
        self.llm_to_cond = MLP([H, hidden_dim, hidden_dim], ret_before_act=True)
        if prompt_mask_pred:
            self.mask_pred_head = MLP([hidden_dim, 1], ret_before_act=True, without_norm=True)

    def forward(self, text_cond: Dict[str, torch.Tensor], prompt_cond_emb,
                prompt: Prompt) -> Tuple[torch.Tensor, Optional[Dict]]:
        """text_cond: input_ids / token_mask / agent_slot_ids [B, L],
        prompt_mask [B, N] (the agents the text addresses), optional
        read_positions [B, N]; prompt_cond_emb [B, N, D]."""
        ids = text_cond["input_ids"]
        tok_mask = text_cond["token_mask"]
        slot_ids = text_cond["agent_slot_ids"]

        agent_llm = self.ln_prompt(self.prompt_to_llm(prompt_cond_emb))  # [B, N, H]
        if not self.use_prompt_token:
            # ablation: the block keeps its layout, the injected vectors are zero
            agent_llm = agent_llm * 0.0
        if self.replace_agent_token or self.agent_token_mode == "add":
            hidden = self.llm(ids, tok_mask, agent_embs=agent_llm, agent_slot_ids=slot_ids,
                              agent_add_mode=self.agent_token_mode == "add")
        else:
            hidden = self.llm(ids, tok_mask)
        hidden = hidden.float()

        N = prompt_cond_emb.shape[1]
        read_pos = text_cond.get("read_positions")
        if read_pos is not None:
            safe = read_pos.long().clamp(0, hidden.shape[1] - 1)
            gathered = torch.gather(hidden, 1, safe[..., None].expand(-1, -1, hidden.shape[-1]))
            addressed = read_pos >= 0
        else:
            onehot = F.one_hot(torch.where(slot_ids >= 0, slot_ids, N).long(), N + 1)[..., :N]
            onehot = onehot.to(hidden.dtype) * tok_mask[..., None]  # [B, L, N]
            counts = onehot.sum(dim=1)  # [B, N]
            gathered = torch.einsum("blh,bln->bnh", hidden, onehot)
            gathered = gathered / counts.clamp_min(1)[..., None]
            addressed = counts > 0

        res = self.llm_to_cond(gathered)  # [B, N, D]
        out = torch.where((addressed & prompt.mask)[..., None], prompt_cond_emb + res,
                          prompt_cond_emb)
        if not self.prompt_mask_pred:
            return out, None
        logits = self.mask_pred_head(res)[..., 0]  # [B, N]
        target = text_cond["prompt_mask"].float()
        bce = -(target * F.logsigmoid(logits) + (1 - target) * F.logsigmoid(-logits))
        valid = prompt.mask
        loss = torch.where(valid, bce, 0.0).sum() / valid.sum().clamp_min(1)
        return out, {"prompt_mask_pred_loss": loss}
