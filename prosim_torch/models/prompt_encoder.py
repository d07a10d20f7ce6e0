"""Agent-status prompt encoder (port of prosim_tpu/models/prompt_encoder.py):
velocity, extent and type one-hot of each policy agent through an MLP that
computes in `dtype`."""

import torch
from torch import nn

from prosim_torch.data.batch import Prompt
from prosim_torch.ops.mlp import MLP


class AgentStatusPromptEncoder(nn.Module):
    def __init__(self, hidden_dim: int, in_dim: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.state_encoder = MLP([in_dim, hidden_dim, hidden_dim], ret_before_act=True, dtype=dtype)

    def forward(self, prompt: Prompt):
        emb = self.state_encoder(prompt.feat)
        return torch.where(prompt.mask[..., None], emb, 0.0)


def build_prompt_encoder(config, dtype=torch.float32) -> AgentStatusPromptEncoder:
    status = config.PROMPT.AGENT_STATUS
    in_dim = 2 * status.USE_VEL + 2 * status.USE_EXTEND + 3 * status.USE_AGENT_TYPE
    return AgentStatusPromptEncoder(hidden_dim=config.MODEL.HIDDEN_DIM, in_dim=in_dim, dtype=dtype)
