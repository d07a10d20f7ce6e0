"""prosim_torch.rollout"""
