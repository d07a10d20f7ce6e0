"""prosim_torch.models"""
