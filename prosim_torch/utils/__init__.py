"""prosim_torch.utils"""
