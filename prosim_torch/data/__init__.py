"""prosim_torch.data"""
