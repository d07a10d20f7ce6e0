"""prosim_torch.viz"""
