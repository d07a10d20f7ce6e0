"""prosim_torch.demo"""
