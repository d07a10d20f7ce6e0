"""The controls' lower precisions, put around the reference.

`fp8_products()`: every matrix product's two inputs rounded to float8 e4m3
(each tensor scaled so its largest magnitude maps to e4m3's largest finite
value, 448, rounded, and scaled back) before the product, which then runs
as it would. Under a bf16 reference this is the fp8 path a later change
might be tempted by: fp8 inputs, wider accumulation.

`tf32_products()`: float32 products on the tensor cores in TF32.
"""

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    if not x.is_floating_point():
        return x
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(x.dtype)


class _Fp8Products(TorchFunctionMode):
    PRODUCTS = {F.linear, torch.matmul, torch.bmm, torch.mm, torch.einsum,
                torch.Tensor.__matmul__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            if func is torch.einsum:
                eq, *ops = args
                if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                    ops = list(ops[0])
                args = (eq, *[round_e4m3(t) for t in ops])
            elif func is F.linear:
                x, w = args[0], args[1] if len(args) > 1 else kwargs.pop("weight")
                args = (round_e4m3(x), round_e4m3(w), *args[2:])
            else:
                args = tuple(round_e4m3(a) if torch.is_tensor(a) else a for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def fp8_products():
    with _Fp8Products():
        yield


@contextlib.contextmanager
def tf32_products():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
