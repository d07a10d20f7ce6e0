"""Fixed-K neighbor selection over padded token grids (port of
prosim_tpu/ops/neighbors.py), with its hand-written CUDA kernel.

`neighbor_topk` returns, for each destination, the K nearest valid sources
as `[B, Q, eff_k]` int32 indices plus a validity mask, eff_k = min(k, S):
masked squared distances, optional radius cut, optional self exclusion,
ties to the lower source index. On a CUDA tensor it launches
csrc/neighbor_topk.cu (which replaces the TPU kernel
prosim_tpu/ops/pallas_topk.py:neighbor_topk_pallas; warp selection for
eff_k <= 128, radix select and a sort of next_pow2(eff_k) keys above); on a
CPU tensor it runs `neighbor_topk_plain`, which defines the semantics. The
two agree bit for bit.
"""

import ctypes
import functools

import numpy as np
import torch

from prosim_torch.ops import _build


def _radius2(radius) -> float:
    # the jitted JAX function traces a float radius as a weak f32 and
    # squares it in f32: round r to f32 first, then round the product
    r = np.float32(radius)
    return float(r * r)


def pairwise_d2(dst_pos, src_pos):
    """[B,Q,2], [B,S,2] -> [B,Q,S] squared distances rounded as the kernel
    (and XLA:CPU) computes them: fma(dy, dy, dx * dx) in float32, rounded
    once after the product dx*dx and once after the fused multiply-add.

    dy*dy is exact in float64, but the float64 sum with dx*dx may round,
    and a second rounding to float32 could then land on the other side of
    a float32 tie. So the float64 sum is rounded to odd (TwoSum's error
    term says whether it was inexact, and an inexact even result steps one
    ulp toward the exact sum); 53 >= 2*24 + 2 bits make the final rounding
    to float32 that of the exact sum."""
    dx = dst_pos[:, :, None, 0] - src_pos[:, None, :, 0]
    dy = dst_pos[:, :, None, 1] - src_pos[:, None, :, 1]
    p = dy.double() * dy.double()
    q = (dx * dx).double()
    s = p + q
    b = s - p
    err = (p - (s - b)) + (q - b)
    even = (s.view(torch.int64) & 1) == 0
    step = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf).to(s))
    return torch.where((err != 0) & even, step, s).float()


def neighbor_topk_plain(dst_pos, src_pos, dst_mask, src_mask, k: int,
                        radius=None, exclude_self: bool = False):
    """Plain PyTorch version: masked d2, then a stable ascending sort."""
    d2 = pairwise_d2(dst_pos.float(), src_pos.float())
    bad = ~(src_mask[:, None, :] & dst_mask[:, :, None])
    if radius is not None:
        bad = bad | (d2 > _radius2(radius))
    if exclude_self:
        q, s = d2.shape[1], d2.shape[2]
        bad = bad | torch.eye(q, s, dtype=torch.bool, device=d2.device)[None]
    d2 = torch.where(bad, torch.inf, d2)
    eff_k = min(k, d2.shape[-1])
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return idx[..., :eff_k].to(torch.int32), vals[..., :eff_k] < torch.inf


@functools.cache
def _launcher():
    fn = _build.load("neighbor_topk").neighbor_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def neighbor_topk(dst_pos, src_pos, dst_mask, src_mask, k: int, radius=None,
                  exclude_self: bool = False):
    """Select up to k nearest valid sources for each destination.

    dst_pos [B,Q,2] f32, src_pos [B,S,2] f32, dst_mask [B,Q] bool,
    src_mask [B,S] bool. Returns idx [B,Q,eff_k] int32 (arbitrary where
    invalid) and valid [B,Q,eff_k] bool, eff_k = min(k, S).
    """
    if dst_pos.device.type == "cpu":
        return neighbor_topk_plain(dst_pos, src_pos, dst_mask, src_mask, k,
                                   radius=radius, exclude_self=exclude_self)
    if dst_pos.device.type != "cuda":
        raise ValueError(f"neighbor_topk: unsupported device {dst_pos.device}")
    B, Q, _ = dst_pos.shape
    S = src_pos.shape[1]
    dev = dst_pos.device
    _check("dst_pos", dst_pos, torch.float32, (B, Q, 2), dev)
    _check("src_pos", src_pos, torch.float32, (B, S, 2), dev)
    _check("dst_mask", dst_mask, torch.bool, (B, Q), dev)
    _check("src_mask", src_mask, torch.bool, (B, S), dev)
    if exclude_self and Q > S:
        raise ValueError("exclude_self needs Q <= S")
    if S > (1 << 14):
        raise ValueError("neighbor_topk kernel stages rows of at most 16384 sources in shared "
                         f"memory, got {S}")
    eff_k = min(k, S)
    idx = torch.empty((B, Q, eff_k), dtype=torch.int32, device=dev)
    valid = torch.empty((B, Q, eff_k), dtype=torch.bool, device=dev)
    err = _launcher()(
        dst_pos.data_ptr(), src_pos.data_ptr(), dst_mask.data_ptr(), src_mask.data_ptr(),
        B, Q, S, eff_k, _radius2(radius) if radius is not None else 0.0,
        int(radius is not None), int(exclude_self), idx.data_ptr(), valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"neighbor_topk kernel launch failed: CUDA error {err}")
    neighbor_topk.launches += 1
    return idx, valid


neighbor_topk.launches = 0


def gather_neighbors(src, idx):
    """Gather per-neighbor features: src [B, S, ...], idx [B, Q, K] -> [B, Q, K, ...]."""
    bidx = torch.arange(src.shape[0], device=src.device)[:, None, None]
    return src[bidx, idx.long()]
