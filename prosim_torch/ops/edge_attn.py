"""One-pass attention core over gathered source rows, with its CUDA kernel.

Port of prosim_tpu/ops/edge_attn.py:edge_attn_core composed with the gather
the JAX package does before it (prosim_tpu/ops/attention.py
gather_neighbors(x_src_n, idx)). For each destination row and head:
    x_g  = x_src_n[idx]                           (per edge, [K, D])
    sim  = (x_g . qx + z_r . qp) * scale
    attn = softmax_K(where(valid, sim, -inf))     (rows with no valid edge -> 0)
    agg_x = sum_k attn * x_g ; agg_z = sum_k attn * z_r ; attn_sum = any(valid)
The layer's per-query score bias is constant over K and cancels inside the
softmax, so it is not an input. idx is arbitrary where an edge is invalid.

On a CUDA tensor `edge_attn_core` launches csrc/edge_attn.cu, which gathers
the valid edges' source rows itself (no [B,Q,K,D] table is written), at any
K and head count H <= 8, with D, Dp <= 128 and D != Dp allowed; on a CPU
tensor it runs `edge_attn_core_plain`: the gather, then the einsum/softmax
block of prosim_tpu/ops/attention.py. The TPU package's EDGE_KERNEL switch
and support window were measured on a TPU and do not gate the port:
GatedNeighborAttention calls this core at every site.
"""

import ctypes
import functools

import torch

from prosim_torch.ops import _build
from prosim_torch.ops.neighbors import _check, gather_neighbors


@functools.cache
def _launcher():
    fn = _build.load("edge_attn").edge_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def edge_attn_core_plain(x_src_n, idx, z_r, qx, qp, edge_valid, scale: float):
    x_g = gather_neighbors(x_src_n, torch.where(edge_valid, idx, 0))
    sim = (
        torch.einsum("bqhd,bqkd->bqkh", qx, x_g)
        + torch.einsum("bqhd,bqkd->bqkh", qp, z_r)
    ) * scale
    valid = edge_valid[..., None]
    sim = torch.where(valid, sim, -torch.inf)
    sim_max = sim.amax(dim=2, keepdim=True)
    sim_max = torch.where(torch.isfinite(sim_max), sim_max, 0.0)
    expw = torch.where(valid, torch.exp(sim - sim_max), 0.0)
    denom = expw.sum(dim=2, keepdim=True)
    attn = expw / denom.clamp_min(1e-9)  # [B,Q,K,H]
    agg_x = torch.einsum("bqkh,bqkd->bqhd", attn, x_g)
    agg_z = torch.einsum("bqkh,bqkd->bqhd", attn, z_r)
    attn_sum = edge_valid.any(-1).to(x_g.dtype)[..., None].expand(*qx.shape[:3])
    return agg_x, agg_z, attn_sum


def edge_attn_core(x_src_n, idx, z_r, qx, qp, edge_valid, scale: float):
    """x_src_n [B,S,D] (the normalized source rows), idx [B,Q,K] int32,
    z_r [B,Q,K,Dp], qx [B,Q,H,D], qp [B,Q,H,Dp] f32, edge_valid [B,Q,K]
    bool -> (agg_x [B,Q,H,D], agg_z [B,Q,H,Dp], attn_sum [B,Q,H])."""
    if x_src_n.device.type == "cpu":
        return edge_attn_core_plain(x_src_n, idx, z_r, qx, qp, edge_valid, scale)
    if x_src_n.device.type != "cuda":
        raise ValueError(f"edge_attn_core: unsupported device {x_src_n.device}")
    B, S, D = x_src_n.shape
    Q, K = idx.shape[1:]
    Dp = z_r.shape[-1]
    H = qx.shape[2]
    dev = x_src_n.device
    f32 = torch.float32
    _check("x_src_n", x_src_n, f32, (B, S, D), dev)
    _check("idx", idx, torch.int32, (B, Q, K), dev)
    _check("z_r", z_r, f32, (B, Q, K, Dp), dev)
    _check("qx", qx, f32, (B, Q, H, D), dev)
    _check("qp", qp, f32, (B, Q, H, Dp), dev)
    _check("edge_valid", edge_valid, torch.bool, (B, Q, K), dev)
    if not (1 <= H <= 8 and 1 <= D <= 128 and 1 <= Dp <= 128):
        raise ValueError(f"edge_attn kernel takes H <= 8 and D, Dp <= 128, got H={H}, D={D}, Dp={Dp}")
    agg_x = torch.empty((B, Q, H, D), dtype=f32, device=dev)
    agg_z = torch.empty((B, Q, H, Dp), dtype=f32, device=dev)
    attn_sum = torch.empty((B, Q, H), dtype=f32, device=dev)
    err = _launcher()(
        x_src_n.data_ptr(), idx.data_ptr(), z_r.data_ptr(), qx.data_ptr(), qp.data_ptr(),
        edge_valid.data_ptr(), agg_x.data_ptr(), agg_z.data_ptr(), attn_sum.data_ptr(),
        B, Q, S, K, H, D, Dp,
        float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_attn kernel launch failed: CUDA error {err}")
    edge_attn_core.launches += 1
    return agg_x, agg_z, attn_sum


edge_attn_core.launches = 0
