"""One-pass attention core over gathered source rows, with its CUDA kernel.

Port of prosim_tpu/ops/edge_attn.py:edge_attn_core composed with the gather
the JAX package does before it (prosim_tpu/ops/attention.py
gather_neighbors(x_src_n, idx)). For each destination row and head:
    x_g  = x_src_n[idx]                           (per edge, [K, D])
    sim  = (x_g . qx + z_r . qp) * scale
    attn = softmax_K(where(valid, sim, -inf))     (rows with no valid edge -> 0)
    agg_x = sum_k attn * x_g ; agg_z = sum_k attn * z_r ; attn_sum = any(valid)
The layer's per-query score bias is constant over K and cancels inside the
softmax, so it is not an input. The tables, queries and outputs are in the
model dtype (f32 or bf16), as the TPU kernel's are in x_g.dtype; products
accumulate in f32. In bf16 the plain version rounds where the TPU kernel
does (prosim_tpu/ops/edge_attn.py:57-78): the scaled score, exp(s - max)
against the row's max, the weights, and each output once. idx is
arbitrary where an edge is invalid. It has no backward and refuses inputs
that require grad (training takes `attend_gathered`, the same block with
the bias and attention dropout).

On a CUDA tensor `edge_attn_core` launches csrc/edge_attn.cu, which gathers
the valid edges' source rows itself (no [B,Q,K,D] table is written), at any
K and head count H <= 8, with D, Dp <= 128 and D != Dp allowed; on a CPU
tensor it runs `edge_attn_core_plain`: the gather, then the einsum/softmax
block of prosim_tpu/ops/attention.py (in bf16, the TPU kernel's rounding).
The TPU package's EDGE_KERNEL switch and support window were measured on a
TPU and do not gate the port: GatedNeighborAttention calls this core at
every site.
"""

import ctypes
import functools

import torch

from prosim_torch.ops import _build
from prosim_torch.ops.neighbors import _check, gather_neighbors, refuse_grad


@functools.cache
def _launcher(dtype: torch.dtype):
    """The kernel's instantiation for the tables' dtype: f32 or bf16."""
    lib = _build.load("edge_attn")
    fn = lib.edge_attn_launch_bf16 if dtype == torch.bfloat16 else lib.edge_attn_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _Einsum32(torch.autograd.Function):
    """torch.einsum(eq, a.float(), b.float()) of two operands in a narrower
    dtype: each product exact in f32 and the sum accumulated in f32, with
    the operands upcast inside the forward and again inside the backward, so
    autograd keeps the bf16 operands and no f32 copy of them (a per-edge
    table in f32 is twice its bf16 size, and each layer kept two). Each
    operand's gradient is accumulated in f32 and rounded once to its dtype,
    as the transpose of the JAX package's bf16 einsum rounds it. eq is
    "X,Y->Z" with every index of X and of Y in Z or in the other operand."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.save_for_backward(a, b)
        ctx.eq = eq
        return torch.einsum(eq, a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        operands, z = ctx.eq.split("->")
        x, y = operands.split(",")
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = torch.einsum(f"{z},{y}->{x}", g, b.float()).to(a.dtype)
        if ctx.needs_input_grad[2]:
            gb = torch.einsum(f"{z},{x}->{y}", g, a.float()).to(b.dtype)
        return None, ga, gb


def _einsum32(eq, a, b):
    """torch.einsum(eq, a.float(), b.float()): f32 products and sums; in a
    narrower dtype under autograd through _Einsum32."""
    if a.dtype == b.dtype == torch.float32 or not torch.is_grad_enabled():
        return torch.einsum(eq, a.float(), b.float())
    return _Einsum32.apply(eq, a, b)


def attend_gathered(x_g, z_r, qx, qp, edge_valid, scale: float, bias=None, drop=None):
    """The differentiable einsum/softmax block of prosim_tpu/ops/attention.py
    (:346-366) over gathered source rows x_g [B,Q,K,D] -> (agg_x, agg_z,
    attn [B,Q,K,H]). The training branch passes the per-query score bias
    [B,Q,H] and `drop`, the dropout applied to the weights before they
    aggregate; the plain core passes neither. Products accumulate in f32;
    in bf16 the values round through x_g.dtype where the TPU kernel
    (`_edge_attn_kernel`) rounds them: the scaled score, exp(s - max), the
    weights, and each output (every cast is the identity in f32). Under
    autograd in bf16 the products go through _Einsum32, which keeps the
    bf16 tables for the backward and no f32 copy of them."""
    dt = x_g.dtype
    sim = _einsum32("bqhd,bqkd->bqkh", qx, x_g) + _einsum32("bqhd,bqkd->bqkh", qp, z_r)
    if bias is not None:
        sim = sim + bias[:, :, None]
    sim = (sim * scale).to(dt).float()
    valid = edge_valid[..., None]
    sim = torch.where(valid, sim, -torch.inf)
    sim_max = sim.amax(dim=2, keepdim=True)
    sim_max = torch.where(torch.isfinite(sim_max), sim_max, 0.0)
    expw = torch.where(valid, torch.exp(sim - sim_max), 0.0).to(dt).float()
    denom = expw.sum(dim=2, keepdim=True)
    attn = (expw / denom.clamp_min(1e-9)).to(dt)  # [B,Q,K,H]
    if drop is not None:
        attn = drop(attn)
    agg_x = _einsum32("bqkh,bqkd->bqhd", attn, x_g).to(dt)
    agg_z = _einsum32("bqkh,bqkd->bqhd", attn, z_r).to(dt)
    return agg_x, agg_z, attn


def edge_attn_core_plain(x_src_n, idx, z_r, qx, qp, edge_valid, scale: float):
    x_g = gather_neighbors(x_src_n, torch.where(edge_valid, idx, 0))
    agg_x, agg_z, _ = attend_gathered(x_g, z_r, qx, qp, edge_valid, scale)
    attn_sum = edge_valid.any(-1).to(x_g.dtype)[..., None].expand(*qx.shape[:3])
    return agg_x, agg_z, attn_sum


def edge_attn_core(x_src_n, idx, z_r, qx, qp, edge_valid, scale: float):
    """x_src_n [B,S,D] (the normalized source rows), idx [B,Q,K] int32,
    z_r [B,Q,K,Dp], qx [B,Q,H,D], qp [B,Q,H,Dp], edge_valid [B,Q,K] bool
    -> (agg_x [B,Q,H,D], agg_z [B,Q,H,Dp], attn_sum [B,Q,H]). The four
    value tensors share one dtype, f32 or bf16 (the kernel's two
    instantiations), which the outputs take. Forward only: refuses inputs
    that require grad while grad mode is on."""
    refuse_grad("edge_attn_core", x_src_n, z_r, qx, qp)
    dt = x_src_n.dtype
    if dt not in (torch.float32, torch.bfloat16) or any(t.dtype != dt for t in (z_r, qx, qp)):
        raise TypeError("edge_attn_core takes x_src_n, z_r, qx and qp in one dtype, float32 or "
                        f"bfloat16; got {[t.dtype for t in (x_src_n, z_r, qx, qp)]}")
    if x_src_n.device.type == "cpu":
        return edge_attn_core_plain(x_src_n, idx, z_r, qx, qp, edge_valid, scale)
    if x_src_n.device.type != "cuda":
        raise ValueError(f"edge_attn_core: unsupported device {x_src_n.device}")
    B, S, D = x_src_n.shape
    Q, K = idx.shape[1:]
    Dp = z_r.shape[-1]
    H = qx.shape[2]
    dev = x_src_n.device
    _check("x_src_n", x_src_n, dt, (B, S, D), dev)
    _check("idx", idx, torch.int32, (B, Q, K), dev)
    _check("z_r", z_r, dt, (B, Q, K, Dp), dev)
    _check("qx", qx, dt, (B, Q, H, D), dev)
    _check("qp", qp, dt, (B, Q, H, Dp), dev)
    _check("edge_valid", edge_valid, torch.bool, (B, Q, K), dev)
    if not (1 <= H <= 8 and 1 <= D <= 128 and 1 <= Dp <= 128):
        raise ValueError(f"edge_attn kernel takes H <= 8 and D, Dp <= 128, got H={H}, D={D}, Dp={Dp}")
    agg_x = torch.empty((B, Q, H, D), dtype=dt, device=dev)
    agg_z = torch.empty((B, Q, H, Dp), dtype=dt, device=dev)
    attn_sum = torch.empty((B, Q, H), dtype=dt, device=dev)
    err = _launcher(dt)(
        x_src_n.data_ptr(), idx.data_ptr(), z_r.data_ptr(), qx.data_ptr(), qp.data_ptr(),
        edge_valid.data_ptr(), agg_x.data_ptr(), agg_z.data_ptr(), attn_sum.data_ptr(),
        B, Q, S, K, H, D, Dp, float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_attn kernel launch failed: CUDA error {err}")
    edge_attn_core.launches += 1
    return agg_x, agg_z, attn_sum


edge_attn_core.launches = 0
