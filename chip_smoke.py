#!/usr/bin/env python3
"""Drive prosim_torch's main path on one NVIDIA GPU and check its kernels.

Run from the repository root:  python3 chip_smoke.py
(`--kernels-only` stops after phase 3.) Three configurations of the closed
loop are driven at full width: the default (the policy's a2p/m2p stack as a
layer loop), FUSED_STACK=True (the stack as one fused kernel per replan
step), and the text-conditioned loop (configs/waymo_demo.yaml's goal,
v_action_tag, drag_point and OneText conditions, the condition transformer
at policy_decoder, the Llama text path at Llama3-8B width with random bf16
weights); a fourth, configs/waymo_demo.yaml as shipped (its f32 tiny()
Llama), at B=2 in phase 5. Phases:
  1. device   - card name and power limit (nvidia-smi); TF32 and reduced-
                precision bf16 reductions off.
  2. build    - nvcc builds every CUDA kernel of the path from prosim_torch/csrc.
  3. kernels  - each kernel against its plain PyTorch version at the shapes
                of the rollout (demo padding, B=16): top-K at the six graph
                sites (bit-equal), the edge core on their real graphs (the
                top-K's idx and valid) and at the condition GNN's site
                (within EDGE_TOL, empty rows zero, two launches bitwise
                equal; beside it the earlier design over a gathered table,
                csrc/edge_attn_table.cu, and its gather), the fused stack on the policy's real a2p/m2p
                tables of the encoded batch with the fused model's random
                weights (within FUSED_TOL), flash attention at the Llama's
                shape on a holed tokenizer-layout mask (bf16 by the 2x rule
                below; f32 at tiny()'s shape within FLASH_F32_TOL; pad rows
                exactly zero). Times: device ms per call (torch.profiler,
                the call's device operations) beside the bound and a
                one-call PyTorch yardstick where one exists (for the fused
                stack, the layer loop instead); wall ms per call between
                CUDA events (which at the small sites is the host's time to
                launch the call) for the kernel and the yardstick.
  4. rollout  - the full-width closed loop of each configuration (lanes
                2048, obs agents 160, agents 128, B=16, 8 replan steps):
                finite, bounded, deterministic, every kernel launched the
                expected number of times per forward; scenes/s. Then one
                forward of each under torch.profiler with every kernel
                launch's inputs recorded: each kernel's device ms, launches
                and bound per forward and per site, and the device time by
                kernel family (written to chip_smoke_kernels.json in the
                output directory).
  5. parity   - each configuration's kernel path against its plain path (the
                model with its kernel calls pointed at the plain versions),
                and the fused rollout against the layer-loop rollout, all on
                the card, at B=2: rollouts within PARITY_TOL_M metres. For
                the text configuration the gate is the conditioned policy
                embedding (LlamaTextAttn's output): the kernel path's max
                deviation from a plain path whose attention runs in f32 on
                the same bf16 q/k/v is at most 2x the plain path's own
                deviation with the attention in bf16, plus 1e-5; its
                rollout deviation is logged. The shipped demo configuration
                (f32 Llama): launches per forward, its rollout within
                PARITY_TOL_M of its plain path, and one profiled forward.
  6. replicas - parallel_rollout with M=4 on B=2 matches the B=2 rollout.
Any failure raises and exits non-zero. The kernels JSON line comes just
before the last line, which is the device JSON.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

EDGE_TOL = 1e-4      # f32, unit-scale inputs; only the summation order differs
BF16_RULE = (2.0, 1e-5)  # flash attention: err <= 2 * (plain in bf16's err) + 1e-5, both vs f32
FLASH_F32_TOL = 1e-5  # flash attention in f32: only the order of the sums differs
FUSED_TOL = 3e-4     # abs and rel; the bar tests/test_fused_stack.py holds the TPU kernel to
PARITY_TOL_M = 1e-3  # metres, the bar the JAX package was held to
B_FULL, LANES, OBS_AGENTS, AGENTS, REPLAN = 16, 2048, 160, 128, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 dense tensor-core peak
LAYERS = 6
TEXT_YAML = "configs/waymo_demo.yaml"
TEXT_OPTS = ["MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.ARCH", "llama3_8b"]

FAMILIES = [  # (family, substrings of the kernel name), first match wins
    ("flash_attn (ours)", ("flash_attn_",)),
    ("fused_stack (ours)", ("fused_stack_kernel",)),
    ("edge_attn (ours)", ("edge_attn_kernel",)),
    ("neighbor_topk (ours)", ("neighbor_topk_",)),
    ("matmul", ("gemm", "sm90_xmma", "cutlass", "ampere_sgemm", "sgemm", "gemv", "nvjet")),
    ("gather/index", ("index", "gather", "scatter")),
    ("sort", ("sort", "radix")),
    ("reduce", ("reduce",)),
    ("copy/cat", ("copy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]
KERNEL_NAMES = {  # a substring of the names of each wrapper's CUDA kernels
    "neighbor_topk": "neighbor_topk_", "edge_attn_core": "edge_attn_kernel",
    "fused_two_site_stack": "fused_stack_kernel", "causal_attention": "flash_attn_"}


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters):
    """Wall time per call between CUDA events: the device time, or the
    host's time to launch the call where that is longer (small launches)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device time per call: the durations of the device operations (kernels,
    memsets, copies) the calls enqueue, from torch.profiler, over `iters`
    calls after a warm-up; the host's launch time is not in it. A trace
    with no device event (the profiler has returned one, once) is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
        log("device_ms: the profiler recorded no device time; profiling again")
    raise RuntimeError("the profiler recorded no device time in three traces")


def times(torch, fn, iters):
    """(device ms, wall ms) per call."""
    return device_ms(torch, fn, iters), cuda_ms(torch, fn, iters)


def kernel_fns():
    """{name: wrapper} of every kernel of the path; each counts its launches."""
    from prosim_torch.ops.edge_attn import edge_attn_core
    from prosim_torch.ops.flash_attn import causal_attention
    from prosim_torch.ops.fused_stack import fused_two_site_stack
    from prosim_torch.ops.neighbors import neighbor_topk

    return {"neighbor_topk": neighbor_topk, "edge_attn_core": edge_attn_core,
            "fused_two_site_stack": fused_two_site_stack, "causal_attention": causal_attention}


def launch_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


@contextlib.contextmanager
def kernel_calls(topk_fn, edge_fn, fused_fn, flash_fn):
    """Point the model's kernel calls at other functions (the plain versions
    in phase 5, recording shims in phase 4's profiled forward); the
    originals come back on exit."""
    from prosim_torch.models import decoder, policy, scene_encoder
    from prosim_torch.models.llm import llama
    from prosim_torch.ops import attention

    swaps = [(m, "neighbor_topk", topk_fn) for m in (scene_encoder, decoder, policy)]
    swaps.append((attention, "edge_attn_core", edge_fn))
    swaps.append((policy, "fused_two_site_stack", fused_fn))
    swaps.append((llama, "causal_attention", flash_fn))
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, fn in swaps:
            setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def site_inputs(torch, cfg, batch):
    """(dst_pos, src_pos, dst_mask, src_mask, k, radius, exclude_self) of the
    six neighbor-graph sites, as the model builds them from this batch."""
    m_pos, o_pos = batch.init_map.pos, batch.init_obs.pos
    m_mask, o_mask = batch.init_map.token_mask, batch.init_obs.token_mask
    s_pos = torch.cat([m_pos, o_pos], 1)
    s_mask = torch.cat([m_mask, o_mask], 1)
    p = batch.prompt
    se, de, po = cfg.MODEL.SCENE_ENCODER.ATTN, cfg.MODEL.DECODER.ATTN, cfg.MODEL.POLICY.ACT_DECODER.ATTN
    return {
        "a2a": (o_pos, o_pos, o_mask, o_mask, min(se.MAX_NUM_NEIGH * 4, 100), None, False),
        "s2s": (s_pos, s_pos, s_mask, s_mask, se.MAX_NUM_NEIGH, None, False),
        "p2p": (p.pos, p.pos, p.mask, p.mask, de.MAX_NUM_NEIGH, de.PROMPT_RADIUS, True),
        "s2p": (p.pos, s_pos, p.mask, s_mask, de.MAX_NUM_NEIGH, de.SCENE_RADIUS, False),
        "a2p": (p.pos, o_pos, p.mask, o_mask, po.MAX_NUM_NEIGH, po.AGENT_RADIUS, False),
        "m2p": (p.pos, m_pos, p.mask, m_mask, po.MAX_NUM_NEIGH, po.MAP_RADIUS, False),
    }


def check_topk(torch, sites):
    from prosim_torch.ops.neighbors import neighbor_topk, neighbor_topk_plain, pairwise_d2

    rows, graphs = [], {}
    for name, (dp, sp, dm, sm, k, r, ex) in sites.items():
        idx, val = neighbor_topk(dp, sp, dm, sm, k, radius=r, exclude_self=ex)
        idx_p, val_p = neighbor_topk_plain(dp, sp, dm, sm, k, radius=r, exclude_self=ex)
        torch.cuda.synchronize()
        if not (torch.equal(idx, idx_p) and torch.equal(val, val_p)):
            bad = (idx != idx_p) | (val != val_p)
            raise AssertionError(f"neighbor_topk[{name}] differs from its plain version "
                                 f"in {int(bad.sum())} of {bad.numel()} slots")
        graphs[name] = (idx, val)
        B, Q = dp.shape[:2]
        S = sp.shape[1]
        K = idx.shape[-1]
        iters = 5 if S > 1024 else 20
        ms, wall_ms = times(torch, lambda: neighbor_topk(dp, sp, dm, sm, k, radius=r, exclude_self=ex),
                            iters)
        plain_ms = device_ms(
            torch, lambda: neighbor_topk_plain(dp, sp, dm, sm, k, radius=r, exclude_self=ex), iters)
        d2 = pairwise_d2(dp, sp)
        bad = ~(sm[:, None, :] & dm[:, :, None])
        if r is not None:
            bad |= d2 > float(r) ** 2
        if ex:
            bad |= torch.eye(Q, S, dtype=torch.bool, device=d2.device)[None]
        d2 = torch.where(bad, torch.inf, d2)
        lib_ms, lib_wall_ms = times(torch, lambda: torch.topk(d2, K, dim=-1, largest=False), iters)
        rows.append(dict(site=name, B=B, Q=Q, S=S, K=K, ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_wall_ms=lib_wall_ms, max_abs_err=0.0,
                         **topk_cost(B, Q, S, K)))
        log(f"  neighbor_topk[{name}] B={B} Q={Q} S={S} K={K}: bit-equal; device ms: kernel "
            f"{ms:.4f}, plain {plain_ms:.4f}, torch.topk {lib_ms:.4f} ({lib_ms / ms:.2f}x the "
            f"kernel); wall ms: kernel {wall_ms:.4f}, torch.topk {lib_wall_ms:.4f}")
    return rows, graphs


@functools.cache
def _table_launcher():
    """The edge core's earlier design over a materialised table x_g
    (csrc/edge_attn_table.cu), the baseline phase 3 times beside the kernel."""
    import ctypes
    from prosim_torch.ops import _build

    fn = _build.load("edge_attn_table").edge_attn_table_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def edge_attn_table(torch, x_g, z_r, qx, qp, edge_valid, scale):
    B, Q, K, D = x_g.shape
    H, Dp = qx.shape[2], z_r.shape[-1]
    out = (torch.empty((B, Q, H, D), device="cuda"), torch.empty((B, Q, H, Dp), device="cuda"),
           torch.empty((B, Q, H), device="cuda"))
    err = _table_launcher()(
        x_g.data_ptr(), z_r.data_ptr(), qx.data_ptr(), qp.data_ptr(), edge_valid.data_ptr(),
        *(o.data_ptr() for o in out), B * Q, K, H, D, Dp, float(scale),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_attn_table launch failed: CUDA error {err}")
    return out


def check_edge(torch, graphs, H, D, scale):
    """graphs: {site: (idx [B,Q,K] int32, edge_valid [B,Q,K], S, D_pe)}, the
    sites' real graphs. The source rows x_src_n [B,S,D] are normalized
    random rows, z_r and the queries random; row 0 of every scene gets no
    valid edge. Beside the kernel: the earlier design (gather_src_features,
    then its kernel over the table, both timed) and the SDPA yardstick on
    the materialised [x_g | z_r] (with the time of the gather it needs)."""
    import torch.nn.functional as F
    from prosim_torch.ops import _build
    from prosim_torch.ops.attention import _norm_stats, gather_src_features
    from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
    from prosim_torch.ops.neighbors import gather_neighbors

    lib = _build.load("edge_attn")
    for Dp in sorted({g[3] for g in graphs.values()}):
        log(f"  edge_attn_core at D={D} Dp={Dp}: {lib.edge_attn_smem_bytes(D, Dp)} bytes of "
            f"dynamic shared memory a block; blocks of 4 warps per SM: short rows "
            f"{lib.edge_attn_blocks_per_sm(0, D, Dp)}, long rows {lib.edge_attn_blocks_per_sm(1, D, Dp)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, (idx, valid, S, Dp) in graphs.items():
        B, Q, K = valid.shape
        valid = valid.clone()
        valid[:, 0] = False  # at least one row with no valid edge per scene
        x_src = torch.randn((B, S, D), generator=gen, device="cuda")
        x_src_n = _norm_stats(x_src)
        z_r = torch.randn((B, Q, K, Dp), generator=gen, device="cuda")
        qx = torch.randn((B, Q, H, D), generator=gen, device="cuda") * 0.1
        qp = torch.randn((B, Q, H, Dp), generator=gen, device="cuda") * 0.1
        args = (x_src_n, idx, z_r, qx, qp, valid, scale)
        out = edge_attn_core(*args)
        again = edge_attn_core(*args)
        ref = edge_attn_core_plain(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        if not err <= EDGE_TOL:
            raise AssertionError(f"edge_attn_core[{name}] max abs err {err} > {EDGE_TOL}")
        empty = ~valid.any(-1)
        if any(float(o[empty].abs().max()) != 0.0 for o in out):
            raise AssertionError(f"edge_attn_core[{name}] rows without a valid edge are not zero")
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"edge_attn_core[{name}]: two launches differ")
        x_g = gather_src_features(x_src, idx)
        old = edge_attn_table(torch, x_g, z_r, qx, qp, valid, scale)
        torch.cuda.synchronize()
        old_err = max(float((a - b).abs().max()) for a, b in zip(old, ref))
        iters = 5 if B * Q * K > 2_000_000 else 20
        ms, wall_ms = times(torch, lambda: edge_attn_core(*args), iters)
        plain_ms = device_ms(torch, lambda: edge_attn_core_plain(*args), iters)
        old_ms = device_ms(torch, lambda: edge_attn_table(torch, x_g, z_r, qx, qp, valid, scale),
                           iters)
        gather_ms = device_ms(torch, lambda: gather_src_features(x_src, idx), iters)
        old_path_ms = device_ms(torch, lambda: edge_attn_table(
            torch, gather_src_features(x_src, idx), z_r, qx, qp, valid, scale), iters)
        path_ms = device_ms(torch, lambda: edge_attn_core(_norm_stats(x_src), *args[1:]), iters)
        # yardstick: one SDPA call on [qx|qp] against the shared [x_g|z_r]
        # rows of each destination (one key/value head for H query heads)
        q = torch.cat([qx, qp], -1).reshape(B * Q, H, 1, D + Dp)
        kv_of = lambda: torch.cat([gather_neighbors(x_src_n, idx), z_r], -1).reshape(
            B * Q, 1, K, D + Dp)
        kv = kv_of()
        mask = valid.reshape(B * Q, 1, 1, K)
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kv, kv, attn_mask=mask, scale=scale, enable_gqa=True), iters)
        lib_gather_ms = device_ms(torch, kv_of, iters)
        del q, kv, x_g
        n_valid = int(valid.sum())
        rows.append(dict(site=name, B=B, Q=Q, K=K, S=S, Dp=Dp, valid_edges=n_valid, ms=ms,
                         wall_ms=wall_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library_gather_ms=lib_gather_ms, path_ms=path_ms, table_ms=old_ms,
                         table_gather_ms=gather_ms, table_path_ms=old_path_ms,
                         table_max_abs_err=old_err, max_abs_err=err,
                         **edge_cost(n_valid, B, Q, K, H, D, Dp, S)))
        log(f"  edge_attn_core[{name}] B={B} Q={Q} S={S} K={K} Dp={Dp} valid={n_valid}: err "
            f"{err:.2e}; device ms: kernel {ms:.4f} (norm + kernel {path_ms:.4f}), earlier "
            f"design {old_ms:.4f} + gather {gather_ms:.4f} (together {old_path_ms:.4f}), plain "
            f"{plain_ms:.4f}, sdpa {lib_ms:.4f} + gather {lib_gather_ms:.4f}, bound "
            f"{bound_ms(rows[-1]):.4f}; wall ms: kernel {wall_ms:.4f}")
    return rows


def topk_cost(B, Q, S, K):
    """Bytes the top-K must move (positions and masks read once, idx and
    valid written once) and its operations (2 sub, 2 mul, 1 add per pair)."""
    return {"bytes": B * Q * 2 * 4 + B * S * 2 * 4 + B * Q + B * S + B * Q * K * (4 + 1),
            "ops": 5 * B * Q * S}


def edge_cost(n_valid, B, Q, K, H, D, Dp, S):
    """Bytes the edge core must move (per valid edge its idx and its z_r
    row; the mask; each scene's source table x_src_n once; the queries; the
    outputs) and its operations (a multiply-add for the score and one for
    the aggregate, per valid edge, head and dim)."""
    return {"bytes": (n_valid * (4 + Dp * 4) + B * Q * K + B * S * D * 4
                      + B * Q * H * (D + Dp) * 4 * 2 + B * Q * H * 4),
            "ops": n_valid * 4 * H * (D + Dp)}


def flash_cost(token_mask, Hq, D, Hkv, dtype):
    """Bytes the causal attention must move (in the inputs' dtype, once each:
    every output row, the q rows of valid tokens, the k and v rows of valid
    keys; and the mask) and its operations: the q.k and p.v multiply-adds
    over the valid (query, key) pairs at or below the diagonal, 4 Hq D per
    pair, at the peak of the path's units (bf16: the tensor cores; f32: the
    CUDA cores' FMA). A pad query row needs no input (its output is zero)
    and a masked key takes part in no pair."""
    import torch

    size, peak = (2, BF16_FLOPS) if dtype == torch.bfloat16 else (4, F32_FLOPS)
    B, T = token_mask.shape
    n = token_mask.sum(dim=1).long()  # valid tokens per scene
    pairs = int((n * (n + 1) // 2).sum())  # the i-th valid query sees i valid keys
    return {"bytes": size * D * (B * T * Hq + int(n.sum()) * (Hq + 2 * Hkv)) + B * T,
            "ops": 4 * Hq * D * pairs, "peak": peak}


def text_layout_mask(torch, B, text_len, block, seed):
    """The tokenizer's layout of [B, text_len + block] tokens: text of a
    random valid length 32..text_len, pad, then the prompt block with about
    half of its slots on (holes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mask = np.zeros((B, text_len + block), bool)
    for b in range(B):
        mask[b, : rng.integers(32, text_len + 1)] = True
        mask[b, text_len:] = rng.random(block) > 0.5
    return torch.from_numpy(mask).cuda()


def check_flash(torch, cfg_llm, B, text_len, block, site):
    """B4 at a Llama's shape and dtype: q/k/v from a seed, the tokenizer's
    holed mask. bf16: the kernel's max error against the plain version in
    f32 on the same inputs must be at most 2x the plain version's own error
    in bf16, plus 1e-5, on valid rows. f32: within FLASH_F32_TOL of the f32
    plain version on valid rows. Pad rows exactly zero."""
    import torch.nn.functional as F
    from prosim_torch.ops.flash_attn import causal_attention, causal_attention_plain

    T, Hq, Hkv, D = text_len + block, cfg_llm.num_heads, cfg_llm.num_kv_heads, cfg_llm.head_dim
    dtype = cfg_llm.dtype
    gen = torch.Generator(device="cuda").manual_seed(4)
    rnd = lambda h: torch.randn((B, T, h, D), generator=gen, device="cuda").to(dtype)
    q, k, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
    mask = text_layout_mask(torch, B, text_len, block, seed=4)
    scale = 1.0 / D ** 0.5
    out = causal_attention(q, k, v, mask, scale)
    ref = causal_attention_plain(q.float(), k.float(), v.float(), mask, scale)
    torch.cuda.synchronize()
    err = float((out.float() - ref)[mask].abs().max())
    extra = {}
    if dtype == torch.bfloat16:
        ref_bf16 = causal_attention_plain(q, k, v, mask, scale)
        err_bf16 = float((ref_bf16.float() - ref)[mask].abs().max())
        bar = BF16_RULE[0] * err_bf16 + BF16_RULE[1]
        extra = {"plain_bf16_err": err_bf16}
        note = f"plain in bf16 {err_bf16:.3e}"
        del ref_bf16
    else:
        bar = FLASH_F32_TOL
        note = f"bar {bar:.0e}"
    if not err <= bar:
        raise AssertionError(f"causal_attention[{site}] max abs err {err} > {bar} ({note})")
    if not bool(torch.isfinite(out).all()) or float(out[~mask].float().abs().max()) != 0.0:
        raise AssertionError(f"causal_attention[{site}]: pad rows are not exactly zero, or "
                             "non-finite values")
    del ref
    ms, wall_ms = times(torch, lambda: causal_attention(q, k, v, mask, scale), 20)
    plain_ms = device_ms(torch, lambda: causal_attention_plain(q, k, v, mask, scale), 5)
    # yardstick: one SDPA call, the same boolean mask, GQA
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    causal = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    bmask = (causal[None] & mask[:, None, :])[:, None]
    lib_ms, lib_wall_ms = times(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bmask, scale=scale, enable_gqa=True), 20)
    row = dict(site=site, B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, dtype=str(dtype).split(".")[-1],
               valid_tokens=int(mask.sum()), ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_wall_ms=lib_wall_ms, max_abs_err=err, **extra,
               **flash_cost(mask, Hq, D, Hkv, dtype))
    log(f"  causal_attention[{site}] B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} {row['dtype']}: err "
        f"{err:.3e} ({note}); device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, sdpa {lib_ms:.4f} "
        f"({lib_ms / ms:.2f}x the kernel); wall ms: kernel {wall_ms:.4f}, sdpa {lib_wall_ms:.4f}")
    return [row]


def check_fused(torch, model, batch):
    """The fused stack at the demo shape: the policy's real a2p/m2p tables at
    the prompt agents' poses, built from the encoded batch as the policy
    builds them (its graphs, rel-PE features and source tokens), x the
    policy embeddings, the model's random weights packed; row 0 of every
    scene has no valid edge. Also times the layer loop (FUSED_STACK=False,
    12 edge-core launches) and the fused path (tables + kernel) from the
    same graphs."""
    from prosim_torch.ops.fused_stack import fused_two_site_stack, fused_two_site_stack_plain

    policy = model.policy
    p = batch.prompt
    with torch.inference_mode():
        scene, emd = model.prepare(batch)
        x = emd["emd"].contiguous()
        graphs = [(idx, valid.clone()) for idx, valid in policy.site_graphs(scene, p.pos, p.mask)]
        for _, valid in graphs:
            valid[:, 0] = False
        ta, tm = policy.fused_tables(scene, p.pos, p.ori, graphs)
        wa, wm = policy.pack_fused()
        kw = dict(num_heads=policy.num_heads, head_dim=policy.head_dim)
        out = fused_two_site_stack(x, ta, tm, wa, wm, **kw)
        ref = fused_two_site_stack_plain(x, ta, tm, wa, wm, **kw)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        err = float(diff.max())
        over = float((diff - FUSED_TOL * ref.abs()).max())
        if not over <= FUSED_TOL:
            raise AssertionError(f"fused_two_site_stack differs from its plain version: max abs "
                                 f"err {err}, {over} over {FUSED_TOL} + {FUSED_TOL} * |plain|")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("fused_two_site_stack gave non-finite values")
        ms, wall_ms = times(torch, lambda: fused_two_site_stack(x, ta, tm, wa, wm, **kw), 5)
        plain_ms = device_ms(torch, lambda: fused_two_site_stack_plain(x, ta, tm, wa, wm, **kw), 3)
        loop_ms = device_ms(torch, lambda: policy.layer_loop(x, scene, p.pos, p.ori, graphs), 5)
        path_ms = device_ms(torch, lambda: fused_two_site_stack(
            x, *policy.fused_tables(scene, p.pos, p.ori, graphs), wa, wm, **kw), 5)
        cost = fused_cost(x, (ta, tm), (wa, wm), **kw)
    B, N, _ = x.shape
    n_valid = [int(t[3].sum()) for t in (ta, tm)]
    row = dict(site="policy", B=B, N=N, Ka=ta[1].shape[-1], Km=tm[1].shape[-1],
               valid_edges=n_valid, ms=ms, wall_ms=wall_ms, plain_ms=plain_ms, library_ms=None,
               layer_loop_ms=loop_ms, fused_path_ms=path_ms, max_abs_err=err, **cost)
    log(f"  fused_two_site_stack[policy] B={B} N={N} Ka={row['Ka']} Km={row['Km']} "
        f"valid={n_valid}: err {err:.2e}; device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, "
        f"tables + kernel {path_ms:.4f}, layer loop {loop_ms:.4f}; wall ms: kernel {wall_ms:.4f}")
    return [row]


def fused_cost(x_p, tables, weights, num_heads, head_dim):
    """Bytes the fused stack must move (x, both sites' source tokens, idx,
    feats and valid, both sites' packed weights, each read once; the output
    written once) and its operations: per valid edge and layer, 2 H (D + P)
    multiply-adds for the score and the aggregate (2 operations each) and
    the rel-PE expansion at 8 operations per column (the argument's
    multiply-add, one sin, the norm's sum, sum of squares and scaling); per
    query row and layer, the dense products' multiply-adds (to_q, the two
    folds, to_g, to_s, to_out, the FFN)."""
    from prosim_torch.ops.fused_stack import _FIELDS

    B, N, D = x_p.shape
    H, I = num_heads, num_heads * head_dim
    L, P = weights[0][0].shape[0], weights[0][_FIELDS.index("wkvr")].shape[1]
    dense = D * I + 2 * I * (D + P) + (I + D) * I + 2 * D * I + 8 * D * D
    nbytes = 2 * B * N * D * 4 + 4 * sum(t.numel() for w in weights for t in w)
    ops = 0
    for x_src, idx, feats, valid in tables:
        nbytes += 4 * (x_src.numel() + idx.numel() + feats.numel()) + valid.numel()
        ops += L * int(valid.sum()) * (4 * H * (D + P) + 8 * P) + 2 * L * B * N * dense
    return {"bytes": nbytes, "ops": ops}


def _bound_s(cost):
    """(bytes time, operations time) in seconds; operations at the cost's
    own peak (f32 CUDA cores unless it names the bf16 tensor cores)."""
    return cost["bytes"] / HBM_BYTES_PER_S, cost["ops"] / cost.get("peak", F32_FLOPS)


def bound_ms(cost):
    return 1e3 * max(_bound_s(cost))


def family(name):
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def profile_forward(torch, model, batch, topk_rows, edge_rows):
    """One forward under torch.profiler, with every kernel launch's inputs
    recorded by a shim around its wrapper. Each kernel launch's device time
    (matched to its shim record in launch order) and its bound at these
    inputs are added up per site; the site is the phase-3 site of the same
    shape ("policy" for the fused stack). Also returns the device time by
    kernel family."""
    from torch.profiler import ProfilerActivity, profile

    fns = kernel_fns()
    topk_site = {(r["Q"], r["S"], r["K"]): r["site"] for r in topk_rows}
    edge_site = {(r["Q"], r["K"], r["Dp"]): r["site"] for r in edge_rows}
    calls = {name: [] for name in fns}  # (site, cost or the inputs it is computed from)

    def topk(*a, **kw):
        idx, valid = fns["neighbor_topk"](*a, **kw)
        B, Q, K = idx.shape
        S = a[1].shape[1]
        calls["neighbor_topk"].append((topk_site[Q, S, K], topk_cost(B, Q, S, K)))
        return idx, valid

    def edge(x_src_n, idx, z_r, qx, qp, edge_valid, scale):
        out = fns["edge_attn_core"](x_src_n, idx, z_r, qx, qp, edge_valid, scale)
        B, S, D = x_src_n.shape
        Q, K = idx.shape[1:]
        dims = (B, Q, K, qx.shape[2], D, z_r.shape[-1], S)
        calls["edge_attn_core"].append((edge_site[Q, K, z_r.shape[-1]], (edge_valid, dims)))
        return out

    def flash(q, k, v, token_mask, scale):
        out = fns["causal_attention"](q, k, v, token_mask, scale)
        site = "llama" if q.dtype == torch.bfloat16 else "tiny_f32"
        calls["causal_attention"].append(
            (site, (token_mask, q.shape[2], q.shape[3], k.shape[2], q.dtype)))
        return out

    def fused(x_p, a2p_tables, m2p_tables, weights_a, weights_m, **kw):
        out = fns["fused_two_site_stack"](x_p, a2p_tables, m2p_tables, weights_a, weights_m, **kw)
        calls["fused_two_site_stack"].append(
            ("policy", (x_p, (a2p_tables, m2p_tables), (weights_a, weights_m), kw)))
        return out

    # The profiler can drop device events of a forward with ~18k launches
    # (seen once in the text forward: 111 of 123 edge-core launches); such a
    # trace cannot be matched to the shims, so it is taken again.
    for attempt in range(3):
        for recs in calls.values():
            recs.clear()
        before = launch_counts()
        with kernel_calls(topk, edge, fused, flash), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        if launched != {k: len(v) for k, v in calls.items()}:
            raise AssertionError(f"the shims saw {[len(v) for v in calls.values()]} of "
                                 f"{launched} kernel launches")
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not device:
            raise RuntimeError("the profiler recorded no device time")
        seen = {k: sum(KERNEL_NAMES[k] in e.name for e in device) for k in calls}
        if seen == launched:
            break
        log(f"profile: the trace holds {seen} of {launched} kernel launches; profiling again")
    else:
        raise AssertionError("the profiler dropped kernel launches in three traces")
    calls["edge_attn_core"] = [
        (site, edge_cost(int(valid.sum()), *dims)) for site, (valid, dims) in calls["edge_attn_core"]]
    calls["causal_attention"] = [
        (site, flash_cost(*args)) for site, args in calls["causal_attention"]]
    calls["fused_two_site_stack"] = [
        (site, fused_cost(x, tables, weights, **kw))
        for site, (x, tables, weights, kw) in calls["fused_two_site_stack"]]
    device.sort(key=lambda e: e.time_range.start)
    by_fam, by_name, count = {}, {}, {}
    for e in device:
        us = e.time_range.elapsed_us()
        by_fam[family(e.name)] = by_fam.get(family(e.name), 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
        count[e.name] = count.get(e.name, 0) + 1
    per_site = {}
    for kernel, recs in calls.items():
        evs = [e for e in device if KERNEL_NAMES[kernel] in e.name]
        sites = per_site[kernel] = {}
        for e, (site, cost) in zip(evs, recs):
            s = sites.setdefault(site, {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
            s["launches"] += 1
            s["ms"] += e.time_range.elapsed_us() / 1e3
            s["bound_ms"] += bound_ms(cost)
    busy = sum(by_fam.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return per_site, {"wall_ms": wall_ms, "busy_ms": busy, "launches": len(device),
                      "families_ms": dict(sorted(by_fam.items(), key=lambda kv: -kv[1])),
                      "top_kernels": [(n[:110], ms, count[n]) for n, ms in top]}


def text_parity(torch, model, small, plain, flash_plain):
    """The text configuration at B=2: the conditioned policy embedding
    (LlamaTextAttn's output, from `prepare`) of the kernel path against a
    plain path whose attention runs in f32 on the same bf16 q/k/v; the
    kernel path's max deviation must be at most 2x the deviation of the
    plain path with the attention in bf16, plus 1e-5. The rollouts'
    deviation is logged."""
    from prosim_torch.ops.flash_attn import causal_attention

    def f32_attention(q, k, v, token_mask, scale):
        return flash_plain(q.float(), k.float(), v.float(), token_mask, scale)

    m2 = small.prompt.mask
    emd = model.prepare(small)[1]["emd"]
    out = model(small)
    before = launch_counts()
    with kernel_calls(*plain, f32_attention):
        emd_ref = model.prepare(small)[1]["emd"]
        out_ref = model(small)
    with kernel_calls(*plain, flash_plain):
        emd_bf16 = model.prepare(small)[1]["emd"]
    if launch_counts() != before:
        raise AssertionError("text: the plain path launched a kernel")
    dev = float((emd - emd_ref)[m2].abs().max())
    dev_bf16 = float((emd_bf16 - emd_ref)[m2].abs().max())
    dxy = float((out["rollout_traj"] - out_ref["rollout_traj"])[m2][..., :2].abs().max())
    log(f"parity: B=2 text conditioned embedding, kernel path vs plain path (f32 attention) "
        f"max dev {dev:.3e}; plain path with bf16 attention {dev_bf16:.3e}; "
        f"rollout max |dxy| {dxy:.3e} m; {causal_attention.launches} B4 launches so far")
    bar = BF16_RULE[0] * dev_bf16 + BF16_RULE[1]
    if not dev <= bar:
        raise AssertionError(f"text: conditioned embedding deviates by {dev} > {bar} "
                             f"(2x the bf16 plain path's {dev_bf16} + 1e-5)")
    return {"embedding_dev": dev, "embedding_dev_plain_bf16": dev_bf16, "rollout_dxy_m": dxy}


def run_rollout(torch, cfg, model, batch, want, label):
    """Warm-up forward, then three timed forwards of the full-width B=16
    closed loop: launches per forward as `want`, finite, bounded, (sin, cos)
    on the unit circle, bitwise deterministic. Returns the sorted forward
    times in seconds."""
    t0 = time.perf_counter()
    model(batch)
    torch.cuda.synchronize()
    log(f"rollout[{label}]: first forward {time.perf_counter() - t0:.2f} s")
    for fn in kernel_fns().values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = model(batch)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = launch_counts()
    log(f"rollout[{label}]: launches per forward {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches} != {want}")
    for _ in range(2):
        t0 = time.perf_counter()
        out2 = model(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    traj = out["rollout_traj"]
    valid_traj = traj[batch.prompt.mask]
    if traj.shape != (B_FULL, AGENTS, REPLAN * cfg.ROLLOUT.POLICY.REPLAN_FREQ, 4):
        raise AssertionError(f"{label}: rollout_traj shape {tuple(traj.shape)}")
    if not bool(torch.isfinite(valid_traj).all()):
        raise AssertionError(f"{label}: rollout_traj has non-finite values")
    if float(valid_traj[..., :2].abs().max()) > 1e4:
        raise AssertionError(f"{label}: rollout_traj leaves a 10 km box")
    unit = (valid_traj[..., 2] ** 2 + valid_traj[..., 3] ** 2 - 1).abs().max()
    if float(unit) > 1e-4:
        raise AssertionError(f"{label}: (sin, cos) off the unit circle by {float(unit)}")
    if not torch.equal(out["rollout_traj"], out2["rollout_traj"]):
        raise AssertionError(f"{label}: two forwards of the same batch differ")
    times.sort()
    log(f"rollout[{label}]: B={B_FULL} forward s {['%.4f' % t for t in times]}, "
        f"median {B_FULL / times[1]:.3f} scenes/s, "
        f"max |xy| {float(valid_traj[..., :2].abs().max()):.2f} m, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, times


def log_profile(label, per_site, prof):
    log(f"profile[{label}]: forward wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), "
        f"{prof['launches']} kernel launches")
    for fam, ms in prof["families_ms"].items():
        log(f"  {fam:22s} {ms:10.3f} ms  {100 * ms / prof['busy_ms']:5.1f} %")
    for kernel, sites in per_site.items():
        if sites:
            log(f"  {kernel} per forward: " + ", ".join(
                f"{s} x{v['launches']} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})"
                for s, v in sites.items()))


def summarize(name, route, source, replaces, rows, launches, forward, extra=()):
    """One kernel's JSON entry: times and bounds summed over one launch at
    each of its phase-3 sites; forward_ms, forward_bound_ms and the sites'
    forward_* fields come from phase 4's profiled forward of the
    configuration that runs the kernel; `extra` names more row fields to
    sum."""
    for r in rows:
        r["bound_ms"] = bound_ms(r)
        t_bytes, t_ops = _bound_s(r)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        f = forward.get(r["site"], {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
        r.update({f"forward_{k}": v for k, v in f.items()})
    tot = lambda key: sum(r[key] for r in rows)
    lib = [r["library_ms"] for r in rows]
    lib_wall = [r.get("library_wall_ms") for r in rows]
    return {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
        "bound_by": ("bytes" if sum(_bound_s(r)[0] for r in rows) >= sum(_bound_s(r)[1] for r in rows)
                     else "operations"),
        "library_ms": None if None in lib else sum(lib),
        "wall_ms": tot("wall_ms"), "library_wall_ms": None if None in lib_wall else sum(lib_wall),
        **{key: tot(key) for key in extra},
        "forward_ms": tot("forward_ms"), "forward_bound_ms": tot("forward_bound_ms"),
        "sites": rows,
    }


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "prosim_torch", "csrc")):
        print("chip_smoke: prosim_torch/ is not beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.ops import _build
    from prosim_torch.models.condition.attn import condition_edge_mask
    from prosim_torch.models.llm.llama import LlamaConfig
    from prosim_torch.ops.edge_attn import edge_attn_core_plain
    from prosim_torch.ops.flash_attn import causal_attention_plain
    from prosim_torch.ops.fused_stack import fused_two_site_stack_plain
    from prosim_torch.ops.neighbors import neighbor_topk_plain
    from prosim_torch.rollout.rollout import parallel_rollout
    from prosim_torch.utils.params import init_params

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(_build.SOURCES)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions at the rollout's shapes
    cfg = get_config()
    cfg_fused = get_config(opts=["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"])
    cfg_text = get_config(os.path.join(root, TEXT_YAML), TEXT_OPTS)
    shape = dict(num_lanes=LANES, num_obs_agents=OBS_AGENTS, num_agents=AGENTS, num_replan=REPLAN)
    batch = make_synthetic_batch(cfg, batch_size=B_FULL, seed=0, device="cuda", **shape)
    batch_t = make_synthetic_batch(cfg_text, batch_size=B_FULL, seed=0, device="cuda", **shape)
    sites = site_inputs(torch, cfg, batch)
    topk_rows, graphs = check_topk(torch, sites)
    hd = cfg.MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM
    H = cfg.MODEL.POLICY.ACT_DECODER.ATTN.NUM_HEAD
    D = cfg.MODEL.HIDDEN_DIM
    graphs = {name: (idx, v, sites[name][1].shape[1], 3 * D // 4)
              for name, (idx, v) in graphs.items()}
    # the condition GNN's site: Q = K = N, rel-PE at full width D
    ct_cfg = cfg_text.MODEL.CONDITION_TRANSFORMER
    if (ct_cfg.NHEAD, ct_cfg.FF_DIM) != (H, hd):
        raise AssertionError("the GNN site is timed with the policy's heads; they differ")
    N = batch_t.prompt.mask.shape[1]
    graphs["gnn"] = (torch.arange(N, dtype=torch.int32, device="cuda").expand(B_FULL, N, N)
                     .contiguous(),
                     condition_edge_mask(batch_t.conditions, cfg_text.PROMPT.CONDITION.TYPES,
                                         batch_t.prompt.mask), N, D)
    edge_rows = check_edge(torch, graphs, H, D, hd ** -0.5)
    del graphs
    llm_cfg = LlamaConfig.llama3_8b(lora_rank=ct_cfg.TEXT_ATTN.LORA.R)  # TEXT_OPTS' ARCH
    text_len = ct_cfg.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS
    flash_rows = check_flash(torch, llm_cfg, B_FULL, text_len, AGENTS, "llama")
    # the f32 instantiation at tiny()'s shape, what the shipped demo configuration runs
    llm_tiny = LlamaConfig.tiny(
        lora_rank=ct_cfg.TEXT_ATTN.LORA.R if ct_cfg.TEXT_ATTN.LORA.ENABLE else 0)
    flash_rows_f32 = check_flash(torch, llm_tiny, B_FULL, text_len, AGENTS, "tiny_f32")
    torch.cuda.empty_cache()
    model_f = ProSim(cfg_fused, device="cuda")
    init_params(model_f, seed=0)
    if not model_f.policy.uses_fused_stack():
        raise AssertionError("FUSED_STACK=True did not select the fused stack")
    fused_rows = check_fused(torch, model_f, batch)
    torch.cuda.empty_cache()
    if "--kernels-only" in argv:
        return 0

    # 4. full-width rollout of the three configurations
    model = ProSim(cfg, device="cuda")
    init_params(model, seed=0)
    steps = 2 + 2 + 2 * REPLAN  # graph builds: scene encoder, decoder, policy per step
    want = {"neighbor_topk": steps, "edge_attn_core": LAYERS * steps, "fused_two_site_stack": 0,
            "causal_attention": 0}
    launches, times = run_rollout(torch, cfg, model, batch, want, "layer loop")
    per_site, prof = profile_forward(torch, model, batch, topk_rows, edge_rows)
    log_profile("layer loop", per_site, prof)
    want_f = dict(want, edge_attn_core=LAYERS * 4, fused_two_site_stack=REPLAN)
    launches_f, times_f = run_rollout(torch, cfg_fused, model_f, batch, want_f, "fused")
    per_site_f, prof_f = profile_forward(torch, model_f, batch, topk_rows, edge_rows)
    log_profile("fused", per_site_f, prof_f)
    t0 = time.perf_counter()
    model_t = ProSim(cfg_text, device="cuda")
    init_params(model_t, seed=0)
    with torch.no_grad():  # LoRA B factors start at zero; make the adapters do work
        gen = torch.Generator(device="cuda").manual_seed(1)
        for name, prm in model_t.named_parameters():
            if name.endswith(("lora_b", "lora_embed_b")):
                prm.copy_(torch.randn(prm.shape, generator=gen, device="cuda") * 0.02)
    torch.cuda.synchronize()
    n_llm = sum(p.numel() for p in model_t.condition_transformer_policy_decoder.text_attn.llm.parameters())
    log(f"text model: built and initialised on the card in {time.perf_counter() - t0:.1f} s, "
        f"Llama {n_llm / 1e9:.3f} B parameters in {llm_cfg.dtype}")
    want_t = dict(want, edge_attn_core=LAYERS * steps + ct_cfg.NLAYER,
                  causal_attention=llm_cfg.num_layers)
    launches_t, times_t = run_rollout(torch, cfg_text, model_t, batch_t, want_t, "text")
    per_site_t, prof_t = profile_forward(torch, model_t, batch_t, topk_rows, edge_rows)
    log_profile("text", per_site_t, prof_t)

    # 5. kernel path against plain path, both on the card; fused against layer loop
    small = make_synthetic_batch(cfg, batch_size=2, num_lanes=LANES,
                                 num_obs_agents=OBS_AGENTS, num_agents=AGENTS,
                                 num_replan=REPLAN, seed=1, device="cuda")
    m2 = small.prompt.mask

    def traj_err(a, b, what, mask=m2):
        diff = (a["rollout_traj"] - b["rollout_traj"])[mask][..., :2].abs()
        err_m = float(diff.max())
        per_step = diff.amax(dim=(0, 2)).view(REPLAN, -1).amax(dim=1)
        log(f"parity: B=2 rollout {what} max |dxy| {err_m:.3e} m (mean {float(diff.mean()):.3e}); "
            f"max per replan step {['%.2e' % float(x) for x in per_step]}")
        if not err_m <= PARITY_TOL_M:
            raise AssertionError(f"{what}: {err_m} m > {PARITY_TOL_M} m")
        return err_m

    plain = (neighbor_topk_plain, edge_attn_core_plain, fused_two_site_stack_plain)
    outs, parity = {}, {}
    for label, m in (("layer loop", model), ("fused", model_f)):
        outs[label] = m(small)
        before = launch_counts()
        with kernel_calls(*plain, causal_attention_plain):
            out_plain = m(small)
        if launch_counts() != before:
            raise AssertionError(f"{label}: the plain path launched a kernel")
        parity[label] = traj_err(outs[label], out_plain, f"[{label}] kernel path vs plain path")
    parity["fused vs layer loop"] = traj_err(outs["fused"], outs["layer loop"],
                                             "fused stack vs layer loop (kernel paths)")
    out_gpu = outs["layer loop"]
    parity["text"] = text_parity(torch, model_t, make_synthetic_batch(
        cfg_text, batch_size=2, seed=1, device="cuda", **shape), plain, causal_attention_plain)
    del model_t
    torch.cuda.empty_cache()
    # configs/waymo_demo.yaml as shipped: TEXT.LLM.ARCH auto without weights
    # resolves to the f32 tiny() Llama, whose attention is B4's f32 path
    cfg_demo = get_config(os.path.join(root, TEXT_YAML))
    model_d = ProSim(cfg_demo, device="cuda")
    init_params(model_d, seed=0)
    if model_d.condition_transformer_policy_decoder.text_attn.llm.cfg != llm_tiny:
        raise AssertionError("the shipped demo configuration did not resolve to the f32 tiny() Llama")
    small_d = make_synthetic_batch(cfg_demo, batch_size=2, seed=1, device="cuda", **shape)
    model_d(small_d)
    for fn in kernel_fns().values():
        fn.launches = 0
    out_d = model_d(small_d)
    torch.cuda.synchronize()
    launches_d = launch_counts()
    want_d = dict(want_t, causal_attention=llm_tiny.num_layers)
    log(f"demo (shipped, f32 Llama): launches per B=2 forward {launches_d} (expected {want_d})")
    if launches_d != want_d:
        raise AssertionError(f"demo: kernel launches {launches_d} != {want_d}")
    if not bool(torch.isfinite(out_d["rollout_traj"][small_d.prompt.mask]).all()):
        raise AssertionError("demo: rollout_traj has non-finite values")
    before = launch_counts()
    with kernel_calls(*plain, causal_attention_plain):
        out_dp = model_d(small_d)
    if launch_counts() != before:
        raise AssertionError("demo: the plain path launched a kernel")
    parity["demo"] = traj_err(out_d, out_dp, "[demo, f32 Llama] kernel path vs plain path",
                              mask=small_d.prompt.mask)
    per_site_d, prof_d = profile_forward(torch, model_d, small_d, topk_rows, edge_rows)
    log_profile("demo B=2", per_site_d, prof_d)
    del model_d

    # 6. M-replica rollout
    M = 4
    rep = parallel_rollout(model, small.to("cuda"), M)
    rt = rep["rollout_traj"].view(2, M, *rep["rollout_traj"].shape[1:])
    rep_err = float((rt - out_gpu["rollout_traj"][:, None]).abs()[m2[:, None].expand(2, M, -1)].max())
    log(f"replicas: parallel_rollout M={M} on B=2 -> {tuple(rep['rollout_traj'].shape)}, "
        f"max |replica - single| {rep_err:.3e}")
    if not rep_err <= PARITY_TOL_M:
        raise AssertionError(f"replicas differ from the single rollout by {rep_err}")

    # B1, B2 and B4 are read from the text configuration (it runs every site
    # of B1 and B2, the GNN's included), B3 from the fused one
    by_path = {"layer loop": launches, "fused": launches_f, "text": launches_t,
               "demo (B=2)": launches_d}
    kernels = [
        summarize("neighbor_topk", "cuda", "prosim_torch/csrc/neighbor_topk.cu",
                  "prosim_tpu/ops/pallas_topk.py:95", topk_rows,
                  launches_t["neighbor_topk"], per_site_t["neighbor_topk"]),
        summarize("edge_attn_core", "cuda", "prosim_torch/csrc/edge_attn.cu",
                  "prosim_tpu/ops/edge_attn.py:91", edge_rows,
                  launches_t["edge_attn_core"], per_site_t["edge_attn_core"],
                  extra=("path_ms", "table_ms", "table_gather_ms", "table_path_ms",
                         "library_gather_ms")),
        summarize("fused_two_site_stack", "cuda", "prosim_torch/csrc/fused_stack.cu",
                  "prosim_tpu/ops/fused_stack.py:260", fused_rows,
                  launches_f["fused_two_site_stack"], per_site_f["fused_two_site_stack"],
                  extra=("layer_loop_ms", "fused_path_ms")),
        summarize("causal_attention", "cuda", "prosim_torch/csrc/flash_attn.cu",
                  "prosim_tpu/models/llm/llama.py:134", flash_rows,
                  launches_t["causal_attention"], per_site_t["causal_attention"]),
        # B4's f32 instantiation, read from the shipped demo configuration
        summarize("causal_attention_f32", "cuda", "prosim_torch/csrc/flash_attn.cu",
                  "prosim_tpu/models/llm/llama.py:134", flash_rows_f32,
                  launches_d["causal_attention"], per_site_d["causal_attention"]),
    ]
    # B4's one launch count covers both instantiations: bf16 in the text
    # configuration, f32 in the shipped demo one
    paths = {"causal_attention": ("layer loop", "fused", "text"),
             "causal_attention_f32": ("demo (B=2)",)}
    for k in kernels:
        wrapper = k["name"].removesuffix("_f32")
        k["launches_per_path"] = {p: by_path[p][wrapper] for p in paths.get(k["name"], by_path)}
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": smi,
                   "rollout": {"layer loop": {"scenes_per_s": B_FULL / times[1], "forward_s": times,
                                              "profile": prof, "per_site": per_site},
                               "fused": {"scenes_per_s": B_FULL / times_f[1], "forward_s": times_f,
                                         "profile": prof_f, "per_site": per_site_f},
                               "text": {"scenes_per_s": B_FULL / times_t[1], "forward_s": times_t,
                                        "profile": prof_t, "per_site": per_site_t},
                               "demo (B=2)": {"profile": prof_d, "per_site": per_site_d}},
                   "parity_m": parity, "kernels": kernels}, f, indent=1)
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "sites"} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
