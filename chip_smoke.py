#!/usr/bin/env python3
"""Drive prosim_torch's main path on one NVIDIA GPU and check its kernels.

Run from the repository root:  python3 chip_smoke.py
(`--kernels-only` stops after phase 3.) Phases:
  1. device   - card name and power limit (nvidia-smi); TF32 off.
  2. build    - nvcc builds every CUDA kernel of the path from prosim_torch/csrc.
  3. kernels  - each kernel against its plain PyTorch version at the six
                graph/attention sites of the rollout (demo padding, B=16):
                top-K bit-equal, edge core within EDGE_TOL; times by CUDA
                events beside the bound and a one-call PyTorch yardstick.
  4. rollout  - the full-width closed loop (get_config() defaults, lanes
                2048, obs agents 160, agents 128, B=16, 8 replan steps):
                finite, bounded, deterministic, every kernel launched the
                expected number of times per forward; scenes/s. Then one
                forward under torch.profiler with every kernel launch's
                inputs recorded: each kernel's device ms, launches and bound
                per forward and per site, and the device time by kernel
                family (written to chiprun_out/chip_smoke_kernels.json).
  5. parity   - the kernel path against the plain path (the model with its
                kernel calls pointed at the plain versions), both on the
                card, at B=2: rollout within PARITY_TOL_M metres.
  6. replicas - parallel_rollout with M=4 on B=2 matches the B=2 rollout.
Any failure raises and exits non-zero. The kernels JSON line comes just
before the last line, which is the device JSON.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

EDGE_TOL = 1e-4      # f32, unit-scale inputs; only the summation order differs
PARITY_TOL_M = 1e-3  # metres, the bar the JAX package was held to
B_FULL, LANES, OBS_AGENTS, AGENTS, REPLAN = 16, 2048, 160, 128, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
LAYERS = 6

FAMILIES = [  # (family, substrings of the kernel name), first match wins
    ("edge_attn (ours)", ("edge_attn_kernel",)),
    ("neighbor_topk (ours)", ("neighbor_topk_kernel",)),
    ("matmul", ("gemm", "sm90_xmma", "cutlass", "ampere_sgemm", "sgemm", "gemv")),
    ("gather/index", ("index", "gather", "scatter")),
    ("sort", ("sort", "radix")),
    ("reduce", ("reduce",)),
    ("copy/cat", ("copy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]
KERNEL_NAMES = {"neighbor_topk": "neighbor_topk_kernel", "edge_attn_core": "edge_attn_kernel"}


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters):
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


@contextlib.contextmanager
def kernel_calls(topk_fn, edge_fn):
    """Point the model's kernel calls at other functions (the plain versions
    in phase 5, recording shims in phase 4's profiled forward); the
    originals come back on exit."""
    from prosim_torch.models import decoder, policy, scene_encoder
    from prosim_torch.ops import attention

    swaps = [(m, "neighbor_topk", topk_fn) for m in (scene_encoder, decoder, policy)]
    swaps.append((attention, "edge_attn_core", edge_fn))
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

    rows, valids = [], {}
    for name, (dp, sp, dm, sm, k, r, ex) in sites.items():
        idx, val = neighbor_topk(dp, sp, dm, sm, k, radius=r, exclude_self=ex)
        idx_p, val_p = neighbor_topk_plain(dp, sp, dm, sm, k, radius=r, exclude_self=ex)
        torch.cuda.synchronize()
        if not (torch.equal(idx, idx_p) and torch.equal(val, val_p)):
            bad = (idx != idx_p) | (val != val_p)
            raise AssertionError(f"neighbor_topk[{name}] differs from its plain version "
                                 f"in {int(bad.sum())} of {bad.numel()} slots")
        valids[name] = val
        B, Q = dp.shape[:2]
        S = sp.shape[1]
        K = idx.shape[-1]
        iters = 5 if S > 1024 else 20
        ms = cuda_ms(torch, lambda: neighbor_topk(dp, sp, dm, sm, k, radius=r, exclude_self=ex), iters)
        plain_ms = cuda_ms(torch, lambda: neighbor_topk_plain(dp, sp, dm, sm, k, radius=r, exclude_self=ex), iters)
        d2 = pairwise_d2(dp, sp)
        bad = ~(sm[:, None, :] & dm[:, :, None])
        if r is not None:
            bad |= d2 > float(r) ** 2
        if ex:
            bad |= torch.eye(Q, S, dtype=torch.bool, device=d2.device)[None]
        d2 = torch.where(bad, torch.inf, d2)
        lib_ms = cuda_ms(torch, lambda: torch.topk(d2, K, dim=-1, largest=False), iters)
        rows.append(dict(site=name, B=B, Q=Q, S=S, K=K, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, max_abs_err=0.0, **topk_cost(B, Q, S, K)))
        log(f"  neighbor_topk[{name}] B={B} Q={Q} S={S} K={K}: bit-equal; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.topk {lib_ms:.4f} ms")
    return rows, valids


def check_edge(torch, valids, H, D, Dp, scale):
    import torch.nn.functional as F
    from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, valid in valids.items():
        B, Q, K = valid.shape
        valid = valid.clone()
        valid[:, 0] = False  # at least one row with no valid edge per scene
        x_g = torch.randn((B, Q, K, D), generator=gen, device="cuda")
        z_r = torch.randn((B, Q, K, Dp), generator=gen, device="cuda")
        qx = torch.randn((B, Q, H, D), generator=gen, device="cuda") * 0.1
        qp = torch.randn((B, Q, H, Dp), generator=gen, device="cuda") * 0.1
        out = edge_attn_core(x_g, z_r, qx, qp, valid, scale)
        ref = edge_attn_core_plain(x_g, z_r, qx, qp, valid, scale)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        if not err <= EDGE_TOL:
            raise AssertionError(f"edge_attn_core[{name}] max abs err {err} > {EDGE_TOL}")
        empty = ~valid.any(-1)
        if any(float(o[empty].abs().max()) != 0.0 for o in out):
            raise AssertionError(f"edge_attn_core[{name}] rows without a valid edge are not zero")
        iters = 5 if B * Q * K > 2_000_000 else 20
        ms = cuda_ms(torch, lambda: edge_attn_core(x_g, z_r, qx, qp, valid, scale), iters)
        plain_ms = cuda_ms(torch, lambda: edge_attn_core_plain(x_g, z_r, qx, qp, valid, scale), iters)
        # yardstick: one SDPA call on [qx|qp] against the shared [x_g|z_r]
        # rows of each destination (one key/value head for H query heads)
        q = torch.cat([qx, qp], -1).reshape(B * Q, H, 1, D + Dp)
        kv = torch.cat([x_g, z_r], -1).reshape(B * Q, 1, K, D + Dp)
        mask = valid.reshape(B * Q, 1, 1, K)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kv, kv, attn_mask=mask, scale=scale, enable_gqa=True), iters)
        del q, kv
        n_valid = int(valid.sum())
        rows.append(dict(site=name, B=B, Q=Q, K=K, valid_edges=n_valid, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
                         **edge_cost(n_valid, B, Q, K, H, D, Dp)))
        log(f"  edge_attn_core[{name}] B={B} Q={Q} K={K} valid={n_valid}: err {err:.2e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms")
    return rows


def topk_cost(B, Q, S, K):
    """Bytes the top-K must move (positions and masks read once, idx and
    valid written once) and its operations (2 sub, 2 mul, 1 add per pair)."""
    return {"bytes": B * Q * 2 * 4 + B * S * 2 * 4 + B * Q + B * S + B * Q * K * (4 + 1),
            "ops": 5 * B * Q * S}


def edge_cost(n_valid, B, Q, K, H, D, Dp):
    """Bytes the edge core must move (the valid edges' x_g/z_r rows, the
    mask, the queries, the outputs) and its operations (a multiply-add for
    the score and one for the aggregate, per valid edge, head and dim)."""
    return {"bytes": (n_valid * (D + Dp) * 4 + B * Q * K + B * Q * H * (D + Dp) * 4 * 2
                      + B * Q * H * 4),
            "ops": n_valid * 4 * H * (D + Dp)}


def bound_ms(cost):
    return 1e3 * max(cost["bytes"] / HBM_BYTES_PER_S, cost["ops"] / F32_FLOPS)


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
    shape. Also returns the device time by kernel family."""
    from torch.profiler import ProfilerActivity, profile

    from prosim_torch.ops.edge_attn import edge_attn_core
    from prosim_torch.ops.neighbors import neighbor_topk

    topk_site = {(r["Q"], r["S"], r["K"]): r["site"] for r in topk_rows}
    edge_site = {(r["Q"], r["K"]): r["site"] for r in edge_rows}
    calls = {"neighbor_topk": [], "edge_attn_core": []}  # (site, cost or its inputs)

    def topk(*a, **kw):
        idx, valid = neighbor_topk(*a, **kw)
        B, Q, K = idx.shape
        S = a[1].shape[1]
        calls["neighbor_topk"].append((topk_site[Q, S, K], topk_cost(B, Q, S, K)))
        return idx, valid

    def edge(x_g, z_r, qx, qp, edge_valid, scale):
        out = edge_attn_core(x_g, z_r, qx, qp, edge_valid, scale)
        B, Q, K, D = x_g.shape
        dims = (B, Q, K, qx.shape[2], D, z_r.shape[-1])
        calls["edge_attn_core"].append((edge_site[Q, K], (edge_valid, dims)))
        return out

    before = {"neighbor_topk": neighbor_topk.launches, "edge_attn_core": edge_attn_core.launches}
    with kernel_calls(topk, edge), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    launched = {"neighbor_topk": neighbor_topk.launches - before["neighbor_topk"],
                "edge_attn_core": edge_attn_core.launches - before["edge_attn_core"]}
    if launched != {k: len(v) for k, v in calls.items()}:
        raise AssertionError(f"the shims saw {[len(v) for v in calls.values()]} of "
                             f"{launched} kernel launches")
    calls["edge_attn_core"] = [
        (site, edge_cost(int(valid.sum()), *dims)) for site, (valid, dims) in calls["edge_attn_core"]]

    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device time")
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
        if len(evs) != len(recs):
            raise AssertionError(f"{kernel}: profiler saw {len(evs)} launches, shims {len(recs)}")
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


def summarize(name, route, source, replaces, rows, launches, forward):
    """One kernel's JSON entry: times and bounds summed over one launch at
    each of the six sites (phase 3); forward_ms, forward_bound_ms and the
    sites' forward_* fields come from phase 4's profiled forward."""
    for r in rows:
        r["bound_ms"] = bound_ms(r)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S >= r["ops"] / F32_FLOPS
                         else "operations")
        f = forward.get(r["site"], {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
        r.update({f"forward_{k}": v for k, v in f.items()})
    tot = lambda key: sum(r[key] for r in rows)
    return {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
        "bound_by": "bytes" if tot("bytes") / HBM_BYTES_PER_S >= tot("ops") / F32_FLOPS else "operations",
        "library_ms": tot("library_ms"),
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
    from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
    from prosim_torch.ops.neighbors import neighbor_topk, neighbor_topk_plain
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

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(_build.SOURCES)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions at the six sites
    cfg = get_config()
    batch = make_synthetic_batch(cfg, batch_size=B_FULL, num_lanes=LANES,
                                 num_obs_agents=OBS_AGENTS, num_agents=AGENTS,
                                 num_replan=REPLAN, seed=0, device="cuda")
    topk_rows, valids = check_topk(torch, site_inputs(torch, cfg, batch))
    hd = cfg.MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM
    H = cfg.MODEL.POLICY.ACT_DECODER.ATTN.NUM_HEAD
    D = cfg.MODEL.HIDDEN_DIM
    edge_rows = check_edge(torch, valids, H, D, 3 * D // 4, hd ** -0.5)
    del valids
    torch.cuda.empty_cache()
    if "--kernels-only" in argv:
        return 0

    # 4. full-width rollout
    model = ProSim(cfg, device="cuda")
    init_params(model, seed=0)
    t0 = time.perf_counter()
    model(batch)
    torch.cuda.synchronize()
    log(f"rollout: first forward {time.perf_counter() - t0:.2f} s")
    neighbor_topk.launches = 0
    edge_attn_core.launches = 0
    t0 = time.perf_counter()
    out = model(batch)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches = {"neighbor_topk": neighbor_topk.launches, "edge_attn_core": edge_attn_core.launches}
    want = {"neighbor_topk": 2 + 2 + 2 * REPLAN, "edge_attn_core": LAYERS * (2 + 2 + 2 * REPLAN)}
    log(f"rollout: launches per forward {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    times = [fwd_s]
    for _ in range(2):
        t0 = time.perf_counter()
        out2 = model(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    traj = out["rollout_traj"]
    mask = batch.prompt.mask
    valid_traj = traj[mask]
    if traj.shape != (B_FULL, AGENTS, REPLAN * cfg.ROLLOUT.POLICY.REPLAN_FREQ, 4):
        raise AssertionError(f"rollout_traj shape {tuple(traj.shape)}")
    if not bool(torch.isfinite(valid_traj).all()):
        raise AssertionError("rollout_traj has non-finite values")
    if float(valid_traj[..., :2].abs().max()) > 1e4:
        raise AssertionError("rollout_traj leaves a 10 km box")
    unit = (valid_traj[..., 2] ** 2 + valid_traj[..., 3] ** 2 - 1).abs().max()
    if float(unit) > 1e-4:
        raise AssertionError(f"(sin, cos) off the unit circle by {float(unit)}")
    if not torch.equal(out["rollout_traj"], out2["rollout_traj"]):
        raise AssertionError("two forwards of the same batch differ")
    times.sort()
    log(f"rollout: B={B_FULL} forward s {['%.4f' % t for t in times]}, "
        f"median {B_FULL / times[1]:.3f} scenes/s, "
        f"max |xy| {float(valid_traj[..., :2].abs().max()):.2f} m, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out, out2, traj, valid_traj
    per_site, prof = profile_forward(torch, model, batch, topk_rows, edge_rows)
    log(f"profile: forward wall {prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), {prof['launches']} kernel launches")
    for fam, ms in prof["families_ms"].items():
        log(f"  {fam:22s} {ms:10.3f} ms  {100 * ms / prof['busy_ms']:5.1f} %")
    for kernel, sites in per_site.items():
        log(f"  {kernel} per forward: " + ", ".join(
            f"{s} x{v['launches']} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})"
            for s, v in sites.items()))

    # 5. kernel path against plain path, both on the card
    small = make_synthetic_batch(cfg, batch_size=2, num_lanes=LANES,
                                 num_obs_agents=OBS_AGENTS, num_agents=AGENTS,
                                 num_replan=REPLAN, seed=1, device="cuda")
    out_gpu = model(small)
    before = (neighbor_topk.launches, edge_attn_core.launches)
    with kernel_calls(neighbor_topk_plain, edge_attn_core_plain):
        out_plain = model(small)
    if (neighbor_topk.launches, edge_attn_core.launches) != before:
        raise AssertionError("the plain path launched a kernel")
    m2 = small.prompt.mask
    diff = (out_gpu["rollout_traj"] - out_plain["rollout_traj"])[m2][..., :2].abs()
    err_m = float(diff.max())
    per_step = diff.amax(dim=(0, 2)).view(REPLAN, -1).amax(dim=1)
    log(f"parity: B=2 rollout kernel path vs plain path max |dxy| {err_m:.3e} m "
        f"(mean {float(diff.mean()):.3e}); max per replan step "
        f"{['%.2e' % float(x) for x in per_step]}")
    if not err_m <= PARITY_TOL_M:
        raise AssertionError(f"kernel path vs plain path {err_m} m > {PARITY_TOL_M} m")

    # 6. M-replica rollout
    M = 4
    rep = parallel_rollout(model, small.to("cuda"), M)
    rt = rep["rollout_traj"].view(2, M, *rep["rollout_traj"].shape[1:])
    rep_err = float((rt - out_gpu["rollout_traj"][:, None]).abs()[m2[:, None].expand(2, M, -1)].max())
    log(f"replicas: parallel_rollout M={M} on B=2 -> {tuple(rep['rollout_traj'].shape)}, "
        f"max |replica - single| {rep_err:.3e}")
    if not rep_err <= PARITY_TOL_M:
        raise AssertionError(f"replicas differ from the single rollout by {rep_err}")

    kernels = [
        summarize("neighbor_topk", "cuda", "prosim_torch/csrc/neighbor_topk.cu",
                  "prosim_tpu/ops/pallas_topk.py:95", topk_rows,
                  launches["neighbor_topk"], per_site["neighbor_topk"]),
        summarize("edge_attn_core", "cuda", "prosim_torch/csrc/edge_attn.cu",
                  "prosim_tpu/ops/edge_attn.py:91", edge_rows,
                  launches["edge_attn_core"], per_site["edge_attn_core"]),
    ]
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": smi, "scenes_per_s": B_FULL / times[1], "forward_s": times,
                   "profile": prof, "kernels": kernels}, f, indent=1)
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "sites"} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
