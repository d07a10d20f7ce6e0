"""The traced run's readings: the device trace of the window, and the
accounting of the kernels' bounds and of the model's operations.

The window is traced by torch.profiler with device activity only (a host
trace of a ~100k-operation step takes about a minute to process). The
trace gives the device's busy time (the union of its operations'
intervals), each kernel's time by name, and the longest idle gaps.

The accounting replays each distinct input of the pool once, after the
window and untimed, with recording shims around the program's kernel
wrappers: each launch's bound (benchmark/costs) from the inputs it was given,
and its operations. The dense products the program runs as PyTorch operators
are counted by torch's FlopCounterMode over the same replay; the edge and
fused kernels' operations (ctypes launches, which it cannot see) come from
their cost functions. Counts are per input and multiplied by the times the
traced window served it.
"""

import contextlib

from benchmark.costs import costs


def device_events(prof, torch):
    """[(name, start_us, end_us)] of the device operations in a profile."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out.sort(key=lambda e: e[1])
    return out


def busy_and_gaps(events, top: int = 10):
    """(busy seconds: the union of the intervals, the `top` longest idle
    gaps between them as [label, seconds], label the operation that waited)."""
    busy, end, gaps = 0.0, None, []
    for name, s, t in events:
        if end is None or s >= end:
            if end is not None:
                gaps.append((s - end, f"before {name[:80]}"))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    gaps.sort(reverse=True)
    return busy / 1e6, [[label, g / 1e6] for g, label in gaps[:top]]


def summarize(events) -> dict:
    """The trace's numbers a record keeps: busy seconds, seconds by kernel
    name for the benchmark's kernels, the top device operations and gaps."""
    busy, gaps = busy_and_gaps(events)
    by_name = {}
    for name, s, t in events:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    kernel_s = {k: sum(v for n, v in by_name.items() if sub in n)
                for k, sub in costs.KERNEL_NAMES.items()}
    kernel_n = {k: sum(1 for n, _, _ in events if sub in n)
                for k, sub in costs.KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "kernel_s": kernel_s, "kernel_launches": kernel_n,
            "device_ops": [[n, v] for n, v in top], "idle_gaps": gaps,
            "n_device_ops": len(events)}


@contextlib.contextmanager
def kernel_shims(record: dict):
    """Point the program's kernel calls at recording shims: each launch adds
    its bound seconds and operations to record[kernel] = [bound_s, ops,
    launches]. The originals come back on exit."""
    from prosim_torch.models import decoder, policy, scene_encoder
    from prosim_torch.ops import attention

    for k in costs.KERNEL_NAMES:
        record.setdefault(k, [0.0, 0.0, 0])

    def add(kernel, cost):
        r = record[kernel]
        r[0] += costs.bound_s(cost)
        r[1] += cost["ops"]
        r[2] += 1

    def topk(orig):
        def shim(dst_pos, src_pos, dst_mask, src_mask, k, radius=None, exclude_self=False):
            B, Q, _ = dst_pos.shape
            S = src_pos.shape[1]
            add("b1_topk", costs.topk_cost(B, Q, S, min(k, S)))
            return orig(dst_pos, src_pos, dst_mask, src_mask, k, radius=radius,
                        exclude_self=exclude_self)
        return shim

    def edge(orig):
        def shim(x_src_n, idx, z_r, qx, qp, edge_valid, scale):
            B, S, D = x_src_n.shape
            Q, K = idx.shape[1:]
            add("b2_edge", costs.edge_cost(int(edge_valid.sum()), B, Q, K, qx.shape[2], D,
                                           z_r.shape[-1], S, x_src_n.element_size()))
            return orig(x_src_n, idx, z_r, qx, qp, edge_valid, scale)
        return shim

    def fused(orig):
        def shim(x_p, a2p, m2p, wa, wm, *, num_heads, head_dim):
            add("b3_fused", costs.fused_cost(x_p, [a2p, m2p], [wa, wm], num_heads, head_dim))
            return orig(x_p, a2p, m2p, wa, wm, num_heads=num_heads, head_dim=head_dim)
        return shim

    swaps = [(m, "neighbor_topk", topk) for m in (scene_encoder, decoder, policy)]
    swaps += [(attention, "edge_attn_core", edge), (policy, "fused_two_site_stack", fused)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, make in swaps:
            setattr(m, n, make(getattr(m, n)))
        yield record
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def account(call_fn, torch) -> dict:
    """One replay of call_fn() under the shims and FlopCounterMode:
    {'kernels': {kernel: [bound_s, ops, launches]}, 'dense_flops': n}."""
    from torch.utils.flop_counter import FlopCounterMode

    rec = {}
    with kernel_shims(rec), FlopCounterMode(display=False) as fc:
        call_fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return {"kernels": rec, "dense_flops": float(fc.get_total_flops())}


def scaled_accounting(per_input: dict, served: dict) -> dict:
    """Sum the per-input accountings, each times the calls the traced
    window served it: {'kernels': {...}, 'flops': total operations}."""
    kernels = {k: [0.0, 0.0, 0] for k in costs.KERNEL_NAMES}
    flops = 0.0
    for key, n in served.items():
        acc = per_input[key]
        for k, (b, ops, launches) in acc["kernels"].items():
            kernels[k][0] += n * b
            kernels[k][1] += n * ops
            kernels[k][2] += n * launches
        # the model's arithmetic: the dense products and the attention
        # kernels' edge work (the top-K's distance tests are selection, not
        # model arithmetic)
        flops += n * (acc["dense_flops"] + acc["kernels"]["b2_edge"][1]
                      + acc["kernels"]["b3_fused"][1])
    return {"kernels": kernels, "flops": flops}
