"""Lay the port's spans over the device trace of a benchmark cell, on a card.

    python3 scripts/trace_layers.py --workload no_text.wosac_m32 --seeds 11 12 13 \
        [--seconds 10] [--out layers_wosac.json]

For each seed the cell is set up as `benchmark/run.py` sets it up, then
four windows of `--seconds` run, each traced as a `--trace 1` run traces
its window (device activity only), in turns with the program's span
recorder (`prosim_torch.utils.tracing`) off, on, on, off. Of every window:
the call p50 and the device's idle share, so the recorder's cost is the on
windows against the off ones. Of each window with the recorder on, the
spans laid over the trace (`benchmark/spans.py`): host and device time by
span path, the span readers' metrics (`benchmark/metrics/`), the longest
idle gaps named by span, the device time launched under no span, the
clock's check (a device operation starts after the runtime event that
launched it), the device ms a call under the layers of `FAMILY_LAYERS`
by kernel family (the benchmark's families, and the program's own kernels
that they do not name yet) with their top operations,
and for WOSAC the share of a request's median latency that
the host time of `sampler`, `replicas`, `rollout` and `rollout_to_world`
covers, and the two scene encodes of a request. Of every window: the
rel-PE table kernel's launches and the table's plain builds on the card
a call (`prosim_torch.ops.attention.rel_pe_table`; none where the program
has no such counter). Needs a CUDA card; writes the readings as JSON to
`--out` and a summary to standard output.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import core, run  # noqa: E402
from benchmark import spans as sp  # noqa: E402
from benchmark.costs import costs  # noqa: E402

READERS = {
    "no_text.wosac_m32": ["sampler_host_ms.wosac", "replicas_host_ms.wosac",
                          "step_host_ms.wosac", "launches_per_request.wosac",
                          "program_idle_ms.wosac"],
    "default.closed_loop_b64": ["prepare_device_ms.default", "step_env_device_ms.default",
                                "policy_device_ms.default"],
}
REQUEST = "rollout_with_sampler"
COVER = ["rollout_with_sampler/sampler", "rollout_with_sampler/replicas",
         "rollout_with_sampler/rollout", "rollout_to_world"]
ENCODES = {"sampler": "rollout_with_sampler/sampler/prepare/scene_encoder",
           "replicas": "rollout_with_sampler/replicas/scene_encoder"}
ORDER = (False, True, True, False)
# layer: the span path segments that place an operation in it
FAMILY_LAYERS = {"policy": "step/policy", "prepare/scene_encoder": "prepare/scene_encoder",
                 "prepare/decoder": "prepare/decoder"}
TOP_OPS = 8
# kernels of the program that the benchmark's families do not name yet
OWN_FAMILIES = [("rel_pe_table (ours)", ("rel_pe_table_kernel",))]


def family(name: str) -> str:
    """A device operation's kernel family: OWN_FAMILIES, else the
    benchmark's (`benchmark/costs/costs.py`)."""
    for fam, keys in OWN_FAMILIES:
        if any(k in name for k in keys):
            return fam
    return costs.family(name)


def span_paths(spans) -> dict:
    """{span id: the names from its root span down to it, joined by '/'}."""
    by_id = {s[3]: s for s in spans}
    path = {}

    def p(i):
        if i not in path:
            s = by_id[i]
            path[i] = f"{p(s[4])}/{s[0]}" if s[4] in by_id else s[0]
        return path[i]

    for s in spans:
        p(s[3])
    return path


def table_counters():
    """(launches, plain builds) of the program's rel-PE table op, or None
    where the program has no such op."""
    try:
        from prosim_torch.ops.attention import rel_pe_table
    except ImportError:
        return None
    return rel_pe_table.launches, rel_pe_table.plain_builds


def layer_families(ops, launches, spans, calls):
    """{layer: {'families_ms': {family: ms a call}, 'top_ops': [[name, ms a
    call, launches a call]]}} over the operations launched under each layer
    of FAMILY_LAYERS (or below it)."""
    owner, _ = sp.attribute(ops, launches, spans)
    path = span_paths(spans)
    out = {layer: ({}, {}) for layer in FAMILY_LAYERS}
    for op, i in zip(ops, owner):
        if not i:
            continue
        p, ms, fam = f"/{path[i]}/", (op[2] - op[1]) / 1e6 / calls, family(op[0])
        for layer, seg in FAMILY_LAYERS.items():
            if f"/{seg}/" in p:
                fams, names = out[layer]
                fams[fam] = fams.get(fam, 0.0) + ms
                n = names.setdefault(op[0], [0.0, 0.0])
                n[0] += ms
                n[1] += 1 / calls
    return {layer: {"families_ms": dict(sorted(f.items(), key=lambda kv: -kv[1])),
                    "top_ops": [[k[:100], *v] for k, v in
                                sorted(n.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]]}
            for layer, (f, n) in out.items()}


def clock_check(ops, launches):
    """The share of operations that start on the device after the runtime
    event that launched them, and the least and median launch-to-start lag
    in us (a wrong clock shows as negative lags)."""
    lags = [o[1] - launches[o[3]] for o in ops if o[3] in launches]
    if not lags:
        return None
    return {"after_launch_share": sum(g >= 0 for g in lags) / len(lags),
            "min_lag_us": min(lags) / 1e3, "median_lag_us": statistics.median(lags) / 1e3}


def window(ctx, drv, seconds, on, tracing):
    torch = ctx.torch
    tracing.drain()
    if on:
        tracing.enable()
    counted = table_counters()
    try:
        w = run.run_window(ctx, drv, seconds, True)
    finally:
        tracing.disable()
    spans = tracing.drain()
    if counted is not None:
        counted = [(b - a) / w["calls"] for a, b in zip(counted, table_counters())]
    tw = w["traced"]
    ops, launches = sp.kineto_ops(tw.pop("prof"), torch)
    busy = sp.union((o[1], o[2]) for o in ops)
    busy_s = sum(e - s for s, e in busy) / 1e9
    lat = w["latencies_s"][:tw["calls"]]
    out = {"recorder": on, "calls": tw["calls"], "window_s": tw["window_s"],
           "call_p50_ms": 1e3 * statistics.median(lat), "busy_s": busy_s,
           "idle_pct": 100.0 * (1.0 - busy_s / tw["window_s"]), "device_ops": len(ops),
           "spans": len(spans), "rel_pe_table_per_call": counted}
    if not on:
        return out
    L = sp.layers(ops, launches, spans)
    record = {"layers": L, "window_s": tw["window_s"], "calls": tw["calls"]}
    out["metrics"] = {m: core.read_metric(m, record) for m in READERS[ctx.cell["name"]]}
    out["launches_found"] = L["launches_found"]
    out["clock"] = clock_check(ops, launches)
    out["unattributed_busy_pct"] = 100.0 * L["unattributed_busy_s"] / L["busy_s"]
    out["program_idle_s"] = L["program_idle_s"]
    out["requests"] = L["requests"]
    out["host_ms"] = {p: [n, 1e3 * s, 1e3 * s / n] for p, (n, s) in sorted(L["host"].items())}
    out["device_ms"] = {p: [n, 1e3 * s] for p, (n, s) in sorted(L["device"].items())}
    out["gaps"] = sp.label_gaps(ops, spans)
    out["layer_families"] = layer_families(ops, launches, spans, tw["calls"])
    n_req = L["requests"].get(REQUEST, 0)
    if n_req:
        per = {p: 1e3 * L["host"][p][1] / n_req for p in COVER if p in L["host"]}
        out["cover"] = {"host_ms_per_request": per, "median_call_ms": out["call_p50_ms"],
                        "share": sum(per.values()) / out["call_p50_ms"]}
        out["encodes"] = {k: {"host_ms": 1e3 * L["host"][p][1] / n_req,
                              "device_busy_ms": 1e3 * L["device"].get(p, [0, 0.0])[1] / n_req,
                              "device_ops": L["device"].get(p, [0, 0])[0] / n_req}
                          for k, p in ENCODES.items() if p in L["host"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, choices=sorted(READERS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    core.set_cache_dirs()
    cell = core.load_workload(args.workload)
    torch = core.require_cards(cell["chips"])
    tracing = sp.tracer()
    if tracing is None:
        raise core.BenchError("the program has no span recorder (prosim_torch.utils.tracing)")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = {"workload": args.workload, "card": core.power_limit(), "seconds": args.seconds,
              "seeds": {}}
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = run.make_ctx(cell, seed, torch, device)
        drv = core.load_driver(cell["driver"])
        drv.setup(ctx)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        wins = [window(ctx, drv, args.seconds, on, tracing) for on in ORDER]
        drv.release_program(ctx)
        torch.cuda.empty_cache()
        result["seeds"][seed] = {"setup_s": setup_s, "windows": wins}
        for w in wins:
            line = (f"{args.workload} seed {seed} recorder {'on ' if w['recorder'] else 'off'}: "
                    f"{w['calls']} calls, p50 {w['call_p50_ms']:.3f} ms, idle "
                    f"{w['idle_pct']:.3f} %, {w['device_ops']} ops, {w['spans']} spans, "
                    "rel_pe_table (launches, plain builds) a call "
                    f"{w['rel_pe_table_per_call']}")
            if w["recorder"]:
                line += (f"; no span {w['unattributed_busy_pct']:.4f} % of busy, launches found "
                         f"{w['launches_found']:.4f}, metrics "
                         + json.dumps({k: v and round(v, 4) for k, v in w["metrics"].items()}))
                if "cover" in w:
                    line += f"; cover {w['cover']['share']:.4f}"
            print(line, flush=True)
            for layer, rec in w.get("layer_families", {}).items():
                fams = {k: round(v, 3) for k, v in rec["families_ms"].items()}
                print(f"  {layer}: device ms a call {round(sum(fams.values()), 3)} {fams}",
                      flush=True)
                for name, ms, n in rec["top_ops"]:
                    print(f"    {ms:9.3f} ms {n:7.1f}x {name}", flush=True)
    result["card"] = core.power_limit()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except core.BenchError as e:
        print(f"trace_layers: {e}", file=sys.stderr)
        sys.exit(2)
