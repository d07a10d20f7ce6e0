"""Run one cell of the port's benchmark and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (benchmark/workloads/<cell>.json) names its configuration
(benchmark/configs/), its traffic mix (benchmark/traffic/) and its driver
(benchmark/drivers/), and gives the limits of the numbers compared. A run:
builds or finds the program's CUDA libraries (inside the checkout), makes
the weights on the card from the seed, draws the scenes from the seed,
warms up the cell's shapes (all of that is `setup_s`), then calls the
program back to back for `--seconds`. With --trace 1 the window is traced
(device only), with the program's spans recorded over it, and the kernels'
bounds and the model's operations are accounted after it. Then, the
program freed, the reference checks a sample of what the window produced,
drawn from the seed. Metrics are read by the readers in benchmark/metrics/,
one file per metric named in BENCHMARK.json.

It exits non-zero without a result when there is no CUDA card, too few
cards, a module of JAX or of the JAX package loaded, or anything missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, core  # noqa: E402
from benchmark import spans as sp  # noqa: E402


class Ctx(types.SimpleNamespace):
    """What a driver is handed: the cell, its configuration (program node
    `cfg` and attribute tree `tree`), dtype, mix, seed, device, and a
    `state` namespace it fills."""

    def make_pool(self):
        from benchmark.traffic.generator import make_pool

        return make_pool(self.mix, self.tree, self.seed)


def make_ctx(cell: dict, seed: int, torch, device) -> Ctx:
    cfg_file = cell["config_file"]
    tree = core.Tree(cfg_file["config"])
    cfg = core.program_config(cfg_file)
    return Ctx(cell=cell, cfg=cfg, tree=tree, dtype=core.dtype_of(cfg_file), mix=cell["mix"],
               seed=seed, torch=torch, device=device, state=types.SimpleNamespace(),
               replan_steps=tree.ROLLOUT.POLICY.MAX_STEPS // tree.ROLLOUT.POLICY.REPLAN_FREQ)


def check_sample(mix: dict, seed: int) -> set:
    """The calls whose answers the check reads, drawn from the seed among
    the mix's first `check_among` calls (a window finishes more)."""
    import numpy as np

    rng = np.random.default_rng([seed, 3])
    return set(int(i) for i in rng.choice(mix["check_among"], size=mix["check_calls"],
                                          replace=False))


def run_window(ctx, drv, seconds: float, trace: bool, recorder=None) -> dict:
    """Calls back to back until `seconds` have passed; the window is the
    first call's start to the last call's end. What the check reads is
    kept of the sampled calls (`check_sample`), and of the last call, which
    stands in where the window finished fewer calls. With `trace`, the
    device is traced over the window's first whole calls up to the mix's
    `trace_seconds` (a trace of every call of a long window would take
    minutes to read), and the benchmark's spans are kept for those calls.
    Given the program's span recorder (`benchmark.spans.tracer()`), a
    traced window turns it on over the same calls and keeps their spans
    (`program_spans`; None without a recorder)."""
    torch = ctx.torch
    trace_s = min(seconds, ctx.mix.get("trace_seconds", seconds)) if trace else 0.0
    spans = {} if trace else None
    sample = check_sample(ctx.mix, ctx.seed)
    kept, latencies, served = {}, [], {}
    prof = None
    traced = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        if recorder is not None:
            recorder.drain()
            recorder.enable()
        prof.__enter__()
    t0 = time.perf_counter()
    i = 0
    while True:
        ts = time.perf_counter()
        out = drv.call(ctx, i, spans)
        te = time.perf_counter()
        if i - 1 not in sample:
            kept.pop(i - 1, None)
        kept[i] = out
        latencies.append(te - ts)
        key = drv.input_key(ctx, i)
        served[key] = served.get(key, 0) + 1
        i += 1
        if prof is not None and te - t0 >= trace_s:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            program_spans = None
            if recorder is not None:
                recorder.disable()
                program_spans = recorder.drain()
            traced = {"prof": prof, "window_s": te - t0, "calls": i, "served": dict(served),
                      "spans": spans, "program_spans": program_spans}
            prof, spans = None, None
        if te - t0 >= seconds:
            break
    chosen = [kept[j] for j in sorted(sample) if j in kept] or [kept[i - 1]]
    return {"window_s": te - t0, "calls": i, "latencies_s": latencies, "served": served,
            "kept": chosen, "traced": traced}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    core.set_cache_dirs()
    cell = core.load_workload(args.workload)
    torch = core.require_cards(cell["chips"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = make_ctx(cell, args.seed, torch, device)
    drv = core.load_driver(cell["driver"])
    drv.setup(ctx)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    w = run_window(ctx, drv, args.seconds, bool(args.trace), sp.tracer())
    memory_peak = torch.cuda.max_memory_allocated(device)
    found = core.loaded_forbidden()
    if found:
        raise core.BenchError(f"modules of JAX or the JAX package are loaded: {found}")

    record = {"setup_s": setup_s, "window_s": w["window_s"], "calls": w["calls"],
              "latencies_s": w["latencies_s"], "units": drv.units(ctx, w["calls"]),
              "spans": {}, "replan_steps": ctx.replan_steps,
              "dtype": cell["config_file"]["dtype"]}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                   "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if args.trace:
        from benchmark import trace as tr

        t_read = time.perf_counter()
        tw = w["traced"]
        prof = tw.pop("prof")
        events = tr.device_events(prof, torch)
        if not events:
            raise core.BenchError("the profiler recorded no device operation in the window")
        # the per-layer readers read the traced part of the window
        record.update(window_s=tw["window_s"], calls=tw["calls"], spans=tw["spans"],
                      units=drv.units(ctx, tw["calls"]), trace=tr.summarize(events))
        del events
        program_spans = tw["program_spans"]
        layers_note = ""
        if program_spans is not None:
            # the program's spans over the device trace: the span readers'
            # layers, and the idle gaps named by what the host was doing
            ops, launches = sp.kineto_ops(prof, torch)
            L = record["layers"] = sp.layers(ops, launches, program_spans)
            record["trace"]["idle_gaps"] = sp.label_gaps(ops, program_spans)
            layers_note = (f"; {len(program_spans)} program spans, launch events found for "
                           f"{100.0 * L['launches_found']:.4f} % of the operations, "
                           f"{100.0 * L['unattributed_busy_s'] / L['busy_s']:.4f} % of the "
                           f"busy time under no span")
            del ops, launches
        del prof
        per_input = {key: tr.account(lambda key=key: drv.call(ctx, key), torch)
                     for key in sorted(tw["served"])}
        record["accounting"] = tr.scaled_accounting(per_input, tw["served"])
        device_info["busy_s"] = record["trace"]["busy_s"]
        device_info["window_s"] = tw["window_s"]
        breakdown = {"device_ops": record["trace"]["device_ops"],
                     "idle_gaps": record["trace"]["idle_gaps"]}
        print(f"# trace: {tw['calls']} calls in {tw['window_s']:.3f} s traced, "
              f"{record['trace']['n_device_ops']} device operations{layers_note}; read and "
              f"accounted in {time.perf_counter() - t_read:.3f} s", file=sys.stderr)

    drv.release_program(ctx)
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = drv.check(ctx, w["kept"], args.seed)
    check_s = time.perf_counter() - t_check
    checks = compare.judge(values, cell["checks"])

    metrics = {}
    for m in core.cell_metrics(args.workload, bool(args.trace)):
        v = core.read_metric(m["name"], record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    found = core.loaded_forbidden()
    if found:
        raise core.BenchError(f"modules of JAX or the JAX package are loaded: {found}")
    lat = w["latencies_s"]
    print(f"# {args.workload} seed {args.seed}: {w['calls']} calls in {w['window_s']:.3f} s "
          f"(call ms p25 {1e3 * core.quantile(lat, 0.25):.3f}, p50 "
          f"{1e3 * core.quantile(lat, 0.5):.3f}, p75 {1e3 * core.quantile(lat, 0.75):.3f}, p95 "
          f"{1e3 * core.quantile(lat, 0.95):.3f}, max {1e3 * max(lat):.3f}), setup "
          f"{setup_s:.3f} s, check {check_s:.3f} s; card {core.power_limit()}", file=sys.stderr)
    core.print_result(all(c["ok"] for c in checks), w["calls"], 0, metrics, device_info, checks,
                      breakdown)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except core.BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        sys.exit(2)
