"""Run one cell several times, each run a fresh process, and report how far
its runs spread, with the card's clocks and power beside each run.

    python3 benchmark/spread.py --workload default.closed_loop_b64 \
        --seeds 1,2,3,4,5,6 --seconds 50 [--roots local/parent,.] [--out spread.jsonl]

Each seed runs once under each root (a checkout holding `benchmark/run.py`),
the roots in turns, the order reversed every other seed (parent, change,
change, parent, ...). A repeated seed (`--seeds 1,1,1`) runs again. Before
each run a fixed pure-Python loop is timed in this process (`host_loop_s`:
the host CPU's own speed at that moment, to tell a machine that drifts from
a process that does). While a run goes on, the card's clocks and power are
sampled every half second (`nvidia-smi`); the samples inside the run's
window (from its set-up's end for its window's seconds) are kept, with the
CPUs the run may use (its affinity).

One JSON line a run (its result line's metrics and `correct`, the call-ms
quantiles its standard error gives, what was sampled), then a summary by
root: the cell's metrics, their median, and two spreads as a share of the
median: the check's (max - min over the runs, leaving out the run farthest
from the median where that narrows it) and the bounds' (the distance
between the first and third quartile of `statistics.quantiles(n=4)`).
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

SMI_FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "power.limit")
CALL_MS = re.compile(r"call ms ((?:p\d+ [\d.]+, )*p\d+ [\d.]+, max [\d.]+)")
SETUP = re.compile(r"\), setup ([\d.]+) s")
LOOP_N = 2_000_000


# ------------------------------------------------------------------ spreads


def check_spread(values) -> float:
    """max - min over the values, leaving out the one farthest from the
    median where that narrows it (with three values or more)."""
    xs = sorted(values)
    full = xs[-1] - xs[0]
    if len(xs) < 3:
        return full
    med = statistics.median(xs)
    far = max(range(len(xs)), key=lambda k: abs(xs[k] - med))
    rest = xs[:far] + xs[far + 1:]
    return min(full, rest[-1] - rest[0])


def iqr_spread(values) -> float:
    """The distance between the first and third quartiles
    (`statistics.quantiles(n=4)`); 0 for fewer than two values."""
    if len(values) < 2:
        return 0.0
    q = statistics.quantiles(values, n=4)
    return q[2] - q[0]


def summarize(values) -> dict:
    """The median and both spreads, absolute and as a share of the median."""
    med = statistics.median(values)
    cs, iq = check_spread(values), iqr_spread(values)
    return {"n": len(values), "median": med, "min": min(values), "max": max(values),
            "check_spread": cs, "check_spread_pct": 100.0 * cs / med if med else None,
            "iqr_spread": iq, "iqr_spread_pct": 100.0 * iq / med if med else None}


# ------------------------------------------------------------ the host and the card


def host_loop_s(n: int = LOOP_N, repeats: int = 3) -> float:
    """The fewest seconds this process takes, of `repeats` tries, for a
    fixed loop of `n` additions."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        x = 0
        for k in range(n):
            x += k
        best = min(best, time.perf_counter() - t0)
    return best


class CardSampler:
    """`nvidia-smi` every half second until `stop()`; no samples where it
    cannot be run."""

    def __init__(self, t0: float):
        self.t0, self.samples, self._thread = t0, [], None
        try:
            self._smi = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._smi = None
            return
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        for line in self._smi.stdout:
            vals = []
            for x in line.split(","):
                try:
                    vals.append(float(x))
                except ValueError:
                    vals.append(None)
            self.samples.append((time.monotonic() - self.t0, dict(zip(SMI_FIELDS, vals))))

    def stop(self):
        if self._smi is None:
            return
        self._smi.terminate()
        try:
            self._smi.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._smi.kill()
            self._smi.wait()
        self._thread.join(timeout=10)


def window_card(samples, a: float, b: float) -> dict:
    """[min, median, max] of each field over the samples inside [a, b]
    (seconds from the spawn)."""
    card = [v for t, v in samples if a <= t <= b]
    out = {}
    for k in SMI_FIELDS:
        xs = [v[k] for v in card if v.get(k) is not None]
        if xs:
            out[k] = [min(xs), statistics.median(xs), max(xs)]
    return out


# ---------------------------------------------------------------- runs


def run_one(root: Path, args, seed: int, log_dir: Path, tag: str) -> dict:
    cmd = [sys.executable, "benchmark/run.py", "--workload", args.workload, "--seed", str(seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace)]
    out_path, err_path = log_dir / f"{tag}.out", log_dir / f"{tag}.err"
    rec = {"root": str(root), "seed": seed, "host_loop_s": host_loop_s()}
    with open(out_path, "w") as fo, open(err_path, "w") as fe:
        t0 = time.monotonic()
        p = subprocess.Popen(cmd, cwd=root, stdout=fo, stderr=fe)
        card = CardSampler(t0)
        try:
            rec["cpus"] = sorted(os.sched_getaffinity(p.pid))
        except OSError:
            pass
        try:
            rc = p.wait(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        finally:
            card.stop()
        rec.update(rc=rc, wall_s=time.monotonic() - t0)
    lines = out_path.read_text().strip().splitlines()
    err = err_path.read_text()
    try:
        res = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        res = {}
    rec["correct"] = res.get("correct")
    rec["metrics"] = {k: v["value"] for k, v in res.get("metrics", {}).items()}
    rec["checks"] = {k: v["value"] for k, v in res.get("checks", {}).items()}
    m = CALL_MS.search(err)
    if m:
        rec["call_ms"] = {k: float(v) for k, v in
                          (kv.split(" ") for kv in m.group(1).split(", "))}
    setup = SETUP.search(err)  # the run's own line; a traced run's metrics lack setup_s
    setup = float(setup.group(1)) if setup else rec["metrics"].get("setup_s")
    if setup is not None:
        rec["card"] = window_card(card.samples, setup, setup + args.seconds)
    if rc != 0:
        rec["stderr_tail"] = err[-2000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated; a repeated seed runs again")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--roots", default=".", help="comma-separated checkouts, run in turns")
    ap.add_argument("--timeout", type=float, default=1200.0, help="seconds a run may take")
    ap.add_argument("--label", default="", help="a name for this series in the output")
    ap.add_argument("--out", default="", help="append the JSON lines to this file")
    args = ap.parse_args(argv)

    seeds = [int(x) for x in args.seeds.split(",") if x]
    roots = [Path(r).resolve() for r in args.roots.split(",") if r]
    log_dir = Path(args.out).parent / "spread_logs" if args.out else Path("spread_logs")
    log_dir.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    runs = []
    for k, seed in enumerate(seeds):
        for root in (roots if k % 2 == 0 else roots[::-1]):
            rec = run_one(root, args, seed, log_dir,
                          f"{stamp}_{args.workload}_{len(runs)}_s{seed}")
            rec.update(label=args.label, workload=args.workload)
            runs.append(rec)
            emit(rec)
    for root in roots:
        mine = [r for r in runs if r["root"] == str(root) and r["rc"] == 0]
        names = sorted({n for r in mine for n in r["metrics"]})
        summary = {"summary": str(root), "label": args.label, "workload": args.workload,
                   "runs": len(mine), "failed_runs": sum(r["root"] == str(root) and r["rc"] != 0
                                                          for r in runs),
                   "all_correct": all(r["correct"] for r in mine),
                   "metrics": {n: summarize([r["metrics"][n] for r in mine
                                             if n in r["metrics"]]) for n in names}}
        p50 = [r["call_ms"]["p50"] for r in mine if "p50" in r.get("call_ms", {})]
        if p50:
            summary["call_ms_p50"] = summarize(p50)
        emit(summary)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
