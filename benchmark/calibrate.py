"""Read the numbers that decide `correct` over many seeds in one process,
for the program and for the cell's control, to set the cell's limits.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3] [--out readings.jsonl]

Each program seed is a run of the cell as `run.py` makes it, with a short
window: set-up, the window, the program freed, the check. Each control seed
builds the same inputs and puts the reference, in the precision below the
configuration's (the driver's `make_control`: bf16 with fp8 products under
a bf16 configuration, TF32 products under an f32 one), in the program's
place for as many requests as a run checks; the same check then judges it.
One JSON line per seed: the numbers, and the limits they would meet.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, core, run  # noqa: E402


def seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    core.set_cache_dirs()
    cell = core.load_workload(args.workload)
    torch = core.require_cards(cell["chips"])
    device = torch.device("cuda", 0)
    drv = core.load_driver(cell["driver"])
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for kind, seed in ([("program", s) for s in seeds(args.seeds)]
                       + [("control", s) for s in seeds(args.control_seeds)]):
        t0 = time.perf_counter()
        ctx = run.make_ctx(cell, seed, torch, device)
        drv.setup(ctx)
        setup_s = time.perf_counter() - t0
        if kind == "program":
            w = run.run_window(ctx, drv, args.seconds, False)
            kept, calls = w["kept"], w["calls"]
            drv.release_program(ctx)
        else:
            drv.release_program(ctx)
            torch.cuda.empty_cache()
            drv.make_control(ctx)
            n = cell["mix"]["check_calls"]
            kept = [drv.control_call(ctx, i) for i in range(n)]
            calls = n
            ctx.state.control = None
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        values = drv.check(ctx, kept, seed)
        check_s = time.perf_counter() - t1
        emit({"workload": args.workload, "kind": kind, "seed": seed, "calls": calls,
              "setup_s": setup_s, "check_s": check_s, "values": values,
              "ok": {c["name"]: c["ok"] for c in compare.judge(values, cell["checks"])}})
        del ctx, kept
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
