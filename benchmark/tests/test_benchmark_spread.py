"""benchmark/spread.py: the check's spread (max - min, leaving out the run
farthest from the median where that narrows it) and the bounds' spread on
fixed numbers, the card's samples inside a run's window, the host loop,
and a series of runs of a stand-in cell in turns under two roots."""

import json

import pytest

from benchmark import spread


@pytest.mark.parametrize("values,want", [
    ([100.0, 101.0, 102.0, 103.0, 110.0], 3.0),  # 110 is left out
    ([182.97, 180.0, 183.5, 184.2, 181.0, 196.9], 4.2),  # 196.9 is the farthest
    ([100.0, 105.0, 110.0], 5.0),  # a tie: either end goes, the rest spans 5
    ([100.0, 104.0], 4.0),  # two runs: nothing is left out
    ([7.0], 0.0),
])
def test_check_spread(values, want):
    assert spread.check_spread(values) == pytest.approx(want)


def test_iqr_spread_and_summary():
    assert spread.iqr_spread([1, 2, 3, 4, 5, 6]) == pytest.approx(5.25 - 1.75)
    s = spread.summarize([200.0, 202.0, 204.0, 198.0, 201.0, 230.0])
    assert s["median"] == pytest.approx(201.5)
    assert s["check_spread"] == pytest.approx(6.0)  # 230 left out: 198 to 204
    assert s["check_spread_pct"] == pytest.approx(100 * 6.0 / 201.5)
    assert s["n"] == 6 and s["min"] == 198.0 and s["max"] == 230.0


def test_window_card_reads_the_samples_inside_the_window():
    smi = [(0.5, {"clocks.sm": 990.0, "power.draw": 90.0}),  # set-up: outside the window
           (1.5, {"clocks.sm": 1980.0, "power.draw": 300.0}),
           (2.5, {"clocks.sm": 1755.0, "power.draw": None}),
           (9.0, {"clocks.sm": 100.0})]
    c = spread.window_card(smi, 1.0, 3.0)
    assert c["clocks.sm"] == [1755.0, pytest.approx(1867.5), 1980.0]
    assert c["power.draw"] == [300.0, 300.0, 300.0]
    assert "clocks.mem" not in c
    assert spread.window_card(smi, 3.0, 4.0) == {}


def test_host_loop_takes_time():
    assert 0.0 < spread.host_loop_s(10_000, repeats=2) < spread.host_loop_s(1_000_000, 1)


STAND_IN = '''
import argparse, json, sys
ap = argparse.ArgumentParser()
for a in ("--workload", "--seed", "--seconds", "--trace"):
    ap.add_argument(a)
a = ap.parse_args()
rate = {"parent": 100.0, "change": 110.0}[open("side").read().strip()] + int(a.seed)
print(f"# {a.workload} seed {a.seed}: 3 calls in 0.1 s (call ms p25 1.000, p50 2.000, "
      "p75 3.000, p95 4.000, max 5.000), setup 0.010 s", file=sys.stderr)
print(json.dumps({"correct": True, "attempted": 3, "failed": 0,
                  "metrics": {"setup_s": {"value": 0.01, "unit": "s"},
                              "rate": {"value": rate, "unit": "1/s"}},
                  "device": {}, "checks": {"gap": {"value": 0.1, "limit": 1.0}}}))
'''


def test_a_series_in_turns_under_two_roots(tmp_path):
    roots = []
    for side in ("parent", "change"):
        root = tmp_path / side
        (root / "benchmark").mkdir(parents=True)
        (root / "benchmark" / "run.py").write_text(STAND_IN)
        (root / "side").write_text(side)
        roots.append(str(root))
    out = tmp_path / "out" / "spread.jsonl"
    rc = spread.main(["--workload", "w", "--seeds", "1,2,3", "--seconds", "0.1",
                      "--roots", ",".join(roots), "--out", str(out)])
    assert rc == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    runs = [x for x in lines if "seed" in x]
    # parent, change | change, parent | parent, change
    assert [(r["root"].rsplit("/", 1)[-1], r["seed"]) for r in runs] == [
        ("parent", 1), ("change", 1), ("change", 2), ("parent", 2), ("parent", 3),
        ("change", 3)]
    assert all(r["correct"] and r["call_ms"]["p75"] == 3.0 and r["host_loop_s"] > 0
               for r in runs)
    summaries = {x["summary"].rsplit("/", 1)[-1]: x for x in lines if "summary" in x}
    assert summaries["parent"]["metrics"]["rate"]["median"] == 102.0
    assert summaries["change"]["metrics"]["rate"]["check_spread"] == pytest.approx(1.0)
