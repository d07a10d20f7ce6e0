"""The program's spans laid over a device trace (benchmark/spans.py) and the
span readers (benchmark/metrics/), on synthetic spans and device events:
attribution to the innermost span open at the launch (an operation whose
launch event is missing by its own start), the layers by span path, the idle
gaps named by span or `client`, each reader's number, and None from every
reader where the program has no span recorder."""

import sys

import pytest

from benchmark import core
from benchmark import spans as sp

MS = 1_000_000  # ns


def S(name, a, b, i, parent=0, request=None, r=None):
    """A span as the recorder closes it (times in ms here, ns in it)."""
    return (name, a * MS, b * MS, i, parent, request or i, r)


def request(i0, t0):
    """One WOSAC-like request starting at t0 ms, span ids from i0:
    rollout_with_sampler [t0, t0+10] > sampler [t0, t0+3] > prepare >
    scene_encoder [t0, t0+1]; replicas [t0+3, t0+5] > scene_encoder
    [t0+3, t0+4]; rollout [t0+5, t0+10] > step r=0 [t0+5, t0+7] > policy
    [t0+5, t0+6], step r=1 [t0+7, t0+10] > step_env [t0+7, t0+8], policy
    [t0+8, t0+9]; then rollout_to_world [t0+10, t0+11] (its own root)."""
    root = i0
    return [
        S("rollout_with_sampler", t0, t0 + 10, root),
        S("sampler", t0, t0 + 3, i0 + 1, root, root),
        S("prepare", t0, t0 + 3, i0 + 2, i0 + 1, root),
        S("scene_encoder", t0, t0 + 1, i0 + 3, i0 + 2, root),
        S("replicas", t0 + 3, t0 + 5, i0 + 4, root, root),
        S("scene_encoder", t0 + 3, t0 + 4, i0 + 5, i0 + 4, root),
        S("rollout", t0 + 5, t0 + 10, i0 + 6, root, root),
        S("step", t0 + 5, t0 + 7, i0 + 7, i0 + 6, root, 0),
        S("policy", t0 + 5, t0 + 6, i0 + 8, i0 + 7, root),
        S("step", t0 + 7, t0 + 10, i0 + 9, i0 + 6, root, 1),
        S("step_env", t0 + 7, t0 + 8, i0 + 10, i0 + 9, root),
        S("policy", t0 + 8, t0 + 9, i0 + 11, i0 + 9, root),
        S("rollout_to_world", t0 + 10, t0 + 11, i0 + 12),
    ]


def op(name, a, b, corr):
    return (name, int(a * MS), int(b * MS), corr)


def test_attribution_takes_the_innermost_span_at_the_launch():
    spans = request(1, 0)
    ops = [op("k_enc", 0.5, 0.9, 10), op("k_pol", 8.6, 8.9, 11), op("k_miss", 8.8, 8.95, 12),
           op("k_out", 12.5, 13, 13), op("k_world", 10.6, 10.8, 14)]
    # launches: each op's runtime event; 12's is missing (its device start stands in)
    launches = {10: int(0.2 * MS), 11: int(8.5 * MS), 13: int(12 * MS), 14: int(10.5 * MS)}
    owner, found = sp.attribute(ops, launches, spans)
    assert owner == [4, 12, 12, 0, 13]
    assert found == pytest.approx(4 / 5)


def test_attribution_at_shared_boundaries():
    """A child that starts with its parent holds a launch at that instant;
    a launch at the instant one sibling ends and the next starts belongs to
    the next."""
    spans = [S("a", 0, 10, 1), S("b", 0, 5, 2, 1, 1), S("c", 5, 10, 3, 1, 1)]
    ops = [op("x", 1, 2, 1), op("y", 6, 7, 2)]
    owner, _ = sp.attribute(ops, {1: 0, 2: 5 * MS}, spans)
    assert owner == [2, 3]


def test_layers_by_span_path():
    spans = request(1, 0) + request(20, 20)
    ops, launches = [], {}
    for k, t0 in enumerate((0, 20)):
        for j, (a, b, t) in enumerate([(0.5, 1.5, 0.2), (1.0, 2.0, 0.3),  # encode, overlapping
                                       (3.5, 3.9, 3.2),  # replicas' encode
                                       (5.5, 6.5, 5.2), (8.2, 8.4, 8.1),  # policy r=0, r=1
                                       (7.2, 7.6, 7.1)]):  # step_env
            c = 100 * k + j
            ops.append(op(f"k{j}", t0 + a, t0 + b, c))
            launches[c] = int((t0 + t) * MS)
    ops.append(op("stray", 15, 16, 999))
    launches[999] = 14 * MS
    ops.sort(key=lambda o: o[1])
    L = sp.layers(ops, launches, spans)
    assert L["requests"] == {"rollout_with_sampler": 2, "rollout_to_world": 2}
    assert L["host"]["rollout_with_sampler/sampler"] == [2, pytest.approx(0.006)]
    assert L["host"]["rollout_with_sampler/rollout/step"] == [4, pytest.approx(0.010)]
    enc = L["device"]["rollout_with_sampler/sampler/prepare/scene_encoder"]
    assert enc == [4, pytest.approx(2 * 0.0015)]  # the union of [0.5, 2.0] twice
    assert L["device"]["rollout_with_sampler"][0] == 12
    assert L["device"]["rollout_with_sampler/rollout/step/step_env"] == [2, pytest.approx(0.0008)]
    assert L["unattributed_busy_s"] == pytest.approx(0.001)
    assert L["busy_s"] == pytest.approx(2 * (0.0015 + 0.0004 + 0.001 + 0.0002 + 0.0004) + 0.001)
    # root spans open 2 x [0, 11] ms; busy inside them 2 x 3.5 ms
    assert L["program_idle_s"] == pytest.approx(2 * (0.011 - 0.0035))
    assert L["launches_found"] == 1.0
    assert sp.by_name(L["host"], "scene_encoder") == [4, pytest.approx(0.004)]
    assert sp.by_name(L["host"], "nothing") is None


def test_gap_labels_name_the_span_that_held_the_host_or_the_client():
    spans = request(1, 0)
    long_name = "k" * 200
    ops = [op("a", 0, 0.1, 1),
           op("b", 7.05, 7.1, 2),  # gap 0.1-7.05 ms: only the request spans over half of it
           op(long_name, 8.1, 8.2, 3),  # gap 7.1-8.1 ms: step_env [7, 8] is the innermost
           op("c", 14, 14.1, 4)]  # gap 8.2-14 ms: the spans end at 11, so the client holds it
    gaps = sp.label_gaps(ops, spans, top=3)
    assert [g[0] for g in gaps] == ["rollout_with_sampler before b", "client before c",
                                    "step_env before " + "k" * 80]
    assert [g[1] for g in gaps] == pytest.approx([0.00695, 0.0058, 0.001])


def _record(L):
    return {"layers": L, "window_s": 1.0, "calls": 2}


def test_readers_read_the_layers():
    spans = request(1, 0) + request(20, 20)
    ops = [op("e", 0.5, 1.5, 1), op("r", 3.5, 3.7, 2), op("p", 5.5, 6.0, 3),
           op("se", 7.2, 7.5, 4), op("p2", 8.2, 8.6, 5), op("w", 10.2, 10.3, 6)]
    launches = {i: int(t * MS) for i, t in zip(range(1, 7), (0.2, 3.2, 5.1, 7.1, 8.1, 10.1))}
    L = sp.layers(ops, launches, spans)
    got = {m: core.read_metric(m, _record(L)) for m in (
        "sampler_host_ms.wosac", "replicas_host_ms.wosac", "step_host_ms.wosac",
        "launches_per_request.wosac", "program_idle_ms.wosac", "prepare_device_ms.default",
        "step_env_device_ms.default", "policy_device_ms.default", "step_host_ms.default")}
    assert got == pytest.approx({
        "sampler_host_ms.wosac": 3.0, "replicas_host_ms.wosac": 2.0,
        "step_host_ms.wosac": 2.5, "launches_per_request.wosac": 2.5,
        # 22 ms of root spans, 2.5 ms busy inside them, over 2 requests
        "program_idle_ms.wosac": (22 - 2.5) / 2,
        "prepare_device_ms.default": 0.5, "step_env_device_ms.default": 0.15,
        "policy_device_ms.default": 0.9 / 4, "step_host_ms.default": 2.5},
        rel=1e-5)  # ms given to the ns


def test_readers_give_none_without_the_recorder(monkeypatch):
    names = ["sampler_host_ms.wosac", "replicas_host_ms.wosac", "step_host_ms.wosac",
             "launches_per_request.wosac", "program_idle_ms.wosac", "prepare_device_ms.default",
             "step_env_device_ms.default", "policy_device_ms.default", "step_host_ms.default"]
    # a record of a program without the recorder has no layers
    plain = {"window_s": 1.0, "calls": 2, "spans": {}}
    assert all(core.read_metric(m, plain) is None for m in names)
    # a window whose spans name none of the cell's layers
    other = sp.layers([op("x", 0, 1, 1)], {1: 0}, [S("prepare", 0, 2, 1)])
    wosac = names[:5]
    assert all(core.read_metric(m, _record(other)) is None for m in wosac)
    # the program without prosim_torch.utils.tracing
    import prosim_torch.utils

    monkeypatch.delattr(prosim_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "prosim_torch.utils.tracing", None)
    assert sp.tracer() is None


def closed_loop_call(i0, t0):
    """One closed-loop call as the benchmark makes it at t0 ms, span ids
    from i0: prepare [t0, t0+4] > scene_encoder [t0, t0+3]; then, after a
    synchronise, rollout [t0+5, t0+11] > step r=0 [t0+5, t0+7] > policy
    [t0+5, t0+6], integrate [t0+6, t0+7]; step r=1 [t0+7, t0+11] > step_env
    [t0+7, t0+8], policy [t0+8, t0+10], integrate [t0+10, t0+11]."""
    return [
        S("prepare", t0, t0 + 4, i0),
        S("scene_encoder", t0, t0 + 3, i0 + 1, i0, i0),
        S("rollout", t0 + 5, t0 + 11, i0 + 2),
        S("step", t0 + 5, t0 + 7, i0 + 3, i0 + 2, i0 + 2, 0),
        S("policy", t0 + 5, t0 + 6, i0 + 4, i0 + 3, i0 + 2),
        S("integrate", t0 + 6, t0 + 7, i0 + 5, i0 + 3, i0 + 2),
        S("step", t0 + 7, t0 + 11, i0 + 6, i0 + 2, i0 + 2, 1),
        S("step_env", t0 + 7, t0 + 8, i0 + 7, i0 + 6, i0 + 2),
        S("policy", t0 + 8, t0 + 10, i0 + 8, i0 + 6, i0 + 2),
        S("integrate", t0 + 10, t0 + 11, i0 + 9, i0 + 6, i0 + 2),
    ]


def test_closed_loop_readers_on_a_record():
    """The closed loop's four span readers on the layers of two synthetic
    calls: device ms under `prepare`, `step_env` and `policy` a span, host
    ms a `step`; the WOSAC readers find no request there."""
    spans = closed_loop_call(1, 0) + closed_loop_call(20, 20)
    ops, launches = [], {}
    # (start, end, launch) ms: two overlapping encoder ops and one more in
    # prepare, a policy op each step, a step_env op, an integrate op
    for k, t0 in enumerate((0, 20)):
        for j, (a, b, t) in enumerate([(0.5, 2.0, 0.1), (1.0, 2.5, 0.2), (3.5, 4.5, 3.2),
                                       (5.2, 5.8, 5.1), (8.2, 9.0, 8.1), (7.2, 7.5, 7.1),
                                       (10.2, 10.4, 10.1)]):
            c = 100 * k + j
            ops.append(op(f"k{j}", t0 + a, t0 + b, c))
            launches[c] = int((t0 + t) * MS)
    ops.sort(key=lambda o: o[1])
    L = sp.layers(ops, launches, spans)
    assert L["requests"] == {"prepare": 2, "rollout": 2}
    assert L["unattributed_busy_s"] == 0
    rec = _record(L)
    want = {"prepare_device_ms.default": 2.0 + 1.0,  # union [0.5, 2.5] and [3.5, 4.5]
            "step_env_device_ms.default": 0.3,
            "policy_device_ms.default": (0.6 + 0.8) / 2,
            "step_host_ms.default": 3.0}
    got = {m: core.read_metric(m, rec) for m in want}
    assert got == pytest.approx(want, rel=1e-5)
    for m in ("sampler_host_ms.wosac", "replicas_host_ms.wosac", "launches_per_request.wosac",
              "program_idle_ms.wosac"):
        assert core.read_metric(m, rec) is None, m


def test_tracer_is_the_programs_recorder():
    from prosim_torch.utils import tracing

    assert sp.tracer() is tracing


def test_layers_of_the_programs_own_spans(make_tiny_ctx):
    """The spans of a tiny closed-loop call on the CPU, with one synthetic
    device operation launched inside each span, come out by path."""
    from prosim_torch.utils import tracing

    ctx = make_tiny_ctx("default.closed_loop_b64")
    drv = core.load_driver(ctx.cell["driver"])
    drv.setup(ctx)
    tracing.drain()
    tracing.enable()
    try:
        drv.call(ctx, 0, {})
    finally:
        tracing.disable()
    spans = tracing.drain()
    ops = [op(s[0], s[1] / MS, s[1] / MS + 1e-6, k) for k, s in enumerate(spans)]
    launches = {k: s[1] + 1 for k, s in enumerate(spans)}
    ops.sort(key=lambda o: o[1])
    L = sp.layers(ops, launches, spans)
    R = ctx.replan_steps
    assert L["requests"] == {"prepare": 1, "rollout": 1}
    assert L["host"]["rollout/step"][0] == R
    assert L["host"]["rollout/step/step_env"][0] == R - 1
    assert L["device"]["rollout/step/policy"][0] == R
    assert L["device"]["prepare"][0] == 5 and L["unattributed_busy_s"] == 0


@pytest.mark.parametrize("has_recorder", [True, False])
def test_the_traced_window_records_the_programs_spans(make_tiny_ctx, monkeypatch, has_recorder):
    """`run_window` with trace on, given the program's recorder, turns it on
    over the traced calls, hands out their spans and leaves it off; given
    none (a caller that handles the recorder itself) it hands out None.
    The profiler is stubbed: the CPU build of torch traces no device."""
    import torch

    from benchmark import run
    from prosim_torch.utils import tracing

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    ctx = make_tiny_ctx("default.closed_loop_b64")
    ctx.mix["trace_seconds"] = 0.0  # the first call alone is traced
    drv = core.load_driver(ctx.cell["driver"])
    drv.setup(ctx)
    tw = run.run_window(ctx, drv, 0.0, True, sp.tracer() if has_recorder else None)["traced"]
    assert tw["calls"] == 1 and not tracing.is_enabled()
    if not has_recorder:
        assert tw["program_spans"] is None
        return
    names = [s.name for s in tw["program_spans"]]
    assert names.count("prepare") == 1 and names.count("rollout") == 1
    assert names.count("step") == ctx.replan_steps
    assert tracing.drain() == []
