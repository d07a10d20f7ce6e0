"""The port's span recorder (prosim_torch/utils/tracing.py) and the spans the
rollout path opens, on the CPU at a tiny size (the no_text configuration
with goal heads, one layer a stack, width 16): off records nothing and
costs one shared no-op; on and off give bitwise-equal outputs; the span
tree has the layers' names, parents and request ids; spans close when the
code inside raises; training opens none; the spans' clock is the one
torch.profiler stamps its events with; scripts/trace_layers.py groups
device time by layer and kernel family. One test, marked `gpu`, checks on a
card that a span holds exactly the launches made inside it. This file
imports neither JAX nor prosim_tpu:
    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import os
import time

import pytest
import torch

from prosim_torch.config import get_config
from prosim_torch.data.synthetic import make_synthetic_batch
from prosim_torch.models.prosim import ProSim
from prosim_torch.rollout import rollout as R
from prosim_torch.utils import tracing
from prosim_torch.utils.params import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_TEXT = os.path.join(REPO, "configs/no_text.yaml")
TINY = [
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1",
    "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "2",
    "MODEL.DECODER.ATTN.FF_DIM", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "2",
    "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.DECODER.GOAL_PRED.ENABLE", "True",
    "MODEL.DECODER.GOAL_PRED.K", "4",
]
REPLAN = 3  # replan steps of the synthetic batch
M = 2  # replicas of the sampler rollout
PREPARE = ["prepare", "scene_encoder", "prompt_encoder", "decoder", "select_k"]


@pytest.fixture(scope="module")
def model_batch():
    cfg = get_config(NO_TEXT, TINY)
    model = ProSim(cfg, device="cpu")
    init_params(model, 0)
    batch = make_synthetic_batch(cfg, batch_size=2, num_lanes=16, num_obs_agents=10,
                                 num_agents=6, num_replan=REPLAN, seed=1, device="cpu")
    return model, batch


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _forward(model, batch):
    torch.manual_seed(2)  # the mode pick draws from the default generator
    return model(batch, mode="val")


def _sampler(model, batch):
    torch.manual_seed(2)
    B, N = batch.prompt.mask.shape
    picks = torch.randint(0, 3, (B, M, N), generator=torch.Generator().manual_seed(5))
    out = R.parallel_rollout_with_sampler(model, batch, M, model, top_k=3, picks=picks)
    center = torch.zeros(B * M, 2), torch.zeros(B * M)
    out["world"] = R.rollout_to_world(out, None, *center)
    return out


def _traced(fn, *args):
    tracing.enable()
    try:
        out = fn(*args)
    finally:
        tracing.disable()
    return out, tracing.drain()


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.start_ns)


def _check_nest(spans):
    """Every span lies inside its parent and shares its parent's request;
    a root is its own request."""
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent == 0:
            assert s.request == s.id
        else:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.request == p.request


def _check_rollout(spans, root):
    steps = _children(spans, root)
    assert [s.name for s in steps] == ["step"] * REPLAN
    assert [s.r for s in steps] == list(range(REPLAN))
    for s in steps:
        names = [c.name for c in _children(spans, s)]
        assert names == (["step_env"] if s.r > 0 else []) + ["policy", "integrate"], s.r


def _check_prepare(spans, root):
    assert root.name == "prepare"
    assert [c.name for c in _children(spans, root)] == PREPARE[1:]


def test_off_records_nothing_and_costs_one_shared_noop(model_batch):
    model, batch = model_batch
    assert not tracing.is_enabled()
    assert tracing.span("a") is tracing.span("b", 3) is tracing.no_span("c")
    _forward(model, batch)
    _sampler(model, batch)
    assert tracing.drain() == []


@pytest.mark.parametrize("fn", [_forward, _sampler], ids=["forward", "sampler"])
def test_on_and_off_give_bitwise_equal_outputs(model_batch, fn):
    model, batch = model_batch
    off = fn(model, batch)
    on, spans = _traced(fn, model, batch)
    assert spans
    assert set(off) == set(on)
    for k, v in off.items():
        if torch.is_tensor(v):
            assert torch.equal(v, on[k]), k


def test_forward_span_tree(model_batch):
    model, batch = model_batch
    _, spans = _traced(_forward, model, batch)
    _check_nest(spans)
    roots = sorted((s for s in spans if s.parent == 0), key=lambda s: s.start_ns)
    assert [s.name for s in roots] == ["prepare", "rollout"]
    assert len({s.request for s in spans}) == 2
    _check_prepare(spans, roots[0])
    _check_rollout(spans, roots[1])
    assert len(spans) == len(PREPARE) + 1 + REPLAN * 3 + REPLAN - 1


def test_sampler_span_tree(model_batch):
    model, batch = model_batch
    _, spans = _traced(_sampler, model, batch)
    _check_nest(spans)
    roots = sorted((s for s in spans if s.parent == 0), key=lambda s: s.start_ns)
    assert [s.name for s in roots] == ["rollout_with_sampler", "rollout_to_world"]
    top = roots[0]
    sampler, replicas, rollout = _children(spans, top)
    assert (sampler.name, replicas.name, rollout.name) == ("sampler", "replicas", "rollout")
    (prepare,) = _children(spans, sampler)
    _check_prepare(spans, prepare)
    # the replicas encode the scene a second time
    assert [c.name for c in _children(spans, replicas)] == ["scene_encoder"]
    _check_rollout(spans, rollout)
    assert all(s.request == top.id for s in spans if s is not roots[1])


def test_spans_close_when_the_step_raises(model_batch, monkeypatch):
    model, batch = model_batch
    calls = []
    policy = model.policy.forward

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("policy failed")
        return policy(*a, **kw)

    monkeypatch.setattr(model.policy, "forward", failing)
    tracing.enable()
    with pytest.raises(RuntimeError, match="policy failed"):
        _forward(model, batch)
    spans = tracing.drain()
    _check_nest(spans)
    rollout = next(s for s in spans if s.name == "rollout")
    steps = _children(spans, rollout)
    assert [s.r for s in steps] == [0, 1]
    assert [c.name for c in _children(spans, steps[1])] == ["step_env", "policy"]
    # nothing was left open: the next span is a root
    with tracing.span("after"):
        pass
    (after,) = tracing.drain()
    assert after.parent == 0 and after.request == after.id


def test_training_opens_no_spans(model_batch):
    model, batch = model_batch
    tracing.enable()
    model.train()
    try:
        out = model.forward_train(batch, seed=3)
        out["motion_pred"].float().sum().backward()  # the remat recomputes run here
    finally:
        model.eval()
        model.zero_grad(set_to_none=True)
    assert tracing.drain() == []


def test_nesting_request_ids_and_drain():
    tracing.enable()
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c", 7):
                pass
        tracing.disable()  # spans open now still close into the record
        with tracing.span("off"):
            pass
    tracing.enable()
    with tracing.span("d"):
        pass
    spans = tracing.drain()
    assert [s.name for s in spans] == ["c", "b", "a", "d"]
    c, b, a, d = spans
    assert (a.parent, b.parent, c.parent) == (0, a.id, b.id)
    assert a.request == b.request == c.request == a.id and d.request == d.id != a.id
    assert c.r == 7 and a.r is None
    assert tracing.drain() == []


def test_span_clock_is_the_profiler_clock():
    """A CPU operation inside a span starts inside it on the profiler's
    clock (Kineto: trace_start_ns plus the event's relative start, here
    KinetoEvent.start_ns)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        with tracing.span("mm"):
            for _ in range(3):
                torch.mm(x, x)
        time.sleep(0.002)
    (sp,) = tracing.drain()
    kr = prof.profiler.kineto_results
    mms = [e for e in kr.events() if e.name() == "aten::mm"]
    assert len(mms) == 3
    start = kr.trace_start_ns()
    assert abs(start - sp.start_ns) < 60e9  # the same epoch
    for e in mms:
        assert sp.start_ns <= e.start_ns() <= e.end_ns() <= sp.end_ns


@pytest.mark.gpu
def test_span_holds_exactly_its_launches_on_the_card():
    """In a CUDA-activity profile (device and runtime events only, as the
    benchmark traces), the runtime launch events whose correlation ids are
    those of the kernels launched inside a span start inside it, and no
    other launch does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the launches and their runtime events exist only there")
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            x.mul_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.005)
        with tracing.span("inside"):
            for _ in range(5):
                x.add_(1.0)
            torch.cuda.synchronize()
        time.sleep(0.005)
        for _ in range(4):
            x.mul_(1.0)
        torch.cuda.synchronize()
    (sp,) = tracing.drain()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type() == cuda and "emcpy" not in e.name()
               and "emset" not in e.name()]
    # the runtime's and the driver's launch calls (cudaLaunchKernel, cuLaunchKernel)
    launches = {e.correlation_id(): e for e in events
                if e.device_type() != cuda and e.name().startswith("cu") and "aunch" in e.name()}
    assert len(kernels) == 12
    assert all(k.correlation_id() in launches for k in kernels)
    inside = [k for k in kernels if sp.start_ns <= launches[k.correlation_id()].start_ns()
              <= sp.end_ns]
    assert len(inside) == 5
    assert all("add" in k.name().lower() or "Add" in k.name() for k in inside), [
        k.name() for k in inside]


def test_trace_layers_groups_device_time_by_layer_and_family():
    """scripts/trace_layers.py's layer_families: each operation's device ms
    a call goes to the layer whose span was open at its launch (or an
    ancestor's), by kernel family, with its top operations."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import trace_layers
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    # (name, start ns, end ns, id, parent id)
    spans = [("rollout", 0, 100, 1, 0), ("step", 10, 50, 2, 1), ("policy", 12, 40, 3, 2),
             ("prepare", 100, 200, 4, 0), ("scene_encoder", 110, 150, 5, 4)]
    # (name, device start, device end, correlation id), launched at `launches`
    ops = [("rel_pe_table_kernel<float>", 20, 30, 11), ("reduce_kernel<512>", 31, 35, 12),
           ("reduce_kernel<512>", 36, 38, 13), ("sm80_xmma_gemm", 120, 130, 14),
           ("copy_kernel", 210, 220, 15)]
    launches = {11: 15, 12: 16, 13: 17, 14: 115, 15: 205}
    got = trace_layers.layer_families(ops, launches, spans, calls=2)
    assert got["policy"]["families_ms"] == pytest.approx({"rel_pe_table (ours)": 5e-6,
                                                          "reduce": 3e-6})
    assert got["policy"]["top_ops"][0] == ["rel_pe_table_kernel<float>", pytest.approx(5e-6),
                                           pytest.approx(0.5)]
    assert got["policy"]["top_ops"][1] == ["reduce_kernel<512>", pytest.approx(3e-6),
                                           pytest.approx(1.0)]
    assert got["prepare/scene_encoder"]["families_ms"] == pytest.approx({"matmul": 5e-6})
    assert got["prepare/decoder"] == {"families_ms": {}, "top_ops": []}
