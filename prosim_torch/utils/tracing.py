"""Spans of the port's layers on the host clock, recorded in memory.

    from prosim_torch.utils import tracing
    tracing.enable()
    ...                      # calls of the program
    spans = tracing.drain()  # the closed spans, and the record emptied
    tracing.disable()

`span(name)` is a context manager. While the recorder is off (the default)
it is one check of a module global that returns one shared no-op object, so
the program's spans cost nothing measurable. While it is on, each span
closed (an exception included) adds a `Span` to the record; nothing leaves
the process but what `drain()` hands out.

A span's times are `time.time_ns()`: nanoseconds since the Unix epoch on
the clock torch.profiler's Kineto trace stamps its events with (its
`kineto_results.trace_start_ns()` plus an event's relative start), so spans
lay over a profiler trace of the same process. Spans nest in the order they
open on the calling thread; the port opens them on its calling thread only.
The root span of a nest is a request: every span under it carries its id.

What the port opens (the names docs/tracing.md lists): `ProSim.prepare`
(`prepare` > `scene_encoder`, `prompt_encoder`, `decoder`, `select_k`),
`ProSim.rollout` (`rollout` > `step` with `r` > `step_env` (r > 0),
`policy`, `integrate`), `parallel_rollout_with_sampler`
(`rollout_with_sampler` > `sampler`, `replicas`, `rollout`),
`rollout_to_world`, and the farm's scenes (`scene` > `format`, `roll`,
`package`, `metrics`). Training opens none: its remat recomputes would open
them again.
"""

import itertools
import time
from typing import List, NamedTuple, Optional


class Span(NamedTuple):
    """One closed span: its name, its host interval (Unix-epoch ns), its id,
    its parent's id (0 for a root), its request (its root's id) and the
    replan step `r` of a `step` span (None elsewhere)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    request: int
    r: Optional[int] = None


_on = False
_closed: List[Span] = []
_open: List[tuple] = []  # (id, request) of the spans open, innermost last
_ids = itertools.count(1)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "r", "id", "parent", "request", "start_ns")

    def __init__(self, name, r):
        self.name, self.r = name, r

    def __enter__(self):
        self.id = next(_ids)
        self.parent, self.request = _open[-1] if _open else (0, self.id)
        _open.append((self.id, self.request))
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.pop()  # this span: `with` blocks close the innermost first
        _closed.append(Span(self.name, self.start_ns, end, self.id, self.parent, self.request,
                            self.r))
        return False


def span(name: str, r: Optional[int] = None):
    """A span named `name` (`r`: the replan step of a `step` span). Off, the
    shared no-op; it takes its one attribute as a plain keyword, since a
    `**attrs` parameter would build a dict on every call."""
    if not _on:
        return _NO_SPAN
    return _Span(name, r)


def no_span(name: str, r: Optional[int] = None):
    """The no-op span, on or off: what a path that must open no spans (a
    checkpointed training region) calls in `span`'s place."""
    return _NO_SPAN


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans open now still close into the record."""
    global _on
    _on = False


def is_enabled() -> bool:
    return _on


def drain() -> List[Span]:
    """The spans closed since the last drain, in the order they closed (a
    child before its parent); the record is emptied. Open spans stay open."""
    out = list(_closed)
    _closed.clear()
    return out
