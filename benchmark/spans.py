"""The program's spans laid over the device trace of a traced window.

The program records spans of its layers on the host clock
(`prosim_torch.utils.tracing`, Unix-epoch ns, the clock torch.profiler's
Kineto trace stamps its events with). A traced window with the recorder on
gives two timelines on one clock: the spans, and the profile's device
operations with the runtime events that launched them (the CUDA-activity
trace records both, joined by a correlation id).

- Attribution: a device operation belongs to the innermost span open on the
  host when the operation was launched (its runtime event's start; where
  the trace lacks that event, which no run on the card has shown, the
  operation's own start stands in).
- Layers (`layers`): by span path (`rollout_with_sampler/sampler/prepare`),
  the spans' count and host seconds, and the operations attributed to the
  path or below it with the union of their device intervals; the device's
  busy seconds, those attributed to no span, and its idle seconds while a
  span was open.
- Gap labels (`label_gaps`): each of the longest idle gaps named by the
  innermost span open on the host for most of it, or `client` where none
  was, then `before <operation>`.

Where the program has no recorder (`tracer()` is None) there is nothing to
lay over the trace, and a run keeps the trace's own readings.
"""

import bisect

NO_SPAN = "(no span)"
CLIENT = "client"


def tracer():
    """The program's span recorder, or None where the program has none."""
    try:
        from prosim_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def kineto_ops(prof, torch):
    """From a torch.profiler profile: the device operations as [(name,
    start_ns, end_ns, correlation id)] by start, and {correlation id:
    start_ns} of the runtime and driver events that launched them."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            ops.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        elif is_launch(e):
            c, t = e.correlation_id(), e.start_ns()
            launches[c] = min(t, launches.get(c, t))
    ops.sort(key=lambda o: o[1])
    return ops, launches


def is_launch(e) -> bool:
    """A host event of the CUDA runtime or driver API, by its name
    (`cudaLaunchKernel`, `cudaMemcpyAsync`, `cuLaunchKernel`; torch 2.11's
    events carry no activity type). Its correlation id is that of the device
    operation it launched, where it launched one."""
    n = e.name()
    return n.startswith("cuda") or (n.startswith("cu") and n[2:3].isupper())


def _depths(spans):
    by_id = {s[3]: s for s in spans}
    depth = {}

    def d(i):
        if i not in depth:
            p = by_id[i][4]
            depth[i] = d(p) + 1 if p in by_id else 0
        return depth[i]

    for s in spans:
        d(s[3])
    return by_id, depth


def _timeline(spans, depth):
    """(change times, the innermost open span's id from each on, 0 for none)."""
    marks = [(s[1], 1, depth[s[3]], s[3]) for s in spans]
    marks += [(s[2], 0, -depth[s[3]], s[3]) for s in spans]
    marks.sort()  # at one time: ends first (the inner first), then starts (the outer first)
    times, inner, stack = [], [], []
    for t, kind, _, i in marks:
        if kind:
            stack.append(i)
        else:
            stack.remove(i)
        times.append(t)
        inner.append(stack[-1] if stack else 0)
    return times, inner


def attribute(ops, launches, spans):
    """(for each op, the id of the innermost span open at its launch, 0 for
    none; the share of ops whose own launch event was found)."""
    _, depth = _depths(spans)
    times, inner = _timeline(spans, depth)
    out, found = [], 0
    for op in ops:
        t = launches.get(op[3])
        found += t is not None
        k = bisect.bisect_right(times, op[1] if t is None else t) - 1
        out.append(inner[k] if k >= 0 else 0)
    return out, (found / len(ops) if ops else 0.0)


def _paths(spans):
    by_id, _ = _depths(spans)
    path = {}

    def p(i):
        if i not in path:
            s = by_id[i]
            path[i] = f"{p(s[4])}/{s[0]}" if s[4] in by_id else s[0]
        return path[i]

    for s in spans:
        p(s[3])
    return path


def union(intervals):
    """The merged intervals of [(start, end)] sorted by start."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _length(merged):
    return sum(e - s for s, e in merged)


def _overlap(a, b):
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def layers(ops, launches, spans) -> dict:
    """The window by span path. {'host': {path: [spans, host s]}, 'device':
    {path: [ops, busy s]} (the ops attributed to the path or below it, busy
    the union of their intervals), 'busy_s', 'unattributed_busy_s' (ops
    under no span), 'program_idle_s' (device idle while a root span was
    open on the host), 'requests': {root name: count}, 'launches_found'
    (the share of ops whose launch event was found)}."""
    path = _paths(spans)
    host, requests = {}, {}
    for s in spans:
        h = host.setdefault(path[s[3]], [0, 0.0])
        h[0] += 1
        h[1] += (s[2] - s[1]) / 1e9
        if s[4] not in path:
            requests[s[0]] = requests.get(s[0], 0) + 1
    owner, found = attribute(ops, launches, spans)
    under = {}  # path -> its own and its ancestors' paths
    ivals, counts = {}, {}
    for op, i in zip(ops, owner):
        p = path[i] if i else NO_SPAN
        if p not in under:
            parts = p.split("/")
            under[p] = ["/".join(parts[:k]) for k in range(1, len(parts) + 1)]
        for q in under[p]:
            ivals.setdefault(q, []).append((op[1], op[2]))
            counts[q] = counts.get(q, 0) + 1
    device = {q: [counts[q], _length(union(v)) / 1e9] for q, v in ivals.items()}
    busy = union((o[1], o[2]) for o in ops)
    roots = union(sorted((s[1], s[2]) for s in spans if s[4] not in path))
    return {"host": host, "device": device, "busy_s": _length(busy) / 1e9,
            "unattributed_busy_s": device.get(NO_SPAN, [0, 0.0])[1],
            "program_idle_s": (_length(roots) - _overlap(roots, busy)) / 1e9,
            "requests": requests, "launches_found": found}


def by_name(table: dict, name: str):
    """[count, seconds] summed over the paths of `table` that end in `name`
    (spans of one name never nest in each other, so their seconds add), or
    None where no path does."""
    rows = [v for p, v in table.items() if p.rsplit("/", 1)[-1] == name]
    return [sum(r[0] for r in rows), sum(r[1] for r in rows)] if rows else None


def label_gaps(ops, spans, top: int = 10):
    """The `top` longest idle gaps between device operations as [label,
    seconds], label '<span> before <operation>': the innermost span open on
    the host for more than half the gap, or 'client' where none was."""
    gaps, end = [], None
    for name, s, e, _ in ops:
        if end is not None and s > end:
            gaps.append((s - end, end, s, name))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    _, depth = _depths(spans)
    out = []
    for g, a, b, name in gaps[:top]:
        held = [s for s in spans if min(b, s[2]) - max(a, s[1]) > g / 2]
        who = max(held, key=lambda s: depth[s[3]])[0] if held else CLIENT
        out.append([f"{who} before {name[:80]}", g / 1e9])
    return out
