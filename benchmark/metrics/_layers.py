"""What the span readers compute, each for its own cells, from the traced
window's layers (`record['layers']`, benchmark/spans.py `layers`: the
program's spans laid over the device trace). Each returns None where the
record has no layers (a program without the span recorder) or the window
opened no span of the name."""

from benchmark.spans import by_name


def _layers(record):
    return record.get("layers") or None


def requests(record, root):
    """The window's requests: its root spans named `root`."""
    L = _layers(record)
    return L["requests"].get(root, 0) if L else 0


def host_ms_per_request(record, name, root):
    """Host ms inside spans named `name`, per `root` request."""
    L, n = _layers(record), requests(record, root)
    h = by_name(L["host"], name) if L else None
    return 1e3 * h[1] / n if h and n else None


def host_ms_per_span(record, name):
    """The mean host ms of a span named `name`."""
    L = _layers(record)
    h = by_name(L["host"], name) if L else None
    return 1e3 * h[1] / h[0] if h else None


def device_ms_per_span(record, name):
    """Device-busy ms (the union of the intervals of the operations launched
    inside spans named `name`) per such span."""
    L = _layers(record)
    h = by_name(L["host"], name) if L else None
    d = by_name(L["device"], name) if L else None
    return 1e3 * d[1] / h[0] if h and d else None


def ops_per_request(record, root):
    """Device operations launched inside `root` spans, per request."""
    L, n = _layers(record), requests(record, root)
    d = by_name(L["device"], root) if L else None
    return d[0] / n if d and n else None


def program_idle_ms_per_request(record, root):
    """Device idle ms while a program span was open on the host, per
    `root` request."""
    L, n = _layers(record), requests(record, root)
    return 1e3 * L["program_idle_s"] / n if L and n else None
