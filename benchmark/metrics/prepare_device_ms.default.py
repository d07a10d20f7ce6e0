"""Device-busy ms per `prepare` call (the union of the intervals of the
operations launched inside it) in the closed loop (default.closed_loop_b64)."""

from benchmark.metrics._layers import device_ms_per_span


def read(record):
    return device_ms_per_span(record, "prepare")
