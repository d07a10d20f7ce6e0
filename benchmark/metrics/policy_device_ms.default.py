"""Device-busy ms per `policy` call (the policy's layer loop and head of a
replan step) in the closed loop (default.closed_loop_b64)."""

from benchmark.metrics._layers import device_ms_per_span


def read(record):
    return device_ms_per_span(record, "policy")
