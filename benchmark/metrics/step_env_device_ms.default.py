"""Device-busy ms per `step_env` call (the obs update of a replan step
after the first) in the closed loop (default.closed_loop_b64)."""

from benchmark.metrics._layers import device_ms_per_span


def read(record):
    return device_ms_per_span(record, "step_env")
