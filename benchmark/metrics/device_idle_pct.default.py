"""The device's idle share of the traced window in the closed loop
(default.closed_loop_b64), in %."""

from benchmark.metrics._shared import idle_pct


def read(record):
    return idle_pct(record)
