"""The whole rollout's share of the card's peak in the closed loop
(default.closed_loop_b64), in %."""

from benchmark.metrics._shared import mfu_pct


def read(record):
    return mfu_pct(record)
