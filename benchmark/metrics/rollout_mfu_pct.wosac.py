"""The whole rollout's share of the card's peak in the WOSAC requests
(no_text.wosac_m32), in %."""

from benchmark.metrics._shared import mfu_pct


def read(record):
    return mfu_pct(record)
