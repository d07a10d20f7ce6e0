"""The device's idle share of the traced window in the WOSAC requests
(no_text.wosac_m32), in %."""

from benchmark.metrics._shared import idle_pct


def read(record):
    return idle_pct(record)
