"""The 95th percentile over all the window's requests of the time from a
request to its world-frame futures on the host, in ms (linear
interpolation between order statistics)."""

from benchmark.core import quantile


def read(record):
    lat = record["latencies_s"]
    return 1e3 * quantile(lat, 0.95) if lat else None
