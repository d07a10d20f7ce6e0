"""Host ms per WOSAC request inside the `sampler` span (the sampler's
`prepare` and the goal sampling), over the traced window (no_text.wosac_m32)."""

from benchmark.metrics._layers import host_ms_per_request


def read(record):
    return host_ms_per_request(record, "sampler", "rollout_with_sampler")
