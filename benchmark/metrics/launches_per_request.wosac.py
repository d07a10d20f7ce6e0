"""Device operations launched inside a `rollout_with_sampler` span, per
WOSAC request (no_text.wosac_m32): the host's issue work a request."""

from benchmark.metrics._layers import ops_per_request


def read(record):
    return ops_per_request(record, "rollout_with_sampler")
