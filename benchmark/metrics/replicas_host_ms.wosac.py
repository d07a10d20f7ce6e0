"""Host ms per WOSAC request inside the `replicas` span (the second scene
encode, the tiling, the prompt, the per-replica decoder and goal pick),
over the traced window (no_text.wosac_m32)."""

from benchmark.metrics._layers import host_ms_per_request


def read(record):
    return host_ms_per_request(record, "replicas", "rollout_with_sampler")
