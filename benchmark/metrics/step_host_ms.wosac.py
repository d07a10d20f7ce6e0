"""The mean host ms of a replan `step` span (step_env, the policy, the
integration) in the WOSAC requests (no_text.wosac_m32)."""

from benchmark.metrics._layers import host_ms_per_span


def read(record):
    return host_ms_per_span(record, "step")
