"""The mean host ms of a replan `step` span (step_env, the policy, the
integration) in the closed loop (default.closed_loop_b64), whose steps the
host's issue of their launches paces."""

from benchmark.metrics._layers import host_ms_per_span


def read(record):
    return host_ms_per_span(record, "step")
