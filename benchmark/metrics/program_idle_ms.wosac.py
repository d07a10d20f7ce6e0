"""Device idle ms per WOSAC request while a program span was open on the
host (no_text.wosac_m32): the idle time the program, not the client, owns."""

from benchmark.metrics._layers import program_idle_ms_per_request


def read(record):
    return program_idle_ms_per_request(record, "rollout_with_sampler")
