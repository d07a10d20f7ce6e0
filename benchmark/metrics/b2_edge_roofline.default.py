"""The edge-attention core's (B2, csrc/edge_attn.cu) share of its roofline
in the closed loop (default.closed_loop_b64), in %."""

from benchmark.metrics._shared import roofline_pct


def read(record):
    return roofline_pct(record, "b2_edge")
