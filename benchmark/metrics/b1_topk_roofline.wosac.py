"""Neighbour selection's (B1, csrc/neighbor_topk.cu) share of its roofline
in the WOSAC requests (no_text.wosac_m32), in %."""

from benchmark.metrics._shared import roofline_pct


def read(record):
    return roofline_pct(record, "b1_topk")
