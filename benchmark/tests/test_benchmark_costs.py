"""The yardstick's cost functions against counts made by hand."""

import torch

from benchmark.costs import costs


def test_topk_cost_by_hand():
    c = costs.topk_cost(B=2, Q=3, S=5, K=4)
    # positions 2*3*2*4 + 2*5*2*4, masks 2*3 + 2*5, idx and valid 2*3*4*(4+1)
    assert c["bytes"] == 48 + 80 + 6 + 10 + 120
    assert c["ops"] == 5 * 2 * 3 * 5


def test_edge_cost_by_hand():
    c = costs.edge_cost(n_valid=7, B=1, Q=2, K=4, H=2, D=3, Dp=2, S=5, size=4)
    # edges 7*(4+2*4), mask 1*2*4, source 5*3*4, q and out 2*2*(3+2)*4*2, sum 2*2*4
    assert c["bytes"] == 7 * 12 + 8 + 60 + 160 + 16
    assert c["ops"] == 7 * 4 * 2 * (3 + 2)
    assert c["peak"] == costs.F32_FLOPS
    assert costs.edge_cost(7, 1, 2, 4, 2, 3, 2, 5, size=2)["peak"] == costs.BF16_FLOPS


def test_fused_cost_by_hand():
    L, D, I, P, H = 2, 4, 4, 3, 2
    x = torch.zeros(1, 2, D)
    w = [torch.zeros(L, D)] * 5 + [torch.zeros(L, P, 2 * I)]
    valid = torch.tensor([[[True, False], [True, True]]])
    table = (torch.zeros(1, 6, D), torch.zeros(1, 2, 2, dtype=torch.int32),
             torch.zeros(1, 2, 2, 4), valid)
    c = costs.fused_cost(x, [table, table], [w, w], num_heads=H, head_dim=I // H)
    dense = D * I + 2 * I * (D + P) + (I + D) * I + 2 * D * I + 8 * D * D
    per_site = L * 3 * 4 * H * (D + P) + 3 * 8 * P + 2 * L * 1 * 2 * dense
    assert c["ops"] == 2 * per_site
    wbytes = 4 * (5 * L * D + L * P * 2 * I)
    tbytes = 4 * 6 * D + 4 * (4 + 16) + 4
    assert c["bytes"] == 2 * 1 * 2 * D * 4 + 2 * wbytes + 2 * tbytes


def test_bound_is_the_larger_side():
    assert costs.bound_s({"bytes": 3.35e12, "ops": 0}) == 1.0
    assert costs.bound_s({"bytes": 0, "ops": 67e12}) == 1.0
    assert costs.bound_s({"bytes": 0, "ops": 989e12, "peak": costs.BF16_FLOPS}) == 1.0
