"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `gpu` and skipped where torch sees no CUDA device (the kernels have
no CPU or interpret mode). This file imports neither JAX nor prosim_tpu, so
it runs on a machine without them:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Tolerances: top-K bit-equal; the edge core 1e-5 in f32 (the kernel sums in
another order than the plain einsum); the fused stack 3e-4, the bar the JAX
package holds its fused kernel to (the kernel folds the k|v projections onto
the queries where the plain version projects every edge, through 2L layers).
"""

import numpy as np
import pytest
import torch

from prosim_torch.ops.attention import GatedNeighborAttention
from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
from prosim_torch.ops.fused_stack import (
    fused_two_site_stack,
    fused_two_site_stack_plain,
    pack_site_weights,
)
from prosim_torch.ops.neighbors import neighbor_topk, neighbor_topk_plain
from prosim_torch.utils.params import init_params

pytestmark = pytest.mark.gpu

TOPK_CASES = {  # name: (Q, S, k, radius, exclude_self, grid step of positions or 0)
    "random": (24, 40, 8, None, False, 0),
    "radius": (24, 40, 12, 25.0, False, 0),
    "exclude_self": (40, 40, 10, 40.0, True, 0),
    "k_exceeds_sources": (24, 40, 64, None, False, 0),
    "duplicated_positions": (24, 40, 16, 30.0, False, 20),
    "wide_row": (128, 2208, 512, 300.0, False, 0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_kernel_matches_plain(cuda, case):
    Q, S, k, r, ex, step = TOPK_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    pos = lambda n: (rng.normal(size=(2, n, 2)) * 30).astype(np.float32)
    dst, src = pos(Q), pos(S)
    if ex:
        dst = src
    if step:
        dst, src = np.round(dst / step) * step, np.round(src / step) * step
        src[:, S // 2:] = src[:, : S - S // 2]
    dm, sm = rng.random((2, Q)) > 0.2, rng.random((2, S)) > 0.2
    if ex:
        dm = sm
    dm[0, :3] = False
    args = [torch.from_numpy(a).to(cuda) for a in (dst, src, dm, sm)]
    before = neighbor_topk.launches
    ki, kv = neighbor_topk(*args, k, radius=r, exclude_self=ex)
    pi, pv = neighbor_topk_plain(*args, k, radius=r, exclude_self=ex)
    torch.cuda.synchronize()
    assert neighbor_topk.launches == before + 1
    assert ki.shape == (2, Q, min(k, S))
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


def test_topk_kernel_rounds_d2_once(cuda):
    """dy*dy on a float32 tie plus a dx*dx far below it: the kernel's fma
    and the plain version's rounded-to-odd float64 sum both round up, so
    source 0 sorts after source 1 instead of tying with it."""
    dy = 1 + 2**-12
    dst = torch.zeros((1, 1, 2), device=cuda)
    src = torch.tensor([[[2**-40, dy], [0.0, dy]]], device=cuda)
    dm = torch.ones((1, 1), dtype=torch.bool, device=cuda)
    sm = torch.ones((1, 2), dtype=torch.bool, device=cuda)
    ki, _ = neighbor_topk(dst, src, dm, sm, 2)
    pi, _ = neighbor_topk_plain(dst, src, dm, sm, 2)
    assert ki.tolist() == pi.tolist() == [[[1, 0]]]


@pytest.mark.parametrize("K,Dp,H", [
    (32, 96, 8), (100, 96, 8), (768, 96, 8), (128, 128, 8), (40, 24, 4), (7, 96, 8), (1, 96, 8),
])
def test_edge_kernel_matches_plain(cuda, K, Dp, H):
    gen = torch.Generator(device=cuda).manual_seed(K)
    B, Q, D = 2, 8, 128 if Dp >= 96 else 32
    x_g = torch.randn((B, Q, K, D), generator=gen, device=cuda)
    z_r = torch.randn((B, Q, K, Dp), generator=gen, device=cuda)
    qx = torch.randn((B, Q, H, D), generator=gen, device=cuda) * 0.1
    qp = torch.randn((B, Q, H, Dp), generator=gen, device=cuda) * 0.1
    valid = torch.rand((B, Q, K), generator=gen, device=cuda) > 0.3
    valid[0, 3] = False  # a destination with no valid edge
    before = edge_attn_core.launches
    got = edge_attn_core(x_g, z_r, qx, qp, valid, 0.25)
    ref = edge_attn_core_plain(x_g, z_r, qx, qp, valid, 0.25)
    torch.cuda.synchronize()
    assert edge_attn_core.launches == before + 1
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b.expand_as(a), atol=1e-5, rtol=1e-5)
    assert float(got[0][0, 3].abs().max()) == 0.0 and float(got[2][0, 3].max()) == 0.0


FUSED_CASES = {  # name: (B, N, D, H, head_dim, L, Sa, Ka, Sm, Km)
    "jax_test_widths": (2, 11, 32, 4, 8, 2, 12, 5, 24, 7),
    "demo_widths": (2, 13, 128, 8, 16, 2, 160, 160, 900, 768),
    "short_rows": (3, 8, 128, 8, 16, 1, 40, 9, 300, 64),
}


def _fused_inputs(cuda, B, N, D, H, hd, L, Sa, Ka, Sm, Km, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    stack = torch.nn.Module()
    for i in range(L):
        for site in ("a2p", "m2p"):
            stack.add_module(f"{site}_{i}", GatedNeighborAttention(D, H, hd, bipartite=True))
    init_params(stack, seed=seed)
    stack.to(cuda)
    with torch.no_grad():  # exercise the norm affines and the biases
        for p in stack.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, device=cuda))
    x = torch.randn((B, N, D), generator=gen, device=cuda)
    tables = []
    for S, K in ((Sa, Ka), (Sm, Km)):
        src = torch.randn((B, S, D), generator=gen, device=cuda)
        idx = torch.randint(0, S, (B, N, K), generator=gen, device=cuda, dtype=torch.int32)
        valid = torch.rand((B, N, K), generator=gen, device=cuda) > 0.3
        valid[0, 1] = False  # a row with no valid edge at both sites
        valid[B - 1, N - 1] = False
        u = lambda lo, hi: lo + (hi - lo) * torch.rand((B, N, K), generator=gen, device=cuda)
        ori_vec = u(-3.14159, 3.14159)
        feats = torch.stack([u(0.0, 200.0), u(-3.14159, 3.14159), ori_vec, ori_vec], -1)
        tables.append((src, idx, feats, valid))
    with torch.no_grad():
        w = pack_site_weights(stack, "a2p"), pack_site_weights(stack, "m2p")
    return x, tables, w


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_stack_kernel_matches_plain(cuda, case):
    B, N, D, H, hd, L, Sa, Ka, Sm, Km = FUSED_CASES[case]
    x, (ta, tm), (wa, wm) = _fused_inputs(cuda, B, N, D, H, hd, L, Sa, Ka, Sm, Km, len(case))
    before = fused_two_site_stack.launches
    got = fused_two_site_stack(x, ta, tm, wa, wm, num_heads=H, head_dim=hd)
    ref = fused_two_site_stack_plain(x, ta, tm, wa, wm, num_heads=H, head_dim=hd)
    again = fused_two_site_stack(x, ta, tm, wa, wm, num_heads=H, head_dim=hd)
    torch.cuda.synchronize()
    assert fused_two_site_stack.launches == before + 2
    assert got.shape == (B, N, D) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, atol=3e-4, rtol=3e-4)
    assert torch.equal(got, again)  # no atomics: bitwise reproducible


def test_wrappers_refuse_cpu_and_cuda_mix(cuda):
    """A kernel wrapper given a CUDA tensor launches or raises: mixed
    devices and non-contiguous inputs raise instead of running anything."""
    pos = torch.zeros((1, 4, 2), device=cuda)
    mask = torch.ones((1, 4), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        neighbor_topk(pos, pos.cpu(), mask, mask.cpu(), 2)
    with pytest.raises(ValueError):
        neighbor_topk(pos, torch.zeros((1, 2, 4), device=cuda).transpose(1, 2), mask, mask, 2)
    x, (ta, tm), (wa, wm) = _fused_inputs(cuda, 1, 4, 32, 4, 8, 1, 6, 3, 8, 5, 0)
    before = fused_two_site_stack.launches
    with pytest.raises(ValueError):  # a table on the CPU
        fused_two_site_stack(x, (ta[0].cpu(),) + ta[1:], tm, wa, wm, num_heads=4, head_dim=8)
    with pytest.raises(ValueError):  # packed weights on the CPU
        fused_two_site_stack(x, ta, tm, [w.cpu() for w in wa], wm, num_heads=4, head_dim=8)
    assert fused_two_site_stack.launches == before
