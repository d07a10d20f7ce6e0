"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `gpu` and skipped where torch sees no CUDA device (the kernels have
no CPU or interpret mode). This file imports neither JAX nor prosim_tpu, so
it runs on a machine without them:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
Tolerances: top-K bit-equal; the edge core 1e-5 in f32 (the kernel sums in
another order than the plain einsum and its gather), rows with no valid
edge exactly zero; the fused stack 3e-4, the bar the JAX
package holds its fused kernel to (the kernel folds the k|v projections onto
the queries where the plain version projects every edge, through 2L layers);
flash attention in bf16 by the flash-attention rule: its max error against
the plain version in f32 on the same bf16 inputs is at most twice the plain
version's own error in bf16, plus 1e-5, on valid rows; in f32 within 1e-5
of the f32 plain version on valid rows (the order of the sums is the only
difference); pad rows exactly zero in both. The flash backward (dq, dk,
dv) by the same rules against the plain backward: bf16 within twice the
bf16 plain backward's own error, plus 1e-5, of the f32 plain backward on
the same inputs; f32 within 1e-5 of each tensor's largest magnitude; pad
rows' dq and masked keys' dk/dv exactly zero; two launches bitwise equal.
Flash attention at head widths that are not multiples of 16 (D = 40, 8)
goes through the same gates: the wrapper zero-pads D. The backward works
on each scene's valid rows only (compacted in order), so it is also held
at masks that stress that: an empty scene, one token a scene, rows only in
the prompt block, counts off the tiles, the train step's layout, no pad. The bf16
paths of the edge core and the fused stack (tensor-core products) by the
same 2x rule:
the kernel's max error against the f32 plain version at most twice the
bf16 plain version's, plus 1e-5 (BF16_ATOL); rows with no valid edge
exactly zero, two launches bitwise equal; a wrong or mixed dtype raises.
"""

from pathlib import Path


import numpy as np
import pytest
import torch

from prosim_torch.ops.attention import GatedNeighborAttention
from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
from prosim_torch.ops.flash_attn import (
    _flash_fwd,
    causal_attention,
    causal_attention_bwd,
    causal_attention_bwd_plain,
    causal_attention_fwd_plain,
    causal_attention_plain,
)
from prosim_torch.ops.fused_stack import (
    fused_two_site_stack,
    fused_two_site_stack_plain,
    pack_site_weights,
)
from prosim_torch.ops.mlp import Dense
from prosim_torch.ops.neighbors import neighbor_topk, neighbor_topk_plain
from prosim_torch.utils.params import init_params

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parent.parent
BF16_ATOL = 1e-5  # the 2x rule's absolute term, as flash attention's

TOPK_CASES = {  # name: (Q, S, k, radius, exclude_self, grid step of positions or 0)
    "random": (24, 40, 8, None, False, 0),
    "radius": (24, 40, 12, 25.0, False, 0),
    "exclude_self": (40, 40, 10, 40.0, True, 0),
    "k_exceeds_sources": (24, 40, 64, None, False, 0),
    "duplicated_positions": (24, 40, 16, 30.0, False, 20),
    "wide_row": (128, 2208, 512, 300.0, False, 0),
    # the six graph sites of the demo configuration (chip_smoke.py site_inputs)
    "site_a2a": (160, 160, 100, None, False, 0),
    "site_s2s": (2208, 2208, 32, None, False, 0),
    "site_p2p": (128, 128, 512, 300.0, True, 0),
    "site_s2p": (128, 2208, 512, 300.0, False, 0),
    "site_a2p": (128, 160, 768, 100.0, False, 0),
    "site_m2p": (128, 2048, 768, 50.0, False, 0),
    # the boundaries of the kernel's regimes (warp lists of 32/64/128/256
    # keys; radix select above 128), S not a power of two, ties
    "k1": (40, 300, 1, None, False, 0),
    "k32": (40, 1000, 32, 60.0, False, 0),
    "k33": (40, 1000, 33, None, False, 20),
    "k128": (40, 777, 128, 80.0, False, 0),
    "k129": (40, 777, 129, None, False, 20),
    "k_eq_s_warp": (40, 200, 200, 60.0, False, 20),
    "k_eq_s_radix": (40, 300, 300, None, False, 0),
    "k_near_s_radix": (30, 1500, 1499, 40.0, False, 20),
    "empty_scene_warp": (40, 500, 16, None, False, 0),
    "empty_scene_radix": (40, 500, 200, None, False, 0),
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
    spread = 30 if S <= 40 else 60
    pos = lambda n: (rng.normal(size=(2, n, 2)) * spread).astype(np.float32)
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
    sm[1, : S // 3] = False  # scene 1: some rows find no valid source within the radius
    if case.startswith("empty_scene"):
        sm[1] = False  # no valid source at all
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


EDGE_CASES = [  # (K, D, Dp, H): one team per row for K <= 128, a block per row above
    (1, 128, 96, 8), (7, 128, 96, 8), (31, 128, 96, 8), (32, 128, 96, 8), (33, 128, 96, 8),
    (100, 128, 96, 2), (128, 128, 128, 8), (129, 128, 96, 8), (160, 128, 96, 1),
    (512, 128, 96, 8), (768, 128, 96, 8), (1100, 128, 96, 8), (40, 32, 24, 4), (64, 128, 96, 3),
    (200, 64, 96, 5), (50, 30, 18, 8), (300, 30, 18, 2),
]


def _edge_inputs(cuda, B, Q, K, D, Dp, H, S, seed, prefix=False):
    """(x_src_n, idx, z_r, qx, qp, valid): row (0, 3) has no valid edge and
    the idx of every invalid edge is poisoned out of range (-1 or S + 7).
    prefix: the valid edges of a row come first, as top-K with a radius
    gives them."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x_src = torch.randn((B, S, D), generator=gen, device=cuda)
    idx = torch.randint(0, S, (B, Q, K), generator=gen, device=cuda, dtype=torch.int32)
    z_r = torch.randn((B, Q, K, Dp), generator=gen, device=cuda)
    qx = torch.randn((B, Q, H, D), generator=gen, device=cuda) * 0.1
    qp = torch.randn((B, Q, H, Dp), generator=gen, device=cuda) * 0.1
    if prefix:
        n = torch.randint(0, K + 1, (B, Q, 1), generator=gen, device=cuda)
        valid = torch.arange(K, device=cuda) < n
    else:
        valid = torch.rand((B, Q, K), generator=gen, device=cuda) > 0.3
    valid[0, 3] = False  # a destination with no valid edge
    poison = torch.where(torch.rand((B, Q, K), generator=gen, device=cuda) > 0.5, -1, S + 7)
    idx = torch.where(valid, idx, poison.to(torch.int32))
    return x_src, idx, z_r, qx, qp, valid


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("K,D,Dp,H", EDGE_CASES)
def test_edge_kernel_matches_plain(cuda, K, D, Dp, H, prefix):
    """Both regimes, K off every tile and segment, H odd and small, D != Dp,
    D and Dp not multiples of 4 (4-byte copies); rows with no valid edge
    exactly zero; two launches bitwise equal."""
    args = _edge_inputs(cuda, 2, 8, K, D, Dp, H, 300, seed=K + H, prefix=prefix)
    valid = args[-1]
    before = edge_attn_core.launches
    got = edge_attn_core(*args, 0.25)
    again = edge_attn_core(*args, 0.25)
    ref = edge_attn_core_plain(*args, 0.25)
    torch.cuda.synchronize()
    assert edge_attn_core.launches == before + 2
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b.expand_as(a), atol=1e-5, rtol=1e-5)
    empty = ~valid.any(-1)
    assert bool(empty[0, 3]) and all(float(o[empty].abs().max()) == 0.0 for o in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


def test_edge_kernel_gnn_site(cuda):
    """The condition GNN's site: Q = K = N = 128, D_pe = D = 128, idx the
    identity row, most rows with one valid edge (unary conditions sit on
    the diagonal), a few with more, the rest with none."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, N, D, H = 3, 128, 128, 8
    x_src = torch.randn((B, N, D), generator=gen, device=cuda)
    idx = torch.arange(N, dtype=torch.int32, device=cuda).expand(B, N, N).contiguous()
    z_r = torch.randn((B, N, N, D), generator=gen, device=cuda)
    qx = torch.randn((B, N, H, D), generator=gen, device=cuda) * 0.1
    qp = torch.randn((B, N, H, D), generator=gen, device=cuda) * 0.1
    diag = torch.rand((B, N), generator=gen, device=cuda) > 0.4
    valid = torch.diag_embed(diag) | (torch.rand((B, N, N), generator=gen, device=cuda) > 0.995)
    before = edge_attn_core.launches
    got = edge_attn_core(x_src, idx, z_r, qx, qp, valid, 0.25)
    ref = edge_attn_core_plain(x_src, idx, z_r, qx, qp, valid, 0.25)
    torch.cuda.synchronize()
    assert edge_attn_core.launches == before + 1
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b.expand_as(a), atol=1e-5, rtol=1e-5)
    empty = ~valid.any(-1)
    assert bool(empty.any()) and all(float(o[empty].abs().max()) == 0.0 for o in got)


def test_edge_kernel_refuses_other_inputs(cuda):
    """Widths and head counts outside the kernel's raise; nothing falls back
    to the plain version."""
    before = edge_attn_core.launches
    for K, D, Dp, H in ((8, 129, 96, 8), (8, 128, 129, 8), (8, 128, 96, 9)):
        args = _edge_inputs(cuda, 1, 4, K, D, Dp, H, 10, seed=0)
        with pytest.raises(ValueError):
            edge_attn_core(*args, 0.25)
    args = list(_edge_inputs(cuda, 1, 4, 8, 32, 24, 2, 10, seed=0))
    with pytest.raises(TypeError):  # idx must be int32
        edge_attn_core(args[0], args[1].long(), *args[2:], 0.25)
    with pytest.raises(ValueError):  # a table on the CPU
        edge_attn_core(args[0], args[1], args[2].cpu(), *args[3:], 0.25)
    assert edge_attn_core.launches == before


def _two_x(got, ref32, ref16, what):
    """The 2x rule over tuples of outputs: max error of `got` against the
    f32 plain version at most twice the bf16 plain version's, plus BF16_ATOL."""
    err = max(float((g.float() - r).abs().max()) for g, r in zip(got, ref32))
    err16 = max(float((g.float() - r).abs().max()) for g, r in zip(ref16, ref32))
    assert err <= 2 * err16 + BF16_ATOL, (what, err, err16)


# (K, D, Dp, H): both regimes; D and Dp multiples of 8 (16-byte copies of
# bf16 rows) and not (chunks assembled value by value); K off the 16-edge
# tiles; H < 8 (heads of the mma's n8 left empty)
EDGE_BF16_CASES = [(7, 128, 96, 8), (33, 128, 96, 8), (160, 128, 96, 8), (768, 128, 96, 8),
                   (40, 32, 24, 4), (50, 30, 18, 8), (300, 30, 18, 2), (1, 128, 96, 3),
                   (23, 128, 96, 8), (129, 64, 96, 7), (777, 128, 128, 5), (100, 8, 120, 1)]


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("K,D,Dp,H", EDGE_BF16_CASES)
def test_edge_kernel_bf16_matches_plain(cuda, K, D, Dp, H, prefix):
    """The bf16 instantiation on bf16 tables and queries: by the 2x rule
    against the f32 plain version on the same values, outputs in bf16,
    rows with no valid edge exactly zero, two launches bitwise equal."""
    x_src, idx, z_r, qx, qp, valid = _edge_inputs(cuda, 2, 8, K, D, Dp, H, 300, seed=K + H,
                                                  prefix=prefix)
    bf = [t.to(torch.bfloat16) for t in (x_src, z_r, qx, qp)]
    args16 = (bf[0], idx, bf[1], bf[2], bf[3], valid, 0.25)
    before = edge_attn_core.launches
    got = edge_attn_core(*args16)
    again = edge_attn_core(*args16)
    ref16 = edge_attn_core_plain(*args16)
    ref32 = edge_attn_core_plain(bf[0].float(), idx, bf[1].float(), bf[2].float(), bf[3].float(),
                                 valid, 0.25)
    torch.cuda.synchronize()
    assert edge_attn_core.launches == before + 2
    assert all(o.dtype == torch.bfloat16 for o in got)
    _two_x(got, [r.expand_as(g) for r, g in zip(ref32, got)], [r.expand_as(g) for r, g in
                                                               zip(ref16, got)], "edge bf16")
    empty = ~valid.any(-1)
    assert all(float(o[empty].float().abs().max()) == 0.0 for o in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("K,H", [(32, 8), (32, 3), (600, 8), (600, 5)])
def test_edge_kernel_bf16_sparse_rows(cuda, K, H):
    """The bf16 path on rows of 0, 1, 2, 15, 16, 17 and 33 valid edges (a
    tile's edge, a full tile and one over), the valid edges spread over the
    row: by the 2x rule, empty rows zero, two launches bitwise equal."""
    x_src, _, z_r, qx, qp, _ = _edge_inputs(cuda, 2, 7, K, 128, 96, H, 300, seed=K + H)
    gen = torch.Generator(device=cuda).manual_seed(H)
    valid = torch.zeros((2, 7, K), dtype=torch.bool, device=cuda)
    for q, n in enumerate((0, 1, 2, 15, 16, 17, min(33, K))):
        valid[:, q, torch.randperm(K, generator=gen, device=cuda)[:n]] = True
    idx = torch.randint(0, 300, (2, 7, K), generator=gen, device=cuda, dtype=torch.int32)
    idx = torch.where(valid, idx, -1)  # an invalid edge's idx is never read
    bf = [t.to(torch.bfloat16) for t in (x_src, z_r, qx, qp)]
    args16 = (bf[0], idx, bf[1], bf[2], bf[3], valid, 0.25)
    got = edge_attn_core(*args16)
    again = edge_attn_core(*args16)
    ref16 = edge_attn_core_plain(*args16)
    ref32 = edge_attn_core_plain(bf[0].float(), idx, bf[1].float(), bf[2].float(), bf[3].float(),
                                 valid, 0.25)
    torch.cuda.synchronize()
    _two_x(got, [r.expand_as(g) for r, g in zip(ref32, got)], [r.expand_as(g) for r, g in
                                                               zip(ref16, got)], "edge bf16 sparse")
    assert all(float(o[:, 0].float().abs().max()) == 0.0 for o in got)
    assert all(float(o[:, 1:].float().abs().amax((-2, -1)).min()) > 0.0 for o in got[:2])
    assert torch.equal(got[2][:, 1:], torch.ones_like(got[2][:, 1:]))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_edge_kernel_refuses_mixed_dtypes(cuda):
    """One value table in another dtype than the rest, or a dtype without an
    instantiation, raises a TypeError: nothing is cast, nothing launched."""
    x_src, idx, z_r, qx, qp, valid = _edge_inputs(cuda, 1, 4, 8, 32, 24, 2, 10, seed=0)
    bf = torch.bfloat16
    before = edge_attn_core.launches
    for args in ((x_src.to(bf), idx, z_r, qx.to(bf), qp.to(bf)),
                 (x_src, idx, z_r.to(bf), qx, qp),
                 (x_src.half(), idx, z_r.half(), qx.half(), qp.half())):
        with pytest.raises(TypeError):
            edge_attn_core(*args, valid, 0.25)
    assert edge_attn_core.launches == before


def test_topk_kernel_radius_rounds_like_jax(cuda):
    """r = 255.14771324126028: float32(r) squared in float32 is 65100.36,
    which keeps a source at (255.14772, 0) (d2 = 65100.36), as the JAX
    package's neighbor_topk does (tests/test_torch_kernels.py)."""
    r = 255.14771324126028
    dst = torch.zeros((1, 1, 2), device=cuda)
    src = torch.tensor([[[255.14772, 0.0], [1.0, 0.0], [300.0, 0.0]]], device=cuda)
    dm = torch.ones((1, 1), dtype=torch.bool, device=cuda)
    sm = torch.ones((1, 3), dtype=torch.bool, device=cuda)
    ki, kv = neighbor_topk(dst, src, dm, sm, 3, radius=r)
    pi, pv = neighbor_topk_plain(dst, src, dm, sm, 3, radius=r)
    assert kv.tolist() == pv.tolist() == [[[True, True, False]]]
    assert ki[kv].tolist() == pi[pv].tolist() == [1, 0]


def _flash_inputs(cuda, B, T, Hq, Hkv, D, seed, dtype=torch.bfloat16):
    """q/k/v (bf16 rounded from f32 draws, or the f32 draws) and the
    tokenizer's holed mask: text of a random length, pad, a block of slots
    about half on; scene 0 has no valid token."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda h: torch.randn((B, T, h, D), generator=gen, device=cuda).to(dtype)
    q, k, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
    block = min(T // 3, 40)
    mask = torch.zeros((B, T), dtype=torch.bool, device=cuda)
    for b in range(1, B):
        n = int(torch.randint(1, T - block, (1,), generator=gen, device=cuda))
        mask[b, :n] = True
        mask[b, T - block:] = torch.rand(block, generator=gen, device=cuda) > 0.5
    return q, k, v, mask


# (B, T, Hq, Hkv, D): Hq/Hkv of 1, 2, 4 and 8; T off the 64-key tile and the
# 16-128-row query tiles; D 16 (tiny()), 32, 64, 128 (Llama3-8B)
FLASH_CASES = [
    (3, 100, 8, 2, 64), (3, 200, 8, 2, 128), (2, 64, 4, 1, 128), (2, 77, 4, 4, 32),
    (2, 390, 32, 8, 128), (2, 150, 8, 1, 16), (2, 333, 8, 4, 64), (3, 384, 4, 2, 16),
    (2, 129, 8, 8, 128), (2, 500, 16, 2, 128), (2, 45, 2, 2, 16),
    # head widths the wrapper zero-pads to a multiple of 16
    (2, 120, 8, 2, 40), (2, 70, 4, 4, 8),
]


@pytest.mark.parametrize("B,T,Hq,Hkv,D", FLASH_CASES)
def test_flash_attn_kernel_matches_plain(cuda, B, T, Hq, Hkv, D):
    q, k, v, mask = _flash_inputs(cuda, B, T, Hq, Hkv, D, seed=T + D)
    scale = D ** -0.5
    before = causal_attention.launches
    got = causal_attention(q, k, v, mask, scale)
    again = causal_attention(q, k, v, mask, scale)
    ref = causal_attention_plain(q.float(), k.float(), v.float(), mask, scale)
    ref_bf16 = causal_attention_plain(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert causal_attention.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again)  # no atomics: bitwise reproducible
    err = float((got.float() - ref)[mask].abs().max())
    err_bf16 = float((ref_bf16.float() - ref)[mask].abs().max())
    assert err <= 2 * err_bf16 + 1e-5, (err, err_bf16)
    assert bool(torch.isfinite(got).all())
    assert float(got[~mask].float().abs().max()) == 0.0  # pad rows (and scene 0) are zeros


@pytest.mark.parametrize("B,T,Hq,Hkv,D", FLASH_CASES)
def test_flash_attn_f32_kernel_matches_plain(cuda, B, T, Hq, Hkv, D):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's einsums in full f32
    q, k, v, mask = _flash_inputs(cuda, B, T, Hq, Hkv, D, seed=T + D + 1, dtype=torch.float32)
    scale = D ** -0.5
    before = causal_attention.launches
    got = causal_attention(q, k, v, mask, scale)
    again = causal_attention(q, k, v, mask, scale)
    ref = causal_attention_plain(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert causal_attention.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, again)
    assert float((got - ref)[mask].abs().max()) <= 1e-5
    assert float(got[~mask].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_skips_masked_keys(cuda, dtype):
    """Non-finite values in pad rows of q, k and v do not reach the output:
    masked keys are skipped, not weighted by p = 0, and pad query rows are
    not read."""
    q, k, v, mask = _flash_inputs(cuda, 3, 150, 8, 2, 128, seed=1, dtype=dtype)
    clean = causal_attention(q, k, v, mask, 0.1)
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    q2[~mask] = float("nan")
    k2[~mask] = float("nan")
    v2[~mask] = float("inf")
    assert torch.equal(causal_attention(q2, k2, v2, mask, 0.1), clean)


def test_flash_attn_refuses_other_inputs(cuda):
    q, k, v, mask = _flash_inputs(cuda, 2, 40, 4, 2, 64, seed=2)
    before = causal_attention.launches
    for dtype in (torch.float16, torch.float64):  # never cast
        with pytest.raises(TypeError):
            causal_attention(q.to(dtype), k.to(dtype), v.to(dtype), mask, 0.125)
    with pytest.raises(TypeError):  # mixed dtypes
        causal_attention(q, k.float(), v.float(), mask, 0.125)
    with pytest.raises(ValueError):  # Hq not a multiple of Hkv
        causal_attention(q[:, :, :3].contiguous(), k, v, mask, 0.125)
    with pytest.raises(ValueError):  # non-contiguous
        causal_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask, 0.125)
    with pytest.raises(ValueError):  # the mask on the CPU
        causal_attention(q, k, v, mask.cpu(), 0.125)
    assert causal_attention.launches == before


# (B, T, Hq, Hkv, D) of the backward: the Llama3-8B text shape, tiny()'s,
# T off the 32/64-row tiles with Hq/Hkv of 1, 2 and 4, and head counts that
# leave the prep's last block of query heads short (5, 6 and 9 heads)
FLASH_BWD_CASES = [
    (2, 384, 32, 8, 128), (3, 384, 4, 2, 16), (3, 100, 8, 2, 64), (2, 77, 4, 4, 32),
    (2, 150, 8, 1, 16), (2, 129, 8, 8, 128), (2, 45, 2, 2, 16), (2, 333, 8, 4, 48),
    (2, 120, 8, 2, 40), (2, 70, 4, 4, 8), (2, 100, 6, 6, 64), (2, 90, 5, 5, 32),
    (2, 70, 9, 9, 16),
]


def _poison_allocator(cuda, *likes):
    """Free blocks of NaN the size of each tensor in `likes`, so that the
    outputs torch.empty_like allocates next hold NaN until the kernel writes
    them: an output element the kernel never writes then shows."""
    nans = [torch.full_like(x, float("nan")) for x in likes]
    del nans


def _flash_bwd_inputs(cuda, B, T, Hq, Hkv, D, dtype, seed, mask=None):
    """q/k/v/mask (the tokenizer's holed layout unless a mask is given), the
    kernel forward's out and lse, and an upstream gradient do (random, zero
    on pad rows)."""
    q, k, v, holed = _flash_inputs(cuda, B, T, Hq, Hkv, D, seed=seed, dtype=dtype)
    mask = holed if mask is None else mask.to(cuda)
    out, lse = _flash_fwd(q, k, v, mask, D ** -0.5, with_lse=True)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    do = (torch.randn(q.shape, generator=gen, device=cuda) * mask[:, :, None, None]).to(dtype)
    return q, k, v, mask, out, lse, do


def _bwd_err(got, ref, mask):
    """Max abs error of (dq, dk, dv) on valid rows / valid keys."""
    return max(float((g.float() - r.float())[mask].abs().max()) for g, r in zip(got, ref))


@pytest.mark.parametrize("B,T,Hq,Hkv,D", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, B, T, Hq, Hkv, D):
    """bf16: the kernel's dq/dk/dv deviation from the plain backward run in
    f32 on the same bf16 inputs is at most twice the bf16 plain backward's,
    plus 1e-5. The forward's lse against the plain forward's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask, out, lse, do = _flash_bwd_inputs(cuda, B, T, Hq, Hkv, D, torch.bfloat16, T + D)
    scale = D ** -0.5
    before = causal_attention_bwd.launches
    _poison_allocator(cuda, q, k, v)
    got = causal_attention_bwd(q, k, v, out, lse, do, mask, scale)
    again = causal_attention_bwd(q, k, v, out, lse, do, mask, scale)
    f32 = [x.float() for x in (q, k, v, out)]
    ref = causal_attention_bwd_plain(*f32, lse, do.float(), mask, scale)
    ref_bf16 = causal_attention_bwd_plain(q, k, v, out, lse, do, mask, scale)
    torch.cuda.synchronize()
    assert causal_attention_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    assert [x.dtype for x in got] == [torch.bfloat16] * 3
    err = _bwd_err(got, ref, mask)
    err_bf16 = _bwd_err(ref_bf16, ref, mask)
    assert err <= 2 * err_bf16 + 1e-5, (err, err_bf16)
    assert all(bool(torch.isfinite(x).all()) and float(x[~mask].float().abs().max()) == 0.0
               for x in got)
    _, lse_ref = causal_attention_fwd_plain(*f32[:3], mask, scale)
    lm = mask[:, None, :].expand_as(lse)
    assert float((lse - lse_ref)[lm].abs().max()) <= 2e-2
    assert bool((lse[~lm] == float("-inf")).all())


@pytest.mark.parametrize("B,T,Hq,Hkv,D", FLASH_BWD_CASES)
def test_flash_bwd_f32_kernel_matches_plain(cuda, B, T, Hq, Hkv, D):
    """f32: dq/dk/dv within 1e-5 of each tensor's largest magnitude; lse
    within 1e-5 of the plain forward's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask, out, lse, do = _flash_bwd_inputs(cuda, B, T, Hq, Hkv, D, torch.float32,
                                                    T + D + 1)
    scale = D ** -0.5
    _poison_allocator(cuda, q, k, v)
    got = causal_attention_bwd(q, k, v, out, lse, do, mask, scale)
    again = causal_attention_bwd(q, k, v, out, lse, do, mask, scale)
    ref = causal_attention_bwd_plain(q, k, v, out, lse, do, mask, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
        assert float(g[~mask].abs().max()) == 0.0
    _, lse_ref = causal_attention_fwd_plain(q, k, v, mask, scale)
    lm = mask[:, None, :].expand_as(lse)
    assert float((lse - lse_ref)[lm].abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_reads_no_pad_row(cuda, dtype):
    """NaN or inf in the pad rows of q, k, v, out and do leaves dq/dk/dv
    bitwise unchanged, pad rows and masked keys zero."""
    q, k, v, mask, out, lse, do = _flash_bwd_inputs(cuda, 3, 150, 8, 2, 128, dtype, 5)
    clean = causal_attention_bwd(q, k, v, out, lse, do, mask, 0.1)
    pads = []
    for x, val in ((q, "nan"), (k, "nan"), (v, "inf"), (out, "nan"), (do, "nan")):
        x = x.clone()
        x[~mask] = float(val)
        pads.append(x)
    got = causal_attention_bwd(*pads[:4], lse, pads[4], mask, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(got, clean))
    assert all(float(x[~mask].float().abs().max()) == 0.0 for x in got)


def _compaction_mask(name, B, T, block):
    """[B, T] masks that stress the backward's compaction of valid rows
    (the last `block` positions are the prompt block)."""
    rng = np.random.default_rng(len(name))
    m = np.zeros((B, T), bool)
    if name == "no_valid_scene":  # scene 0 empty, the others holed
        for b in range(1, B):
            m[b, : rng.integers(1, T - block)] = True
            m[b, T - block:] = rng.random(block) > 0.5
    elif name == "single_token":  # one valid token in scenes 0 and 2, the others holed
        for b in range(B):
            if b % 2 == 0:
                m[b, rng.integers(0, T)] = True
            else:
                m[b, : rng.integers(1, T - block)] = True
                m[b, T - block:] = rng.random(block) > 0.5
    elif name == "prompt_block_only":
        m[:, T - block:] = rng.random((B, block)) > 0.5
    elif name == "tile_ragged":  # counts one off the 32- and 64-row tiles
        for b, n in enumerate((63, 65, 97, 33)[:B]):
            m[b, :n] = True
    elif name == "train_layout":  # the 8B train step's: 27 text tokens, 2 prompt slots
        m[:, :27] = True
        m[:, T - block + rng.integers(0, block, 2)] = True
    elif name == "all_valid":
        m[:] = True
    return torch.from_numpy(m)


COMPACTION_MASKS = ["no_valid_scene", "single_token", "prompt_block_only", "tile_ragged",
                    "train_layout", "all_valid"]


@pytest.mark.parametrize("heads", [(8, 2), (6, 6), (5, 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask_name", COMPACTION_MASKS)
def test_flash_bwd_compaction_masks(cuda, mask_name, dtype, heads):
    """The backward works on each scene's valid rows only: at masks with
    empty scenes, single tokens, prompt-only rows, counts off the tiles,
    the train step's layout and no pad at all, each dtype's gate (bf16: 2x
    the bf16 plain backward's error plus 1e-5; f32: 1e-5 of each tensor's
    largest), two launches bitwise equal, pad rows and masked keys exactly
    zero (the outputs allocated over NaN), and NaN or inf in every pad row
    changing nothing; with grouped query heads and with 6 and 5 heads of
    their own (the prep's last block of query heads then holds fewer heads
    than its share of the kv heads)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, T, D = 4, 200, 64
    Hq, Hkv = heads
    mask = _compaction_mask(mask_name, B, T, 64)
    q, k, v, mask, out, lse, do = _flash_bwd_inputs(cuda, B, T, Hq, Hkv, D, dtype, 7, mask)
    scale = D ** -0.5
    _poison_allocator(cuda, q, k, v)
    got = causal_attention_bwd(q, k, v, out, lse, do, mask, scale)
    again = causal_attention_bwd(q, k, v, out, lse, do, mask, scale)
    f32 = [x.float() for x in (q, k, v, out)]
    ref = causal_attention_bwd_plain(*f32, lse, do.float(), mask, scale)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(x).all()) for x in got)
    if bool(mask.any()):
        if dtype == torch.bfloat16:
            ref_bf16 = causal_attention_bwd_plain(q, k, v, out, lse, do, mask, scale)
            err, err_bf16 = _bwd_err(got, ref, mask), _bwd_err(ref_bf16, ref, mask)
            assert err <= 2 * err_bf16 + 1e-5, (err, err_bf16)
        else:
            for g, r in zip(got, ref):
                assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    if not bool(mask.all()):
        assert all(float(x[~mask].float().abs().max()) == 0.0 for x in got)
        pads = []
        for x, val in ((q, "nan"), (k, "nan"), (v, "inf"), (out, "nan"), (do, "nan")):
            x = x.clone()
            x[~mask] = float(val)
            pads.append(x)
        dirty = causal_attention_bwd(*pads[:4], lse, pads[4], mask, scale)
        assert all(torch.equal(a, b) for a, b in zip(dirty, got))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_causal_attention_has_a_gradient_on_the_card(cuda, dtype):
    """With q requiring grad the output has a grad_fn (CausalAttention): the
    forward launches with lse, the backward launches the backward kernel
    once, and the gradients are the plain backward's on the same forward
    (bitwise) and the dense path's autograd within the backward rules;
    outside grad mode the launch is the eval one, bitwise the same output."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _flash_inputs(cuda, 2, 200, 8, 2, 64, seed=9, dtype=dtype)
    gen = torch.Generator(device=cuda).manual_seed(10)
    g = (torch.randn(q.shape, generator=gen, device=cuda) * mask[:, :, None, None]).to(dtype)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    f0, b0 = causal_attention.launches, causal_attention_bwd.launches
    out = causal_attention(*xs, mask, 0.125)
    assert type(out.grad_fn).__name__ == "CausalAttentionBackward"
    (out.float() * g.float()).sum().backward()
    torch.cuda.synchronize()
    assert (causal_attention.launches - f0, causal_attention_bwd.launches - b0) == (1, 1)
    with torch.no_grad():
        assert torch.equal(causal_attention(q, k, v, mask, 0.125), out.detach())
    o2, lse = _flash_fwd(q, k, v, mask, 0.125, with_lse=True)
    assert torch.equal(o2, out.detach())
    ref = causal_attention_bwd(q, k, v, o2, lse, g, mask, 0.125)
    assert all(torch.equal(x.grad, r) for x, r in zip(xs, ref))
    ys = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    (causal_attention_plain(*ys, mask, 0.125) * g.float()).sum().backward()
    plain_lo = causal_attention_bwd_plain(q, k, v, o2, lse, g, mask, 0.125)
    bar = (2 * _bwd_err(plain_lo, [y.grad for y in ys], mask) + 1e-5 if dtype == torch.bfloat16
           else 1e-5 * max(float(y.grad.abs().max()) for y in ys))
    assert _bwd_err([x.grad for x in xs], [y.grad for y in ys], mask) <= bar


def test_text_train_step_lora_grads_match_plain_on_the_card(cuda, monkeypatch):
    """configs/with_text.yaml at small widths (the f32 tiny() Llama): one
    train step through B4 and its backward against the same step with the
    dense plain attention: the loss within 1e-5 relative and every layer's
    q/k/v lora_b gradient within 1e-4 of its largest magnitude; the frozen
    body gets no gradient."""
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.llm import llama
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.train.optim import build_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(str(ROOT / "configs" / "with_text.yaml"), TRAIN_OPTS)
    model = ProSim(cfg, device=cuda)
    init_params(model, seed=0)
    build_optimizer(cfg, model)
    with torch.no_grad():  # the LoRA B factors start at zero; make the adapters do work
        gen = torch.Generator(device=cuda).manual_seed(1)
        for n, p in model.named_parameters():
            if n.endswith(("lora_b", "lora_embed_b")):
                p.copy_(torch.randn(p.shape, generator=gen, device=cuda) * 0.05)
    batch = make_synthetic_batch(cfg, batch_size=2, seed=1, device=cuda, **TRAIN_SHAPE)
    f0, b0 = causal_attention.launches, causal_attention_bwd.launches
    loss_k, g_k = _grad_step(model, cfg, batch)
    layers = model.condition_transformer_policy_decoder.text_attn.llm.cfg.num_layers
    assert causal_attention_bwd.launches - b0 == layers
    assert causal_attention.launches - f0 == 2 * layers  # the forward and prepare's recompute
    monkeypatch.setattr(llama, "causal_attention", causal_attention_plain)
    loss_p, g_p = _grad_step(model, cfg, batch)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert set(g_k) == set(g_p)
    qkv = [n for n in g_p if n.endswith(("q_proj.lora_b", "k_proj.lora_b", "v_proj.lora_b"))]
    assert len(qkv) == 3 * layers
    for n in qkv:
        assert float(g_p[n].abs().max()) > 0
        assert float((g_k[n] - g_p[n]).abs().max()) <= 1e-4 * float(g_p[n].abs().max()), n
    assert not any(".llm." in n and "lora" not in n for n in g_k)


def test_demo_config_runs_its_f32_llama_through_the_kernel(cuda, monkeypatch):
    """configs/waymo_demo.yaml as shipped (TEXT.LLM.ARCH auto, no weights)
    builds the f32 tiny() Llama; on the card its attention is the f32
    kernel, two launches per forward (one per layer), and the rollout
    matches the same model with the plain attention within 1e-3 m."""
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.llm import llama
    from prosim_torch.models.prosim import ProSim

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(str(ROOT / "configs" / "waymo_demo.yaml"))
    model = ProSim(cfg, device="cuda")
    init_params(model, seed=0)
    llm_cfg = model.condition_transformer_policy_decoder.text_attn.llm.cfg
    assert llm_cfg.dtype == torch.float32 and llm_cfg.head_dim == 16
    batch = make_synthetic_batch(cfg, batch_size=2, num_lanes=64, num_obs_agents=24,
                                 num_agents=16, num_replan=2, seed=1, device="cuda")
    before = causal_attention.launches
    with torch.no_grad():
        out = model(batch)
        torch.cuda.synchronize()
        assert causal_attention.launches == before + llm_cfg.num_layers == before + 2
        monkeypatch.setattr(llama, "causal_attention", causal_attention_plain)
        ref = model(batch)
    m = batch.prompt.mask
    traj, traj_ref = out["rollout_traj"][m], ref["rollout_traj"][m]
    assert bool(torch.isfinite(traj).all())
    assert float((traj - traj_ref)[..., :2].abs().max()) <= 1e-3


FUSED_CASES = {  # name: (B, N, D, H, head_dim, L, Sa, Ka, Sm, Km[, options of _fused_inputs])
    "jax_test_widths": (2, 11, 32, 4, 8, 2, 12, 5, 24, 7),
    "demo_widths": (2, 13, 128, 8, 16, 2, 160, 160, 900, 768),
    "short_rows": (3, 8, 128, 8, 16, 1, 40, 9, 300, 64),
    # invalid edges' idx out of range (-1 and S + 7): never dereferenced
    "poisoned_idx": (2, 11, 32, 4, 8, 2, 12, 5, 24, 7, {"poison": True}),
    "every_edge_valid": (2, 9, 32, 4, 8, 2, 12, 12, 40, 40, {"valid": "all"}),  # K = S
    "k1": (2, 9, 32, 4, 8, 2, 6, 1, 10, 1),
    "k_not_multiple_of_8": (2, 9, 64, 4, 8, 2, 30, 13, 100, 37),
    "h1_hd4": (2, 9, 32, 1, 4, 2, 20, 11, 40, 21),
    "h1_hd32": (2, 9, 32, 1, 32, 2, 20, 11, 40, 21),
    "h2_hd4": (2, 9, 32, 2, 4, 2, 20, 11, 40, 21),
    "h2_hd32": (2, 9, 32, 2, 32, 2, 20, 11, 40, 21),
    "d_ne_p": (2, 9, 64, 4, 8, 2, 20, 11, 50, 30, {"pe_dim": 96}),
    # D and P not multiples of 4: 4-byte source copies, padded table rows
    "odd_widths": (2, 9, 30, 4, 8, 2, 20, 11, 50, 30, {"pe_dim": 30, "num_features": 3}),
    "n_not_multiple_of_rows": (2, 21, 32, 4, 8, 2, 20, 11, 50, 30),
    "demo_depth": (1, 16, 128, 8, 16, 6, 160, 160, 2048, 768),
    # a second call on the same shapes with other features and edges must not
    # read the first call's rel-PE rows
    "second_call_new_feats": (2, 13, 128, 8, 16, 2, 160, 160, 900, 768, {"second_call": True}),
}


def _fused_inputs(cuda, B, N, D, H, hd, L, Sa, Ka, Sm, Km, seed, pe_dim=None, num_features=4,
                  valid="random", poison=False):
    """x [B,N,D], both sites' (src, idx, feats, valid) and packed weights;
    feats are the reference's raw rel-PE features (dist, rel_ori,
    rel_ori_vec twice), the first num_features of them."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    stack = torch.nn.Module()
    for i in range(L):
        for site in ("a2p", "m2p"):
            stack.add_module(f"{site}_{i}",
                             GatedNeighborAttention(D, H, hd, bipartite=True, pe_dim=pe_dim))
    init_params(stack, seed=seed)
    stack.to(cuda)
    with torch.no_grad():  # exercise the norm affines and the biases
        for p in stack.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, device=cuda))
    x = torch.randn((B, N, D), generator=gen, device=cuda)
    tables = []
    for S, K in ((Sa, Ka), (Sm, Km)):
        src = torch.randn((B, S, D), generator=gen, device=cuda)
        tables.append((src,) + _edges(cuda, gen, B, N, S, K, num_features, valid, poison))
    with torch.no_grad():
        w = pack_site_weights(stack, "a2p"), pack_site_weights(stack, "m2p")
    return x, tables, w


def _edges(cuda, gen, B, N, S, K, num_features, valid_mode, poison):
    """(idx, feats, valid) of one site: random sources and validity (or
    every edge valid, idx a permutation of the sources), a row with no
    valid edge at (0, 1) and (B - 1, N - 1)."""
    if valid_mode == "all":
        idx = torch.argsort(torch.rand((B, N, S), generator=gen, device=cuda), -1)[..., :K]
        idx = idx.to(torch.int32).contiguous()
        valid = torch.ones((B, N, K), dtype=torch.bool, device=cuda)
    else:
        idx = torch.randint(0, S, (B, N, K), generator=gen, device=cuda, dtype=torch.int32)
        valid = torch.rand((B, N, K), generator=gen, device=cuda) > 0.3
    valid[0, 1] = False  # a row with no valid edge at both sites
    valid[B - 1, N - 1] = False
    if poison:
        bad = torch.where(torch.arange(K, device=cuda) % 2 == 0, -1, S + 7).to(torch.int32)
        idx = torch.where(valid, idx, bad)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((B, N, K), generator=gen, device=cuda)
    ori_vec = u(-3.14159, 3.14159)
    feats = torch.stack([u(0.0, 200.0), u(-3.14159, 3.14159), ori_vec, ori_vec], -1)
    return idx, feats[..., :num_features].contiguous(), valid


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_stack_kernel_matches_plain(cuda, case):
    B, N, D, H, hd, L, Sa, Ka, Sm, Km, *opts = FUSED_CASES[case]
    opts = dict(opts[0]) if opts else {}
    second_call = opts.pop("second_call", False)
    x, (ta, tm), (wa, wm) = _fused_inputs(cuda, B, N, D, H, hd, L, Sa, Ka, Sm, Km, len(case),
                                          **opts)
    calls = [(ta, tm)]
    if second_call:
        gen = torch.Generator(device=cuda).manual_seed(len(case) + 1)
        calls.append(tuple((t[0],) + _edges(cuda, gen, B, N, t[0].shape[1], t[1].shape[-1],
                                             t[2].shape[-1], "random", False) for t in (ta, tm)))
    for ta, tm in calls:
        before = fused_two_site_stack.launches
        got = fused_two_site_stack(x, ta, tm, wa, wm, num_heads=H, head_dim=hd)
        ref = fused_two_site_stack_plain(x, ta, tm, wa, wm, num_heads=H, head_dim=hd)
        again = fused_two_site_stack(x, ta, tm, wa, wm, num_heads=H, head_dim=hd)
        torch.cuda.synchronize()
        assert fused_two_site_stack.launches == before + 2
        assert got.shape == (B, N, D) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, ref, atol=3e-4, rtol=3e-4)
        assert torch.equal(got, again)  # no atomics: bitwise reproducible


@pytest.mark.parametrize("D,H,hd,pe_dim,num_features", [
    (32, 9, 8, None, 4),     # more than 8 heads
    (32, 4, 6, None, 4),     # head_dim not a multiple of 4
    (32, 4, 36, None, 4),    # I = H * head_dim above 128
    (132, 4, 8, None, 4),    # D above 128
    (32, 4, 8, 132, 4),      # P above 128
    (32, 4, 8, 30, 4),       # F does not divide P
])
def test_fused_stack_kernel_refuses_other_widths(cuda, D, H, hd, pe_dim, num_features):
    """Widths the kernel does not take raise before anything is launched."""
    x, (ta, tm), (wa, wm) = _fused_inputs(cuda, 1, 4, D, H, hd, 1, 6, 3, 8, 5, 0, pe_dim=pe_dim,
                                          num_features=num_features)
    before = fused_two_site_stack.launches
    with pytest.raises(ValueError):
        fused_two_site_stack(x, ta, tm, wa, wm, num_heads=H, head_dim=hd)
    assert fused_two_site_stack.launches == before


@pytest.mark.parametrize("case", ["jax_test_widths", "demo_widths", "short_rows", "k1",
                                  "k_not_multiple_of_8", "d_ne_p", "h1_hd4", "h2_hd32",
                                  "odd_widths", "n_not_multiple_of_rows", "demo_depth"])
def test_fused_stack_kernel_bf16_matches_plain(cuda, case):
    """The bf16 instantiation: x, the source tokens and the weights (packed
    in bf16 from the same layers) in bf16, feats f32; by the 2x rule against
    the f32 plain version with the f32 weights, on the same bf16-rounded x
    and sources; two launches bitwise equal."""
    B, N, D, H, hd, L, Sa, Ka, Sm, Km, *opts = FUSED_CASES[case]
    x, (ta, tm), (wa, wm) = _fused_inputs(cuda, B, N, D, H, hd, L, Sa, Ka, Sm, Km, len(case),
                                          **(dict(opts[0]) if opts else {}))
    bf = torch.bfloat16
    x16 = x.to(bf)
    t16 = [(t[0].to(bf),) + t[1:] for t in (ta, tm)]
    t32 = [(t[0].float(),) + t[1:] for t in t16]
    with torch.no_grad():
        w16 = [[w.to(bf) for w in ws] for ws in (wa, wm)]
    kw = dict(num_heads=H, head_dim=hd)
    before = fused_two_site_stack.launches
    got = fused_two_site_stack(x16, *t16, *w16, **kw)
    again = fused_two_site_stack(x16, *t16, *w16, **kw)
    ref16 = fused_two_site_stack_plain(x16, *t16, *w16, **kw)
    ref32 = fused_two_site_stack_plain(x16.float(), *t32, wa, wm, **kw)
    torch.cuda.synchronize()
    assert fused_two_site_stack.launches == before + 2
    assert got.dtype == bf and bool(torch.isfinite(got).all())
    _two_x([got], [ref32], [ref16], "fused bf16")
    assert torch.equal(got, again)


def test_fused_stack_kernel_refuses_mixed_dtypes(cuda):
    x, (ta, tm), (wa, wm) = _fused_inputs(cuda, 1, 4, 32, 4, 8, 1, 6, 3, 8, 5, 0)
    bf = torch.bfloat16
    with torch.no_grad():
        w16 = [w.to(bf) for w in wa], [w.to(bf) for w in wm]
    t16 = [(t[0].to(bf),) + t[1:] for t in (ta, tm)]
    before = fused_two_site_stack.launches
    for args in ((x, *t16, *w16),              # f32 x, bf16 rest
                 (x.to(bf), ta, tm, *w16),     # f32 sources
                 (x.to(bf), *t16, wa, wm),     # f32 weights
                 (x.to(bf), *[(t[0], t[1], t[2].to(bf), t[3]) for t in t16], *w16)):  # bf16 feats
        with pytest.raises(TypeError):
            fused_two_site_stack(*args, num_heads=4, head_dim=8)
    assert fused_two_site_stack.launches == before


def test_dense_bf16_adds_the_bias_after_the_product(cuda):
    """Dense in bf16 on the card: the product rounds, then the bf16 bias is
    added and the sum rounds (flax's order), not a fused add before the
    rounding; parameters stay f32."""
    layer = Dense(64, 32, dtype=torch.bfloat16).to(cuda)
    with torch.no_grad():
        layer.bias.fill_(1.0 + 2 ** -9)
    x = torch.randn((16, 64), device=cuda)
    with torch.inference_mode():
        got = layer(x)
        bf = torch.bfloat16
        want = torch.nn.functional.linear(x.to(bf), layer.weight.to(bf)) + layer.bias.to(bf)
    assert got.dtype == bf and layer.weight.dtype == torch.float32
    assert torch.equal(got, want)


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


# ---------------------------------------------------------------- training

TRAIN_OPTS = [  # configs/no_text.yaml at tests/test_trainer.py's widths
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1", "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1", "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "2", "MODEL.DECODER.ATTN.FF_DIM", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "2",
    "TRAIN.SCHEDULER.WARMUP_STEPS", "0",
]
TRAIN_SHAPE = dict(num_lanes=64, num_obs_agents=24, num_agents=16, num_replan=3)


def _train_model(cuda, opts=()):
    from prosim_torch.config import get_config
    from prosim_torch.models.prosim import ProSim

    cfg = get_config(str(ROOT / "configs" / "no_text.yaml"), TRAIN_OPTS + list(opts))
    model = ProSim(cfg, device=cuda)
    init_params(model, seed=0)
    return cfg, model


def _grad_step(model, cfg, batch, seed=3):
    from prosim_torch.train.losses import paired_mse_k

    model.zero_grad(set_to_none=True)
    out = model.forward_train(batch, seed=seed)
    loss = paired_mse_k(batch, out, cfg)["full_loss"]
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


def test_forward_only_wrappers_refuse_inputs_that_require_grad(cuda):
    x = torch.randn((1, 4, 16), device=cuda)
    idx = torch.zeros((1, 3, 2), dtype=torch.int32, device=cuda)
    z = torch.randn((1, 3, 2, 8), device=cuda)
    qx = torch.randn((1, 3, 2, 16), device=cuda, requires_grad=True)
    qp = torch.randn((1, 3, 2, 8), device=cuda)
    ok = torch.ones((1, 3, 2), dtype=torch.bool, device=cuda)
    before = edge_attn_core.launches, fused_two_site_stack.launches
    with pytest.raises(RuntimeError, match="no backward"):
        edge_attn_core(x, idx, z, qx, qp, ok, 0.5)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_two_site_stack(qx, (x, idx, z, ok), (x, idx, z, ok), [], [], num_heads=2,
                             head_dim=8)
    assert (edge_attn_core.launches, fused_two_site_stack.launches) == before
    with torch.no_grad():
        edge_attn_core(x, idx, z, qx, qp, ok, 0.5)
    assert edge_attn_core.launches == before[0] + 1


@pytest.mark.parametrize("remat", ["full", "none"])
def test_train_step_with_topk_kernel_matches_plain(cuda, remat):
    """One train step (dropout on, one seed) through B1's kernel against the
    same step with the plain top-K: B1 is bit-equal to its plain version, so
    only the backward's atomic adds differ. B2, B3 and the rel-PE table
    kernel do not run in training; each forward and its recompute build
    their graphs with B1."""
    from prosim_torch.data.synthetic import make_synthetic_batch

    import chip_smoke

    cfg, model = _train_model(cuda, ["TRAIN.REMAT_POLICY", remat])
    batch = make_synthetic_batch(cfg, batch_size=2, seed=1, device=cuda, **TRAIN_SHAPE)
    before = chip_smoke.launch_counts()
    loss_k, g_k = _grad_step(model, cfg, batch)
    loss_k2, _ = _grad_step(model, cfg, batch)
    launches = {k: v - before[k] for k, v in chip_smoke.launch_counts().items()}
    per_forward = 4 + 2 * TRAIN_SHAPE["num_replan"]
    assert launches == {"neighbor_topk": 2 * per_forward * (2 if remat == "full" else 1),
                        "edge_attn_core": 0, "fused_two_site_stack": 0, "causal_attention": 0,
                        "causal_attention_bwd": 0, "rel_pe_table": 0}
    with chip_smoke.kernel_calls(neighbor_topk_plain, edge_attn_core_plain,
                                 fused_two_site_stack_plain, causal_attention_plain):
        loss_p, g_p = _grad_step(model, cfg, batch)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert abs(loss_k - loss_k2) <= 1e-6 * abs(loss_k)
    assert set(g_k) == set(g_p)
    for n, g in g_p.items():
        assert float((g_k[n] - g).abs().max()) <= 1e-4 * float(g.abs().max()), n


def test_trainer_fits_evaluates_and_rolls_out_on_the_card(cuda, tmp_path):
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.train.trainer import Trainer

    import chip_smoke

    cfg = get_config(str(ROOT / "configs" / "no_text.yaml"),
                     TRAIN_OPTS + ["EXPERIMENT_DIR", str(tmp_path)])
    trainer = Trainer(cfg, device=cuda)
    trainer.setup()
    batches = [make_synthetic_batch(cfg, batch_size=2, seed=s, device=cuda, **TRAIN_SHAPE)
               for s in range(2)]
    p0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    trainer.fit(batches, max_steps=2)
    moved = {n: float((p.detach() - p0[n]).abs().max())
             for n, p in trainer.model.named_parameters()}
    assert max(moved.values()) > 0
    assert all(v == 0.0 for n, v in moved.items() if "pred_mlp" in n)
    before = chip_smoke.launch_counts()
    metrics = trainer.evaluate(batches[:1])
    rollout = trainer.rollout_callback(batches[:1], m=4)
    after = chip_smoke.launch_counts()
    assert all(np.isfinite(v) for v in list(metrics.values()) + list(rollout.values()))
    assert after["neighbor_topk"] > before["neighbor_topk"]
    assert after["edge_attn_core"] > before["edge_attn_core"]
