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
difference); pad rows exactly zero in both.
"""

from pathlib import Path


import numpy as np
import pytest
import torch

from prosim_torch.ops.attention import GatedNeighborAttention
from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
from prosim_torch.ops.flash_attn import causal_attention, causal_attention_plain
from prosim_torch.ops.fused_stack import (
    fused_two_site_stack,
    fused_two_site_stack_plain,
    pack_site_weights,
)
from prosim_torch.ops.neighbors import neighbor_topk, neighbor_topk_plain
from prosim_torch.utils.params import init_params

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parent.parent

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
