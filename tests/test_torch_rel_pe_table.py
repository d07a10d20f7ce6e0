"""The normalized rel-PE table of a site (`ops/attention.py rel_pe_table`).

On the CPU: the plain path is today's chain,
normalize_rel_pe(RelPE(rel_pe_features(...)), hidden_dim), bit for bit in
f32 and bf16, at K > S, invalid edges and idx on pad slots; the selection
rule sends training (grad on or deterministic=False), the learnable
embedding and the reference layout (fold_dup=False) to the plain chain.

Marked `gpu` (skipped without a card; this file imports neither JAX nor
prosim_tpu): csrc/rel_pe_table.cu against the plain chain on the card at
the six site shapes of the default configuration with B cut to 4, in f32
within 4e-6 (the kernel repeats the chain's roundings; only the order of
the statistics' sums differs) and in bf16 within one bf16 ulp of the
plain table's value (or 4e-6 where that ulp is smaller); two launches
bitwise equal; a strided source view read in place; widths other than
the default's (hidden / 4 odd, hidden not a multiple of 4); the
closed-loop forward's 4 + 2 R launches and no plain build on the card.
    python -m pytest --noconftest tests/test_torch_rel_pe_table.py -q
"""

import numpy as np
import pytest
import torch

from prosim_torch.ops.attention import (
    RelPE,
    normalize_rel_pe,
    rel_pe_features,
    rel_pe_table,
    rel_pe_table_plain,
    table_takes_kernel,
)

F32_TOL = 4e-6
D = 128  # the default configuration's HIDDEN_DIM
SITES = {  # the default configuration's six fixed-PE sites: (Q, S, K)
    "a2a": (160, 160, 100),
    "s2s": (2208, 2208, 32),
    "p2p": (128, 128, 128),
    "s2p": (128, 2208, 512),
    "a2p": (128, 160, 160),
    "m2p": (128, 2048, 768),
}


def _poses(B, Q, S, seed, device="cpu", spread=80.0):
    """dst/src poses drawn from a seed: positions over +-spread m, some
    sources on the destinations' own positions (self edges, zero offsets),
    orientations over several turns."""
    rng = np.random.default_rng(seed)
    src_pos = rng.uniform(-spread, spread, (B, S, 2)).astype(np.float32)
    src_ori = rng.uniform(-7.0, 7.0, (B, S)).astype(np.float32)
    dst_pos = rng.uniform(-spread, spread, (B, Q, 2)).astype(np.float32)
    dst_ori = rng.uniform(-7.0, 7.0, (B, Q)).astype(np.float32)
    n = min(Q, S) // 2
    dst_pos[:, :n] = src_pos[:, :n]
    dst_ori[:, : n // 2] = src_ori[:, : n // 2]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return t(dst_pos), t(dst_ori), t(src_pos), t(src_ori)


def _idx(B, Q, S, K, seed, device="cpu", pad_slots=0):
    """idx [B,Q,K] int32 in [0, S): K > S repeats sources; the last
    `pad_slots` sources stand for pad slots (idx of invalid edges)."""
    rng = np.random.default_rng(seed + 1)
    idx = rng.integers(0, S, (B, Q, K)).astype(np.int32)
    if pad_slots:
        idx[:, :, K // 2:] = rng.integers(S - pad_slots, S, (B, Q, K - K // 2))
    return torch.from_numpy(idx).to(device)


def _chain(args, pe):
    return normalize_rel_pe(pe(rel_pe_features(*args)), pe.hidden_dim)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["k_exceeds_s", "pad_slots", "wide"])
def test_plain_path_is_the_chain(case, dtype):
    Q, S, K, hidden, pad = {"k_exceeds_s": (6, 5, 9, 16, 0), "pad_slots": (7, 12, 10, 32, 4),
                            "wide": (5, 40, 24, 128, 8)}[case]
    args = (*_poses(2, Q, S, seed=3), _idx(2, Q, S, K, seed=3, pad_slots=pad))
    pe = RelPE(hidden, dtype=dtype)
    want = _chain(args, pe)
    assert want.dtype == dtype and want.shape == (2, Q, K, 3 * hidden // 4)
    for deterministic in (True, False):
        assert torch.equal(rel_pe_table_plain(*args, pe), want)
        assert torch.equal(rel_pe_table(*args, pe, deterministic), want)
    with torch.no_grad():
        assert torch.equal(rel_pe_table(*args, pe, True), want)


def test_plain_path_with_bf16_destination():
    """The bf16 policy's destination poses are bf16: cos/sin round there."""
    dst_pos, dst_ori, src_pos, src_ori = _poses(2, 6, 11, seed=5)
    args = (dst_pos.bfloat16(), dst_ori.bfloat16(), src_pos, src_ori, _idx(2, 6, 11, 8, seed=5))
    pe = RelPE(32, dtype=torch.bfloat16)
    assert torch.equal(rel_pe_table(*args, pe, True), _chain(args, pe))


def test_selection_rule():
    fixed, learnable = RelPE(32), RelPE(32, learnable_pe=True, num_freq_bands=4)
    full = RelPE(32, fold_dup=False)
    with torch.no_grad():
        assert table_takes_kernel(fixed, True)
        assert not table_takes_kernel(fixed, False)
        assert not table_takes_kernel(learnable, True)
        assert not table_takes_kernel(full, True)
    assert not table_takes_kernel(fixed, True)  # grad mode on: training keeps its gradients


def test_cpu_counts_no_plain_build():
    args = (*_poses(1, 4, 6, seed=7), _idx(1, 4, 6, 5, seed=7))
    before = (rel_pe_table.launches, rel_pe_table.plain_builds)
    with torch.no_grad():
        rel_pe_table(*args, RelPE(16), True)
    assert (rel_pe_table.launches, rel_pe_table.plain_builds) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _assert_close(got, want):
    """f32: within F32_TOL. bf16: within one bf16 ulp of the plain value,
    or F32_TOL where that ulp is smaller (near zero the f32 statistics'
    own rounding is larger than a bf16 step)."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        assert float(err.max()) <= F32_TOL
        return
    exp = torch.frexp(want.float())[1]  # |want| in [2^(exp-1), 2^exp)
    ulp = torch.ldexp(torch.ones_like(err), exp - 8)
    bad = err > torch.clamp_min(ulp, F32_TOL)
    assert not bool(bad.any()), (float(err[bad].max()), int(bad.sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", sorted(SITES))
def test_kernel_matches_plain(cuda, site, dtype):
    Q, S, K = SITES[site]
    args = (*_poses(4, Q, S, seed=11, device=cuda), _idx(4, Q, S, K, seed=11, device=cuda,
                                                         pad_slots=S // 8))
    pe = RelPE(D, dtype=dtype).to(cuda)
    with torch.no_grad():
        want = rel_pe_table_plain(*args, pe)
        before = rel_pe_table.launches
        got = rel_pe_table(*args, pe, True)
        again = rel_pe_table(*args, pe, True)
    torch.cuda.synchronize()
    assert rel_pe_table.launches == before + 2
    assert got.dtype == dtype and got.shape == want.shape == (4, Q, K, 3 * D // 4)
    assert torch.equal(got, again)
    _assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_strided_sources_and_bf16_destination(cuda, dtype):
    """The policy's sources are views (scene.pos[:, m:]) read in place; the
    bf16 policy's destination poses are bf16."""
    Q, S, K, m = 64, 300, 96, 40
    dst_pos, dst_ori, src_pos, src_ori = _poses(3, Q, S + m, seed=13, device=cuda)
    idx = _idx(3, Q, S, K, seed=13, device=cuda)
    if dtype == torch.bfloat16:
        dst_pos, dst_ori = dst_pos.bfloat16(), dst_ori.bfloat16()
    args = (dst_pos, dst_ori, src_pos[:, m:], src_ori[:, m:], idx)
    pe = RelPE(D, dtype=dtype).to(cuda)
    with torch.no_grad():
        want = rel_pe_table_plain(*args, pe)
        got = rel_pe_table(*args, pe, True)
    _assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [12, 20, 130])
def test_kernel_other_widths(cuda, hidden, dtype):
    """hidden / 4 odd (12, 20: the lanes past it idle) and hidden not a
    multiple of 4 (130: the duplicated tail reaches into the second
    block), at K = 40 (a full and a partial chunk of 32 edges)."""
    args = (*_poses(2, 24, 50, seed=19, device=cuda), _idx(2, 24, 50, 40, seed=19, device=cuda))
    pe = RelPE(hidden, dtype=dtype).to(cuda)
    with torch.no_grad():
        want = rel_pe_table_plain(*args, pe)
        got = rel_pe_table(*args, pe, True)
    assert got.shape == want.shape == (2, 24, 40, 3 * (hidden // 4))
    _assert_close(got, want)


@pytest.mark.gpu
def test_kernel_refuses_outside_its_envelope(cuda):
    args = (*_poses(1, 4, 6, seed=17, device=cuda), _idx(1, 4, 6, 5, seed=17, device=cuda))
    with torch.no_grad():
        for hidden in (3, 136):  # no Fourier feature; more than a lane each
            with pytest.raises(ValueError, match="hidden_dim // 4"):
                rel_pe_table(*args, RelPE(hidden).to(cuda), True)


@pytest.mark.gpu
def test_closed_loop_takes_the_kernel(cuda):
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.utils.params import init_params

    cfg = get_config()
    model = ProSim(cfg, device="cuda")
    init_params(model, seed=0)
    batch = make_synthetic_batch(cfg, batch_size=2, num_replan=3, seed=1, device="cuda")
    R = int(batch.fut_obs.feat.shape[1])
    before = (rel_pe_table.launches, rel_pe_table.plain_builds)
    model(batch)
    torch.cuda.synchronize()
    assert (rel_pe_table.launches - before[0], rel_pe_table.plain_builds - before[1]) == (
        4 + 2 * R, 0)
