"""The port's two kernels: their plain versions against the JAX functions
and the TPU kernels run in Pallas interpret mode, on the CPU. The CUDA
kernels themselves are held against the plain versions on a card in
tests/test_torch_cuda.py.

Tolerances: neighbor top-K exactly (idx and valid, bit for bit); the edge
core 1e-5 in f32 (sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.ops.edge_attn import edge_attn_core as jax_edge_attn_core
from prosim_tpu.ops.neighbors import neighbor_topk as jax_neighbor_topk
from prosim_tpu.ops.pallas_topk import neighbor_topk_pallas
from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
from prosim_torch.ops.neighbors import neighbor_topk, neighbor_topk_plain, pairwise_d2


def _host(tree):
    """A JAX result as numpy arrays. JAX dispatches asynchronously on the CPU;
    a torch computation that ran while a JAX one was still in flight came out
    sporadically imprecise (~2e-5 instead of ~2e-7, about one process in 40),
    so every reference is on the host before the port's side runs."""
    return jax.tree.map(np.asarray, tree)


def _topk_case(name):
    """(dst_pos, src_pos, dst_mask, src_mask, k, radius, exclude_self)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    B, Q, S = 2, 24, 40
    pos = lambda n: (rng.normal(size=(B, n, 2)) * 30).astype(np.float32)
    msk = lambda n: rng.random((B, n)) > 0.2
    if name == "random":
        return pos(Q), pos(S), msk(Q), msk(S), 8, None, False
    if name == "radius":
        return pos(Q), pos(S), msk(Q), msk(S), 12, 25.0, False
    if name == "exclude_self":
        p, m = pos(S), msk(S)
        return p, p, m, m, 10, 40.0, True
    if name == "k_exceeds_sources":
        return pos(Q), pos(S), msk(Q), msk(S), 64, None, False
    if name == "duplicated_positions":
        # grid points repeated: many exactly equal distances, ties to the lower index
        src = np.round(pos(S) / 20) * 20
        src[:, S // 2:] = src[:, : S - S // 2]
        return np.round(pos(Q) / 20) * 20, src, msk(Q), msk(S), 16, 30.0, False
    if name == "all_invalid_rows":
        dm, sm = msk(Q), msk(S)
        dm[0, :3] = False
        sm[1] = False  # scene 1 has no valid source at all
        return pos(Q), pos(S), dm, sm, 8, 50.0, False
    raise KeyError(name)


TOPK_CASES = ["random", "radius", "exclude_self", "k_exceeds_sources",
              "duplicated_positions", "all_invalid_rows"]


@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_plain_matches_jax_exactly(case):
    dp, sp, dm, sm, k, r, ex = _topk_case(case)
    ji, jv = _host(jax_neighbor_topk(jnp.asarray(dp), jnp.asarray(sp), jnp.asarray(dm),
                                     jnp.asarray(sm), k=k, radius=r, exclude_self=ex))
    ti, tv = neighbor_topk_plain(*map(torch.from_numpy, (dp, sp, dm, sm)), k, radius=r,
                                 exclude_self=ex)
    assert ti.dtype == torch.int32 and tv.dtype == torch.bool
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)


@pytest.mark.parametrize("case", ["random", "radius", "k_exceeds_sources",
                                  "duplicated_positions", "all_invalid_rows"])
def test_topk_plain_matches_pallas_interpret(case):
    dp, sp, dm, sm, k, r, _ = _topk_case(case)
    pi, pv = _host(neighbor_topk_pallas(jnp.asarray(dp), jnp.asarray(sp), jnp.asarray(dm),
                                        jnp.asarray(sm), k, radius=r, q_tile=8, interpret=True))
    ti, tv = neighbor_topk_plain(*map(torch.from_numpy, (dp, sp, dm, sm)), k, radius=r)
    eff_k = ti.shape[-1]  # the Pallas kernel pads its output back to k
    pv = pv[..., :eff_k]
    np.testing.assert_array_equal(tv.numpy(), pv)
    # indices of invalid slots are arbitrary in the Pallas kernel
    np.testing.assert_array_equal(np.where(pv, ti.numpy(), -1),
                                  np.where(pv, pi[..., :eff_k], -1))


# the six graph sites of the demo configuration: (Q, S, k, radius, exclude_self),
# as chip_smoke.py builds them (scene encoder a2a/s2s, decoder p2p/s2p,
# policy a2p/m2p) at the demo padding
DEMO_SITES = {
    "a2a": (160, 160, 100, None, False),
    "s2s": (2208, 2208, 32, None, False),
    "p2p": (128, 128, 512, 300.0, True),
    "s2p": (128, 2208, 512, 300.0, False),
    "a2p": (128, 160, 768, 100.0, False),
    "m2p": (128, 2048, 768, 50.0, False),
}


@pytest.mark.parametrize("site", sorted(DEMO_SITES))
def test_topk_plain_matches_jax_at_demo_sites(site):
    """Bit-equal at the demo sites' full shapes (B=1), positions spread over
    the demo scenes' ~100 m, a fifth of the tokens masked."""
    Q, S, k, r, ex = DEMO_SITES[site]
    rng = np.random.default_rng(sum(map(ord, site)))
    src = (rng.normal(size=(1, S, 2)) * 60).astype(np.float32)
    sm = rng.random((1, S)) > 0.2
    dst, dm = (src[:, :Q], sm[:, :Q]) if ex else (
        (rng.normal(size=(1, Q, 2)) * 60).astype(np.float32), rng.random((1, Q)) > 0.2)
    ji, jv = _host(jax_neighbor_topk(*map(jnp.asarray, (dst, src, dm, sm)), k=k, radius=r,
                                     exclude_self=ex))
    ti, tv = neighbor_topk_plain(*map(torch.from_numpy, (dst, src, dm, sm)), k, radius=r,
                                 exclude_self=ex)
    assert ti.shape == (1, Q, min(k, S))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_pairwise_d2_bits_match_jax():
    """d2 as XLA:CPU rounds it inside the jitted neighbor_topk (the fused
    square-and-sum contracts to fma(dy, dy, dx * dx))."""
    rng = np.random.default_rng(11)
    dst = (rng.normal(size=(2, 64, 2)) * 60).astype(np.float32)
    src = (rng.normal(size=(2, 96, 2)) * 60).astype(np.float32)
    ref = _host(jax.jit(lambda a, b: jnp.sum((a[:, :, None] - b[:, None]) ** 2, axis=-1))(dst, src))
    got = pairwise_d2(torch.from_numpy(dst), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


def _double_rounding_case():
    """dy*dy lands exactly on a float32 tie and dx*dx = 2**-80 lies below
    float64's ulp there: the single-rounded fma rounds up, a float64 sum
    rounded again to float32 rounds down and ties with source 1."""
    dy = np.float32(1 + 2**-12)
    dst = np.zeros((1, 1, 2), np.float32)
    src = np.array([[[2**-40, dy], [0.0, dy]]], np.float32)
    return dst, src, np.ones((1, 1), bool), np.ones((1, 2), bool)


def test_pairwise_d2_rounds_once_like_jax():
    dst, src, dm, sm = _double_rounding_case()
    ref = _host(jax.jit(lambda a, b: jnp.sum((a[:, :, None] - b[:, None]) ** 2, axis=-1))(dst, src))
    got = pairwise_d2(torch.from_numpy(dst), torch.from_numpy(src)).numpy()
    assert got[0, 0, 0] == np.float32(1 + 2**-11 + 2**-23)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    ji, _ = _host(jax_neighbor_topk(*map(jnp.asarray, (dst, src, dm, sm)), k=2))
    ti, _ = neighbor_topk_plain(*map(torch.from_numpy, (dst, src, dm, sm)), 2)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ji[0, 0], [1, 0])


def test_topk_wrapper_takes_plain_version_on_cpu():
    dp, sp, dm, sm, k, r, ex = _topk_case("radius")
    args = list(map(torch.from_numpy, (dp, sp, dm, sm)))
    before = neighbor_topk.launches
    a = neighbor_topk(*args, k, radius=r, exclude_self=ex)
    b = neighbor_topk_plain(*args, k, radius=r, exclude_self=ex)
    assert neighbor_topk.launches == before  # no kernel launched
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card raises instead of running the plain version."""
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        neighbor_topk(meta(1, 4, 2), meta(1, 5, 2), meta(1, 4, dtype=torch.bool),
                      meta(1, 5, dtype=torch.bool), 3)
    with pytest.raises(ValueError):
        edge_attn_core(meta(1, 2, 3, 8), meta(1, 2, 3, 6), meta(1, 2, 2, 8),
                       meta(1, 2, 2, 6), meta(1, 2, 3, dtype=torch.bool), 0.5)


def _edge_inputs(B=2, Q=16, K=128, D=128, Dp=96, H=8, seed=0):
    rng = np.random.default_rng(seed)
    x_g = rng.normal(size=(B, Q, K, D)).astype(np.float32)
    z_r = rng.normal(size=(B, Q, K, Dp)).astype(np.float32)
    qx = (rng.normal(size=(B, Q, H, D)) * 0.1).astype(np.float32)
    qp = (rng.normal(size=(B, Q, H, Dp)) * 0.1).astype(np.float32)
    valid = rng.random((B, Q, K)) > 0.3
    valid[0, 3] = False  # a row with no valid edge
    return x_g, z_r, qx, qp, valid


def _xla_branch(x_g, z_r, qx, qp, bias, valid, scale):
    """The XLA branch of prosim_tpu GatedNeighborAttention, score bias included
    (prosim_tpu/ops/attention.py:348-366)."""
    sim = (jnp.einsum("bqhd,bqkd->bqkh", qx, x_g) + jnp.einsum("bqhd,bqkd->bqkh", qp, z_r)
           + bias[:, :, None]) * scale
    sim = jnp.where(valid[..., None], sim, -jnp.inf)
    m = jnp.max(sim, axis=2, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    e = jnp.where(valid[..., None], jnp.exp(sim - m), 0.0)
    attn = e / jnp.maximum(e.sum(axis=2, keepdims=True), 1e-9)
    return (jnp.einsum("bqkh,bqkd->bqhd", attn, x_g),
            jnp.einsum("bqkh,bqkd->bqhd", attn, z_r), attn.sum(axis=2))


@pytest.mark.parametrize("Dp", [128, 96])
def test_edge_plain_matches_pallas_interpret(Dp):
    args = _edge_inputs(Dp=Dp)
    scale = 16.0 ** -0.5
    ref = _host(jax_edge_attn_core(*map(jnp.asarray, args), scale, interpret=True))
    got = edge_attn_core_plain(*map(torch.from_numpy, args), scale)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("K", [32, 100, 768])
def test_edge_plain_matches_xla_branch(K):
    """Any K, D != Dp, and the per-query bias cancelling in the softmax."""
    x_g, z_r, qx, qp, valid = _edge_inputs(B=1, Q=8, K=K, seed=K)
    bias = np.random.default_rng(1).normal(size=(1, 8, 8)).astype(np.float32)
    scale = 0.25
    ref = _host(_xla_branch(*map(jnp.asarray, (x_g, z_r, qx, qp, bias, valid)), scale))
    got = edge_attn_core_plain(*map(torch.from_numpy, (x_g, z_r, qx, qp, valid)), scale)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5)
    assert float(got[0][0, 3].abs().max()) == 0.0 and float(got[2][0, 3].max()) == 0.0
