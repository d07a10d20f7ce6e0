"""The flash-attention backward's compaction of valid rows, on the CPU.

On the card the backward (csrc/flash_attn_bwd.cu) works on each scene's
valid positions only: a prep launch lists them in order
(`valid_rows_plain` is that list's plain version), and the dkv and dq
kernels walk tiles of the list, fetching each row by its index. These tests
hold the list against numpy and show that the compaction is exact: the
plain backward run on the gathered valid rows with an all-true mask and
scattered back gives jax.grad of the JAX package's dense causal attention
(`prosim_tpu.models.llm.llama._causal_attention`) on every valid row and
exact zeros on pad rows. Compaction keeps order, so a key may be attended
from a query exactly when its rank is at most the query's. Tolerance: 1e-5
absolute and relative (f32 sums in another order), as
tests/test_torch_text_train.py holds the uncompacted backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.models.llm import llama as jllama
from prosim_torch.ops import flash_attn
from prosim_torch.ops.flash_attn import (
    causal_attention,
    causal_attention_bwd_plain,
    causal_attention_fwd_plain,
    valid_rows_plain,
)

ATTN_TOL = 1e-5  # abs and rel


def _mask(name, B, T, rng):
    m = np.zeros((B, T), bool)
    if name == "one_token":
        m[np.arange(B), rng.integers(0, T, B)] = True
    elif name == "prefix":
        for b in range(B):
            m[b, : rng.integers(1, T + 1)] = True
    elif name == "holed":  # the tokenizer's layout: text, pad, a half-on prompt block
        for b in range(B):
            m[b, : rng.integers(1, T // 2)] = True
            m[b, T - T // 4:] = rng.random(T // 4) > 0.5
    elif name == "all_valid":
        m[:] = True
    return m  # "all_pad": none


@pytest.mark.parametrize("name", ["all_pad", "one_token", "prefix", "holed", "all_valid"])
def test_valid_rows_are_each_scenes_valid_positions(name):
    """rows[b, :counts[b]] is numpy.flatnonzero(mask[b]), the rest -1."""
    rng = np.random.default_rng(len(name))
    mask = _mask(name, 5, 67, rng)
    rows, counts = valid_rows_plain(torch.from_numpy(mask))
    assert rows.dtype == counts.dtype == torch.int32
    for b in range(mask.shape[0]):
        want = np.flatnonzero(mask[b])
        n = int(counts[b])
        assert n == len(want)
        np.testing.assert_array_equal(rows[b, :n].numpy(), want)
        assert bool((rows[b, n:] == -1).all())


def _compacted_bwd(q, k, v, o, lse, do, mask, scale):
    """The backward as the card computes it: each scene's valid rows
    gathered in order (q, k, v, o, dO and lse), the plain backward with an
    all-true mask, the gradients scattered back into zeros."""
    rows, counts = valid_rows_plain(mask)
    grads = [torch.zeros_like(x) for x in (q, k, v)]
    for b in range(q.shape[0]):
        n = int(counts[b])
        if n == 0:
            continue
        idx = rows[b, :n].long()
        pick = lambda x: x[b:b + 1, idx]  # noqa: E731
        got = causal_attention_bwd_plain(
            pick(q), pick(k), pick(v), pick(o), lse[b:b + 1, :, idx], pick(do),
            torch.ones((1, n), dtype=torch.bool), scale)
        for g, x in zip(grads, got):
            g[b, idx] = x[0]
    return grads


@pytest.mark.parametrize("Hq,Hkv,D,T,name", [
    (4, 2, 16, 37, "holed"), (8, 2, 32, 70, "holed"), (4, 4, 16, 45, "prefix"),
    (4, 2, 16, 64, "one_token"), (8, 1, 16, 33, "all_valid"), (6, 6, 16, 41, "holed"),
    (5, 5, 8, 50, "prefix")])
def test_compacted_backward_matches_jax(Hq, Hkv, D, T, name):
    """dq, dk, dv of sum(out * g), g zero on pad rows, through the
    compacted plain backward against jax.grad of the JAX dense path (k/v
    repeated per group inside it) within ATTN_TOL on valid rows; exact
    zeros on pad rows. Scene 0 has no valid token."""
    rng = np.random.default_rng(Hq * 100 + T)
    B = 3
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    mask = _mask(name, B, T, rng)
    mask[0] = False
    g = (rng.normal(size=(B, T, Hq, D)) * mask[:, :, None, None]).astype(np.float32)
    scale = 1.0 / D ** 0.5
    rep = Hq // Hkv
    cfg = jllama.LlamaConfig.tiny()

    def jloss(q_, k_, v_):
        out = jllama._causal_attention(q_, jnp.repeat(k_, rep, axis=2), jnp.repeat(v_, rep, axis=2),
                                       jnp.asarray(mask), cfg, False)
        return (out * g).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tm, tg = (torch.from_numpy(x) for x in (q, k, v, mask, g))
    out, lse = causal_attention_fwd_plain(tq, tk, tv, tm, scale)
    got = _compacted_bwd(tq, tk, tv, out, lse, tg, tm, scale)
    for i, (x, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(x.numpy()[mask], np.asarray(r)[mask], atol=ATTN_TOL,
                                   rtol=ATTN_TOL, err_msg=f"d{'qkv'[i]}")
        assert float(x[~tm].abs().max()) == 0.0  # scene 0 at least is all pad
    # the uncompacted plain backward agrees with the compacted one
    full = causal_attention_bwd_plain(tq, tk, tv, out, lse, tg, tm, scale)
    for x, y in zip(got, full):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_backward_observers_see_each_backward():
    """CausalAttention's backward calls each of flash_attn.backward_observers
    once per backward with its inputs and the gradients it returns; the
    launch counter is the wrapper's own (on the CPU the plain backward runs
    and counts nothing)."""
    rng = np.random.default_rng(3)
    B, T, Hq, Hkv, D = 2, 23, 4, 2, 8
    mask = torch.from_numpy(_mask("holed", B, T, rng))
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, h, D)).astype(np.float32))
               .requires_grad_(True) for h in (Hq, Hkv, Hkv))
    g = torch.from_numpy(rng.normal(size=(B, T, Hq, D)).astype(np.float32)) * mask[..., None, None]
    seen, launches = [], flash_attn.causal_attention_bwd.launches
    flash_attn.backward_observers.append(lambda inputs, grads: seen.append((inputs, grads)))
    try:
        (causal_attention(q, k, v, mask, 0.3) * g).sum().backward()
    finally:
        flash_attn.backward_observers.clear()
    assert len(seen) == 1
    (q_, k_, v_, o, lse, do, m, scale), grads = seen[0]
    assert scale == 0.3 and torch.equal(m, mask) and torch.equal(do, g)
    assert all(torch.equal(a, b.detach()) for a, b in zip((q_, k_, v_), (q, k, v)))
    assert all(torch.equal(a, x.grad) for a, x in zip(grads, (q, k, v)))
    want = causal_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse, g, mask, 0.3)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert flash_attn.causal_attention_bwd.launches == launches
