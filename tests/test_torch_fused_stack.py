"""prosim_torch's fused two-site policy stack (ops/fused_stack.py) against
prosim_tpu's: the packed weights, the Fourier constants, the normalized
rel-PE table the CUDA kernel stores, the stack against the Pallas kernel
run in interpret mode, and the stack against the port's own layer loop;
on the CPU the wrapper runs its plain version. The
FUSED_STACK=True closed loop against the JAX package is in
test_torch_model.py.

Tolerances: 1e-6 for the packed fields (the same products, sums taken in
another order); 1e-5 for the stack against the Pallas kernel (the
per-module bar of test_torch_ops.py); 3e-4 against the layer loop, the bar
tests/test_fused_stack.py holds the TPU kernel to (the loop folds the
weights onto the queries and the duplicated rel-PE block onto its twin,
so the two forms round apart).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosim_tpu.ops import fused_stack as jfs
from prosim_tpu.ops.attention import GatedNeighborAttention as JaxGNA
from prosim_tpu.ops.attention import gather_src_features as jax_gather
from prosim_torch.ops import fused_stack as tfs
from prosim_torch.ops.attention import GatedNeighborAttention, RelPE, normalize_rel_pe
from prosim_torch.utils.params import load_flax_params

L, H, HD, D = 2, 4, 8, 32  # the shapes of tests/test_fused_stack.py
PACK_TOL = dict(atol=1e-6, rtol=1e-6)
PLAIN_TOL = dict(atol=1e-5, rtol=1e-5)
LOOP_TOL = dict(atol=3e-4, rtol=3e-4)


class JaxTwoSite(fnn.Module):
    """The flax layers of an interleaved a2p/m2p stack (only the params are used)."""

    @fnn.compact
    def __call__(self, x, src, idx, valid, pe):
        for i in range(L):
            for site in ("a2p", "m2p"):
                x = JaxGNA(hidden_dim=D, num_heads=H, head_dim=HD, bipartite=True,
                           name=f"{site}_{i}")(x, src, idx, valid, pe)
        return x


class TorchTwoSite(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for i in range(L):
            for site in ("a2p", "m2p"):
                self.add_module(f"{site}_{i}", GatedNeighborAttention(D, H, HD, bipartite=True))


@pytest.fixture(scope="module")
def stacks():
    """Perturbed flax params of both sites' layers, and the torch stack carrying them."""
    rng = np.random.default_rng(0)
    B, N, S, K = 1, 3, 4, 2
    args = (rng.normal(size=(B, N, D)), rng.normal(size=(B, S, D)),
            rng.integers(0, S, (B, N, K)), rng.random((B, N, K)) > 0.3,
            rng.normal(size=(B, N, K, D)))
    args = [jnp.asarray(a, jnp.float32 if a.dtype == np.float64 else None) for a in args]
    params = JaxTwoSite().init(jax.random.PRNGKey(0), *args)["params"]
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(p.size), p.shape), params)
    params = jax.tree.map(np.asarray, params)
    module = TorchTwoSite()
    load_flax_params(module, params)
    return params, module


def _inputs(seed, B, N, Sa, Ka, Sm, Km, empty_rows):
    """x [B,N,D] and each site's (src, idx, feats, valid) as numpy; feats are
    the reference's 4 raw rel-PE features (dist, rel_ori, rel_ori_vec twice)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    tables = []
    for S, K in ((Sa, Ka), (Sm, Km)):
        src = rng.normal(size=(B, S, D)).astype(np.float32)
        idx = rng.integers(0, S, (B, N, K)).astype(np.int32)
        valid = rng.random((B, N, K)) > 0.2
        for b, n in empty_rows:
            valid[b, n] = False
        v = rng.uniform(-np.pi, np.pi, (B, N, K))
        feats = np.stack([rng.uniform(0, 50, (B, N, K)), rng.uniform(-np.pi, np.pi, (B, N, K)),
                          v, v], -1).astype(np.float32)
        tables.append((src, idx, feats, valid))
    return x, tables


def _torch_tables(tables):
    return [tuple(torch.from_numpy(a) for a in t) for t in tables]


@pytest.mark.parametrize("site", ["a2p", "m2p"])
def test_pack_site_weights_matches_jax(stacks, site):
    params, module = stacks
    ref = jax.tree.map(np.asarray, jfs.pack_site_weights(params, site, L, H, HD, jnp.float32))
    got = tfs.pack_site_weights(module, site)
    assert len(got) == len(ref) == len(tfs._FIELDS)
    for name, g, r in zip(tfs._FIELDS, got, ref):
        assert tuple(g.shape) == r.shape, name
        assert g.is_contiguous(), name
        np.testing.assert_allclose(g.detach().numpy(), r, err_msg=name, **PACK_TOL)


@pytest.mark.parametrize("num_features,pe_dim", [(4, 32), (4, 128), (3, 96)])
def test_fourier_consts_match_jax(num_features, pe_dim):
    m1, phase = tfs.fourier_consts(num_features, pe_dim)
    jm1, jphase = jfs.fourier_consts(num_features, pe_dim)
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jm1))
    np.testing.assert_array_equal(phase.numpy(), np.asarray(jphase))


@pytest.mark.parametrize("num_features,pe_dim", [(4, 96), (4, 32)])
def test_z_from_feats_matches_jax(num_features, pe_dim):
    """The normalized fixed rel-PE table that the CUDA kernel stores once per
    call, against the TPU kernel's: distances up to 200 m, so the sines'
    arguments reach several hundred radians."""
    rng = np.random.default_rng(pe_dim)
    E = 4096
    v = rng.uniform(-np.pi, np.pi, E)
    feats = np.stack([rng.uniform(0, 200, E), rng.uniform(-np.pi, np.pi, E), v, v],
                     -1)[:, :num_features].astype(np.float32)
    m1, phase = jfs.fourier_consts(num_features, pe_dim)
    ref = np.asarray(jfs._z_from_feats(jnp.asarray(feats), m1, phase, jnp.float32))
    got = tfs._z_from_feats(torch.from_numpy(feats), pe_dim)
    assert got.shape == (E, pe_dim)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


CASES = {  # name: (B, N, Sa, Ka, Sm, Km, rows with no valid edge)
    "jax_test_shapes": (2, 8, 12, 5, 24, 7, [(0, 3)]),
    "ragged_n": (2, 11, 12, 5, 24, 9, [(0, 0), (1, 10)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(stacks, case):
    params, module = stacks
    B, N, Sa, Ka, Sm, Km, empty = CASES[case]
    x, tables = _inputs(7, B, N, Sa, Ka, Sm, Km, empty)
    jt = [(jax_gather(jnp.asarray(src), jnp.asarray(idx)), jnp.asarray(feats),
           jnp.asarray(valid, jnp.float32)) for src, idx, feats, valid in tables]
    ref = np.asarray(jfs.fused_two_site_stack(
        jnp.asarray(x), jt[0], jt[1],
        jfs.pack_site_weights(params, "a2p", L, H, HD, jnp.float32),
        jfs.pack_site_weights(params, "m2p", L, H, HD, jnp.float32),
        num_layers=L, num_heads=H, head_dim=HD, pe_dim=D, q_tile=8, interpret=True))
    before = tfs.fused_two_site_stack.launches
    with torch.inference_mode():
        got = tfs.fused_two_site_stack(
            torch.from_numpy(x), *_torch_tables(tables), tfs.pack_site_weights(module, "a2p"),
            tfs.pack_site_weights(module, "m2p"), num_heads=H, head_dim=HD)
    assert tfs.fused_two_site_stack.launches == before  # the CPU runs the plain version
    assert got.shape == (B, N, D)
    np.testing.assert_allclose(got.numpy(), ref, **PLAIN_TOL)


def test_plain_ignores_idx_of_invalid_edges(stacks):
    """idx is arbitrary where an edge is invalid: out-of-range values there
    (-1 and S + 7) leave the plain stack's result exactly as it was."""
    _, module = stacks
    x, tables = _inputs(5, 2, 8, 12, 5, 24, 7, [(0, 3)])
    poisoned = []
    for src, idx, feats, valid in tables:
        bad = np.where(np.arange(idx.shape[-1]) % 2 == 0, -1, src.shape[1] + 7)
        poisoned.append((src, np.where(valid, idx, bad).astype(np.int32), feats, valid))
    w = tfs.pack_site_weights(module, "a2p"), tfs.pack_site_weights(module, "m2p")
    with torch.inference_mode():
        got = tfs.fused_two_site_stack(torch.from_numpy(x), *_torch_tables(poisoned), *w,
                                       num_heads=H, head_dim=HD)
        ref = tfs.fused_two_site_stack(torch.from_numpy(x), *_torch_tables(tables), *w,
                                       num_heads=H, head_dim=HD)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_plain_matches_port_layer_loop(stacks):
    """The plain stack (per-edge k|v projections, rel-PE expanded from the
    raw features) against the port's GatedNeighborAttention loop (weights
    folded onto the queries, the rel-PE embedded by RelPE)."""
    _, module = stacks
    x, tables = _inputs(11, 2, 9, 12, 6, 30, 10, [(1, 4)])
    x = torch.from_numpy(x)
    tt = _torch_tables(tables)
    with torch.inference_mode():
        got = tfs.fused_two_site_stack_plain(
            x, *tt, tfs.pack_site_weights(module, "a2p"), tfs.pack_site_weights(module, "m2p"),
            num_heads=H, head_dim=HD)
        relpe = RelPE(D)  # 4 features x D/4 = D dims, nothing folded
        ref = x
        for i in range(L):
            for site, (src, idx, feats, valid) in zip(("a2p", "m2p"), tt):
                ref = getattr(module, f"{site}_{i}")(
                    ref, src, idx, valid, normalize_rel_pe(relpe(feats), D))
    torch.testing.assert_close(got, ref, **LOOP_TOL)


def test_wrapper_refuses_other_devices(stacks):
    """On a CPU tensor the wrapper runs the plain version; on any device
    other than the CPU or a CUDA card it raises instead of running anything."""
    _, module = stacks
    x, tables = _inputs(3, 1, 4, 5, 3, 6, 4, [])
    meta = [tuple(torch.from_numpy(a).to("meta") for a in t) for t in tables]
    w = [t.detach().to("meta") for t in tfs.pack_site_weights(module, "a2p")]
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.fused_two_site_stack(torch.from_numpy(x).to("meta"), *meta, w, w,
                                 num_heads=H, head_dim=HD)


# ------------------------------------------------------------ in the policy

POLICY_OPTS = [
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1",
    "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "2",
    "MODEL.HIDDEN_DIM", "32",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True",
]
BATCH_KW = dict(batch_size=2, num_lanes=16, num_obs_agents=10, num_agents=6, num_replan=2)


@pytest.fixture(scope="module")
def fused_model():
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.utils.params import init_params

    cfg = get_config(opts=POLICY_OPTS)
    model = ProSim(cfg, device="cpu")
    init_params(model, seed=0)
    return model, make_synthetic_batch(cfg, seed=4, device="cpu", **BATCH_KW)


def test_policy_fused_branch_matches_layer_loop(fused_model):
    """The policy's fused branch (3 rel-PE features + the re-appended
    duplicate, expanded in the stack) against its layer loop (3 features,
    the duplicate's parameter rows folded) on one scene."""
    model, batch = fused_model
    policy = model.policy
    assert policy.uses_fused_stack()
    p = batch.prompt
    with torch.inference_mode():
        scene, emd = model.prepare(batch)
        graphs = policy.site_graphs(scene, p.pos, p.mask)
        got = policy._attn_fuse(emd["emd"], scene, p.pos, p.ori, p.mask)
        ref = policy.layer_loop(emd["emd"], scene, p.pos, p.ori, graphs)
    assert not bool(graphs[0][1][~p.mask].any())  # padding agents have no edges
    torch.testing.assert_close(got, ref, **LOOP_TOL)


def test_rollout_packs_weights_once(fused_model, monkeypatch):
    """The fused stack's weights are packed once per rollout, not per step."""
    from prosim_torch.models import policy as policy_mod

    model, batch = fused_model
    calls = []

    def counting_pack(module, site, *dtype):
        calls.append(site)
        return tfs.pack_site_weights(module, site, *dtype)

    monkeypatch.setattr(policy_mod, "pack_site_weights", counting_pack)
    out = model(batch)
    assert sorted(calls) == ["a2p", "m2p"]
    assert out["rollout_traj"].shape[2] == BATCH_KW["num_replan"] * model.replan
    assert bool(torch.isfinite(out["rollout_traj"]).all())
