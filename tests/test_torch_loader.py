"""The port's loader, packed transfer, preformat and scene bank on the CPU
(the cases of tests/test_loader.py and tests/test_scene_bank.py, which skip
without the demo cache, on a synthetic WOMD cache), and one train loss of
configs/no_text.yaml on a dataset batch against the JAX package's.

On the CPU the packed "copy" is a clone of the slab's buffer, so every case
that holds batches past a slab's reuse also shows that a batch never
aliases its slab. Tolerance: exact, except the train loss (1e-5 relative,
tests/test_torch_train.py's LOSS_RTOL).
"""

import numpy as np
import pytest
import torch

from prosim_torch.config import get_config
from prosim_torch.data.batch import to_tensors, tree_leaves
from prosim_torch.data.dataset import ProSimImitationDataset
from prosim_torch.data.formatter import collate, collate_host
from prosim_torch.data.loader import PackedTransfer, SlabCollator, pipelined_batches
from prosim_torch.data.scene_bank import DeviceSceneBank, banked_batches

from torch_data_common import SMALL, assert_trees_equal, build_cache, config_path

OPTS = SMALL + [
    "PROMPT.CONDITION.TYPES", "['goal', 'drag_point', 'v_action_tag', 'llm_text_OneText']",
    "PROMPT.CONDITION.SAMPLE_MODE.TRAIN", "fix",
    "PROMPT.CONDITION.SAMPLE_MODE.VAL", "fix",
    "PROMPT.CONDITION.RANDOM_SAMPLE.VAL", "True",
    "PROMPT.CONDITION.SAMPLE_RATE", "1.0",
]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return build_cache(str(tmp_path_factory.mktemp("synth")))[1]


@pytest.fixture(scope="module")
def ds(cache):
    return ProSimImitationDataset(get_config(opts=OPTS), split="val", cache_dir=cache)


def _same(a, b):
    assert_trees_equal(a, b, ref_is_jax=False)


def _singles(ds, idx, seed0=0):
    return [ds.get_scene_batch(i % len(ds), seed=seed0 + i, device=None) for i in idx]


def _get(ds):
    return lambda j, s: ds.get_scene_batch(j, seed=s, device=None)


# ----------------------------------------------------------------- slabs

@pytest.mark.parametrize("transfer", [None, "device"])
def test_slab_collate_matches_collate(ds, transfer):
    singles = _singles(ds, range(4))
    col = SlabCollator(singles[0], batch_size=4, device="cpu")
    got = col.collate(singles, transfer=transfer)
    _same(got, collate(singles))
    if transfer is None:  # host views into the slab's one buffer
        leaves = tree_leaves(got)
        assert all(isinstance(x, np.ndarray) for x in leaves)
        assert all(np.shares_memory(x, col.transfer.host[0]) for x in leaves if x.size)


def test_slab_rewrite_does_not_corrupt_held_batches(ds):
    """Yielded batches stay valid after their slab is rewritten (more than
    num_slabs later batches): the copy owns its memory."""
    B, K = 2, 2
    col = SlabCollator(_singles(ds, range(2))[0], batch_size=B, num_slabs=K, device="cpu")
    held, want = [], []
    for it in range(2 * K + 1):
        singles = _singles(ds, range(it * B, it * B + B), seed0=100)
        want.append(collate(singles))
        held.append(col.collate(singles, transfer="device"))
    for w, h in zip(want, held):
        _same(h, w)
    assert col.transfer.copies == 2 * K + 1


def test_slab_fallback_on_batch_size_mismatch(ds):
    singles = _singles(ds, range(3))
    col = SlabCollator(singles[0], batch_size=4, device="cpu")
    got = col.collate(singles, transfer="device")  # wrong count -> allocating collate
    assert got.init_obs.feat.shape[0] == 3 and col.transfer.copies == 0
    _same(got, collate(singles))


# -------------------------------------------------------------- pipeline

def test_pipelined_matches_sequential(ds):
    pairs = [(i % len(ds), 7 + i) for i in range(8)]
    seq = [collate([ds.get_scene_batch(j, seed=s, device=None) for j, s in pairs[k:k + 4]])
           for k in (0, 4)]
    for prefetch in (1, 3):
        piped = list(pipelined_batches(_get(ds), pairs, batch_size=4, prefetch=prefetch,
                                       device="cpu"))
        assert len(piped) == 2
        for w, h in zip(seq, piped):
            _same(h, w)


def test_pipelined_host_views(ds):
    """transfer=None yields host views, valid until num_slabs - 1 further
    batches: read each before the next."""
    pairs = [(i % len(ds), i) for i in range(8)]
    for k, got in enumerate(pipelined_batches(_get(ds), pairs, batch_size=4, transfer=None,
                                              prefetch=1, num_slabs=3, device="cpu")):
        assert isinstance(got.init_map.vectors, np.ndarray)
        _same(got, collate([ds.get_scene_batch(j, seed=s, device=None)
                            for j, s in pairs[4 * k:4 * k + 4]]))


def test_pipelined_yields_trailing_partial_group(ds):
    pairs = [(i % len(ds), i) for i in range(7)]
    out = list(pipelined_batches(_get(ds), pairs, batch_size=4, device="cpu"))
    assert [b.prompt.mask.shape[0] for b in out] == [4, 3]
    _same(out[1], collate([ds.get_scene_batch(j, seed=s, device=None) for j, s in pairs[4:]]))


def test_pipelined_drop_last_drops_partial(ds):
    pairs = [(i % len(ds), i) for i in range(7)]
    assert len(list(pipelined_batches(_get(ds), pairs, batch_size=4, drop_last=True,
                                      device="cpu"))) == 1


def test_pipelined_consumer_break_shuts_down(ds):
    import threading

    before = threading.active_count()
    pairs = [(i % len(ds), i) for i in range(64)]
    gen = pipelined_batches(_get(ds), pairs, batch_size=4, prefetch=1, device="cpu")
    next(gen)
    gen.close()  # must not hang: the producer observes the stop flag
    assert threading.active_count() <= before


def test_pipelined_propagates_worker_error(ds):
    def boom(j, s):
        if s >= 4:
            raise RuntimeError("scene exploded")
        return ds.get_scene_batch(j, seed=s, device=None)

    gen = pipelined_batches(boom, [(i % len(ds), i) for i in range(8)], batch_size=4,
                            device="cpu")
    next(gen)
    with pytest.raises(RuntimeError, match="scene exploded"):
        next(gen)


def test_dataset_batches_paths_agree(ds):
    a = list(ds.batches(4, shuffle=True, seed=3, num_workers=0, device="cpu"))
    b = list(ds.batches(4, shuffle=True, seed=3, num_workers=1, device="cpu"))
    c = list(ds.batches(4, shuffle=True, seed=3, num_workers=2, device="cpu"))
    assert len(a) == len(b) == len(c) == 3
    for x, y, z in zip(a, b, c):
        _same(y, x)
        _same(z, x)


# ------------------------------------------------------- packed transfer

def test_packed_transfer_matches_per_leaf_moves(ds):
    """One buffer, one copy: the same values and dtypes as per-leaf moves,
    across buffer reuse (more calls than buffers); a partial batch falls
    back to per-leaf moves; no output aliases a host buffer."""
    col = SlabCollator(_singles(ds, range(4))[0], 4, device="cpu")
    host = col.collate(_singles(ds, range(4)), transfer=None)
    pt = PackedTransfer(host, num_bufs=2, device="cpu")
    outs, refs = [], []
    for seed0 in (10, 20, 30):
        host = col.collate(_singles(ds, range(4), seed0), transfer=None)
        refs.append(to_tensors(host, "cpu"))
        outs.append(pt(host))
    assert pt.copies == 3
    for got, ref in zip(outs, refs):
        _same(got, ref)
        for x in tree_leaves(got):  # the views share the one copied buffer
            assert x.untyped_storage().data_ptr() == tree_leaves(got)[0].untyped_storage().data_ptr()
            assert not any(np.shares_memory(x.numpy(), h) for h in pt.host)
    part = collate_host(_singles(ds, range(3)))
    _same(pt(part), to_tensors(part, "cpu"))
    assert pt.copies == 3


def test_packed_transfer_dtype_rules():
    """int64/float64 leaves narrow to the probe's int32/float32 and still
    match; a float leaf in an int slot does not match (it would be
    value-converted) and goes by per-leaf moves with its values kept."""
    probe = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": np.ones((2, 2), np.float32),
             "c": np.ones((3,), bool)}
    pt = PackedTransfer(probe, device="cpu")
    assert pt.matches(probe)
    wide = {"a": np.arange(6, dtype=np.int64).reshape(2, 3), "b": np.ones((2, 2), np.float64),
            "c": np.array([True, False, True])}
    assert pt.matches(wide)
    out = pt(wide)
    assert out["a"].dtype == torch.int32 and out["b"].dtype == torch.float32
    assert out["c"].tolist() == [True, False, True]
    bad = dict(probe, a=np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3))
    assert not pt.matches(bad)
    np.testing.assert_allclose(pt(bad)["a"].numpy(), bad["a"])
    assert pt.copies == 1


def test_to_tensors_never_aliases():
    x = {"a": np.arange(4, dtype=np.float32)}
    out = to_tensors(x, "cpu")
    x["a"][:] = -1
    assert out["a"].tolist() == [0.0, 1.0, 2.0, 3.0]


# -------------------------------------------------------------- preformat

def test_preformat_matches_jax(cache, tmp_path):
    from prosim_tpu.config import get_config as jax_get_config
    from prosim_tpu.data.preformat import flatten_batch as jflatten
    from prosim_tpu.data.preformat import load_batch_npz as jload
    from prosim_tpu.data.preformat import preformat as jpreformat
    from prosim_torch.data.preformat import flatten_batch, load_batch_npz, preformat

    cfg = get_config(config_path("configs/waymo_demo.yaml"), SMALL)
    jcfg = jax_get_config(config_path("configs/waymo_demo.yaml"), SMALL)
    preformat(cfg, cache, str(tmp_path / "port"), "val")
    jpreformat(jcfg, cache, str(tmp_path / "jax"), "val")
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) and len(names) == 12
    ds = ProSimImitationDataset(cfg, "val", cache)
    like = ds.get_scene_batch(0, device=None)
    for name in names[:4]:
        got = np.load(tmp_path / "port" / name)
        ref = np.load(tmp_path / "jax" / name)
        assert sorted(got.files) == sorted(ref.files)
        for k in got.files:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        back = load_batch_npz(str(tmp_path / "port" / name), like)
        assert flatten_batch(back).keys() == got.keys()
    from prosim_tpu.data.dataset import ProSimImitationDataset as JaxDataset

    jlike = JaxDataset(jcfg, "val", cache).get_scene_batch(0, device=False)
    assert set(flatten_batch(like)) == set(jflatten(jlike))
    assert_trees_equal(load_batch_npz(str(tmp_path / "port" / names[0]), like),
                       jload(str(tmp_path / "jax" / names[0]), jlike))


# ------------------------------------------------------------- scene bank

def test_banked_equals_streaming(ds):
    pairs = [(i % len(ds), 100 + i) for i in range(7)]  # 7 scenes, batch 4
    bank = DeviceSceneBank(ds, device="cpu")
    banked = list(banked_batches(ds, pairs, batch_size=4, bank=bank, device="cpu"))
    assert [b.prompt.mask.shape[0] for b in banked] == [4, 3]
    for bi, lo in enumerate(range(0, 7, 4)):
        _same(banked[bi], collate([ds.get_scene_batch(i, seed=s, device=None)
                                   for i, s in pairs[lo:lo + 4]]))
    assert bank.bank_bytes == bank.per_scene_bytes * len(ds) + 8 * 4  # + t_indices


def test_bank_reuses_rows_across_seeds(ds):
    bank = DeviceSceneBank(ds, device="cpu")
    r1, c1 = bank.sample_conditions(0, seed=1)
    r2, c2 = bank.sample_conditions(0, seed=2)
    assert r1 == r2
    assert any(not np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
               for a, b in zip(tree_leaves(c1), tree_leaves(c2)))


def test_bank_keeps_format_cache_within_cap(cache):
    """Sampling a bank's conditions does not grow the dataset's format
    cache past its cap: the bank keeps on the host only what condition
    sampling reads (the prompt and io pairs), and its conditions are the
    streamed ones."""
    ds = ProSimImitationDataset(get_config(opts=OPTS), "val", cache)
    ds._fmt_cache_cap = 2
    bank = DeviceSceneBank(ds, device="cpu")
    assert all(b.init_map is None and b.fut_obs is None for b in bank.cond_bases)
    for i in range(len(ds)):
        _, conds = bank.sample_conditions(i, 50 + i)
        assert len(ds._fmt_cache) <= 2
        assert_trees_equal(conds, ds.get_scene_batch(i, seed=50 + i, device=None).conditions,
                           ref_is_jax=False)


def test_bank_refuses_seed_dependent_scenes_and_budget(cache):
    cfg = get_config(opts=OPTS + ["DATASET.AGENT.SCENE_MAX_AGENT", "4"])
    with pytest.raises(ValueError, match="seed-dependent"):
        DeviceSceneBank(ProSimImitationDataset(cfg, "train", cache), device="cpu")
    ds = ProSimImitationDataset(get_config(opts=OPTS), "val", cache)
    with pytest.raises(ValueError, match="budget"):
        DeviceSceneBank(ds, budget_bytes=1024, device="cpu")


def test_bank_transports_agree(ds):
    """The bank's one packed copy of rows and conditions gives the batch
    that per-leaf moves of the streamed scenes give, with one packed
    transfer per layout, reused."""
    bank = DeviceSceneBank(ds, device="cpu")
    rows, conds = zip(*(bank.sample_conditions(i, 900 + i) for i in range(4)))
    rows = np.asarray(rows)
    want = to_tensors(collate_host([ds.get_scene_batch(i, seed=900 + i, device=None)
                                    for i in range(4)]), "cpu")
    for _ in range(2):
        _same(bank.assemble(rows, list(conds)), want)
    assert len(bank._transfers) == 1
    assert next(iter(bank._transfers.values())).copies == 2


def test_producers_share_one_bank(ds):
    """More banked streams than cores (up to 17) over one bank, run together
    with a short thread switch interval: each batch equals its streamed twin
    (the lock covers each whole packed copy, so no stream gets another's
    rows or conditions)."""
    import os
    import sys
    import threading

    bank = DeviceSceneBank(ds, device="cpu")
    n = min(len(os.sched_getaffinity(0)), 16) + 1  # more streams than cores (up to 16)
    pairs = {k: [((3 * i + k) % len(ds), 1000 * k + i) for i in range(16)] for k in range(n)}
    got = {}

    def run(k):
        got[k] = list(banked_batches(ds, pairs[k], 4, bank=bank, prefetch=1, device="cpu"))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and sorted(got) == list(range(n))
    for k in range(n):
        assert len(got[k]) == 4
        for b, lo in zip(got[k], range(0, 16, 4)):
            _same(b, collate([ds.get_scene_batch(i, seed=s, device=None)
                              for i, s in pairs[k][lo:lo + 4]]))


# ------------------------------------------------------ training end to end

TRAIN_OPTS = [  # tests/test_torch_train.py's SMALL_OPTS + NO_DROPOUT
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1", "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1", "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "2", "MODEL.DECODER.ATTN.FF_DIM", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "2", "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "4", "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.SCENE_ENCODER.ATTN.DROPOUT", "0.0", "MODEL.DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.POLICY.ACT_DECODER.ATTN.DROPOUT", "0.0", "MODEL.CONDITION_TRANSFORMER.DROPOUT", "0.0",
]
LOSS_RTOL = 1e-5


def test_train_loss_on_a_dataset_batch_matches_jax(cache):
    """configs/no_text.yaml's train loss (paired_mse_k) on a B=2 train-split
    dataset batch (goal, v_action_tag and drag_point drawn by each package's
    ConditionGenerator), the port against the JAX train step's loss with the
    same flax params: every term within 1e-5 relative."""
    import jax

    from prosim_tpu.config import get_config as jax_get_config
    from prosim_tpu.data.dataset import ProSimImitationDataset as JaxDataset
    from prosim_tpu.models.prosim import ProSim as JaxProSim
    from prosim_tpu.train import losses as jlosses
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.train.losses import paired_mse_k
    from prosim_torch.utils.params import load_flax_params

    yaml = config_path("configs/no_text.yaml")
    cfg, jcfg = get_config(yaml, SMALL + TRAIN_OPTS), jax_get_config(yaml, SMALL + TRAIN_OPTS)
    batch = next(ProSimImitationDataset(cfg, "train", cache).batches(2, device="cpu"))
    jbatch = next(JaxDataset(jcfg, "train", cache).batches(2))
    assert sorted(batch.conditions) == ["drag_point", "goal", "v_action_tag"]
    jm = JaxProSim(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jbatch)

    def loss_fn(p, b, k):
        return jlosses.loss_func_dict[jcfg.TASK.MOTION_PRED.LOSS](
            b, jm.forward(p, b, "train", k), jcfg)

    ref = jax.tree.map(np.asarray, jax.jit(loss_fn)(params, jbatch, jax.random.PRNGKey(1)))
    tm = ProSim(cfg, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    got = paired_mse_k(batch, tm.forward_train(batch, seed=0), cfg)
    assert set(got) == set(ref) and np.isfinite(got["full_loss"].item())
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, rtol=LOSS_RTOL, atol=0, err_msg=k)
    got["full_loss"].backward()
    assert all(p.grad is not None for n, p in tm.named_parameters() if "goal_pred" not in n)
