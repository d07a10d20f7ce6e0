"""The scene generator: one seed gives the same arrays, every seed the same
multiset of sizes, in the program's SceneBatch layout."""

import numpy as np

from conftest import tiny_cell


def _pool(seed, name="default.closed_loop_b64", calls=3):
    from benchmark.core import Tree
    from benchmark.traffic.generator import make_pool

    cell = tiny_cell(name)
    mix = dict(cell["mix"], calls=calls)
    return make_pool(mix, Tree(cell["config_file"]["config"]), seed), mix


def _leaves(d, prefix=""):
    for k, v in sorted(d.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        elif v is not None:
            yield prefix + k, v


def test_same_seed_same_arrays():
    a, _ = _pool(2**31 + 17)
    b, _ = _pool(2**31 + 17)
    c, _ = _pool(5)
    for x, y in zip(a, b):
        for (ka, va), (kb, vb) in zip(_leaves(x), _leaves(y)):
            assert ka == kb and np.array_equal(va, vb), ka
    assert not np.array_equal(a[0]["init_map"]["pos"], c[0]["init_map"]["pos"])


def test_counts_are_the_mix_ranges_for_every_seed():
    sizes = []
    for seed in (1, 2):
        pool, mix = _pool(seed, calls=4)
        obs = np.concatenate([p["init_obs"]["mask"].any(-1).sum(-1) for p in pool])
        slots = np.concatenate([p["init_map"]["mask"].any(-1).sum(-1) for p in pool])
        agents = np.concatenate([p["prompt"]["mask"].sum(-1) for p in pool])
        n = len(obs)
        want_obs = np.round(np.linspace(*mix["obs_agents"], n)).astype(int)
        want_slots = np.round(np.linspace(*mix["lane_slots"], n)).astype(int)
        assert sorted(obs) == sorted(want_obs)
        assert sorted(slots) == sorted(want_slots)
        pad = pool[0]["prompt"]["mask"].shape[1]
        assert (agents == np.minimum(obs, pad)).all()
        sizes.append(sorted(obs))
    assert sizes[0] == sizes[1]


def test_layout_matches_the_program():
    import torch

    from prosim_torch.data.batch import SceneBatch

    pool, _ = _pool(9)
    p = pool[0]
    batch = SceneBatch.from_numpy({k: v for k, v in p.items()
                                   if k not in ("world_xy", "world_h")})
    B = p["prompt"]["mask"].shape[0]
    assert batch.init_obs.feat.shape[-1] == 24 and batch.init_map.vectors.shape[-1] == 11
    assert batch.fut_obs.feat.shape[:2] == (B, 8)
    # policy agents are the first obs agents, each valid now
    idx = batch.prompt.obs_index.long()
    ok = batch.prompt.mask
    assert (idx[ok] == torch.arange(idx.shape[1]).expand_as(idx)[ok]).all()
    assert batch.init_obs.mask[:, :, -1].gather(1, idx.clamp_min(0))[ok].all()
    # map slots sit in their own frame: segments start near the slot centre
    v = batch.init_map.vectors[batch.init_map.mask]
    assert v[:, :4].abs().max() < 12.0
