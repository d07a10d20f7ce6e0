"""Shared pieces of the port's data-pipeline tests (tests/test_torch_data.py,
test_torch_loader.py, test_torch_conditions_gen.py): the small padding of
tests/test_scale_path.py, a synthetic WOMD cache built by the port's
womd_synth -> womd_ingest (12 scenes in 3 shards, seed 7), and exact tree
comparisons between the port's containers and the JAX package's."""

import os

import jax.tree_util as jtu
import numpy as np
import torch

from prosim_torch.data.batch import tree_leaves_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [None, "configs/no_text.yaml", "configs/with_text.yaml", "configs/waymo_demo.yaml"]
ENV = "waymo_train"
# tests/test_scale_path.py's padding; every split reads the one synthetic env
SMALL = [
    "DATASET.SOURCE.TRAIN", f"['{ENV}']",
    "DATASET.SOURCE.VAL", f"['{ENV}']",
    "DATASET.SOURCE.ROLLOUT", f"['{ENV}']",
    "DATASET.FORMAT.MAP.MAX_POINTS", "128",
    "DATASET.FORMAT.PAD.NUM_LANES", "128",
    "DATASET.FORMAT.PAD.NUM_OBS_AGENTS", "24",
    "DATASET.FORMAT.PAD.NUM_AGENTS", "16",
    "DATASET.AGENT.SCENE_MAX_AGENT", "16",
]


def config_path(yaml):
    return os.path.join(REPO, yaml) if yaml else None


def build_cache(root, n_scenes=12, n_shards=3, seed=7):
    """(shard paths, cache dir) of a synthetic cache written by the port."""
    from prosim_torch.data import womd_ingest, womd_synth

    shards = womd_synth.synthesize_shards(os.path.join(root, "shards"), n_scenes=n_scenes,
                                          n_shards=n_shards, seed=seed)
    cache = os.path.join(root, "cache")
    assert len(womd_ingest.ingest_shards(shards, cache, ENV)) == n_scenes
    return shards, cache


def scale_weight_matrices(params, scale):
    """A flax params tree with every leaf of two or more axes (the weight
    matrices and embeddings) multiplied by `scale`; biases and norms kept."""
    return jtu.tree_map(lambda x: (np.asarray(x) * scale).astype(np.asarray(x).dtype)
                        if np.ndim(x) >= 2 else x, params)


def as_numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_paths(tree):
    """[(path tuple, leaf)] of a JAX container, keyed as the port keys its
    own (field names and dict keys)."""
    return [(tuple(str(getattr(q, "key", getattr(q, "name", q))) for q in p), leaf)
            for p, leaf in jtu.tree_leaves_with_path(tree)]


def assert_trees_equal(port, ref, narrow=False, ref_is_jax=True):
    """Every leaf of a port container equals the reference container's leaf
    at the same path (a JAX container, or with ref_is_jax=False a port one),
    bit for bit (NaNs in the same places) and in dtype; narrow=True narrows
    the reference's int64/float64 first."""
    got = tree_leaves_with_path(port)
    want = jax_paths(ref) if ref_is_jax else tree_leaves_with_path(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = as_numpy(a), as_numpy(b)
        if narrow:
            b = b.astype({np.dtype(np.int64): np.int32,
                          np.dtype(np.float64): np.float32}.get(b.dtype, b.dtype))
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=str(path))
