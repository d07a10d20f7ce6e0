"""The port's host data pipeline against prosim_tpu's, on the CPU: the
readers (tfrecord, protos, trajdata cache), WOMD ingest and synthesis, the
native lane engine, the formatter, the dataset and get_cond_set_config; and
the slice end to end (a dataset batch through both packages' closed loops).

Inputs: synthetic WOMD shards -> each package's ingest -> trajdata caches
(12 scenes in 3 shards, seed 7, tests/test_scale_path.py's padding). The
JAX package's demo-cache tests skip without the reference's demo cache;
these do not.
Tolerance: exact (assert_array_equal, dtypes equal) for everything but the
rollout, which is held to tests/test_torch_model.py's 1e-3 m: the same
numpy runs on the same inputs in both packages.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from prosim_torch import native
from prosim_torch.config import get_cond_set_config, get_config
from prosim_torch.data import formatter, tfrecord, trajdata_cache, womd_ingest, womd_synth
from prosim_torch.data.batch import SceneBatch, tree_leaves_with_path
from prosim_torch.data.dataset import ProSimDataset, ProSimImitationDataset

from prosim_tpu.config import get_cond_set_config as jax_get_cond_set_config
from prosim_tpu.config import get_config as jax_get_config
from prosim_tpu.data import formatter as jformatter
from prosim_tpu.data import tfrecord as jtfrecord
from prosim_tpu.data import trajdata_cache as jtrajdata_cache
from prosim_tpu.data import womd_ingest as jwomd_ingest
from prosim_tpu.data import womd_synth as jwomd_synth
from prosim_tpu.data.dataset import ProSimImitationDataset as JaxDataset

from torch_data_common import CONFIGS, ENV, REPO, SMALL, assert_trees_equal, build_cache, \
    config_path


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return build_cache(str(tmp_path_factory.mktemp("synth")))


@pytest.fixture(scope="module")
def cache(synth):
    return synth[1]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _configs(yaml, opts=()):
    return get_config(config_path(yaml), SMALL + list(opts)), \
        jax_get_config(config_path(yaml), SMALL + list(opts))


# ------------------------------------------------------------- the readers

def test_synthesized_shards_are_byte_identical(tmp_path, synth):
    ref = jwomd_synth.synthesize_shards(str(tmp_path), n_scenes=12, n_shards=3, seed=7)
    assert [os.path.basename(p) for p in ref] == [os.path.basename(p) for p in synth[0]]
    for a, b in zip(synth[0], ref):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("first", ["port", "jax"])
def test_ingest_caches_are_byte_identical(tmp_path, synth, first):
    """Both ingesters write the same files, byte for byte, whichever runs
    first in a process (the trajdata stand-in classes they register in
    sys.modules are shared and pickle by name)."""
    for name in [m for m in sys.modules if m == "trajdata" or m.startswith("trajdata.")]:
        del sys.modules[name]
    order = [("port", womd_ingest), ("jax", jwomd_ingest)]
    if first == "jax":
        order.reverse()
    caches = {}
    for name, mod in order:
        caches[name] = str(tmp_path / name)
        mod.ingest_shards(synth[0], caches[name], ENV)
    port, ref = _files(caches["port"]), _files(caches["jax"])
    assert len(port) == 12 * 4 + 1 and set(port) == set(ref)
    for rel, blob in port.items():
        assert blob == ref[rel], rel
    assert _files(synth[1]) == port


def test_protos_are_package_modules_with_identical_descriptors():
    from prosim_torch.data.protos import vectorized_map_pb2, waymo_scenario_pb2

    assert os.path.abspath(vectorized_map_pb2.__file__).startswith(
        os.path.join(REPO, "prosim_torch", ""))
    assert trajdata_cache._vm_pb is vectorized_map_pb2 and womd_ingest._sc_pb is waymo_scenario_pb2
    assert (vectorized_map_pb2.DESCRIPTOR.serialized_pb
            == jtrajdata_cache._vm_pb.DESCRIPTOR.serialized_pb)
    assert (waymo_scenario_pb2.DESCRIPTOR.serialized_pb
            == jwomd_ingest._sc_pb.DESCRIPTOR.serialized_pb)


def test_tfrecord_roundtrip_and_crc(tmp_path, synth):
    payloads = [b"hello", b"", bytes(range(256)) * 10]
    for writer, reader in ((tfrecord, jtfrecord), (jtfrecord, tfrecord)):
        p = str(tmp_path / f"{writer.__name__}.tfrecord")
        assert writer.write_tfrecords(p, payloads) == 3
        assert list(reader.read_tfrecords(p)) == payloads
    a, b = tmp_path / "prosim_torch.data.tfrecord.tfrecord", tmp_path / "prosim_tpu.data.tfrecord.tfrecord"
    assert a.read_bytes() == b.read_bytes()
    blob = bytearray(a.read_bytes())
    blob[14] ^= 0xFF  # a byte of the first payload
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(blob))
    for mod in (tfrecord, jtfrecord):
        with pytest.raises(IOError):
            list(mod.read_tfrecords(str(bad)))
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 100, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tfrecord.crc32c(data) == jtfrecord.crc32c(data)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    got, ref = tfrecord.index_waymo_scenarios(synth[0][0]), jtfrecord.index_waymo_scenarios(
        synth[0][0])
    assert got == ref and len(got) == 4


def test_load_scene_matches_jax(cache):
    names = trajdata_cache.list_scenes(cache, ENV)
    assert names == jtrajdata_cache.list_scenes(cache, ENV) and len(names) == 12
    for name in names:
        got = trajdata_cache.load_scene(cache, ENV, name)
        ref = jtrajdata_cache.load_scene(cache, ENV, name)
        for f in ("name", "env_name", "location", "length", "agent_names", "ego_index",
                  "ego_object_id"):
            assert getattr(got, f) == getattr(ref, f), f
        for f in ("agent_types", "states", "valid", "extents"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.map.lane_centers, ref.map.lane_centers)
        assert [l.lane_id for l in got.map.lanes] == [l.lane_id for l in ref.map.lanes]
        for la, lb in zip(got.map.lanes, ref.map.lanes):
            for f in ("center", "left_edge", "right_edge"):
                a, b = getattr(la, f), getattr(lb, f)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
        assert set(got.map.tls) == set(ref.map.tls)
        for k in got.map.tls:
            np.testing.assert_array_equal(got.map.tls[k], ref.map.tls[k])


# ------------------------------------------------------ the native engine

def test_native_lane_engine_equals_plain_and_jax(cache):
    """The C++ engine against its numpy plain version, bit for bit, and
    against prosim_tpu's vectorize_lanes, at several scene times."""
    cfg, jcfg = _configs(None)
    n = 0
    for name in trajdata_cache.list_scenes(cache, ENV):
        scene = trajdata_cache.load_scene(cache, ENV, name)
        jscene = jtrajdata_cache.load_scene(cache, ENV, name)
        for ts in (0, 10, 45, 90):
            ego = scene.states[scene.ego_index, ts]
            got = formatter.vectorize_lanes(scene, ego[:2], ego[7], ts, cfg)
            plain = formatter.vectorize_lanes_plain(scene, ego[:2], ego[7], ts, cfg)
            ref = jformatter.vectorize_lanes(jscene, ego[:2], ego[7], ts, jcfg)
            assert got.dtype == plain.dtype == np.float32
            np.testing.assert_array_equal(got, plain)
            np.testing.assert_array_equal(got, ref)
            n += len(got)
    assert n > 1000  # chunks compared


def test_native_library_lives_in_build_named_by_its_hash():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "prosim_torch_native")
    assert path.name.startswith("liblanevec_") and path.suffix == ".so"
    native.load()
    assert path.exists()


def test_failed_native_build_raises_the_compiler_message(tmp_path, monkeypatch, cache):
    """No silent numpy fallback: a source g++ rejects makes format_scene
    raise with g++'s own error."""
    broken = tmp_path / "lane_vectorize.cpp"
    broken.write_text('extern "C" int vectorize_lanes( { this is not C++ }\n')
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    cfg, _ = _configs(None)
    scene = trajdata_cache.load_scene(cache, ENV, "scene_0")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed:(.|\\n)*error"):
        formatter.format_scene(scene, cfg, 10, "train")
    assert not list((tmp_path / "build").glob("*.so"))


# -------------------------------------------------------------- formatter

@pytest.mark.parametrize("split,opts", [
    ("train", []),
    ("val", []),
    ("rollout", []),
    # more targets than SCENE_MAX_AGENT: the train split's random subsample
    ("train", ["DATASET.AGENT.SCENE_MAX_AGENT", "4"]),
    ("val", ["DATASET.AGENT.SCENE_MAX_AGENT", "4"]),
], ids=["train", "val", "rollout", "train_subsampled", "val_truncated"])
def test_format_scene_matches_jax(cache, split, opts):
    cfg, jcfg = _configs("configs/no_text.yaml", opts)
    seed_dependent = 0
    for name in trajdata_cache.list_scenes(cache, ENV):
        scene = trajdata_cache.load_scene(cache, ENV, name)
        jscene = jtrajdata_cache.load_scene(cache, ENV, name)
        meta, jmeta = {}, {}
        got = formatter.format_scene(scene, cfg, 10, split, np.random.default_rng(5), meta)
        ref = jformatter.format_scene(jscene, jcfg, 10, split, np.random.default_rng(5), jmeta)
        assert isinstance(got, SceneBatch)
        assert_trees_equal(got, ref)
        assert meta == jmeta
        seed_dependent += bool(meta.get("seed_dependent"))
    # only the train split draws; 3 scenes have more than 16 targets
    assert seed_dependent == ({(): 3}.get(tuple(opts), 12) if split == "train" else 0)


def test_collate_matches_jax_and_narrows(cache):
    """collate stacks the scene axis, keeps per-batch constants once, and
    gives int32/float32 where the JAX package's device arrays are."""
    cfg, jcfg = _configs("configs/no_text.yaml")
    ds, jds = ProSimImitationDataset(cfg, "val", cache), JaxDataset(jcfg, "val", cache)
    singles = [ds.get_scene_batch(i, seed=i, device=None) for i in range(3)]
    # a float64 and an int64 leaf (as numpy code may produce) are narrowed
    singles = [s.replace(prompt=s.prompt.replace(pos=s.prompt.pos.astype(np.float64),
                                                 obs_index=s.prompt.obs_index.astype(np.int64)))
               for s in singles]
    got = formatter.collate(singles)
    ref = jformatter.collate([jds.get_scene_batch(i, seed=i, device=False) for i in range(3)])
    assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    assert got.prompt.pos.dtype == torch.float32 and got.prompt.obs_index.dtype == torch.int32
    assert got.init_obs.feat.shape[0] == 3 and got.io_pairs.t_indices.shape == (8,)


# ---------------------------------------------------------------- dataset

@pytest.mark.parametrize("yaml", CONFIGS)
@pytest.mark.parametrize("split", ["train", "val"])
def test_get_scene_batch_matches_jax(cache, yaml, split):
    cfg, jcfg = _configs(yaml)
    ds, jds = ProSimImitationDataset(cfg, split, cache), JaxDataset(jcfg, split, cache)
    assert ds.index == jds.index and len(ds) == 12
    for i in range(len(ds)):
        host = ds.get_scene_batch(i, seed=100 + i, device=None)
        ref = jds.get_scene_batch(i, seed=100 + i, device=False)
        assert_trees_equal(host, ref)
        assert sorted(host.conditions) == sorted(cfg.PROMPT.CONDITION.TYPES)
    # on a device: tensors in the dtypes of the JAX package's device arrays
    dev = ds.get_scene_batch(3, seed=7, device="cpu")
    assert all(torch.is_tensor(x) and x.device.type == "cpu" for _, x in tree_leaves_with_path(dev))
    assert_trees_equal(dev, jax.tree.map(np.asarray, jds.get_scene_batch(3, seed=7)))


@pytest.mark.parametrize("num_workers", [0, 1])
def test_batches_match_jax(cache, num_workers):
    cfg, jcfg = _configs("configs/waymo_demo.yaml")
    ds, jds = ProSimImitationDataset(cfg, "train", cache), JaxDataset(jcfg, "train", cache)
    got = list(ds.batches(5, shuffle=True, seed=4, drop_last=False, num_workers=num_workers,
                          device="cpu"))
    ref = list(jds.batches(5, shuffle=True, seed=4, drop_last=False, num_workers=num_workers))
    assert [b.batch_size for b in got] == [5, 5, 2]
    for a, b in zip(got, ref):
        assert_trees_equal(a, jax.tree.map(np.asarray, b))


def test_format_cache_is_bit_identical(cache):
    """The per-scene formatted-base cache is invisible: a warm dataset and
    one with the cache disabled give the same batches, conditions included."""
    cfg, _ = _configs("configs/with_text.yaml")
    warm = ProSimImitationDataset(cfg, "val", cache)
    cold = ProSimImitationDataset(cfg, "val", cache)
    cold._fmt_cache_cap = 0
    for idx, seed in [(0, 5), (0, 6), (1, 5), (0, 5)]:
        assert_trees_equal(warm.get_scene_batch(idx, seed=seed, device=None),
                           cold.get_scene_batch(idx, seed=seed, device=None), ref_is_jax=False)
    assert len(warm._fmt_cache) == 2 and not cold._fmt_cache


def test_datasets_are_registered():
    from prosim_torch.core.registry import registry

    assert registry.get_dataset("prosim_imitation") is ProSimImitationDataset
    assert registry.get_dataset("prosim") is ProSimDataset


@pytest.mark.parametrize("name", sorted(
    os.path.splitext(n)[0] for n in os.listdir(os.path.join(REPO, "configs", "cond_sampler"))))
def test_get_cond_set_config_matches_jax(name):
    got = get_cond_set_config(get_config(config_path("configs/with_text.yaml")), name)
    ref = jax_get_cond_set_config(jax_get_config(config_path("configs/with_text.yaml")), name)
    assert got.to_dict() == ref.to_dict()
    assert got.PROMPT.CONDITION.TYPES == ref.PROMPT.CONDITION.TYPES


# --------------------------------------------------------- the slice, end to end

ROLLOUT_TOL = 1e-3  # metres: tests/test_torch_model.py's rollout tolerance
MODEL_OPTS = [  # tests/test_torch_model.py's SMALL_OPTS
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "2", "MODEL.DECODER.ATTN.NUM_LAYER", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "2", "MODEL.HIDDEN_DIM", "32",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "4", "MODEL.DECODER.ATTN.FF_DIM", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "4", "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "8",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "8", "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "8",
    "ROLLOUT.POLICY.TOP_K", "1",
]


def test_rollout_on_a_dataset_batch_matches_jax(cache):
    """A B=2 dataset batch of configs/waymo_demo.yaml (goal, v_action_tag,
    drag_point and text conditions, the tiny Llama) through the port's
    ProSim and through the JAX ProSim on the JAX dataset's batch, with the
    flax params carried over: 8 replan steps, eval, argmax modes."""
    from prosim_tpu.models.prosim import ProSim as JaxProSim
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.utils.params import load_flax_params

    cfg, jcfg = _configs("configs/waymo_demo.yaml", MODEL_OPTS)
    ds, jds = ProSimImitationDataset(cfg, "val", cache), JaxDataset(jcfg, "val", cache)
    batch = next(ds.batches(2, device="cpu"))
    jbatch = next(jds.batches(2))
    jm = JaxProSim(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jbatch)
    ref = jax.tree.map(np.asarray, jax.jit(lambda p, b, k: jm.forward(p, b, "val", k))(
        params, jbatch, jax.random.PRNGKey(7)))
    tm = ProSim(cfg, device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    out = tm(batch, mode="val")
    mask = batch.prompt.mask.numpy()
    assert mask.sum() > 10 and out["rollout_traj"].shape == ref["rollout_traj"].shape == (2, 16, 80, 4)
    assert np.isfinite(out["rollout_traj"].numpy()[mask]).all()
    np.testing.assert_allclose(out["rollout_traj"].numpy()[mask], ref["rollout_traj"][mask],
                               atol=ROLLOUT_TOL, rtol=0)
    np.testing.assert_allclose(out["rollout_vel"].numpy()[mask], ref["rollout_vel"][mask],
                               atol=ROLLOUT_TOL, rtol=0)


def test_evaluate_cond_sets_on_the_dataset(cache, tmp_path):
    """Trainer.evaluate_cond_sets: one eval pass per EVAL_COND_SETS entry on
    the dataset's batches, each under its own condition set."""
    from prosim_torch.train.trainer import Trainer

    cfg = get_config(config_path("configs/with_text.yaml"), SMALL + MODEL_OPTS + [
        "EXPERIMENT_DIR", str(tmp_path), "EXPERIMENT_NAME", "cond_sets",
        "PROMPT.CONDITION.EVAL_COND_SETS", "['goal_1.0', 'all_0.25']",
        "DATASET.DATA_LIST.MODE", "list", "DATASET.DATA_LIST.VAL", str(tmp_path / "val.txt")])
    (tmp_path / "val.txt").write_text("scene_0\nscene_1\nscene_2\nscene_3\n")
    trainer = Trainer(cfg, device="cpu")
    trainer.setup()
    out = trainer.evaluate_cond_sets(cache, batch_size=2)
    assert list(out) == ["goal_1.0", "all_0.25"]
    for metrics in out.values():
        assert metrics and all(np.isfinite(v) for v in metrics.values())
    logged = [l for l in open(trainer.log_path) if "val/goal_1.0/full_loss" in l]
    assert len(logged) == 1
