"""Dataset: trajdata cache -> padded SceneBatch stream (port of
prosim_tpu/data/dataset.py).

Equivalent of the reference's ProSimDataset/ProSimImitationDataset
(reference: prosim/dataset/{basic,imitation}.py) without the trajdata
dependency: scenes are read straight from the cache, formatted host-side into
fixed-shape arrays, and collated into batches on the card.

Scene/ts enumeration follows the reference: one element per (scene, scene_ts)
with scene_ts fixed by ROLLOUT.POLICY.POLICY_START_FRAME for the standard
imitation setup, scene-list filtering and subsampling by split.
"""

import os
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from prosim_torch.core.registry import registry
from prosim_torch.data.batch import SceneBatch, to_tensors
from prosim_torch.data.conditions import ConditionGenerator
from prosim_torch.data.formatter import format_scene
from prosim_torch.data.trajdata_cache import SceneData, list_scenes, load_scene


@registry.register_dataset(name="prosim_imitation")
class ProSimImitationDataset:
    def __init__(self, config, split: str = "train",
                 cache_dir: Optional[str] = None):
        self.config = config
        self.split = split
        self.cache_dir = cache_dir or config.DATASET.DATA_PATHS.CACHE_DIR
        self.envs = list(config.DATASET.SOURCE[split.upper()])
        self.cond_gen = ConditionGenerator(config, split)
        self.scene_ts = config.ROLLOUT.POLICY.POLICY_START_FRAME

        self.index: List[Tuple[str, str, int]] = []
        for env in self.envs:
            env_dir = os.path.join(self.cache_dir, env)
            if not os.path.isdir(env_dir):
                continue
            for scene_name in self._filter_scenes(list_scenes(self.cache_dir, env)):
                self.index.append((env, scene_name, self.scene_ts))

        rate = config.DATASET.SCENE.SAMPLE_RATE[split.upper()]
        if rate > 1:
            self.index = self.index[::rate]
        # formatted-base cache: format_scene output is a pure function of
        # (scene, ts, split) whenever target-agent subsampling doesn't fire
        # (meta["seed_dependent"]); only condition sampling varies per seed,
        # so re-visiting a scene (every epoch / bench iteration) pays only
        # condition generation. ~4 MB/scene at demo padding; capped FIFO.
        # The loaded scenes (~1-2 MB each) are cached FIFO at the same cap,
        # and a scene is loaded only when it is formatted or conditioned.
        self._fmt_cache = {}
        self._fmt_cache_cap = 64
        self._scene_cache = {}
        self._cache_lock = threading.Lock()

    def _filter_scenes(self, scenes: Sequence[str]) -> List[str]:
        mode = self.config.DATASET.DATA_LIST.MODE
        if mode == "all":
            return list(scenes)
        list_path = self.config.DATASET.DATA_LIST[self.split.upper()]
        if not list_path or not os.path.exists(list_path):
            return list(scenes)
        with open(list_path) as f:
            wanted = {l.strip() for l in f if l.strip()}
        return [s for s in scenes if s in wanted]

    def __len__(self):
        return len(self.index)

    def _load(self, env: str, scene_name: str) -> SceneData:
        key = (env, scene_name)
        with self._cache_lock:
            cached = self._scene_cache.get(key)
        if cached is not None:
            return cached
        scene = load_scene(self.cache_dir, env, scene_name)
        with self._cache_lock:
            while len(self._scene_cache) >= max(self._fmt_cache_cap, 1):
                self._scene_cache.pop(next(iter(self._scene_cache)))
            self._scene_cache[key] = scene
        return scene

    def get_scene_batch(self, idx: int, seed: Optional[int] = None,
                        device="cuda", out_meta: Optional[dict] = None) -> SceneBatch:
        """Format one scene (B=1) and put it on `device`. device=None keeps
        every leaf a host numpy array (what the loader's workers collate;
        the JAX package's device=False). `out_meta` receives the
        formatter's metadata (format_scene's out_meta: the agent names by
        slot)."""
        env, scene_name, ts = self.index[idx]
        rng = np.random.default_rng(seed if seed is not None else idx)
        fkey = (env, scene_name, ts)
        with self._cache_lock:
            cached = self._fmt_cache.get(fkey)
        if cached is not None:
            # rng untouched by the cached format (no draw happened), so the
            # condition sampling below sees the exact rng state of the
            # uncached path - cached and uncached batches are bit-identical
            batch, meta = cached
        else:
            meta = {}
            batch = format_scene(self._load(env, scene_name), self.config, ts, self.split,
                                 rng, out_meta=meta)
            if not meta.get("seed_dependent") and self._fmt_cache_cap > 0:
                with self._cache_lock:
                    while len(self._fmt_cache) >= self._fmt_cache_cap:
                        self._fmt_cache.pop(next(iter(self._fmt_cache)))
                    self._fmt_cache[fkey] = (batch, meta)

        if out_meta is not None:
            out_meta.update(meta)
        if self.cond_gen.types:
            conds = self.cond_gen.generate(
                self._load(env, scene_name), batch, ts,
                agent_names_by_slot=meta.get("target_names", []),
                rng=rng,
            )
            batch = batch.replace(conditions=conds)

        if device is None:
            return batch
        return to_tensors(batch, device)

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, drop_last: bool = True,
                num_workers: int = 0, prefetch: int = 2,
                transfer="device", device="cuda") -> Iterator[SceneBatch]:
        """Stream collated batches on `device`.

        Scene i of the (optionally shuffled) order is formatted with seed i.
        Full batches are collated into pinned slabs and moved with one
        host-to-device copy each (data/loader.py). With num_workers > 0 one
        producer thread formats, collates and copies up to `prefetch`
        batches ahead of the consumer - the counterpart of the reference
        DataLoader's worker processes + prefetch (reference:
        prosim/trainer.py:182-196 NUM_WORKERS wiring); num_workers <= 0
        formats inline. `transfer` is "device" (the packed copy) or None
        (host views into the slabs).
        """
        from prosim_torch.data.loader import pipelined_batches, sequential_batches

        order = np.arange(len(self.index))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        n_keep = len(order) - (len(order) % batch_size if drop_last else 0)
        pairs = [(int(j), int(j)) for j in order[:n_keep]]
        get_scene = lambda j, s: self.get_scene_batch(j, seed=s, device=None)  # noqa: E731

        if num_workers <= 0:
            yield from sequential_batches(get_scene, pairs, batch_size, transfer=transfer,
                                          device=device)
            return
        yield from pipelined_batches(get_scene, pairs, batch_size, transfer=transfer,
                                     prefetch=prefetch, device=device)


@registry.register_dataset(name="prosim")
class ProSimDataset(ProSimImitationDataset):
    """Base dataset registry entry (reference: prosim/dataset/basic.py:48).

    The reference's agent-centric variant differs only data-side (one element
    per agent instead of per scene); the scene-centric padded formatting here
    covers both training modes, so this is the same pipeline under the
    reference's other registered name."""
