"""Device-resident scene bank (port of prosim_tpu/data/scene_bank.py as a
CUDA-resident bank).

~97 % of a batch's bytes are scene-deterministic: `format_scene` output
depends only on (scene, ts, split) whenever target subsampling doesn't
fire; ONLY the sampled conditions vary per seed. So:

  * each leaf of every bankable scene's formatted base is stacked ONCE on
    the card ([S, ...] per leaf);
  * per iteration the host samples the conditions (numpy), ships them and
    the batch's bank rows through ONE packed host-to-device copy
    (data/loader.py), and the batch is gathered on the card with one
    `index_select` per leaf.

Batches produced here are bitwise equal to the streaming path's: the bank
stores the same format output `ProSimImitationDataset._fmt_cache` serves,
and condition sampling consumes an identically seeded rng. Scenes whose
formatting IS seed-dependent (target subsampling fired) are not bankable:
building the bank refuses them, so the caller can stream instead.

Shared use: the transfer lock is held across the whole packed copy (pack,
send) and packed transfers are cached by layout, so several producers may
share one bank.
"""

import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from prosim_torch.data.batch import narrow_dtype, to_tensors, tree_leaves, tree_unflatten
from prosim_torch.data.loader import PackedLayout, PackedTransfer, _Pending

__all__ = ["DeviceSceneBank", "banked_batches"]


class DeviceSceneBank:
    """Stacked device copies of every bankable scene's formatted base."""

    def __init__(self, ds, scene_indices: Optional[List[int]] = None,
                 budget_bytes: int = 16 * 1024**3, device="cuda"):
        self.ds = ds
        self.device = torch.device(device)

        # unique (env, scene, ts) rows in dataset order
        if scene_indices is None:
            scene_indices = list(range(len(ds)))
        seen = {}
        for i in scene_indices:
            seen.setdefault(ds.index[i], i)
        self.keys = list(seen)
        self.row_of = {k: r for r, k in enumerate(self.keys)}

        bases, self.metas, self.unbankable = [], [], []
        for key in self.keys:
            base, meta = self._format_base(seen[key])
            if meta.get("seed_dependent"):
                self.unbankable.append(key)
                continue
            bases.append(base)
            self.metas.append(meta)
        # what condition sampling reads of a base (the prompt and io pairs,
        # ~10 % of its bytes), kept on the host beside the card's copy
        self.cond_bases = [b.replace(init_map=None, init_obs=None, fut_obs=None,
                                     road_edges=None) for b in bases]
        if self.unbankable:
            # partial banks would silently change batch composition; refuse
            raise ValueError(
                f"{len(self.unbankable)} scene(s) are seed-dependent "
                f"(target subsampling fired) and cannot be banked: "
                f"{self.unbankable[:4]}...")

        flat0 = [np.asarray(x) for x in tree_leaves(bases[0])]
        per_scene = sum(x.size * narrow_dtype(x.dtype).itemsize for x in flat0
                        if x.ndim >= 1 and x.shape[0] == 1)
        total = per_scene * len(bases)
        if total > budget_bytes:
            raise ValueError(f"scene bank needs {total / 1e9:.2f} GB "
                             f"(> budget {budget_bytes / 1e9:.2f} GB); stream instead")

        self.like = bases[0]
        flats = [tree_leaves(b) for b in bases]
        self.bank: List[torch.Tensor] = []  # leaf j -> [S, ...] or a per-batch constant
        self.is_scene: List[bool] = []
        for j, x0 in enumerate(flat0):
            scene = x0.ndim >= 1 and x0.shape[0] == 1
            value = np.concatenate([f[j] for f in flats], axis=0) if scene else x0
            self.bank.append(to_tensors(value, self.device))
            self.is_scene.append(scene)
        self.per_scene_bytes = per_scene
        self.bank_bytes = sum(t.numel() * t.element_size() for t in self.bank)
        self._lock = threading.Lock()
        self._transfers: Dict[tuple, PackedTransfer] = {}

    # -- host-side pieces -------------------------------------------------
    def _format_base(self, idx) -> Tuple[object, Dict]:
        """The condition-free formatted scene (exactly what the dataset's
        _fmt_cache holds) + its meta."""
        from prosim_torch.data.formatter import format_scene

        ds = self.ds
        env, scene_name, ts = ds.index[idx]
        scene = ds._load(env, scene_name)
        meta = {}
        base = format_scene(scene, ds.config, ts, ds.split,
                            np.random.default_rng(0), out_meta=meta)
        return base, meta

    def sample_conditions(self, idx: int, seed: Optional[int]):
        """Host-side condition sampling for dataset row `idx`, bit-identical
        to ProSimImitationDataset.get_scene_batch's (same rng construction:
        formatting a bankable scene draws nothing from the rng, and the
        bank's prompt and io pairs are that format's output)."""
        ds = self.ds
        env, scene_name, ts = ds.index[idx]
        row = self.row_of[(env, scene_name, ts)]
        if not ds.cond_gen.types:
            return row, None
        rng = np.random.default_rng(seed if seed is not None else idx)
        conds = ds.cond_gen.generate(
            ds._load(env, scene_name), self.cond_bases[row], ts,
            agent_names_by_slot=self.metas[row].get("target_names", []), rng=rng)
        return row, conds

    # -- device-side assembly ---------------------------------------------
    def ship(self, rows, cond_batches: Optional[List[Dict]]) -> _Pending:
        """The batch's bank rows and collated conditions onto the card as
        one copy through a PackedTransfer cached by layout (the lock held
        across it)."""
        from prosim_torch.data.formatter import collate_conditions

        payload = {"rows": np.asarray(rows, np.int32)}
        if cond_batches is not None:
            payload["conditions"] = collate_conditions(cond_batches)
        key = PackedLayout.signature_of(payload)
        with self._lock:
            pt = self._transfers.get(key)
            if pt is None:
                pt = self._transfers[key] = PackedTransfer(payload, device=self.device)
            return pt.send_tree(payload)

    def assemble(self, rows, cond_batches: Optional[List[Dict]]):
        """rows [B] bank rows + per-scene condition dicts -> SceneBatch on
        the card: the scene leaves gathered by index_select (on the current
        stream, after the rows' copy), the conditions from the one copy."""
        shipped = self.ship(rows, cond_batches).wait()
        idx = shipped["rows"]
        batch = tree_unflatten(self.like, [
            torch.index_select(leaf, 0, idx) if scene else leaf
            for leaf, scene in zip(self.bank, self.is_scene)])
        if "conditions" in shipped:
            batch = batch.replace(conditions=shipped["conditions"])
        return batch


def banked_batches(ds, index_seed_pairs: Iterable, batch_size: int,
                   bank: Optional[DeviceSceneBank] = None, prefetch: int = 2,
                   drop_last: bool = False, device="cuda"):
    """Banked analogue of `pipelined_batches`: one producer thread samples
    conditions and ships them with the rows; scene tensors never leave the
    card after the bank is built. Yields SceneBatches on the card."""
    import queue

    bank = bank or DeviceSceneBank(ds, device=device)
    cuda = bank.device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    sentinel = object()
    stop = threading.Event()

    def stop_aware_put(item) -> bool:
        # every producer put must be interruptible: the consumer may close
        # the generator at any moment, and an unconditional blocking put on
        # the bounded queue would deadlock the join in the finally below
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def build(group) -> _Pending:
        rows, conds = zip(*(bank.sample_conditions(i, s) for i, s in group))
        batch = bank.assemble(np.asarray(rows), list(conds) if conds[0] is not None else None)
        if not cuda:
            return _Pending(batch)
        event = torch.cuda.Event()
        event.record()  # after the gathers, on this thread's stream
        return _Pending(batch, event, [t for t in tree_leaves(batch) if t.is_cuda])

    def produce():
        try:
            group = []
            for idx, seed in index_seed_pairs:
                group.append((int(idx), int(seed)))
                if len(group) < batch_size:
                    continue
                item, group = build(group), []
                if not stop_aware_put(item):
                    return
            if group and not drop_last:
                if not stop_aware_put(build(group)):
                    return
            stop_aware_put(sentinel)
        except BaseException as e:
            stop_aware_put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item.wait()
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=30.0)
