"""Slab-reusing pipelined host loader for a PCIe-attached card (port of
prosim_tpu/data/loader.py, redesigned for CUDA).

The reference hides host-side batch preparation behind torch DataLoader
worker *processes* (reference: prosim/trainer.py:182-196 NUM_WORKERS). Here
scene formatting is numpy + the native C++ lane engine (GIL-light), batches
are large static-shape trees, and what costs is memory churn and the number
of host-to-device copies, not CPU parallelism. So:

  * `PackedLayout` - every array leaf of a batch at a 16-byte aligned offset
    of one uint8 buffer, in the dtype the model takes (int64 -> int32,
    float64 -> float32).
  * `SlabCollator` - a round-robin pool of slabs; each slab is ONE pinned
    uint8 buffer in that layout, with the batch's leaves as numpy views into
    it, so collation writes the scenes' rows straight into the buffer that
    is copied (no allocation, no second host copy).
  * `PackedTransfer` - ONE non_blocking host-to-device copy of a whole slab
    on a dedicated copy stream. The leaves are rebuilt on the card as views
    (narrow + view(dtype) + view(shape): no kernel, no per-leaf copy). A CUDA
    event recorded after the copy guards the slab: the host waits on it
    before rewriting the slab, and the consumer's stream waits on it before
    the batch is used.
  * `pipelined_batches` - ONE producer thread formats scenes, fills a slab
    and starts its copy, staying `prefetch` batches ahead of the consumer.
    Early shutdown and error propagation as in the JAX package.

Yielded device batches own their device memory, so consumers may hold them
indefinitely. With `transfer=None` the yielded trees are host VIEWS into the
slabs, valid only until `num_slabs - 1` further batches have been produced.
On the CPU (the tests) the "copy" is a clone of the slab: a yielded batch
never aliases its slab there either.
"""

import queue
import threading
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from prosim_torch.data.batch import (narrow_dtype, to_tensors, tree_leaves, tree_map,
                                     tree_structure, tree_unflatten)
from prosim_torch.data.formatter import collate_host

__all__ = ["PackedLayout", "PackedTransfer", "SlabCollator", "pipelined_batches",
           "sequential_batches"]

ALIGN = 16


def _is_scene_leaf(x) -> bool:
    """Per-scene leaves carry a leading singleton scene axis; everything else
    (per-batch constants like io_pairs.t_indices) is shared verbatim across
    the batch - the same rule as `formatter.collate`."""
    return getattr(x, "ndim", 0) >= 1 and x.shape[:1] == (1,)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


class _Pending:
    """A batch whose host-to-device copy may still be in flight. `wait()`
    makes the calling thread's current stream wait for it and returns it."""

    def __init__(self, tree, event=None, bufs=()):
        self.tree, self.event, self.bufs = tree, event, list(bufs)

    def wait(self):
        if self.event is not None:
            stream = torch.cuda.current_stream(self.bufs[0].device)
            stream.wait_event(self.event)
            for b in self.bufs:  # allocated on another stream
                b.record_stream(stream)
        return self.tree


class PackedLayout:
    """Where each array leaf of a tree lives in one flat uint8 buffer."""

    def __init__(self, probe):
        self.like = probe
        self.structure = tree_structure(probe)
        self.entries = []  # (offset, nbytes, numpy dtype, shape), one per leaf
        off = 0
        for x in tree_leaves(probe):
            x = np.asarray(x)
            dt = narrow_dtype(x.dtype)
            off = (off + ALIGN - 1) // ALIGN * ALIGN
            self.entries.append((off, x.size * dt.itemsize, dt, x.shape))
            off += x.size * dt.itemsize
        self.total = max(ALIGN, (off + ALIGN - 1) // ALIGN * ALIGN)

    def signature(self):
        return self.structure, tuple((dt.str, shape) for _, _, dt, shape in self.entries)

    @staticmethod
    def signature_of(tree):
        leaves = [np.asarray(x) for x in tree_leaves(tree)]
        return tree_structure(tree), tuple((narrow_dtype(x.dtype).str, x.shape) for x in leaves)

    def matches(self, tree) -> bool:
        """Same containers, and every leaf of the same shape and narrowed
        dtype (a float leaf in an int slot would be value-converted: no)."""
        return self.signature_of(tree) == self.signature()

    def host_views(self, buf: np.ndarray):
        return tree_unflatten(self.like, [buf[o:o + n].view(dt).reshape(shape)
                                          for o, n, dt, shape in self.entries])

    def pack(self, tree, buf: np.ndarray):
        for (o, n, dt, shape), x in zip(self.entries, tree_leaves(tree)):
            buf[o:o + n].view(dt).reshape(shape)[...] = x

    def device_views(self, flat: torch.Tensor):
        return tree_unflatten(self.like, [
            flat.narrow(0, o, n).view(_torch_dtype(dt)).view(shape)
            for o, n, dt, shape in self.entries])


class PackedTransfer:
    """One host-to-device copy per batch: a round-robin pool of `num_bufs`
    pinned buffers in a `PackedLayout`, each copied whole on a dedicated
    stream. `copies` counts the copies sent."""

    def __init__(self, probe, num_bufs: int = 3, device="cuda"):
        self.device = torch.device(device)
        self.layout = PackedLayout(probe)
        cuda = self.device.type == "cuda"
        self.bufs = [torch.empty(self.layout.total, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(num_bufs)]
        self.host = [b.numpy() for b in self.bufs]
        self.events: List[Optional[torch.cuda.Event]] = [None] * num_bufs
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self._next = 0
        self.copies = 0

    def matches(self, tree) -> bool:
        return self.layout.matches(tree)

    def reserve(self) -> int:
        """The next buffer, once its previous copy has read it."""
        k = self._next
        self._next = (k + 1) % len(self.bufs)
        if self.events[k] is not None:
            self.events[k].synchronize()
            self.events[k] = None
        return k

    def send(self, k: int) -> _Pending:
        """Start the copy of buffer k; the tree of views on the card."""
        if self.stream is None:
            flat, event = self.bufs[k].to(self.device, copy=True), None
        else:
            with torch.cuda.stream(self.stream):
                flat = torch.empty(self.layout.total, dtype=torch.uint8, device=self.device)
                flat.copy_(self.bufs[k], non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
            self.events[k] = event
        self.copies += 1
        return _Pending(self.layout.device_views(flat), event, [flat])

    def send_tree(self, tree) -> _Pending:
        """Pack a host tree into the next buffer and start its copy; a tree
        that does not match the layout goes by per-leaf copies
        (`batch.to_tensors`, which never alias the host arrays)."""
        if not self.matches(tree):
            return _Pending(to_tensors(tree, self.device))
        k = self.reserve()
        self.layout.pack(tree, self.host[k])
        return self.send(k)

    def __call__(self, tree):
        return self.send_tree(tree).wait()


class SlabCollator:
    """Collate single-scene host batches into a round-robin pool of pinned
    slabs, each shipped to `device` whole."""

    def __init__(self, probe, batch_size: int, num_slabs: int = 3, device="cuda"):
        self.batch_size = batch_size
        self.num_slabs = max(2, num_slabs)
        self.structure = tree_structure(probe)
        self.scene_leaf = [_is_scene_leaf(np.asarray(x)) for x in tree_leaves(probe)]
        batched = tree_map(lambda x: np.empty((batch_size,) + x.shape[1:], x.dtype)
                           if _is_scene_leaf(x) else x, probe)
        self.transfer = PackedTransfer(batched, num_bufs=self.num_slabs, device=device)
        self.slabs = [self.transfer.layout.host_views(h) for h in self.transfer.host]
        self._slab_leaves = [tree_leaves(s) for s in self.slabs]
        # each leaf's shape in a single scene
        self._scene_shapes = [(1,) + x.shape[1:] if scene else x.shape
                              for x, scene in zip(self._slab_leaves[0], self.scene_leaf)]

    def fill(self, singles) -> Optional[int]:
        """Write `singles` into the next free slab; its index, or None when
        the scenes do not fit the probe's structure and shapes (the caller
        then takes the allocating `formatter.collate_host`)."""
        if len(singles) != self.batch_size or any(
                tree_structure(s) != self.structure for s in singles):
            return None
        scenes = [tree_leaves(s) for s in singles]
        if any([np.shape(x) for x in s] != self._scene_shapes for s in scenes):
            return None
        k = self.transfer.reserve()
        for j, leaf in enumerate(self._slab_leaves[k]):
            if self.scene_leaf[j]:
                for i, s in enumerate(scenes):
                    leaf[i] = s[j][0]
            else:
                leaf[...] = scenes[0][j]  # per-batch constant: the first scene's
        return k

    def ship(self, singles) -> _Pending:
        """Collate and start the batch's one host-to-device copy."""
        k = self.fill(singles)
        if k is None:
            return _Pending(to_tensors(collate_host(singles), self.transfer.device))
        return self.transfer.send(k)

    def collate(self, singles, transfer: Optional[str] = None):
        """Fill the next slab with `singles`. transfer=None returns the host
        views of the slab; "device" the batch on the card (the current
        stream waits for its copy)."""
        if transfer == "device":
            return self.ship(singles).wait()
        if transfer is not None:
            raise ValueError(f"unknown transfer {transfer!r} (\"device\" or None)")
        k = self.fill(singles)
        return collate_host(singles) if k is None else self.slabs[k]


def _groups(index_seed_pairs, batch_size, drop_last):
    group = []
    for pair in index_seed_pairs:
        group.append(pair)
        if len(group) == batch_size:
            yield group
            group = []
    if group and not drop_last:
        yield group  # partial: SlabCollator routes it to formatter.collate_host


def _produce(collator_box, get_scene, group, batch_size, num_slabs, transfer,
             device) -> _Pending:
    singles = [get_scene(int(i), int(s)) for i, s in group]
    if not collator_box:
        collator_box.append(SlabCollator(singles[0], batch_size, num_slabs=num_slabs,
                                         device=device))
    if transfer == "device":
        return collator_box[0].ship(singles)
    return _Pending(collator_box[0].collate(singles, transfer))


def sequential_batches(get_scene: Callable[[int, int], object], index_seed_pairs: Iterable,
                       batch_size: int, transfer="device", num_slabs: int = 3,
                       drop_last: bool = False, device="cuda"):
    """`pipelined_batches` without the producer thread."""
    box: List[SlabCollator] = []
    for group in _groups(index_seed_pairs, batch_size, drop_last):
        yield _produce(box, get_scene, group, batch_size, num_slabs, transfer, device).wait()


def pipelined_batches(
    get_scene: Callable[[int, int], object],
    index_seed_pairs: Iterable,
    batch_size: int,
    transfer="device",
    prefetch: int = 2,
    num_slabs: Optional[int] = None,
    drop_last: bool = False,
    device="cuda",
):
    """Yield collated batches produced by one background pipeline thread.

    get_scene(idx, seed) -> single-scene host SceneBatch (device=None).
    index_seed_pairs: iterable of (idx, seed); consumed in batch_size groups.
    A trailing partial group is collated by the allocating
    formatter.collate_host unless drop_last=True. transfer: "device" (one
    packed copy a batch onto `device`) or None (host views, see the module
    docstring for their lifetime).
    """
    if num_slabs is None:
        num_slabs = prefetch + 2

    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
    sentinel = object()
    stop = threading.Event()

    def blocking_put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        box: List[SlabCollator] = []
        try:
            for group in _groups(index_seed_pairs, batch_size, drop_last):
                if stop.is_set():
                    return
                item = _produce(box, get_scene, group, batch_size, num_slabs, transfer,
                                device)
                if not blocking_put(item):
                    return
            blocking_put(sentinel)
        except BaseException as e:  # propagate into the consumer
            blocking_put(e)

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
