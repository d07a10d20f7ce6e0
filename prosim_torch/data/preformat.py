"""Batch pre-formatting: cache padded SceneBatch arrays to disk (port of
prosim_tpu/data/preformat.py; the same npz keys and arrays).

Equivalent of the reference's create_dataset.py cache-warming CLI
(reference: prosim/create_dataset.py:20-73), upgraded: instead of merely
warming the trajdata cache, this pre-computes the final padded arrays so the
training input pipeline becomes pure npz reads + collate (no per-step
formatting on the hot path). A host-side tool: the arrays are written in the
dtypes the model takes, and no card is used.

    python -m prosim_torch.data.preformat --cache-dir ... --out-dir ... \
        [--split train] [KEY VALUE ...]
"""

import argparse
import os
import time

import numpy as np
import torch

from prosim_torch.data.batch import tree_leaves_with_path, tree_unflatten


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def flatten_batch(batch) -> dict:
    """SceneBatch -> flat {path: array} dict (text conditions included)."""
    return {_key(path): (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                         else np.asarray(leaf))
            for path, leaf in tree_leaves_with_path(batch)}


def save_batch_npz(batch, path: str):
    np.savez_compressed(path, **flatten_batch(batch))


def load_batch_npz(path: str, like):
    """Rebuild a SceneBatch of numpy arrays from npz using `like` for its
    structure."""
    d = np.load(path)
    return tree_unflatten(like, [d[_key(p)] for p, _ in tree_leaves_with_path(like)])


def preformat(config, cache_dir: str, out_dir: str, split: str = "train"):
    from prosim_torch.data.dataset import ProSimImitationDataset

    ds = ProSimImitationDataset(config, split, cache_dir)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    for i in range(len(ds)):
        batch = ds.get_scene_batch(i, device="cpu")  # host arrays in the model's dtypes
        env, scene_name, ts = ds.index[i]
        save_batch_npz(batch, os.path.join(out_dir, f"{env}__{scene_name}__{ts}.npz"))
    n = len(ds)
    dt = time.time() - t0
    print(f"preformatted {n} scenes in {dt:.1f}s ({n / max(dt, 1e-9):.1f}/s)")
    return out_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--exp-config", default=None)
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = ap.parse_args()

    from prosim_torch.config import get_config

    config = get_config(args.exp_config, args.opts)
    preformat(config, args.cache_dir, args.out_dir, args.split)


if __name__ == "__main__":
    main()
