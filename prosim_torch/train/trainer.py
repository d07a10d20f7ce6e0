"""Training orchestration (port of prosim_tpu/train/trainer.py), on one
device.

Builds the model and optimizer, runs train and eval steps, accumulates
metrics, runs the M-replica validation rollout, checkpoints with torch.save
and logs as JSONL (wandb-compatible key naming).

Checkpoint/resume semantics follow the reference: save every
CHECKPOINT_INTERVAL steps, keep the best by train/full_loss, and save_last
(reference: trainer.py:248-256, models/base.py:134-147). A checkpoint holds
the model (the frozen Llama body stripped), the optimizer and scheduler
state, the step, the best loss and the training generator's state, so a
resumed run continues the interrupted one exactly.

`visualization_callback` renders a validation rollout (viz/plots.py, on
the host with matplotlib) and `submit_rollout_request` hands a checkpoint
to the WOSAC farm (rollout/runner.py serve_rollout_requests) in the JAX
package's request format. Not ported yet (ROADMAP.md queue A7):
`enable_wandb` and data-parallel training.
"""

import glob
import json
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from prosim_torch.data.batch import tree_leaves_with_path
from prosim_torch.models.condition.transformer import load_text_llm_weights
from prosim_torch.models.prosim import ProSim
from prosim_torch.train.metrics import compute_metrics, merge_metric_states
from prosim_torch.train.optim import build_optimizer
from prosim_torch.train.train_step import make_eval_step, make_train_step
from prosim_torch.utils.params import init_params


def find_latest_checkpoint(run_dir: str):
    """The checkpoint to resume a run from: ckpt_last.pt, else the newest
    ckpt_*.pt by mtime; None when the run has none (reference:
    rollout/distributed_utils.py:38-48)."""
    last = os.path.join(run_dir, "ckpt_last.pt")
    if os.path.isfile(last):
        return last
    cands = [p for p in glob.glob(os.path.join(run_dir, "ckpt_*.pt")) if os.path.isfile(p)]
    return max(cands, key=os.path.getmtime) if cands else None


def load_model_state(model, path: str) -> dict:
    """Non-strict restore of a Trainer checkpoint's model (reference:
    models/base.py:141-147): parameters absent from the checkpoint (the
    stripped Llama body) keep their current values; a checkpoint parameter
    the model lacks raises. Returns the whole checkpoint."""
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=False)
    _, unexpected = model.load_state_dict(state["model"], strict=False)
    if unexpected:
        raise KeyError(f"checkpoint {path} has parameters the model lacks: {unexpected}")
    return state


def _batches(source):
    return source() if callable(source) else source


class Trainer:
    def __init__(self, config, model: Optional[ProSim] = None, log_path: Optional[str] = None,
                 device="cuda"):
        self.config = config
        self.model = model if model is not None else ProSim(config, device=device)
        self.device = next(self.model.parameters()).device
        self.run_dir = os.path.join(config.EXPERIMENT_DIR, config.EXPERIMENT_NAME)
        os.makedirs(self.run_dir, exist_ok=True)
        self.log_path = log_path or os.path.join(self.run_dir, "log.jsonl")
        self.step = 0
        self.best_loss = float("inf")
        self._rng = None  # the generator of per-step seeds, kept in checkpoints
        self._improved = False
        self.optimizer = None
        self.scheduler = None
        self._train_step = None
        self._eval_step = None

    # ----------------------------------------------------------------- setup
    def setup(self, example_batch=None, seed: Optional[int] = None):
        """Seeded random weights, the optimizer and scheduler, and a restore
        when LOAD_CHECKPOINT_* asks for one. The modules' shapes come from
        the config, so `example_batch` (the JAX trainer's init input) is not
        needed."""
        init_params(self.model, self.config.SEED if seed is None else seed)
        load_text_llm_weights(self.config, self.model)
        self.optimizer, self.scheduler = build_optimizer(self.config, self.model)
        self._train_step = make_train_step(self.model, self.optimizer, self.scheduler, self.config)
        self._eval_step = make_eval_step(self.model, self.config)
        if self.config.LOAD_CHECKPOINT_MODEL or self.config.LOAD_CHECKPOINT_TRAINER:
            path = self.config.LOAD_CHECKPOINT_PATH
            if not path and self.config.LOAD_CHECKPOINT_TRAINER:
                path = find_latest_checkpoint(self.run_dir)  # auto-resume
            if path:
                self.load_checkpoint(path, trainer_state=self.config.LOAD_CHECKPOINT_TRAINER)

    def _next_seed(self) -> int:
        if self._rng is None:
            self._rng = torch.Generator().manual_seed(self.config.SEED + 1)
        return int(torch.randint(0, 2**62, (1,), generator=self._rng))

    # ------------------------------------------------------------------ train
    def fit(self, train_batches: Iterator, val_batches=None, max_steps: Optional[int] = None):
        t0 = time.time()
        ckpt_every = max(1, self.config.CHECKPOINT_INTERVAL)
        for epoch in range(self.config.MAX_EPOCHES):
            for batch in _batches(train_batches):
                losses = self._train_step(batch, self._next_seed())
                self.step += 1
                if self.step % 10 == 0 or max_steps:
                    loss = float(losses["full_loss"])
                    if not np.isfinite(loss):
                        self._dump_error_batch(batch, losses)
                    rec = {
                        "step": self.step,
                        "epoch": epoch,
                        "train/full_loss": loss,
                        "train/grad_norm": float(losses["grad_norm"]),
                        "wall": time.time() - t0,
                    }
                    # the full loss breakdown, term by term
                    for k_, v_ in losses.items():
                        if k_ not in ("full_loss", "grad_norm") and v_.ndim == 0:
                            rec[f"train/{k_}"] = float(v_)
                    self.log(rec)
                    self._improved = loss < self.best_loss
                    if self._improved:
                        self.best_loss = loss
                # periodic saves, throttled to CHECKPOINT_INTERVAL (reference:
                # Lightning ModelCheckpoint save_last + top-1 by train/full_loss)
                if self.config.SAVE_CHECKPOINT and self.step % ckpt_every == 0:
                    self.save_checkpoint("last")
                    if self._improved:
                        self.save_checkpoint("best")
                        self._improved = False
                if max_steps and self.step >= max_steps:
                    break
            if max_steps and self.step >= max_steps:
                break  # stop cycling epochs too, not just the batch loop
            if val_batches is not None and (epoch + 1) % self.config.VAL_INTERVAL == 0:
                self.evaluate(val_batches)
                rc = self.config.ROLLOUT
                if (rc.ENABLE and (epoch + 1) > rc.WARMUP_EPOCH
                        and (epoch + 1) % rc.INTERVAL_EPOCH == 0):
                    self.rollout_callback(val_batches)
                    if rc.REQUEST_METRIC and self.config.ROLLOUT_REQUEST_PATH:
                        self.submit_rollout_request(epoch + 1)
        if self.config.SAVE_CHECKPOINT:
            self.save_checkpoint("last")
        return self.model

    # ------------------------------------------------------------------- eval
    def evaluate(self, val_batches, save_tag: Optional[str] = None) -> Dict[str, float]:
        gen = torch.Generator(device=self.device).manual_seed(0)
        states, losses_acc, vis_pair = [], [], None
        for batch in _batches(val_batches):
            losses, metric_state, output = self._eval_step(batch, gen)
            states.append({k: (float(s), float(c)) for k, (s, c) in metric_state.items()})
            losses_acc.append(float(losses["full_loss"]))
            if vis_pair is None and self.config.ENABLE_VIS:
                vis_pair = (batch, output)
        merged = merge_metric_states(states) if states else {}
        metrics = compute_metrics(merged) if states else {}
        metrics["full_loss"] = float(np.mean(losses_acc)) if losses_acc else float("nan")
        self.log({"step": self.step, **{f"val/{k}": v for k, v in metrics.items()}})
        if save_tag:
            # metric sums and counts + scalars for offline analysis
            # (reference: trainer.py:287-292 _save_metric -> {mode}_metrics.npy)
            np.save(os.path.join(self.run_dir, f"{save_tag}_metrics.npy"),
                    {"metrics": metrics, "state": merged})
        if vis_pair is not None:
            self.visualization_callback(*vis_pair)
        return metrics

    # -------------------------------------------------------------- callbacks
    def visualization_callback(self, batch, output, tag: str = "val", make_gif: bool = False):
        """Render the first scene's closed-loop rollout (map + GT + predicted
        trajectories) and log the image path, plus optionally a GIF
        (reference: models/utils/visualization.py:303-329 visualization
        callback logging wandb images/videos during validation)."""
        from prosim_torch.viz.plots import save_rollout_gif, save_scene_png

        vis_dir = os.path.join(self.run_dir, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        record = {"step": self.step}
        record[f"vis/{tag}_rollout"] = save_scene_png(
            batch, os.path.join(vis_dir, f"step{self.step}_{tag}.png"), output=output)
        if make_gif:
            record[f"vis/{tag}_rollout_gif"] = save_rollout_gif(
                batch, output, os.path.join(vis_dir, f"step{self.step}_{tag}.gif"))
        self.log(record)
        return record

    def submit_rollout_request(self, epoch: int) -> str:
        """Save a mid-training checkpoint and drop a JSON request file for an
        external WOSAC rollout farm (reference: rollout/callbacks.py:373-399
        submit_rollout_request). A farm worker watches ROLLOUT_REQUEST_PATH,
        loads the checkpoint and runs rollout.runner.run_rollout_eval. The
        request has the JAX package's fields; ckpt_path is the port's
        checkpoint file."""
        import datetime

        ckpt = self.save_checkpoint(f"rollout_ep{epoch}")
        req_dir = self.config.ROLLOUT_REQUEST_PATH
        os.makedirs(req_dir, exist_ok=True)
        exp_name = os.path.join(self.config.EXPERIMENT_DIR,
                                self.config.EXPERIMENT_NAME).replace("/", "_")
        time_str = datetime.datetime.now().strftime("%m-%d-%Y_%H-%M-%S")
        request = {
            "ckpt_path": os.path.abspath(ckpt),
            "exp_folder": os.path.abspath(self.run_dir),
            "time_str": time_str,
            "epoch": epoch,
            "global_step": self.step,
            "m": self.config.ROLLOUT.SAMPLE_NUM,
        }
        path = os.path.join(req_dir, f"{exp_name}_{time_str}_epoch_{epoch}.json")
        with open(path, "w") as f:
            json.dump(request, f)
        self.log({"step": self.step, "rollout_request": path})
        return path

    def rollout_callback(self, val_batches, m: Optional[int] = None,
                         max_batches: int = 1) -> Dict[str, float]:
        """Batched M-replica closed-loop rollout during validation with sim
        metrics (min/mean replica ADE vs the logged future, crash and
        goal-reach rates), the counterpart of the reference's
        rollout_callback_gpu (rollout/callbacks.py:229-307): the M futures
        are a batch-axis tile of one rollout."""
        from prosim_torch.rollout.rollout import (
            parallel_rollout,
            parallel_rollout_with_sampler,
            replica_rollout_metrics,
        )

        m = m or self.config.ROLLOUT.SAMPLE_NUM
        # replica diversity as in the WOSAC farm: with goal heads, each
        # replica rolls out under its own sampled top-K goal; without them
        # all M replicas are the argmax rollout and min_ade == mean_ade
        use_sampler = m > 1 and self.config.MODEL.DECODER.GOAL_PRED.ENABLE
        gen = torch.Generator(device=self.device).manual_seed(self.config.SEED + 2)
        # B_chunk * m stays within ROLLOUT.MAX_TILE (at the WOSAC default
        # M=32 a whole val batch would not fit), with chunks that divide B
        max_tile = max(int(self.config.ROLLOUT.MAX_TILE), m)
        acc = []
        for i, batch in enumerate(_batches(val_batches)):
            if i >= max_batches:
                break
            B = int(batch.prompt.mask.shape[0])
            lim = max(1, min(max_tile // m, B))
            c = max(d for d in range(1, lim + 1) if B % d == 0)
            for s in range(0, B, c):
                sub = batch.map_batch_leaves(lambda x: x[s : s + c])
                if use_sampler:
                    out = parallel_rollout_with_sampler(self.model, sub, m, self.model, top_k=3,
                                                        generator=gen)
                else:
                    out = parallel_rollout(self.model, sub, m, generator=gen)
                with torch.inference_mode():
                    metrics = replica_rollout_metrics(out, sub, m)
                acc.append({k: float(v) for k, v in metrics.items()})
        out = {k: float(np.mean([a[k] for a in acc])) for k in acc[0]} if acc else {}
        self.log({"step": self.step, **{f"rollout/{k}": v for k, v in out.items()}})
        return out

    def evaluate_cond_sets(self, cache_dir, split="val", batch_size=None):
        """One eval pass per PROMPT.CONDITION.EVAL_COND_SETS entry, each with
        its own condition generator and metric namespace (reference:
        prosim/trainer.py:198-206, metrics/base.py per-cond-set instances),
        on the dataset's batches on this trainer's device."""
        from prosim_torch.config import get_cond_set_config
        from prosim_torch.data.dataset import ProSimImitationDataset

        batch_size = batch_size or self.config.VAL.BATCH_SIZE
        out = {}
        for name in self.config.PROMPT.CONDITION.EVAL_COND_SETS:
            cfg = get_cond_set_config(self.config, name)
            ds = ProSimImitationDataset(cfg, split, cache_dir)
            metrics = self.evaluate(lambda: ds.batches(batch_size, device=self.device))
            self.log({
                "step": self.step,
                **{f"val/{name}/{k}": v for k, v in metrics.items()},
            })
            out[name] = metrics
        return out

    def _dump_error_batch(self, batch, losses):
        """Save a batch that produced a non-finite loss for offline debugging
        (reference: loss_func.py:203-213 error-batch dumper)."""
        path = os.path.join(self.run_dir, f"error_batch_step{self.step}.npz")
        arrays = {".".join(("batch",) + path): t.detach().cpu().numpy()
                  for path, t in tree_leaves_with_path(batch)}
        arrays.update({f"loss/{k}": v.detach().cpu().numpy() for k, v in losses.items()})
        np.savez_compressed(path, **arrays)
        self.log({"step": self.step, "error_batch": path})
        return path

    # ------------------------------------------------------------ checkpoints
    @staticmethod
    def _strip_frozen_llm(state_dict):
        """Drop the frozen Llama body, keeping its LoRA leaves (reference:
        models/base.py:134-139 on_save_checkpoint): a Llama3-8B body would
        add ~16 GB per checkpoint."""
        def keep(name):
            parts = name.split(".")
            return "llm" not in parts[:-1] or parts[-1].startswith("lora")

        return {k: v for k, v in state_dict.items() if keep(k)}

    def _trainer_state(self):
        """Everything a resumed run needs: model (frozen Llama stripped),
        optimizer and scheduler state, step, best loss and the training
        generator (the reference's Lightning checkpoint for
        LOAD_CHECKPOINT_TRAINER, trainer.py:305-311)."""
        if self._rng is None:
            self._rng = torch.Generator().manual_seed(self.config.SEED + 1)
        return {
            "model": self._strip_frozen_llm(self.model.state_dict()),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
            "best_loss": self.best_loss,
            "rng": self._rng.get_state(),
        }

    def save_checkpoint(self, tag: str) -> str:
        path = os.path.join(self.run_dir, f"ckpt_{tag}.pt")
        tmp = path + ".tmp"
        torch.save(self._trainer_state(), tmp)
        os.replace(tmp, path)
        return path

    def load_checkpoint(self, path: str, trainer_state: bool = False):
        """Non-strict restore (reference: models/base.py:141-147): parameters
        absent from the checkpoint (the stripped Llama body) keep their
        current values. With trainer_state=True (LOAD_CHECKPOINT_TRAINER) the
        optimizer, scheduler, best loss and training generator come back
        too."""
        state = load_model_state(self.model, path)
        self.step = int(state["step"])
        if trainer_state:
            self.optimizer.load_state_dict(state["optimizer"])
            self.scheduler.load_state_dict(state["scheduler"])
            self.best_loss = float(state["best_loss"])
            self._rng = torch.Generator()
            self._rng.set_state(state["rng"].cpu())

    # -------------------------------------------------------------- profiling
    def profile(self, batch, steps: int = 3, out_dir: Optional[str] = None) -> str:
        """A torch.profiler trace of `steps` train steps, written as a Chrome
        trace under out_dir (replaces the reference's Lightning simple
        profiler, prosim/trainer.py:104)."""
        from torch.profiler import ProfilerActivity, profile

        out_dir = out_dir or os.path.join(self.run_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            for _ in range(steps):
                losses = self._train_step(batch, self._next_seed())
            float(losses["full_loss"])  # waits for the device
        path = os.path.join(out_dir, f"train_step{self.step}.trace.json")
        prof.export_chrome_trace(path)
        return path

    # ---------------------------------------------------------------- logging
    def log(self, record: Dict):
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        print(json.dumps(record), flush=True)
