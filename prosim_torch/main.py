"""CLI entry point (port of prosim_tpu/main.py).

    python -m prosim_torch.main --run-type {train,eval,data_debug,rollout} \
        --exp-config path/to/exp.yaml [--cache-dir DIR] [--device cuda] [KEY VALUE ...]

(reference: prosim/main.py:19-91). Runs on the card unless --device says
otherwise.

Training runs data-parallel when started as several processes: under
torchrun (`torchrun --nproc_per_node N -m prosim_torch.main --run-type train
...`), or one process per rank with COORDINATOR_ADDRESS=host:port, WORLD_SIZE
and RANK set. Each rank joins the group (NCCL on the card, gloo with
--device cpu), reads the same global batches of TRAIN.BATCH_SIZE scenes and
trains on its rows (train/trainer.py); rank 0 logs and writes checkpoints.
Without that environment it is one process.
"""

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--run-type", choices=["train", "eval", "data_debug", "rollout"],
                        required=True)
    parser.add_argument("--exp-config", type=str, default=None)
    parser.add_argument("--cache-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="config overrides: KEY VALUE pairs")
    args = parser.parse_args(argv)
    run_exp(args.run_type, args.exp_config, args.opts, args.cache_dir, args.device)


def run_exp(run_type: str, exp_config, opts, cache_dir=None, device="cuda"):
    from prosim_torch.config import get_config

    config = get_config(exp_config, opts)
    np.random.seed(config.SEED)

    from prosim_torch.data.dataset import ProSimImitationDataset
    from prosim_torch.train.trainer import Trainer

    if run_type == "data_debug":
        ds = ProSimImitationDataset(config, "train", cache_dir)
        for i, batch in enumerate(ds.batches(config.TRAIN.BATCH_SIZE, device=device)):
            print(f"batch {i}: B={batch.batch_size} agents={int(batch.prompt.mask.sum())}")
        return

    if run_type == "train":
        import torch.distributed as dist

        from prosim_torch.parallel.mesh import initialize_multihost

        initialize_multihost(device=device)  # no-op unless a coordinator is configured
        try:
            train_ds = ProSimImitationDataset(config, "train", cache_dir)
            val_ds = ProSimImitationDataset(config, "val", cache_dir)
            trainer = Trainer(config, device=device)
            trainer.setup()
            trainer.fit(
                lambda: train_ds.batches(config.TRAIN.BATCH_SIZE, shuffle=True,
                                         num_workers=config.TRAIN.NUM_WORKERS, device=device),
                lambda: val_ds.batches(config.VAL.BATCH_SIZE,
                                       num_workers=config.VAL.NUM_WORKERS, device=device),
            )
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        return

    if run_type == "eval":
        val_ds = ProSimImitationDataset(config, "val", cache_dir)
        trainer = Trainer(config, device=device)
        trainer.setup()
        if config.PROMPT.CONDITION.EVAL_COND_SETS:
            print(trainer.evaluate_cond_sets(cache_dir))
        else:
            print(trainer.evaluate(lambda: val_ds.batches(config.VAL.BATCH_SIZE, device=device),
                                   save_tag="val"))
        return

    if run_type == "rollout":
        from prosim_torch.rollout.runner import run_rollout_eval

        run_rollout_eval(config, cache_dir, device=device)
        return


if __name__ == "__main__":
    main()
