#!/usr/bin/env python3
"""Where a train step's device memory goes: the peak of one Trainer.fit
step, and the tensors autograd saves for the backward, by dtype and by the
operation that made them.

    python3 scripts/train_memory.py [--config no_text|bench] [--dtype bf16|f32]
        [--batch B] [--remat full|dots|none] [--saved-batch B] [--device cuda]

--config no_text is configs/no_text.yaml; bench is bench.py --mode train's
configuration (the default config, every condition type through the tiny()
Llama). Full width, the demo padding, 8 replan steps, random weights from a
seed, as chip_smoke.py's phases 7 and 11 run them. The peak is
torch.cuda.max_memory_allocated() over one step after a warm-up step (a
step that does not fit is reported as such, with the memory it had reached).
The saved tensors are counted over one train-mode forward at --saved-batch
scenes with TRAIN.REMAT_POLICY none (every activation kept), each storage
once, so they say which tensors a recompute region holds at the peak of its
backward. One JSON line per measurement.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SHAPE = dict(num_lanes=2048, num_obs_agents=160, num_agents=128, num_replan=8)
BENCH_OPTS = [  # bench.py:309-321
    "DATASET.FORMAT.PAD.NUM_LANES", "2048", "DATASET.FORMAT.PAD.NUM_OBS_AGENTS", "160",
    "DATASET.FORMAT.PAD.NUM_AGENTS", "128", "MODEL.DTYPE", "bfloat16",
    "PROMPT.CONDITION.TYPES", "['goal', 'v_action_tag', 'drag_point', 'llm_text_OneText']",
    "PROMPT.CONDITION.SAMPLE_MODE.TRAIN", "fix", "PROMPT.CONDITION.SAMPLE_MODE.VAL", "fix",
    "PROMPT.CONDITION.RANDOM_SAMPLE.TRAIN", "True", "PROMPT.CONDITION.SAMPLE_RATE", "1.0"]


def config(name, remat, run_dir):
    from prosim_torch.config import get_config

    opts = ["TRAIN.REMAT_POLICY", remat, "TRAIN.SCHEDULER.WARMUP_STEPS", "0",
            "SAVE_CHECKPOINT", "False", "EXPERIMENT_DIR", run_dir, "EXPERIMENT_NAME", name]
    if name == "bench":
        return get_config(opts=BENCH_OPTS + opts)
    return get_config(os.path.join(ROOT, "configs", f"{name}.yaml"), opts)


def peak_of_step(torch, cfg, dtype, B, device):
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.train.trainer import Trainer

    trainer = Trainer(cfg, model=ProSim(cfg, device=device, dtype=dtype), device=device)
    trainer.setup()
    batches = [make_synthetic_batch(cfg, batch_size=B, seed=10 + i, device=device, **SHAPE)
               for i in range(2)]
    rec = {"batch": B}
    try:
        trainer.fit(batches[:1], max_steps=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        trainer.fit(batches[1:], max_steps=2)
        torch.cuda.synchronize()
        rec.update(fits=True, before_step_gib=base / 2**30,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    except torch.cuda.OutOfMemoryError as e:
        rec.update(fits=False, reached_gib=torch.cuda.max_memory_allocated() / 2**30,
                   error=str(e).splitlines()[0][:200])
    del trainer, batches
    torch.cuda.empty_cache()
    return rec


def saved_tensors(torch, cfg, dtype, B, device):
    """Bytes autograd saves in one train-mode forward and loss, by dtype and
    by the producing operation, each storage once."""
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.train.losses import paired_mse_k
    from prosim_torch.utils.params import init_params

    model = ProSim(cfg, device=device, dtype=dtype)
    init_params(model, 0)
    batch = make_synthetic_batch(cfg, batch_size=B, seed=1, device=device, **SHAPE)
    seen, by_dtype, by_op = set(), {}, {}

    def pack(t):
        st = t.untyped_storage()
        key = (st.data_ptr(), st.nbytes())
        if key not in seen and t.device.type == torch.device(device).type:
            seen.add(key)
            n = st.nbytes()
            d = str(t.dtype).replace("torch.", "")
            by_dtype[d] = by_dtype.get(d, 0) + n
            op = f"{d} {type(t.grad_fn).__name__ if t.grad_fn is not None else 'leaf/input'}"
            by_op[op] = by_op.get(op, 0) + n
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model.forward_train(batch, seed=0)
        paired_mse_k(batch, out, cfg)["full_loss"]
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    return {"batch": B, "saved_gib": sum(by_dtype.values()) / 2**30,
            "by_dtype_gib": {k: v / 2**30 for k, v in by_dtype.items()},
            "top_ops_gib": [(k, v / 2**30) for k, v in top]}


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="no_text", choices=["no_text", "with_text", "bench"])
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--saved-batch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("train_memory: no CUDA device", file=sys.stderr)
        return 2
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    run_dir = os.path.join(ROOT, "build", "train_memory")
    head = {"config": args.config, "dtype": args.dtype, "remat": args.remat,
            "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}
    if args.batch:
        cfg = config(args.config, args.remat, run_dir)
        print(json.dumps({**head, "step": peak_of_step(torch, cfg, dtype, args.batch,
                                                       args.device)}), flush=True)
    if args.saved_batch:
        cfg = config(args.config, "none", run_dir)
        print(json.dumps({**head, "saved": saved_tensors(torch, cfg, dtype, args.saved_batch,
                                                         args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
