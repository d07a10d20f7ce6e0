"""One rank of tests/test_torch_parallel.py's data-parallel run, on the CPU
over gloo:

    python tests/torch_parallel_worker.py <rank> <world> <port> <out_dir>

Joins the group through `initialize_multihost`, trains configs/no_text.yaml
at small widths for one SGD step through `Trainer.fit` on `global_batch()`
(the trainer takes this rank's rows), runs the chunked validation rollout
and evaluate, evaluates configs/with_text.yaml (the tiny() Llama, whose
prompt-mask loss is a term of the model's own), and writes its parameters,
gradients, metrics and the checkpoint files it wrote under out_dir. It
imports the port alone. `configs()`, `text_configs()` and `global_batch()`
are shared with the test's one-process run.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NO_TEXT = os.path.join(REPO, "configs/no_text.yaml")
WITH_TEXT = os.path.join(REPO, "configs/with_text.yaml")
TEXT_OPTS = [  # tests/test_torch_text_train.py's
    "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS", "32",
    "MODEL.CONDITION_TRANSFORMER.NLAYER", "1",
]
SMALL_OPTS = [  # tests/test_torch_train.py's widths, dropout 0
    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1",
    "MODEL.DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1",
    "MODEL.HIDDEN_DIM", "16",
    "MODEL.SCENE_ENCODER.ATTN.FF_DIM", "2",
    "MODEL.DECODER.ATTN.FF_DIM", "2",
    "MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM", "2",
    "MODEL.SCENE_ENCODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.POLICY.ACT_DECODER.ATTN.MAX_NUM_NEIGH", "4",
    "MODEL.SCENE_ENCODER.ATTN.DROPOUT", "0.0",
    "MODEL.DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.POLICY.ACT_DECODER.ATTN.DROPOUT", "0.0",
    "MODEL.CONDITION_TRANSFORMER.DROPOUT", "0.0",
    "TRAIN.SCHEDULER.WARMUP_STEPS", "0",
    "ROLLOUT.POLICY.TOP_K", "1",
    "ROLLOUT.MAX_TILE", "4",  # B=4 at m=2: chunks of 2 scenes, one a rank
    "CHECKPOINT_INTERVAL", "1",
    # SGD: its update is linear in the gradient, so the step carries the
    # gradient's agreement; Adam's first update LR * g / (|g| + eps) turns a
    # 1e-6 change of a clipped gradient near eps (1e-8) into up to LR
    "TRAIN.OPTIMIZER", "sgd",
]
M = 2  # validation replicas


def configs(out_dir, name, extra=()):
    from prosim_torch.config import get_config

    return get_config(NO_TEXT, SMALL_OPTS + ["EXPERIMENT_DIR", out_dir, "EXPERIMENT_NAME", name,
                                             *extra])


def text_configs(out_dir, name):
    from prosim_torch.config import get_config

    return get_config(WITH_TEXT, SMALL_OPTS + TEXT_OPTS + ["EXPERIMENT_DIR", out_dir,
                                                           "EXPERIMENT_NAME", name])


def global_batch(cfg):
    """Four scenes at one replan step whose halves (scenes 0-1 and 2-3, one
    a rank at world size 2) hold different numbers of valid agents."""
    from prosim_torch.data.synthetic import make_synthetic_batch

    batch = make_synthetic_batch(cfg, seed=3, device="cpu", batch_size=4, num_lanes=16,
                                 num_obs_agents=10, num_agents=6, num_replan=1)
    mask = batch.prompt.mask.clone()
    mask[0, 2:] = False
    mask[1, 4:] = False
    return batch.replace(prompt=batch.prompt.replace(mask=mask))


def params_of(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def grads_of(model):
    """The step's gradients (summed over the ranks and clipped)."""
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters() if p.grad is not None}


def main():
    import numpy as np
    import torch.distributed as dist

    from prosim_torch.parallel.mesh import initialize_multihost
    from prosim_torch.train.trainer import Trainer

    import torch

    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    saves = []  # the checkpoint files this rank writes
    save = torch.save
    torch.save = lambda obj, path, *a, **k: (saves.append(os.path.basename(path)),
                                             save(obj, path, *a, **k))
    assert initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu") == world
    trainer = Trainer(configs(out, "dp"), device="cpu")
    assert trainer.mesh.shape == {"data": world, "model": 1}
    trainer.setup()
    batch = global_batch(trainer.config)
    trainer.fit([batch], max_steps=1)
    np.savez(os.path.join(out, f"params_rank{rank}.npz"), **params_of(trainer.model))
    np.savez(os.path.join(out, f"grads_rank{rank}.npz"), **grads_of(trainer.model))
    metrics = trainer.rollout_callback([batch], m=M)
    evaluated = trainer.evaluate([batch])
    text = Trainer(text_configs(out, "dp_text"), device="cpu")
    text.setup()
    text_eval = text.evaluate([global_batch(text.config)])
    with open(os.path.join(out, f"rollout_rank{rank}.json"), "w") as f:
        json.dump({"metrics": metrics, "eval": evaluated, "text_eval": text_eval,
                   "saves": saves}, f)
    dist.destroy_process_group()
    print(f"OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
