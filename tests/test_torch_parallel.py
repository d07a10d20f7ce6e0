"""prosim_torch.parallel.mesh (the port of prosim_tpu/parallel/mesh.py on
torch.distributed) and data-parallel training, on the CPU over gloo: the
counterparts of tests/test_parallel.py (the strided scene split, the
single-process no-op, t_indices kept whole), a bad coordinator, the model
axis, and a two-process train step (tests/torch_parallel_worker.py) against
the one-process step on the same global batch, whose halves hold different
numbers of valid agents. Each child process runs under its own 60 s limit.

The tolerance: every gradient and every parameter after the step within
PARAM_TOL = 1e-5 of its leaf's largest magnitude of the one-process step's
(the gradients are summed over the ranks in another order than one process
sums them). The step is SGD's (torch_parallel_worker.SMALL_OPTS says why);
the train step is the same code under every optimizer.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from prosim_torch.parallel import mesh as pm
from prosim_torch.train import losses as tlosses
from prosim_torch.train.trainer import Trainer
from torch_parallel_worker import (M, configs, global_batch, grads_of, params_of,
                                   text_configs)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
CHILD_TIMEOUT = 60  # s, each child process
PARAM_TOL = 1e-5    # of the leaf's largest magnitude


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env():
    """The children's environment: no rendezvous settings of this process,
    and one compute thread each: their work is tiny, and two ranks with
    default thread pools on a shared CPU ran several times slower."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE", "LOCAL_RANK")}
    return dict(env, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def test_process_local_scene_indices_partition():
    """Strided shards cover every scene exactly once (the lock-free farm
    contract, reference: rollout/distributed_utils.py:151-158)."""
    shards = [pm.process_local_scene_indices(11, process_index=i, process_count=3)
              for i in range(3)]
    assert sorted(x for s in shards for x in s) == list(range(11))
    assert shards[1] == [1, 4, 7, 10]
    assert pm.process_local_scene_indices(5) == list(range(5))  # one process: all


def test_initialize_multihost_noop_single_process(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert pm.initialize_multihost(device="cpu") == 1
    assert not torch.distributed.is_initialized()
    assert pm.make_mesh().shape == {"data": 1, "model": 1}


def test_bad_coordinator_raises():
    """A rendezvous with a coordinator nobody serves raises in the child
    (within its timeout) instead of running on as a lone rank 0."""
    code = ("import datetime, sys; sys.path.insert(0, %r)\n"
            "from prosim_torch.parallel.mesh import initialize_multihost\n"
            "initialize_multihost('127.0.0.1:%d', 2, 1, device='cpu',\n"
            "                     timeout=datetime.timedelta(seconds=5))\n"
            "print('JOINED')\n") % (os.path.dirname(os.path.dirname(WORKER)), _free_port())
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT, env=_clean_env())
    assert proc.returncode != 0 and "JOINED" not in proc.stdout, proc.stdout + proc.stderr


def test_mesh_shape_and_model_axis():
    """make_mesh checks the data x model shape against the processes, as the
    JAX make_mesh does, and refuses a model axis: the JAX package declares it
    and annotates no array with it (ROADMAP.md)."""
    assert pm.make_mesh(devices=[0, 1, 2, 3]).shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="does not cover"):
        pm.make_mesh(num_data=3, devices=[0, 1])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pm.make_mesh(num_model=2, devices=[0, 1])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Trainer(configs("/unused", "m", ["PARALLEL.NUM_MODEL", "2"]), device="cpu")


def test_shard_batch_keeps_t_indices_whole(monkeypatch):
    """Each rank takes its contiguous rows of every scene-leading tensor;
    io_pairs.t_indices stays whole."""
    batch = global_batch(configs("/unused", "s"))
    mesh = pm.make_mesh(devices=[0, 1])
    for rank in (0, 1):
        monkeypatch.setattr(pm, "_rank", lambda r=rank: r)
        half = pm.shard_batch(batch, mesh)
        rows = slice(2 * rank, 2 * rank + 2)
        assert torch.equal(half.prompt.mask, batch.prompt.mask[rows])
        assert torch.equal(half.init_map.pos, batch.init_map.pos[rows])
        assert torch.equal(half.io_pairs.t_indices, batch.io_pairs.t_indices)
    assert pm.batch_sharding(mesh).rows(4) == slice(2, 4)
    assert pm.replicated_sharding(mesh).rows(4) == slice(0, 4)
    with pytest.raises(ValueError, match="does not split"):
        pm.shard_batch(batch.map_batch_leaves(lambda x: x[:3]), mesh)


def _per_rank_mean_grads(cfg, batch):
    """The gradient DistributedDataParallel would give: the mean over the
    halves of each half's own loss (its own normalisers)."""
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.utils.params import init_params

    model = ProSim(cfg, device="cpu")
    init_params(model, cfg.SEED)
    total = {}
    for rows in (slice(0, 2), slice(2, 4)):
        model.zero_grad()
        half = batch.map_batch_leaves(lambda x: x[rows])
        tlosses.paired_mse_k(half, model.forward_train(half, 0), cfg)["full_loss"].backward()
        for n, p in model.named_parameters():
            if p.grad is not None:
                total[n] = total.get(n, 0) + p.grad / 2
    return total


def test_two_process_step_equals_one_process_step(tmp_path):
    """Two gloo ranks train one step of the global batch through
    Trainer.fit: every gradient and parameter equals the one-process
    step's within PARAM_TOL of its leaf's largest, on both ranks, and the
    ranks are bitwise equal. The halves hold different numbers of valid
    agents, so the normaliser matters: the per-rank-mean gradient is another
    gradient. Only rank 0 writes the log and the checkpoints, each file
    the one-process run writes, ckpt_last twice (at the step and at the end
    of fit), the others once. The chunked
    validation rollout (chunks of 2 scenes, one a rank) and evaluate give
    the one-process metrics, and so does evaluate on configs/with_text.yaml,
    whose prompt-mask loss the model computes in its own forward: its
    per-rank mean would be another loss."""
    port, out = _free_port(), str(tmp_path)
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", str(port), out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_clean_env()) for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank={r}" in text, text[-3000:]

    cfg = configs(out, "single")
    batch = global_batch(cfg)
    counts = batch.prompt.mask.sum(1)
    assert int(counts[:2].sum()) != int(counts[2:].sum())  # unequal valid agents a rank
    single = Trainer(cfg, device="cpu")
    single.setup()
    start = params_of(single.model)
    single.fit([batch], max_steps=1)
    one = single.rollout_callback([batch], m=M)  # at the stepped weights, as the ranks ran it
    one_eval = single.evaluate([batch])
    for what, ref in (("grads", grads_of(single.model)), ("params", params_of(single.model))):
        ranks = [dict(np.load(os.path.join(out, f"{what}_rank{r}.npz"))) for r in (0, 1)]
        assert set(ranks[0]) == set(ref), what
        worst = max((float(np.abs(ranks[0][n] - v).max() / max(np.abs(v).max(), 1e-30)), n)
                    for n, v in ref.items())
        assert worst[0] <= PARAM_TOL, (what, worst)
        assert all(np.array_equal(ranks[0][n], ranks[1][n]) for n in ref), what
    assert sum(not np.array_equal(ref[n], start[n]) for n in ref) > 100  # the step moved them

    # DDP's average of per-rank means is another gradient
    model = single.model
    model.load_state_dict({n: torch.from_numpy(v) for n, v in start.items()}, strict=False)
    model.zero_grad()
    tlosses.paired_mse_k(batch, model.forward_train(batch, 0), cfg)["full_loss"].backward()
    global_grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    mean = _per_rank_mean_grads(cfg, batch)
    gap = max(float((mean[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
              for n, g in global_grads.items())
    assert gap > 100 * PARAM_TOL, gap

    # rank 0 alone logs and writes each checkpoint, once
    dp = [json.load(open(os.path.join(out, f"rollout_rank{r}.json"))) for r in (0, 1)]
    run = os.path.join(out, "dp")
    assert dp[1]["saves"] == [] and dp[0]["saves"]
    assert len(set(dp[0]["saves"])) == len(dp[0]["saves"]) - 1  # ckpt_last at the step and the end
    assert sorted(f for f in os.listdir(run) if f.startswith("ckpt_")) == sorted(
        f for f in os.listdir(single.run_dir) if f.startswith("ckpt_"))
    steps = [json.loads(line) for line in open(os.path.join(run, "log.jsonl"))]
    assert [r["step"] for r in steps if "train/full_loss" in r] == [1]
    assert any("rollout/min_ade" in r for r in steps)

    assert dp[0]["metrics"] == dp[1]["metrics"]
    assert set(dp[0]["metrics"]) == set(one)
    for k, v in one.items():
        assert dp[0]["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    assert dp[0]["eval"] == dp[1]["eval"] and set(dp[0]["eval"]) == set(one_eval)
    for k, v in one_eval.items():  # sums and counts over the ranks, the loss over both
        assert dp[0]["eval"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k

    # the model's own aux loss (with_text's prompt-mask term, weighted 1000)
    text = Trainer(text_configs(out, "single_text"), device="cpu")
    text.setup()
    tbatch = global_batch(text.config)
    one_text = text.evaluate([tbatch])
    assert dp[0]["text_eval"] == dp[1]["text_eval"] and set(dp[0]["text_eval"]) == set(one_text)
    for k, v in one_text.items():
        assert dp[0]["text_eval"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    prompt_loss = [float(text._eval_step(b, None)[2]["prompt_loss_aux"]["prompt_mask_pred_loss"])
                   for b in (tbatch, *(tbatch.map_batch_leaves(lambda x: x[r])
                                       for r in (slice(0, 2), slice(2, 4))))]
    assert prompt_loss[0] > 0
    assert abs(prompt_loss[1] + prompt_loss[2] - prompt_loss[0]) > 100 * PARAM_TOL * prompt_loss[0]


def test_enable_wandb_is_a_no_op_without_wandb(tmp_path, monkeypatch):
    """Without the wandb package enable_wandb leaves the trainer logging to
    its JSONL file alone."""
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    trainer = Trainer(configs(str(tmp_path), "w"), device="cpu")
    trainer.enable_wandb()
    assert trainer._wandb_run is None
    trainer.log({"step": 0, "x": 1.0})
    assert [json.loads(line) for line in open(trainer.log_path)] == [{"step": 0, "x": 1.0}]


def test_cli_trains_data_parallel(tmp_path):
    """`python -m prosim_torch.main --run-type train` started as two ranks
    (COORDINATOR_ADDRESS, WORLD_SIZE, RANK; gloo with --device cpu) on a
    synthetic cache of 4 scenes: both exit 0 after one epoch, two steps of
    global batches of 2 scenes (one a rank), and the validation pass; rank
    0 alone logs and writes the checkpoint."""
    from torch_data_common import SMALL, build_cache

    cache = build_cache(str(tmp_path / "data"), n_scenes=4, n_shards=2)[1]
    opts = SMALL + ["MODEL.HIDDEN_DIM", "16", "PROMPT.CONDITION.TYPES", "[]",
                    "MODEL.SCENE_ENCODER.ATTN.NUM_LAYER", "1", "MODEL.DECODER.ATTN.NUM_LAYER", "1",
                    "MODEL.POLICY.ACT_DECODER.ATTN.NUM_LAYER", "1",
                    "EXPERIMENT_DIR", str(tmp_path), "EXPERIMENT_NAME", "cli",
                    "TRAIN.BATCH_SIZE", "2", "VAL.BATCH_SIZE", "2", "MAX_EPOCHES", "1",
                    "ROLLOUT.ENABLE", "False"]
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "prosim_torch.main", "--run-type", "train", "--cache-dir", cache,
         "--device", "cpu", *opts], cwd=os.path.dirname(os.path.dirname(WORKER)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(_clean_env(), COORDINATOR_ADDRESS=f"127.0.0.1:{port}", WORLD_SIZE="2",
                 RANK=str(r))) for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-2000:] for o in outs)
    recs = [json.loads(line) for line in open(tmp_path / "cli" / "log.jsonl")]
    val = [r for r in recs if "val/full_loss" in r]
    assert len(val) == 1 and val[0]["step"] == 2 and np.isfinite(val[0]["val/full_loss"])
    assert torch.load(tmp_path / "cli" / "ckpt_last.pt", weights_only=False)["step"] == 2
    assert '"val/full_loss"' in outs[0] and '"val/full_loss"' not in outs[1]
