"""Rollout evaluation runner: the WOSAC farm (port of
prosim_tpu/rollout/runner.py).

The reference runs one process per scene with touch-file locking on a shared
filesystem (reference: prosim/rollout/distributed_utils.py:95-226). Here, as
in the JAX package, the farm is deterministic index sharding: worker w of W
handles scenes w, w+W, w+2W, ...; no locks, no IPC, and re-running a worker
is idempotent (it overwrites its own npz outputs). Each scene's M joint
futures are one B = M rollout on the model's device, drawn from a generator
seeded from (SEED, scene index) alone, so a scene's futures do not depend on
which worker ran it. Per scene the host formats the scene, the card runs
the rollout and the world-frame conversion, and one device-to-host copy
brings back the valid agents' trajectories; packaging and the realism
metrics run on the host.
"""

import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from prosim_torch.data.batch import to_tensors
from prosim_torch.data.dataset import ProSimImitationDataset
from prosim_torch.models.condition.transformer import load_text_llm_weights
from prosim_torch.models.prosim import ProSim
from prosim_torch.rollout.rollout import (
    parallel_rollout,
    parallel_rollout_with_sampler,
    rollout_to_world,
)
from prosim_torch.rollout.wosac import (
    ScenarioRollouts,
    joint_scenes_from_rollout,
    save_rollouts_npz,
    validate_scenario_rollouts,
)
from prosim_torch.rollout.wosac_metrics import aggregate_scenarios, scenario_metrics
from prosim_torch.train.trainer import load_model_state
from prosim_torch.utils.params import init_params


def scene_seed(seed: int, idx: int) -> int:
    """The seed of scene idx's generator, a function of (seed, idx) alone
    (the JAX farm folds idx into PRNGKey(SEED))."""
    return int(np.random.SeedSequence([seed, idx]).generate_state(1, np.uint64)[0] >> 1)


def run_rollout_eval(
    config,
    cache_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
    worker_id: int = 0,
    num_workers: int = 1,
    m: Optional[int] = None,
    model: Optional[ProSim] = None,
    max_scenes: Optional[int] = None,
    compute_metrics: bool = True,
    skip_existing: bool = False,
    max_failures: Optional[int] = None,
    goal_sampler: str = "auto",
    sampler_model: Optional[ProSim] = None,
    sampler_top_k: int = 3,
    stop_smooth: float = 5.0,
    device="cuda",
):
    """Roll out M joint futures for every assigned scene and save world-frame
    trajectories (npz per scene; see wosac.package_submission). Without a
    `model`, one is built on `device` with seeded random weights (and the
    Llama weights of TEXT.LLM.WEIGHTS_PATH).

    goal_sampler: 'auto' | 'on' | 'off'. The reference's WOSAC protocol gives
    the M replicas behavioral diversity by sampling each replica's goal
    condition from a goal-predictor's top-K heads (gpu_utils.py:179-216,
    top_K=3, smooth_dist=5.0); without it every replica is the argmax rollout,
    the per-object feature histograms are deltas, and the kinematic
    likelihoods sit on the smoothing floor. 'auto' uses the sampler whenever
    m > 1 and the model has goal heads (DECODER.GOAL_PRED.ENABLE), with the
    eval model doubling as the sampler (pass sampler_model for a separate
    sampler checkpoint like the reference's).

    A scene that raises is reported and skipped; more than max_failures
    such scenes re-raise. Writes the per-scene times (host ms) to
    timing_w<worker_id>.json. Returns out_dir."""
    m = m or config.ROLLOUT.SAMPLE_NUM
    out_dir = out_dir or os.path.join(config.EXPERIMENT_DIR, config.EXPERIMENT_NAME, "rollouts")
    os.makedirs(out_dir, exist_ok=True)

    ds = ProSimImitationDataset(config, "rollout", cache_dir)
    if model is None:
        model = ProSim(config, device=device)
        init_params(model, config.SEED)
        load_text_llm_weights(config, model)
    device = next(model.parameters()).device

    has_goal_heads = bool(config.MODEL.DECODER.GOAL_PRED.ENABLE)
    use_sampler = goal_sampler == "on" or (goal_sampler == "auto" and m > 1 and has_goal_heads)
    if goal_sampler == "on" and not has_goal_heads:
        raise ValueError("goal_sampler='on' requires DECODER.GOAL_PRED.ENABLE")
    if use_sampler:
        s_model = sampler_model if sampler_model is not None else model

        def roll(batch, gen):
            return parallel_rollout_with_sampler(model, batch, m, s_model, top_k=sampler_top_k,
                                                 stop_smooth=stop_smooth, generator=gen)
    else:
        def roll(batch, gen):
            return parallel_rollout(model, batch, m, generator=gen)

    assigned = list(range(worker_id, len(ds), num_workers))
    if max_scenes:
        assigned = assigned[:max_scenes]
    all_metrics, timing = [], []
    failures = 0

    for count, idx in enumerate(assigned):
        t0 = time.perf_counter()
        env, scene_name, ts = ds.index[idx]
        out_npz = os.path.join(out_dir, f"{env}__{scene_name}.npz")
        if skip_existing and os.path.exists(out_npz):
            # resume: outputs are idempotent, a finished scene needs no rework
            # (the reference resumes via its touch-file locks,
            # distributed_utils.py:151-158). Reload its metrics so the final
            # aggregate still covers previously-completed scenes.
            mpath = os.path.join(out_dir, f"{env}__{scene_name}.metrics.json")
            if compute_metrics and os.path.exists(mpath):
                with open(mpath) as f:
                    all_metrics.append(json.load(f))
            continue
        gen = torch.Generator(device=device).manual_seed(scene_seed(config.SEED, idx))
        try:
            rec = _rollout_one_scene(ds, idx, env, scene_name, ts, roll, m, gen, out_dir,
                                     compute_metrics, all_metrics, device)
        except Exception:  # per-scene skip-and-continue
            # (reference: distributed_utils.py:175-226 try/except per scene)
            failures += 1
            print(f"[worker {worker_id}] scene {scene_name} FAILED:\n{traceback.format_exc()}",
                  flush=True)
            if max_failures is not None and failures > max_failures:
                raise
            continue
        rec["total_ms"] = 1e3 * (time.perf_counter() - t0)
        timing.append({"scene": f"{env}/{scene_name}", **rec})
        print(f"[worker {worker_id}] scene {scene_name}: done in {rec['total_ms'] / 1e3:.2f}s "
              f"({count + 1}/{len(assigned)})", flush=True)

    with open(os.path.join(out_dir, f"timing_w{worker_id}.json"), "w") as f:
        json.dump(timing, f, indent=1)
    if compute_metrics and all_metrics:
        agg = aggregate_scenarios(all_metrics)
        with open(os.path.join(out_dir, "wosac_metrics.json"), "w") as f:
            json.dump(agg, f, indent=2)
        print("aggregate realism:", {k: round(v, 3) for k, v in agg.items() if "/" not in k},
              flush=True)
    if failures:
        print(f"[worker {worker_id}] {failures} scene(s) failed and were skipped", flush=True)
    return out_dir


def restore_eval_params(config, ckpt_path: str, model: Optional[ProSim] = None,
                        device="cuda") -> ProSim:
    """A model for farm-side evaluation from a Trainer checkpoint (the port's
    ckpt_*.pt): the seeded init (with the TEXT.LLM.WEIGHTS_PATH weights),
    then the checkpoint merged in non-strictly, so parameters it lacks (the
    stripped frozen Llama body) keep their init values."""
    if model is None:
        model = ProSim(config, device=device)
    init_params(model, config.SEED)
    load_text_llm_weights(config, model)
    load_model_state(model, ckpt_path)
    return model


def serve_rollout_requests(
    config,
    cache_dir: Optional[str] = None,
    poll_s: float = 30.0,
    max_requests: Optional[int] = None,
    once: bool = False,
    worker_id: int = 0,
    num_workers: int = 1,
    m: Optional[int] = None,
    device="cuda",
    **eval_kwargs,
):
    """Farm-side consumer of Trainer.submit_rollout_request files.

    Watches ROLLOUT_REQUEST_PATH for request JSONs (checkpoint path + epoch),
    claims each atomically by rename (the lock-free analogue of the
    reference farm's touch files, distributed_utils.py:151-158; the
    reference's external farm reads the same request contract,
    callbacks.py:373-399), loads the checkpoint on `device`, and runs the
    rollout eval into <exp_folder>/rollouts_ep<N> with `m` replicas (the
    request's m when not given)."""
    import glob as _glob

    req_dir = config.ROLLOUT_REQUEST_PATH
    if not req_dir:
        raise ValueError("config.ROLLOUT_REQUEST_PATH is not set")
    done = 0
    while True:
        for fp in sorted(_glob.glob(os.path.join(req_dir, "*.json"))):
            claim = f"{fp}.claimed_w{worker_id}"
            try:
                os.rename(fp, claim)
            except OSError:
                continue  # another worker claimed it
            with open(claim) as f:
                req = json.load(f)
            out_dir = os.path.join(req["exp_folder"], f"rollouts_ep{req['epoch']}")
            model = restore_eval_params(config, req["ckpt_path"], device=device)
            run_rollout_eval(config, cache_dir, out_dir=out_dir, m=m or req.get("m"),
                             model=model, worker_id=worker_id, num_workers=num_workers,
                             **eval_kwargs)
            done += 1
            if max_requests is not None and done >= max_requests:
                return done
        if once:
            return done
        time.sleep(poll_s)


def _world_lane_segments(scene, max_segments: int = 8192):
    """World-frame lane-center segments for the map-based metric fallback
    (official metrics use true road edges; the trajdata cache carries lane
    centerlines)."""
    if scene.map is None or not scene.map.lanes:
        return None
    starts, ends = [], []
    for lane in scene.map.lanes:
        c = np.asarray(lane.center)
        if len(c) >= 2:
            starts.append(c[:-1])
            ends.append(c[1:])
    if not starts:
        return None
    a = np.concatenate(starts).astype(np.float32)
    b = np.concatenate(ends).astype(np.float32)
    if len(a) > max_segments:
        stride = int(np.ceil(len(a) / max_segments))
        a, b = a[::stride], b[::stride]
    return a, b


def _rollout_one_scene(ds, idx, env, scene_name, ts, roll, m, gen, out_dir, compute_metrics,
                       all_metrics, device):
    """One scene: format on the host, roll out on `device`, package and score
    on the host. Returns the host ms of each stage."""
    t0 = time.perf_counter()
    meta = {}
    host = ds.get_scene_batch(idx, device=None, out_meta=meta)
    batch = to_tensors(host, device)
    scene = ds._load(env, scene_name)
    t1 = time.perf_counter()

    out = roll(batch, gen)
    ego = scene.states[scene.ego_index, ts]
    center_xy = torch.tensor(np.asarray(ego[:2], np.float32), device=device).expand(m, 2)
    center_h = torch.tensor(np.float32(ego[7]), device=device).expand(m)
    world = rollout_to_world(out, batch, center_xy, center_h)  # [M, N, T, 3]
    mask = np.asarray(host.prompt.mask)[0]
    rows = torch.from_numpy(np.nonzero(mask)[0]).to(device)
    world_np = world.index_select(1, rows).cpu().numpy()  # the scene's one copy to the host
    t2 = time.perf_counter()

    # agent z from the frame at scene_ts (planar policy)
    names = meta["target_names"][: mask.sum()]
    name_to_row = {n: i for i, n in enumerate(scene.agent_names)}
    z = [float(np.nan_to_num(scene.states[name_to_row[n], ts, 2])) for n in names]
    # 'ego' is the renamed SDC track: remap it to its recorded WOMD object id
    # so the packaged submission carries the real sim-agent id (reference:
    # gpu_utils.py:286-288); -1 only when the cache never recorded one
    ego_oid = scene.ego_object_id
    oid = [int(n) if n.isdigit() else (ego_oid if n == "ego" and ego_oid is not None else -1)
           for n in names]

    sr = ScenarioRollouts(scenario_id=f"{env}/{scene_name}",
                          joint_scenes=joint_scenes_from_rollout(world_np, oid, z))
    validate_scenario_rollouts(sr, num_rollouts=m, steps=world_np.shape[2])
    save_rollouts_npz(sr, os.path.join(out_dir, f"{env}__{scene_name}.npz"))
    t3 = time.perf_counter()

    if compute_metrics:
        # native realism metrics vs the logged future (reference farm
        # computes official WOSAC metrics per scene, distributed_utils.py:205-223)
        rows = [name_to_row[n] for n in names]
        fut = scene.states[rows, ts + 1 : ts + 1 + world_np.shape[2]]
        log_xyh = np.stack([np.nan_to_num(fut[..., 0]), np.nan_to_num(fut[..., 1]),
                            np.nan_to_num(fut[..., 7])], axis=-1)
        extents = np.nan_to_num(scene.extents[rows])
        valid = scene.valid[rows, ts + 1 : ts + 1 + world_np.shape[2]]
        metrics = scenario_metrics(world_np, log_xyh, extents,
                                   road_segments=_world_lane_segments(scene), valid=valid)
        with open(os.path.join(out_dir, f"{env}__{scene_name}.metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        all_metrics.append(metrics)
    t4 = time.perf_counter()
    return {"format_ms": 1e3 * (t1 - t0), "rollout_ms": 1e3 * (t2 - t1),
            "package_ms": 1e3 * (t3 - t2), "metrics_ms": 1e3 * (t4 - t3)}
