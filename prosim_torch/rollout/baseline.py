"""Constant-velocity WOSAC baseline (port of prosim_tpu/rollout/baseline.py,
numpy on the host over the port's cache, dataset and formatter).

Reference: prosim/rollout/baseline.py:48-130 - extrapolate every sim agent at
its current velocity/heading for the full horizon and package M identical
joint futures. Used to sanity-check the metric pipeline (the published
ConstVel composite is 0.399).
"""

from typing import Optional

import numpy as np

from prosim_torch.data.trajdata_cache import SceneData, VX, VY, X, Y, H


def constant_velocity_rollout(
    scene: SceneData,
    scene_ts: int,
    agent_rows,
    horizon: int = 80,
    m: int = 32,
    dt: float = 0.1,
    noise_scale: float = 0.01,
    seed: int = 0,
) -> np.ndarray:
    """Returns [M, N, horizon, 3] world-frame (x, y, heading).

    Matches the official linear-extrapolation baseline the reference vendors
    (reference: prosim/rollout/baseline.py:96-116): every replica integrates
    the agent's current velocity PLUS i.i.d. per-step action noise of std
    `noise_scale * max_action` (signed max of per-step displacement over
    agents, the official quirk), so the M rollouts diverge as a random walk.
    Without the noise all M replicas are identical, the per-object WOSAC
    histograms collapse to deltas, and every logged sample more than one bin
    from the delta scores the smoothing-floor likelihood - the baseline would
    under-read by ~2x (official ConstVel kinematic 0.225). noise_scale=0
    recovers the deterministic extrapolation."""
    rows = np.asarray(agent_rows)
    st = np.nan_to_num(scene.states[rows, scene_ts])  # [N, 8]
    vel = st[:, None, [VX, VY]]
    h = np.broadcast_to(st[:, None, H], (len(rows), horizon))

    if noise_scale > 0.0 and m > 1:
        rng = np.random.default_rng(seed)
        disp = vel[:, 0] * dt                              # [N, 2] per-step
        max_action = disp.max(axis=0)                      # signed max, [2]
        noise = rng.normal(0.0, noise_scale, (m, len(rows), horizon, 2))
        step_disp = disp[None, :, None, :] + noise * max_action
        xy = st[None, :, None, [X, Y]] + np.cumsum(step_disp, axis=2)
        traj = np.concatenate(
            [xy, np.broadcast_to(h[None, ..., None], (m, *h.shape, 1))], -1)
        return traj.astype(np.float64)

    steps = np.arange(1, horizon + 1)[None, :, None] * dt  # [1, T, 1]
    xy = st[:, None, [X, Y]] + vel * steps
    traj = np.concatenate([xy, h[..., None]], axis=-1)  # [N, T, 3]
    return np.broadcast_to(traj[None], (m, *traj.shape)).copy()


def run_constant_velocity_eval(config, cache_dir: Optional[str] = None,
                               max_scenes: Optional[int] = None):
    """Score the ConstVel baseline with the native realism metrics."""
    from prosim_torch.data.dataset import ProSimImitationDataset
    from prosim_torch.data.formatter import format_scene
    from prosim_torch.rollout.wosac_metrics import aggregate_scenarios, scenario_metrics

    ds = ProSimImitationDataset(config, "rollout", cache_dir)
    horizon = config.ROLLOUT.POLICY.MAX_STEPS
    m = config.ROLLOUT.SAMPLE_NUM
    out = []
    n = min(len(ds), max_scenes) if max_scenes else len(ds)
    for idx in range(n):
        env, scene_name, ts = ds.index[idx]
        scene = ds._load(env, scene_name)
        meta = {}
        format_scene(scene, config, ts, "rollout", out_meta=meta)
        name_to_row = {nm: i for i, nm in enumerate(scene.agent_names)}
        rows = [name_to_row[nm] for nm in meta["target_names"]]
        sim = constant_velocity_rollout(scene, ts, rows, horizon, m, seed=idx)
        fut = scene.states[rows, ts + 1 : ts + 1 + horizon]
        log_xyh = np.stack(
            [np.nan_to_num(fut[..., X]), np.nan_to_num(fut[..., Y]),
             np.nan_to_num(fut[..., H])], axis=-1)
        valid = scene.valid[rows, ts + 1 : ts + 1 + horizon]
        out.append(scenario_metrics(
            sim, log_xyh, np.nan_to_num(scene.extents[rows]), valid=valid))
    return aggregate_scenarios(out)
