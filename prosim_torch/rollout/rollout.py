"""Batched M-replica closed-loop rollout, world-frame conversion and the
validation sim metrics (port of prosim_tpu/rollout/rollout.py).

The scene is encoded once; the M replicas become a batch-axis tile of
(scene tokens, policy embeddings, fut_obs), so the (B*M) rollout runs as
one batch. Replicas of scene i occupy rows i*M ... i*M+M-1. With a goal
sampler (`parallel_rollout_with_sampler`) each replica rolls out under its
own goal, picked among the sampler's top-K goal heads.
"""

from typing import Dict, Optional

import torch

from prosim_torch.data.batch import Condition, SceneBatch, SceneTokens
from prosim_torch.parallel.mesh import global_count
from prosim_torch.utils import tracing
from prosim_torch.utils.geometry import rotate_2d, wrap_angle


def _tile(x, m):
    return x.repeat_interleave(m, dim=0) if torch.is_tensor(x) and x.ndim >= 1 else x


def tile_batch_for_replicas(batch: SceneBatch, m: int) -> SceneBatch:
    """Repeat every scene m times along the batch axis."""
    return batch.map_batch_leaves(lambda x: _tile(x, m))


def _tile_scene(scene: SceneTokens, m: int) -> SceneTokens:
    return SceneTokens(tokens=_tile(scene.tokens, m), pos=_tile(scene.pos, m),
                       ori=_tile(scene.ori, m), mask=_tile(scene.mask, m),
                       num_map=scene.num_map)


def parallel_rollout(model, batch: SceneBatch, m: int, mode: str = "rollout",
                     generator: Optional[torch.Generator] = None) -> Dict:
    """Encode once, tile M x, roll out the (B*M) scenes together. Returns the
    model output dict with leading batch axis B*M."""
    scene, policy_emd = model.prepare(batch, mode, generator)
    scene_m = _tile_scene(scene, m)
    policy_m = {k: _tile(v, m) for k, v in policy_emd.items()}
    batch_m = tile_batch_for_replicas(batch, m)
    return model.rollout(batch_m, scene_m, policy_m, mode, generator)


def rollout_to_world(output: Dict, batch: SceneBatch, center_xy, center_h):
    """Local (agent-init-frame) rollout -> world frame.

    output['rollout_traj'] [B, N, T, 4]; (center_xy, center_h) [B, 2]/[B] is
    the scene-frame origin pose in world coordinates
    (reference: gpu_utils.py:230-281). Returns world xyh [B, N, T, 3].
    """
    with tracing.span("rollout_to_world"):
        traj = output["rollout_traj"]
        init_pos = output["init_pos"]       # [B, N, 2]
        init_h = output["init_heading"]     # [B, N]
        xy_scene = rotate_2d(traj[..., :2], init_h[..., None]) + init_pos[..., None, :]
        h_scene = wrap_angle(torch.atan2(traj[..., 2], traj[..., 3]) + init_h[..., None])
        xy_world = rotate_2d(xy_scene, center_h[:, None, None]) + center_xy[:, None, None, :]
        h_world = wrap_angle(h_scene + center_h[:, None, None])
        return torch.cat([xy_world, h_world[..., None]], dim=-1)


def crash_and_goal_metrics(world_xyh, extents, agent_mask, goals_world,
                           goal_radius: float = 2.0):
    """Crash rate (disc-overlap approximation) and goal-reach rate over the
    rollout (reference: prosim/rollout/metrics.py:21-135).

    world_xyh [B, N, T, 3], extents [B, N, 2], agent_mask [B, N],
    goals_world [B, N, 2].
    """
    xy = world_xyh[..., :2]
    B, N, T, _ = xy.shape
    radius = torch.linalg.vector_norm(extents, dim=-1) / 2.0  # [B, N]
    rsum = radius[:, :, None] + radius[:, None, :]
    eye = torch.eye(N, dtype=torch.bool, device=xy.device)
    pair_mask = agent_mask[:, :, None] & agent_mask[:, None, :] & ~eye[None]

    # pairwise distances in blocks of time steps keep the live temp at
    # [B, Tb, N, N]; any() over time commutes with blocking
    crashed = torch.zeros((B, N), dtype=torch.bool, device=xy.device)
    for t0 in range(0, T, 8):
        xb = xy[:, :, t0 : t0 + 8].transpose(1, 2)  # [B, Tb, N, 2]
        d = torch.linalg.vector_norm(xb[:, :, :, None] - xb[:, :, None, :], dim=-1)
        c = (d < rsum[:, None] * 0.7) & pair_mask[:, None]
        crashed |= c.any(dim=3).any(dim=1)
    n_agents = global_count(agent_mask)
    crash_rate = (crashed & agent_mask).sum() / n_agents

    goal_d = torch.linalg.vector_norm(xy - goals_world[:, :, None], dim=-1).amin(dim=-1)
    goal_rate = ((goal_d < goal_radius) & agent_mask).sum() / n_agents
    return {"crash_rate": crash_rate, "goal_reach_rate": goal_rate}


def replica_rollout_metrics(output: Dict, batch: SceneBatch, m: int) -> Dict:
    """Validation-time sim metrics over an M-replica rollout (the metric set
    the reference's rollout callback logs, rollout/callbacks.py:229-307 +
    rollout/metrics.py): per-scene min/mean ADE of the M joint futures vs the
    logged future, plus crash / goal-reach rates in the scene frame.

    `output` = rollout output on the tiled batch (leading axis B*m);
    `batch` = the UN-tiled batch (leading axis B). The crash test runs over
    the T steps as they are: the JAX package pads T to a multiple of 8 with
    every agent at one point, which reads as a crash (ROADMAP.md queue C).
    """
    traj = output["rollout_traj"]                       # [B*m, N, T, 4]
    BM, N, T, _ = traj.shape
    B = BM // m
    mask = batch.prompt.mask                            # [B, N]

    # --- replica ADE vs GT (both live in each agent's init frame)
    gt_xy = batch.io_pairs.full_traj_xy[:, :, :T]       # [B, N, T, 2]
    gt_valid = batch.io_pairs.full_traj_valid[:, :, :T] & mask[..., None]
    pred = traj[..., :2].reshape(B, m, N, T, 2)
    err = torch.linalg.vector_norm(pred - gt_xy[:, None].to(pred.dtype), dim=-1)
    w = gt_valid[:, None].to(pred.dtype)                # [B, 1, N, T]
    ade_r = (err * w).sum((2, 3)) / w.sum((2, 3)).clamp_min(1)  # [B, m]
    scene_has = gt_valid.any(2).any(1)                  # [B]
    denom = global_count(scene_has)
    min_ade = torch.where(scene_has, ade_r.amin(1), 0.0).sum() / denom
    mean_ade = torch.where(scene_has, ade_r.mean(1), 0.0).sum() / denom

    # --- crash / goal-reach in the scene frame (rigid transform of world)
    init_pos = output["init_pos"]                       # [B*m, N, 2]
    init_h = output["init_heading"]                     # [B*m, N]
    xy_scene = rotate_2d(traj[..., :2], init_h[..., None]) + init_pos[..., None, :]
    h_scene = wrap_angle(torch.atan2(traj[..., 2], traj[..., 3]) + init_h[..., None])
    xyh = torch.cat([xy_scene, h_scene[..., None]], dim=-1)

    goals_scene = batch.prompt.goal_point  # already in the scene frame
    sim = crash_and_goal_metrics(xyh, _tile(batch.prompt.extent, m), output["agent_mask"],
                                 _tile(goals_scene, m))
    return {"min_ade": min_ade, "mean_ade": mean_ade, **sim}


def sample_goal_conditions(goal_point, goal_prob, prompt_mask, m: int,
                           generator: Optional[torch.Generator] = None, top_k: int = 8,
                           stop_smooth: float = 5.0, horizon: float = 80.0,
                           picks=None) -> Condition:
    """Per-replica goal conditions from a goal-sampler model's K-goal heads
    (reference: gpu_utils.py:125-177 sample_M_goal_cond_to_batch): each of the
    m replicas independently picks one of every agent's top-K goals; goals
    within `stop_smooth` metres of the origin snap to (0, 0) (stopping).

    goal_point [B, N, K, 2], goal_prob [B, N, K] -> Condition with feat
    [B*m, N, 3] = (x, y, horizon), replicas of scene i at rows i*m..i*m+m-1.
    `picks` [B, m, N] in [0, min(top_k, K)) replaces the random picks (drawn
    from `generator` otherwise).
    """
    B, N, K, _ = goal_point.shape
    k_eff = min(top_k, K)
    topk_idx = torch.sort(-goal_prob, dim=-1, stable=True)[1][..., :k_eff]  # [B, N, k]
    if picks is None:
        picks = torch.randint(0, k_eff, (B, m, N), generator=generator, device=goal_point.device)
    sel = topk_idx[:, None].expand(B, m, N, k_eff).gather(-1, picks[..., None].long())[..., 0]
    goals = goal_point[:, None].expand(B, m, N, K, 2).gather(
        3, sel[..., None, None].expand(B, m, N, 1, 2))[:, :, :, 0]       # [B, m, N, 2]
    stop = (goals[..., 0].abs() < stop_smooth) & (goals[..., 1].abs() < stop_smooth)
    goals = torch.where(stop[..., None], 0.0, goals)

    feat = torch.cat([goals, torch.full((B, m, N, 1), horizon, dtype=goals.dtype,
                                        device=goals.device)], dim=-1).reshape(B * m, N, 3)
    mask = prompt_mask[:, None].expand(B, m, N).reshape(B * m, N)
    prompt_idx = torch.arange(N, dtype=torch.int32, device=goals.device)[None, :, None].expand(
        B * m, N, 1)
    return Condition(feat=feat, mask=mask, prompt_idx=prompt_idx, prompt_mask=mask)


def parallel_rollout_with_sampler(model, batch: SceneBatch, m: int, sampler_model,
                                  top_k: int = 8, stop_smooth: float = 5.0,
                                  mode: str = "rollout",
                                  generator: Optional[torch.Generator] = None,
                                  picks=None) -> Dict:
    """M-replica rollout where a goal-sampler model proposes a distinct goal
    condition per replica (reference: gpu_utils.py:199-216): encode the scene
    once, tile, attach sampled goal conditions, then decode per-replica
    policies and run one batched rollout. `picks` as in
    `sample_goal_conditions`. Spans: `rollout_with_sampler` > `sampler`,
    `replicas` (> `scene_encoder`, the second encode of the same scene when
    the sampler is the model), `rollout`."""
    with torch.inference_mode(), tracing.span("rollout_with_sampler"):
        # the WOSAC protocol evaluates UNPROMPTED realism: dataset conditions
        # steer neither the sampler's goals nor the policy (the sampled goals
        # replace them wholesale, reference gpu_utils.py:175)
        batch = batch.replace(conditions={})
        with tracing.span("sampler"):
            _, s_emd = sampler_model.prepare(batch, "val", generator)
            if "goal_point" not in s_emd:
                raise ValueError("sampler model has no goal heads (DECODER.GOAL_PRED)")
            goal_cond = sample_goal_conditions(
                s_emd["goal_point"], s_emd["goal_prob"], batch.prompt.mask, m, generator,
                top_k=top_k, stop_smooth=stop_smooth, picks=picks)

        with tracing.span("replicas"):
            with tracing.span("scene_encoder"):
                scene_m = _tile_scene(model.scene_encoder(batch.init_obs, batch.init_map), m)
            batch_m = tile_batch_for_replicas(batch, m).replace(conditions={"goal": goal_cond})
            # with 'prompt_encoder' a condition location, each replica's prompt
            # is encoded under its own goal; otherwise the prompt never sees
            # conditions, so it is encoded once and tiled
            if "prompt_encoder" in model.condition_locations:
                prompt_emb_m = model.encode_prompt(batch_m)
            else:
                prompt_emb_m = _tile(model.encode_prompt(batch), m)
            policy_emd = model.generate_policy(batch_m, scene_m, prompt_emb_m)
            policy_emd = model.select_k_emd(policy_emd, batch_m, mode, generator)
        return model.rollout(batch_m, scene_m, policy_emd, mode, generator)
