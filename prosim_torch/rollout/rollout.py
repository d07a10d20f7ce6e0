"""Batched M-replica closed-loop rollout and world-frame conversion (port of
prosim_tpu/rollout/rollout.py).

The scene is encoded once; the M replicas become a batch-axis tile of
(scene tokens, policy embeddings, fut_obs), so the (B*M) rollout runs as
one batch. Replicas of scene i occupy rows i*M ... i*M+M-1.
"""

from typing import Dict, Optional

import torch

from prosim_torch.data.batch import SceneBatch, SceneTokens
from prosim_torch.utils.geometry import rotate_2d, wrap_angle


def _tile(x, m):
    return x.repeat_interleave(m, dim=0) if torch.is_tensor(x) and x.ndim >= 1 else x


def tile_batch_for_replicas(batch: SceneBatch, m: int) -> SceneBatch:
    """Repeat every scene m times along the batch axis."""
    return batch.map_batch_leaves(lambda x: _tile(x, m))


def parallel_rollout(model, batch: SceneBatch, m: int, mode: str = "rollout",
                     generator: Optional[torch.Generator] = None) -> Dict:
    """Encode once, tile M x, roll out the (B*M) scenes together. Returns the
    model output dict with leading batch axis B*M."""
    scene, policy_emd = model.prepare(batch, mode, generator)
    scene_m = SceneTokens(
        tokens=_tile(scene.tokens, m),
        pos=_tile(scene.pos, m),
        ori=_tile(scene.ori, m),
        mask=_tile(scene.mask, m),
        num_map=scene.num_map,
    )
    policy_m = {k: _tile(v, m) for k, v in policy_emd.items()}
    batch_m = tile_batch_for_replicas(batch, m)
    return model.rollout(batch_m, scene_m, policy_m, mode, generator)


def rollout_to_world(output: Dict, batch: SceneBatch, center_xy, center_h):
    """Local (agent-init-frame) rollout -> world frame.

    output['rollout_traj'] [B, N, T, 4]; (center_xy, center_h) [B, 2]/[B] is
    the scene-frame origin pose in world coordinates
    (reference: gpu_utils.py:230-281). Returns world xyh [B, N, T, 3].
    """
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
    n_agents = agent_mask.sum().clamp_min(1)
    crash_rate = (crashed & agent_mask).sum() / n_agents

    goal_d = torch.linalg.vector_norm(xy - goals_world[:, :, None], dim=-1).amin(dim=-1)
    goal_rate = ((goal_d < goal_radius) & agent_mask).sum() / n_agents
    return {"crash_rate": crash_rate, "goal_reach_rate": goal_rate}
