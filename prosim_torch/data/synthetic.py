"""Synthetic SceneBatch generator.

The arrays are drawn with numpy in the same order as
prosim_tpu/data/synthetic.py, so one seed gives the same arrays in both
packages. Prompt conditions are not ported yet (ROADMAP.md queue A6).
"""

import numpy as np

from prosim_torch.data.batch import SceneBatch


def obs_feature_dim(config) -> int:
    d = len(config.DATASET.FORMAT.HISTORY.ELEMENTS.split(","))
    if config.DATASET.FORMAT.HISTORY.WITH_EXTEND:
        d += 2
    if config.DATASET.FORMAT.HISTORY.WITH_AGENT_TYPE:
        d += 3
    if config.DATASET.FORMAT.HISTORY.WITH_TIME_EMB:
        d += config.DATASET.FORMAT.HISTORY.STEPS
    return d


def map_feature_dim(config) -> int:
    d = 6
    if config.DATASET.FORMAT.MAP.WITH_TYPE_EMB:
        d += 3
    if config.DATASET.FORMAT.MAP.WITH_DIR:
        d += 2
    return d


def synthetic_arrays(
    config,
    batch_size: int = 1,
    num_lanes: int = 64,
    num_obs_agents: int = 24,
    num_agents: int = 16,
    seed: int = 0,
    with_io_pairs: bool = True,
    num_replan: int = None,
) -> dict:
    """Nested dict of numpy arrays in the SceneBatch layout."""
    if config.PROMPT.CONDITION.TYPES:
        raise NotImplementedError(
            "prompt conditions are not ported yet (ROADMAP.md queue A6)")
    rng = np.random.default_rng(seed)
    B = batch_size
    L = num_lanes
    P = config.DATASET.MAP.MAX_LANE_POINTS - 1
    A = num_obs_agents
    N = num_agents
    Th = config.DATASET.FORMAT.HISTORY.STEPS
    S = config.DATASET.FORMAT.TARGET.STEPS
    Cm = map_feature_dim(config)
    Co = obs_feature_dim(config)
    R = num_replan if num_replan is not None else (
        config.ROLLOUT.POLICY.MAX_STEPS // config.ROLLOUT.POLICY.REPLAN_FREQ
    )
    T = R
    tgt_dim = len(config.DATASET.FORMAT.TARGET.ELEMENTS.split(","))

    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)

    init_map = dict(
        vectors=f32(B, L, P, Cm),
        mask=rng.random((B, L, P)) > 0.2,
        pos=f32(B, L, 2) * 50,
        ori=f32(B, L),
    )
    obs_mask = np.ones((B, A, Th), bool)
    obs_mask &= rng.random((B, A, 1)) > 0.1  # a few fully-invalid agents
    init_obs = dict(
        feat=f32(B, A, Th, Co) * 0.5,
        mask=obs_mask,
        pos=f32(B, A, 2) * 30,
        ori=f32(B, A),
    )
    # each policy agent maps to a distinct obs slot
    obs_index = np.tile(np.arange(N, dtype=np.int32)[None], (B, 1))
    prompt_mask = np.asarray(obs_mask[:, :N].any(-1))
    prompt = dict(
        feat=f32(B, N, 7),
        mask=prompt_mask,
        pos=init_obs["pos"][:, :N],
        ori=init_obs["ori"][:, :N],
        agent_type=rng.integers(1, 4, size=(B, N)).astype(np.int32),
        obs_index=obs_index,
        extent=np.abs(f32(B, N, 2)) + 1.0,
        goal_point=f32(B, N, 2) * 40,
    )

    io_pairs = None
    if with_io_pairs:
        t_idx = np.arange(T, dtype=np.int32) * config.ROLLOUT.POLICY.REPLAN_FREQ
        mask = rng.random((B, T, N)) > 0.1
        tv = np.broadcast_to(mask[..., None, None], (B, T, N, S, tgt_dim)).copy()
        io_pairs = dict(
            tgt=f32(B, T, N, S, tgt_dim),
            tgt_valid=tv,
            goal=f32(B, T, N, 2) * 40,
            pos=f32(B, T, N, 2) * 30,
            ori=f32(B, T, N),
            mask=mask,
            agent_type=rng.integers(1, 4, size=(B, T, N)).astype(np.int32),
            init_vel=f32(B, T, N, 2),
            extent=np.abs(f32(B, T, N, 2)) + 1.0,
            full_traj_xy=f32(B, N, T * S, 2) * 30,
            full_traj_valid=np.ones((B, N, T * S), bool),
            t_indices=t_idx,
        )

    fut_obs = dict(
        feat=f32(B, R, A, Th, Co) * 0.5,
        mask=np.broadcast_to(obs_mask[:, None], (B, R, A, Th)).copy(),
        pos=f32(B, R, A, 2) * 30,
        ori=f32(B, R, A),
        obs_index=np.broadcast_to(obs_index[:, None], (B, R, N)).copy(),
    )
    return dict(init_map=init_map, init_obs=init_obs, prompt=prompt,
                io_pairs=io_pairs, fut_obs=fut_obs)


def make_synthetic_batch(config, batch_size: int = 1, num_lanes: int = 64,
                         num_obs_agents: int = 24, num_agents: int = 16,
                         seed: int = 0, with_io_pairs: bool = True,
                         num_replan: int = None, device="cuda") -> SceneBatch:
    arrays = synthetic_arrays(
        config, batch_size=batch_size, num_lanes=num_lanes,
        num_obs_agents=num_obs_agents, num_agents=num_agents, seed=seed,
        with_io_pairs=with_io_pairs, num_replan=num_replan,
    )
    return SceneBatch.from_numpy(arrays).to(device)
