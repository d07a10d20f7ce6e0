"""Synthetic SceneBatch generator.

The arrays are drawn with numpy in the same order as
prosim_tpu/data/synthetic.py, so one seed gives the same arrays in both
packages, prompt conditions included. A text ('*OneText') condition is the
same two-agent instruction in every scene, tokenized by the byte tokenizer.
"""

import numpy as np

from prosim_torch.data.batch import SceneBatch
from prosim_torch.data.text_conditions import build_one_text_condition
from prosim_torch.models.llm.tokenizer import AGENT_TEMPLATE, ByteTokenizer


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

    conditions = {}
    for cond_type in config.PROMPT.CONDITION.TYPES:
        if "OneText" in cond_type:
            llm_cfg = config.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM
            pm = np.zeros((B, N), bool)
            pm[:, : min(2, N)] = True
            texts = [f"{AGENT_TEMPLATE.format(0)} slows down. "
                     f"{AGENT_TEMPLATE.format(min(1, N - 1))} turns left."] * B
            conditions[cond_type] = build_one_text_condition(
                ByteTokenizer(), texts, pm, max_len=llm_cfg.MAX_TEXT_TOKENS,
                use_prompt_token=llm_cfg.USE_PROMPT_TOKEN,
                agent_token_mode=llm_cfg.AGENT_TOKEN_MODE)
            continue
        C = config.DATASET.FORMAT.PAD.NUM_CONDS
        fdim = {"goal": 3, "v_action_tag": 3, "v2v_tag": 3, "drag_point": 16}.get(cond_type, 3)
        pidx_dim = 2 if cond_type == "v2v_tag" else 1
        cmask = rng.random((B, C)) > 0.5
        pidx = rng.integers(0, N, size=(B, C, pidx_dim)).astype(np.int32)
        pmask = np.zeros((B, N), bool)
        for b in range(B):
            pmask[b, pidx[b, cmask[b]].ravel()] = True
        feat = f32(B, C, 8, 2).reshape(B, C, 16) if cond_type == "drag_point" else f32(B, C, fdim)
        conditions[cond_type] = dict(feat=feat, mask=cmask, prompt_idx=pidx,
                                     prompt_mask=pmask & prompt_mask)
    return dict(init_map=init_map, init_obs=init_obs, prompt=prompt,
                io_pairs=io_pairs, fut_obs=fut_obs, conditions=conditions)


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
