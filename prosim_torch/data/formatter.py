"""Batch formatting: SceneData -> padded SceneBatch arrays.

Re-implements the reference's batch construction on plain numpy with fully
static padded shapes (reference: prosim/dataset/format_utils.py:153-815):

  init_map   - local vectorized lanes cropped around the scene center, chunked
               to MAX_LANE_POINTS, re-expressed in per-lane symmetric frames,
               with type one-hot and segment direction channels.
  init_obs   - per-agent relative history with extent / type / time-embedding
               channels; NaN steps become mask=False.
  prompt     - initial agent status (vel in agent frame, extent, type one-hot).
  io_pairs   - local-frame future chunks for every (t, agent) pair.
  fut_obs    - GT observations at each replan step for the log-replay half of
               the closed loop.

All angles/frames follow utils/geometry.py semantics; everything here
is host-side numpy (the device never sees ragged data). This is the port of
prosim_tpu/data/formatter.py: `format_scene` and its helpers are the same
numpy and return the port's `SceneBatch` with numpy leaves (B=1); `collate`
stacks such batches into one of host tensors with the dtypes the model takes.
The lane vectorization runs in the native engine (prosim_torch/native);
`vectorize_lanes_plain` is its numpy plain version.
"""

import math
from typing import List, Optional

import numpy as np
import torch

from prosim_torch import native
from prosim_torch.data.batch import (
    FutObs,
    IOPairs,
    MapInputs,
    ObsInputs,
    Prompt,
    RoadEdges,
    SceneBatch,
    narrow_dtype,
    tree_map,
)
from prosim_torch.data.trajdata_cache import SceneData, STATE_DIM, X, Y, VX, VY, AX, AY, H

LANE_TYPE = {"center": 1.0, "left_edge": 2.0, "right_edge": 3.0}


def _wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def _rot(xy, theta):
    c, s = np.cos(theta), np.sin(theta)
    x = xy[..., 0] * c - xy[..., 1] * s
    y = xy[..., 1] * c + xy[..., 0] * s
    return np.stack([x, y], axis=-1)


def to_frame(states, frame_xy, frame_h):
    """Express world states [.., 8] in the frame at (frame_xy, frame_h).

    One cos/sin evaluation shared by the three xy-pair rotations and direct
    column writes (no fancy-index round trips) — bit-identical to rotating
    each pair by -frame_h via _rot (cos(-h)=cos h, sin(-h)=-sin h exactly)."""
    out = states.copy()
    c, s = np.cos(frame_h), np.sin(frame_h)
    x = states[..., X] - frame_xy[..., 0]
    y = states[..., Y] - frame_xy[..., 1]
    out[..., X] = x * c + y * s
    out[..., Y] = y * c - x * s
    out[..., VX] = states[..., VX] * c + states[..., VY] * s
    out[..., VY] = states[..., VY] * c - states[..., VX] * s
    out[..., AX] = states[..., AX] * c + states[..., AY] * s
    out[..., AY] = states[..., AY] * c - states[..., AX] * s
    out[..., H] = _wrap(states[..., H] - frame_h)
    return out


def obs_channels(rel_states):
    """'x,y,s,c,xd,yd,xdd,ydd' channels from relative states [.., 8]."""
    return np.concatenate(
        [
            rel_states[..., [X, Y]],
            np.sin(rel_states[..., H])[..., None],
            np.cos(rel_states[..., H])[..., None],
            rel_states[..., [VX, VY]],
            rel_states[..., [AX, AY]],
        ],
        axis=-1,
    )


# --------------------------------------------------------------------- map

def _flat_lane_parts(smap, map_cfg):
    """All lane parts (center/left/right polylines) concatenated into flat
    arrays, cached on the SceneMap — lane geometry is static, so per query
    only the near-mask subsetting and the frame transform remain."""
    key = (tuple(map_cfg.INCLUDE_TYPES), map_cfg.CENTER_SAMPLE_RATE,
           map_cfg.EDGE_SAMPLE_RATE)
    cache = getattr(smap, "_flat_parts_cache", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    parts_pts, lens, types_l, rates_l, lane_idx = [], [], [], [], []
    for li, lane in enumerate(smap.lanes):
        for kind, pts_arr, rate in (
            ("center", lane.center, map_cfg.CENTER_SAMPLE_RATE),
            ("left_edge", lane.left_edge, map_cfg.EDGE_SAMPLE_RATE),
            ("right_edge", lane.right_edge, map_cfg.EDGE_SAMPLE_RATE),
        ):
            if kind not in map_cfg.INCLUDE_TYPES or pts_arr is None:
                continue
            parts_pts.append(pts_arr)
            lens.append(len(pts_arr))
            types_l.append(LANE_TYPE[kind])
            rates_l.append(rate)
            lane_idx.append(li)
    flat = {
        "pts": (np.concatenate(parts_pts, axis=0) if parts_pts
                else np.zeros((0, 2))),
        "lens": np.asarray(lens, np.int64),
        "types": np.asarray(types_l, np.float32),
        "rates": np.asarray(rates_l, np.int64),
        "lane_idx": np.asarray(lane_idx, np.int64),
    }
    smap._flat_parts_cache = (key, flat)
    return flat


def _tls_at(smap, scene_ts):
    """Per-lane traffic-light status at scene_ts as one [num_lanes] float32
    array, cached per timestep on the SceneMap."""
    cache = getattr(smap, "_tls_at_cache", None)
    if cache is None:
        cache = {}
        smap._tls_at_cache = cache
    vec = cache.get(scene_ts)
    if vec is None:
        vec = np.asarray(
            [smap.traffic_light_status(l.lane_id, scene_ts)
             for l in smap.lanes], np.float32)
        cache[scene_ts] = vec
    return vec


def _lane_setup(scene: SceneData, center_xy, config):
    map_cfg = config.DATASET.MAP
    map_range = config.DATASET.MAP.RANGE.TRAIN
    max_pts = map_cfg.MAX_LANE_POINTS
    smap = scene.map
    if smap is None or len(smap.lanes) == 0:
        return None
    lane_dist = math.sqrt(2) * map_range
    near = (
        np.linalg.norm(smap.lane_centers - np.asarray(center_xy), axis=-1) < lane_dist
    )
    return map_cfg, map_range, max_pts, smap, near


def vectorize_lanes(scene: SceneData, center_xy, center_h, scene_ts, config):
    """World lanes -> scene-frame 6-d segment vectors chunked per lane
    (reference: prosim/dataset/data_utils.py:155-252), in the native engine:
    lane parts are flattened once per map (cached on the SceneMap), subset
    for this query with vectorized masks, and handed to the C++ library.
    Bit-equal to `vectorize_lanes_plain`."""
    setup = _lane_setup(scene, center_xy, config)
    if setup is None:
        return np.zeros((0, config.DATASET.MAP.MAX_LANE_POINTS - 1, 6), np.float32)
    map_cfg, map_range, max_pts, smap, near = setup
    flat = _flat_lane_parts(smap, map_cfg)
    near_part = near[flat["lane_idx"]]               # [num_parts]
    if not near_part.any():
        return np.zeros((0, max_pts - 1, 6), np.float32)
    lens = flat["lens"][near_part]
    pts = flat["pts"][np.repeat(near_part, flat["lens"])]
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    tls_vec = _tls_at(smap, scene_ts)                # [num_lanes]
    return native.vectorize_lanes_native(
        pts,
        offsets,
        flat["types"][near_part],
        tls_vec[flat["lane_idx"][near_part]],
        flat["rates"][near_part],
        np.asarray(center_xy, np.float64),
        float(center_h),
        float(map_range),
        int(max_pts),
    )


def vectorize_lanes_plain(scene: SceneData, center_xy, center_h, scene_ts, config):
    """The numpy plain version of `vectorize_lanes` (the per-lane loop)."""
    setup = _lane_setup(scene, center_xy, config)
    if setup is None:
        return np.zeros((0, config.DATASET.MAP.MAX_LANE_POINTS - 1, 6), np.float32)
    map_cfg, map_range, max_pts, smap, near = setup
    chunks = []
    for li in np.nonzero(near)[0]:
        lane = smap.lanes[li]
        tls = smap.traffic_light_status(lane.lane_id, scene_ts)
        parts = {
            "center": (lane.center, map_cfg.CENTER_SAMPLE_RATE),
            "left_edge": (lane.left_edge, map_cfg.EDGE_SAMPLE_RATE),
            "right_edge": (lane.right_edge, map_cfg.EDGE_SAMPLE_RATE),
        }
        for kind, (pts, rate) in parts.items():
            if kind not in map_cfg.INCLUDE_TYPES or pts is None:
                continue
            v = pts[::rate] if len(pts) > rate else pts
            v = _rot(v - np.asarray(center_xy), -center_h)
            keep = (np.abs(v[:, 0]) < map_range) & (np.abs(v[:, 1]) < map_range)
            v = v[keep]
            if len(v) < 2:
                continue
            bounds = list(range(0, len(v), max_pts))
            if bounds[-1] != len(v):
                bounds.append(len(v))
            for i in range(len(bounds) - 1):
                seg = v[bounds[i]:bounds[i + 1]]
                n = len(seg) - 1
                if n < 1:
                    continue
                vec = np.zeros((max_pts - 1, 6), np.float32)
                vec[:n, 0:2] = seg[:-1]
                vec[:n, 2:4] = seg[1:]
                vec[:n, 4] = LANE_TYPE[kind]
                vec[:n, 5] = tls
                chunks.append(vec)

    if not chunks:
        return np.zeros((0, max_pts - 1, 6), np.float32)
    return np.stack(chunks)


def build_init_map(lane_vecs, config) -> MapInputs:
    """Crop/pad to MAX_POINTS polylines, move each into its symmetric frame,
    append type one-hot + direction channels
    (reference: format_utils.py:153-263)."""
    fmt = config.DATASET.FORMAT.MAP
    L = fmt.MAX_POINTS
    P = config.DATASET.MAP.MAX_LANE_POINTS - 1

    M = lane_vecs.shape[0]
    point_valid = lane_vecs[..., 4] > 0  # [M, P]

    # polyline reference position = mean of valid segment starts
    cnt = np.clip(point_valid.sum(-1), 1, None)
    mean_start = (lane_vecs[..., 0:2] * point_valid[..., None]).sum(1) / cnt[:, None]
    dist = np.linalg.norm(mean_start, axis=-1)
    in_range = dist < fmt.LOCAL_RANGE
    keep = np.nonzero(in_range)[0]
    truncated = len(keep) > L
    if truncated:
        sorted_keep = keep[np.argsort(dist[keep], kind="stable")[:L]]
    else:
        sorted_keep = keep
    vec = lane_vecs[sorted_keep]
    pv = point_valid[sorted_keep]
    out_pv = pv
    if truncated and fmt.REFERENCE_UNSORTED_MASK_QUIRK:
        # reference stale-mask quirk: the RETURNED mask follows the pre-sort
        # chunk order while the vectors (and their sym frames) are
        # distance-sorted (reference: format_utils.py:170-178)
        out_pv = point_valid[keep[:L]]
    Mk = vec.shape[0]

    out = np.zeros((L, P, 11), np.float32)
    mask = np.zeros((L, P), bool)
    pos = np.zeros((L, 2), np.float32)
    ori = np.zeros((L,), np.float32)

    if Mk > 0:
        start = vec[:, 0, 0:2]
        last = np.clip(pv.sum(-1) - 1, 0, None).astype(int)
        end = vec[np.arange(Mk), last, 2:4]
        heading = np.arctan2(end[:, 1] - start[:, 1], end[:, 0] - start[:, 0])
        center = (start + end) / 2

        # rotate both point pairs by -heading with one cos/sin, writing
        # straight into the padded output (no intermediate copies; same math
        # as _rot, see to_frame)
        o = out[:Mk]
        c, s = np.cos(heading)[:, None], np.sin(heading)[:, None]
        cx, cy = center[:, None, 0], center[:, None, 1]
        x0 = vec[..., 0] - cx
        y0 = vec[..., 1] - cy
        o[..., 0] = x0 * c + y0 * s
        o[..., 1] = y0 * c - x0 * s
        x1 = vec[..., 2] - cx
        y1 = vec[..., 3] - cy
        o[..., 2] = x1 * c + y1 * s
        o[..., 3] = y1 * c - x1 * s
        o[..., 4] = vec[..., 4]
        o[..., 5] = vec[..., 5]
        ch = 6
        if fmt.WITH_TYPE_EMB:
            for tid in (1, 2, 3):
                o[..., ch + tid - 1] = vec[..., 4] == tid
            ch += 3
        if fmt.WITH_DIR:
            dx = o[..., 2] - o[..., 0]
            dy = o[..., 3] - o[..., 1]
            norm = np.clip(np.sqrt(dx * dx + dy * dy), 1e-6, None)
            o[..., ch] = dx / norm
            o[..., ch + 1] = dy / norm

        mask[:Mk] = out_pv
        pos[:Mk] = center
        ori[:Mk] = heading

    return MapInputs(
        vectors=out[None], mask=mask[None], pos=pos[None], ori=ori[None]
    )


def build_road_edges(lane_vecs, config, max_edges: int = 16384) -> RoadEdges:
    """Scene-frame lane CENTER segments for the centerline offroad fallback
    (offroad_loss_centerline). When dedicated Waymo road-edge data is present
    (USE_WAYMO_ROAD_EDGE) the loader should instead emit true oriented road
    edges and the signed-distance offroad loss applies."""
    is_edge = lane_vecs[..., 4] == 1  # center segments
    pts = lane_vecs[..., 0:2][is_edge]
    nxt = lane_vecs[..., 2:4][is_edge]
    if len(pts) > max_edges:
        # stride-subsample to keep full-area coverage (segments are ~0.5 m,
        # so skipping every other one barely changes nearest distances)
        stride = int(np.ceil(len(pts) / max_edges))
        pts, nxt = pts[::stride], nxt[::stride]
    E = min(len(pts), max_edges)
    out_p = np.zeros((max_edges, 2), np.float32)
    out_n = np.zeros((max_edges, 2), np.float32)
    out_v = np.zeros((max_edges,), bool)
    out_p[:E] = pts[:E]
    out_n[:E] = nxt[:E]
    out_v[:E] = True
    return RoadEdges(pts=out_p[None], nxt=out_n[None], valid=out_v[None])


# --------------------------------------------------------------------- obs

def build_obs_window(scene_states, scene_valid, types, extents, origin_idx,
                     start, end, hist_steps, config):
    """Relative observation features for all agents over frames [start, end)
    in the scene frame, each agent in its own frame at the window's last step
    (reference: format_utils.py:357-451).

    scene_states [A, T, 8] already in scene frame. Returns feat [A, Th, C],
    step_mask [A, Th], pos [A, 2], ori [A]."""
    window = scene_states[:, start:end]  # [A, Th, 8]
    wvalid = scene_valid[:, start:end]
    return _obs_from_windows(window, wvalid, types, extents, hist_steps)


def _obs_from_windows(window, wvalid, types, extents, Th):
    """Core of build_obs_window on pre-sliced windows [A, Th, 8] (rows are
    independent, so stacked (agent, replan-step) windows batch through one
    call)."""
    A = window.shape[0]
    origin = window[:, -1]  # [A, 8]
    origin_ok = wvalid[:, -1]

    feat = np.zeros((A, Th, 8), np.float32)
    pos = np.zeros((A, 2), np.float32)
    ori = np.zeros((A,), np.float32)
    step_mask = np.zeros((A, Th), bool)

    ok = origin_ok
    if ok.any():
        frame_xy = origin[ok][:, None, [X, Y]]  # [K, 1, 2]
        frame_h = origin[ok][:, None, H]        # [K, 1]
        rel = to_frame(window[ok], frame_xy, frame_h)
        feat[ok] = np.nan_to_num(obs_channels(rel)).astype(np.float32)
        step_mask[ok] = wvalid[ok]
        pos[ok] = origin[ok][:, [X, Y]]
        ori[ok] = origin[ok][:, H]

    ext = np.broadcast_to(extents[:, None, :], (A, Th, 2))
    onehot = np.zeros((A, 3), np.float32)
    for tid in (1, 2, 3):
        onehot[types == tid, tid - 1] = 1.0
    type_ch = np.broadcast_to(onehot[:, None, :], (A, Th, 3))
    time_ch = np.broadcast_to(np.eye(Th, dtype=np.float32)[None], (A, Th, Th))

    full = np.concatenate(
        [feat, ext.astype(np.float32), type_ch, time_ch], axis=-1
    ).astype(np.float32)
    return full, step_mask, pos, ori


# ------------------------------------------------------------------ scene

def format_scene(scene: SceneData, config, scene_ts: int, split: str = "train",
                 rng: Optional[np.random.Generator] = None,
                 out_meta: Optional[dict] = None) -> SceneBatch:
    """Build a single-scene (B=1) SceneBatch at `scene_ts`.

    Scene frame = ego pose at scene_ts (reference USE_EGO_CENTER,
    prosim/config/default.py + trajdata scene-centric batches)."""
    rng = rng or np.random.default_rng(0)
    Th = config.DATASET.FORMAT.HISTORY.STEPS
    S = config.DATASET.FORMAT.TARGET.STEPS
    fut_len_max = int(config.DATASET.MOTION.FUTURE_SEC.TRAIN / config.DATASET.MOTION.DT)
    pad = config.DATASET.FORMAT.PAD
    A_pad, N_pad, L_pad = pad.NUM_OBS_AGENTS, pad.NUM_AGENTS, config.DATASET.FORMAT.MAP.MAX_POINTS

    ego = scene.states[scene.ego_index, scene_ts]
    assert np.isfinite(ego[[X, Y, H]]).all(), "ego must be valid at scene_ts"
    center_xy, center_h = ego[[X, Y]], ego[H]

    # all states in the scene (ego) frame
    sstates = to_frame(scene.states, center_xy, center_h)
    svalid = scene.valid

    t_hist0 = scene_ts - Th + 1
    t_fut0 = scene_ts + 1
    fut_end = min(t_fut0 + fut_len_max, scene.length)
    F = fut_end - t_fut0  # available future frames

    fut_valid = svalid[:, t_fut0:fut_end]  # [A, F]
    fut_len = np.where(
        fut_valid.any(-1), F - np.argmax(fut_valid[:, ::-1], axis=-1), 0
    )  # index of last valid future + 1

    # ---- target agent selection (reference: format_utils.py:760-791)
    valid_now = svalid[:, scene_ts]
    typed = np.isin(scene.agent_types, (1, 2, 3)) if config.DATASET.USE_PED_CYCLIST else (
        scene.agent_types == 1
    )
    tgt = np.nonzero(valid_now & typed & (fut_len > 0))[0]
    tgt = tgt[np.argsort(-fut_len[tgt], kind="stable")]
    if len(tgt) > config.DATASET.AGENT.SCENE_MAX_AGENT:
        if split.upper() == "TRAIN" and config.DATASET.AGENT.RANDOM_TRAIN_SAMPLE:
            tgt = rng.choice(tgt, config.DATASET.AGENT.SCENE_MAX_AGENT, replace=False)
            if out_meta is not None:
                # the ONLY rng draw in format_scene: when it doesn't fire, the
                # whole output is a pure function of (scene, ts, split) and
                # the dataset may cache it across seeds
                out_meta["seed_dependent"] = True
        else:
            tgt = tgt[: config.DATASET.AGENT.SCENE_MAX_AGENT]
    tgt = tgt[:N_pad]
    N = len(tgt)

    # ---- obs universe: target agents first, then other agents valid now
    others = [i for i in range(len(scene.agent_names))
              if i not in set(tgt.tolist()) and valid_now[i]]
    universe = list(tgt.tolist()) + others
    universe = universe[:A_pad]
    A = len(universe)
    uni = np.asarray(universe, np.int64)
    if out_meta is not None:
        out_meta["target_names"] = [scene.agent_names[i] for i in tgt]
        out_meta["universe_names"] = [scene.agent_names[i] for i in universe]

    # ---- init_obs
    feat, step_mask, pos, ori = build_obs_window(
        sstates[uni], svalid[uni], scene.agent_types[uni], scene.extents[uni],
        None, t_hist0, scene_ts + 1, Th, config,
    )

    def pad_first(x, n):
        return np.concatenate(
            [x, np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)], axis=0
        )

    init_obs = ObsInputs(
        feat=pad_first(feat, A_pad)[None],
        mask=pad_first(step_mask, A_pad)[None],
        pos=pad_first(pos, A_pad)[None],
        ori=pad_first(ori, A_pad)[None],
    )

    # ---- init_map
    lane_vecs = vectorize_lanes(scene, center_xy, center_h, scene_ts, config)
    init_map = build_init_map(lane_vecs, config)

    # ---- prompt (reference: prompt_utils.py:111-150)
    now = sstates[tgt, scene_ts]  # [N, 8]
    vel_agent = _rot(now[:, [VX, VY]], -now[:, H])
    onehot = np.zeros((N, 3), np.float32)
    for tid in (1, 2, 3):
        onehot[scene.agent_types[tgt] == tid, tid - 1] = 1.0
    prompt_feat = np.concatenate(
        [vel_agent, scene.extents[tgt], onehot], axis=-1
    ).astype(np.float32)
    prompt_feat = np.nan_to_num(prompt_feat)

    goal_t = t_fut0 + np.clip(fut_len[tgt] - 1, 0, None)
    goal_xy = sstates[tgt, goal_t][:, [X, Y]]

    prompt = Prompt(
        feat=pad_first(prompt_feat, N_pad)[None],
        mask=pad_first(np.ones(N, bool), N_pad)[None],
        pos=pad_first(now[:, [X, Y]].astype(np.float32), N_pad)[None],
        ori=pad_first(now[:, H].astype(np.float32), N_pad)[None],
        agent_type=pad_first(scene.agent_types[tgt].astype(np.int32), N_pad)[None],
        obs_index=np.concatenate(
            [np.arange(N, dtype=np.int32), -np.ones(N_pad - N, np.int32)]
        )[None],
        extent=pad_first(np.nan_to_num(scene.extents[tgt]).astype(np.float32), N_pad)[None],
        goal_point=pad_first(np.nan_to_num(goal_xy).astype(np.float32), N_pad)[None],
    )

    # ---- io pairs (reference: format_utils.py:498-638)
    sample_rate = config.DATASET.FORMAT.TARGET.SAMPLE_RATE
    if split.upper() == "ROLLOUT":
        max_step = config.ROLLOUT.POLICY.MAX_STEPS
    else:
        max_step = fut_len_max
    if config.DATASET.FORMAT.TARGET.TAIL_PADDING:
        max_idx = max_step - 1
    else:
        max_idx = max_step - S
    t_indices = np.arange(max_idx + 1)[::sample_rate]
    T = len(t_indices)
    tgt_dim = len(config.DATASET.FORMAT.TARGET.ELEMENTS.split(","))
    pred_vel = tgt_dim == 5

    io_tgt = np.zeros((T, N_pad, S, tgt_dim), np.float32)
    io_tgt_valid = np.zeros((T, N_pad, S, tgt_dim), bool)
    io_goal = np.zeros((T, N_pad, 2), np.float32)
    io_pos = np.zeros((T, N_pad, 2), np.float32)
    io_ori = np.zeros((T, N_pad), np.float32)
    io_mask = np.zeros((T, N_pad), bool)
    io_type = np.zeros((T, N_pad), np.int32)
    io_init_vel = np.zeros((T, N_pad, 2), np.float32)
    io_extent = np.zeros((T, N_pad, 2), np.float32)

    # vectorized over all replan indices at once (same math as the per-ti
    # loop this replaces: local frame at scene_ts+t, future chunk of S steps,
    # everything re-expressed in that local frame)
    if N > 0:
        sts = sstates[tgt]                       # [N, Tlen, 8]
        svs = svalid[tgt]                        # [N, Tlen]
        st_idx = scene_ts + t_indices            # [T]
        local = sts[:, st_idx].transpose(1, 0, 2)              # [T, N, 8]
        local_ok = (svs[:, st_idx].T
                    & np.isfinite(local[..., [X, Y, H]]).all(-1))  # [T, N]

        # future chunks: frames st_idx+1 .. st_idx+S, NaN past scene end
        chunk_idx = st_idx[:, None] + 1 + np.arange(S)[None, :]   # [T, S]
        in_len = chunk_idx < scene.length
        fut_chunk = sts[:, np.minimum(chunk_idx, scene.length - 1)]  # [N,T,S,8]
        fut_chunk = np.where(in_len[None, :, :, None], fut_chunk, np.nan)
        fut_chunk = fut_chunk.transpose(1, 0, 2, 3)               # [T, N, S, 8]

        ok = local_ok & (~np.isnan(fut_chunk[..., X])).any(-1)    # [T, N]
        any_t = ok.any(-1)                                        # [T]

        frame_xy = local[..., None, [X, Y]]                       # [T, N, 1, 2]
        frame_h = local[..., None, H]                             # [T, N, 1]
        rel = to_frame(fut_chunk, frame_xy, frame_h)
        cols = [X, Y, H, VX, VY] if pred_vel else [X, Y, H]
        rel_t = rel[..., cols]                                    # [T, N, S, D]

        okm = ok[..., None, None]
        io_tgt[:, :N] = np.where(okm, np.nan_to_num(rel_t), 0.0)
        io_tgt_valid[:, :N] = okm & ~np.isnan(rel_t)
        io_mask[:, :N] = ok
        io_pos[:, :N] = np.where(ok[..., None], local[..., [X, Y]], 0.0)
        io_ori[:, :N] = np.where(ok, local[..., H], 0.0)
        io_type[any_t, :N] = scene.agent_types[tgt][None]
        io_extent[any_t, :N] = np.nan_to_num(scene.extents[tgt])[None]

        # goal + initial velocity in the local frame at t
        g = np.broadcast_to(sstates[tgt, goal_t], local.shape)    # [T, N, 8]
        if config.DATASET.FORMAT.GOAL.LOCAL:
            g = to_frame(g[:, :, None], frame_xy, frame_h)[:, :, 0]
        io_goal[:, :N] = np.where(ok[..., None],
                                  np.nan_to_num(g[..., [X, Y]]), 0.0)
        v = to_frame(local[:, :, None], frame_xy, frame_h)[:, :, 0]
        io_init_vel[:, :N] = np.where(ok[..., None],
                                      np.nan_to_num(v[..., [VX, VY]]), 0.0)

    # full future xy in the frame of hist[-1]
    full_xy = np.full((N_pad, T * S, 2), np.nan, np.float32)
    horizon = min(T * S, scene.length - t_fut0)
    base = sstates[tgt, scene_ts]
    fut_states = sstates[tgt, t_fut0 : t_fut0 + horizon]
    rel_fut = to_frame(fut_states, base[:, None, [X, Y]], base[:, None, H])
    full_xy[:N, :horizon] = rel_fut[..., [X, Y]]
    full_valid = ~np.isnan(full_xy[..., 0])

    io_pairs = IOPairs(
        tgt=io_tgt[None],
        tgt_valid=io_tgt_valid[None],
        goal=io_goal[None],
        pos=io_pos[None],
        ori=io_ori[None],
        mask=io_mask[None],
        agent_type=io_type[None],
        init_vel=io_init_vel[None],
        extent=io_extent[None],
        full_traj_xy=np.nan_to_num(full_xy)[None],
        full_traj_valid=full_valid[None],
        t_indices=t_indices.astype(np.int32),
    )

    # ---- fut_obs (reference: format_utils.py:667-687; FUTURE_OBS_TYPE='latest')
    replan = config.ROLLOUT.POLICY.REPLAN_FREQ
    R = T
    fo_feat = np.zeros((R, A_pad, Th, feat.shape[-1]), np.float32)
    fo_mask = np.zeros((R, A_pad, Th), bool)
    fo_pos = np.zeros((R, A_pad, 2), np.float32)
    fo_ori = np.zeros((R, A_pad), np.float32)
    if R > 1 and A > 0:
        # all replan windows batched through one _obs_from_windows call:
        # window ri covers frames (scene_ts + t_indices[ri] + 1 - Th, .. + 1)
        hi = scene_ts + t_indices[1:].astype(np.int64) + 1      # [R-1]
        win_idx = hi[:, None] - Th + np.arange(Th)[None, :]     # [R-1, Th]
        Rm = R - 1
        windows = sstates[uni][:, win_idx]      # [A, R-1, Th, 8]
        wvalids = svalid[uni][:, win_idx]
        f, m, p, o = _obs_from_windows(
            windows.reshape(A * Rm, Th, STATE_DIM),
            wvalids.reshape(A * Rm, Th),
            np.repeat(scene.agent_types[uni], Rm),
            np.repeat(scene.extents[uni], Rm, axis=0),
            Th,
        )
        fo_feat[1:, :A] = f.reshape(A, Rm, Th, -1).transpose(1, 0, 2, 3)
        fo_mask[1:, :A] = m.reshape(A, Rm, Th).transpose(1, 0, 2)
        fo_pos[1:, :A] = p.reshape(A, Rm, 2).transpose(1, 0, 2)
        fo_ori[1:, :A] = o.reshape(A, Rm).T

    fut_obs = FutObs(
        feat=fo_feat[None],
        mask=fo_mask[None],
        pos=fo_pos[None],
        ori=fo_ori[None],
        obs_index=np.broadcast_to(
            np.asarray(prompt.obs_index)[:, None, :], (1, R, N_pad)
        ).copy(),
    )

    # road edges for the offroad loss (scene frame, from edge-type chunks)
    road_edges = build_road_edges(lane_vecs, config)

    return SceneBatch(
        init_map=init_map,
        init_obs=init_obs,
        prompt=prompt,
        io_pairs=io_pairs,
        fut_obs=fut_obs,
        road_edges=road_edges,
        conditions={},
    )


def _cat_scenes(*xs):
    """One leaf of `collate`: per-scene leaves ([1, ...]) are stacked along
    dim 0; per-batch constants (io_pairs.t_indices) are taken once."""
    x0 = np.asarray(xs[0])
    if x0.ndim >= 1 and all(np.shape(x) == x0.shape for x in xs) and x0.shape[0] != 1:
        return x0
    return np.concatenate([np.asarray(x) for x in xs], axis=0)


def collate_conditions(cond_dicts: List[dict]) -> dict:
    """Stack per-scene condition dicts (each leaf [1, ...]) into one HOST
    condition subtree of numpy arrays (dim 0) - the scene bank ships only
    this. All scenes must carry the same condition types (fix-mode sampling
    does; tree_map raises on a structure mismatch otherwise)."""
    def cat(*xs):
        x0 = np.asarray(xs[0])
        if x0.ndim >= 1 and x0.shape[:1] == (1,):
            return np.concatenate([np.asarray(x) for x in xs], axis=0)
        return x0  # shared constant

    return tree_map(cat, *cond_dicts)


def collate_host(batches: List[SceneBatch]) -> SceneBatch:
    """Stack single-scene host batches into one batch (dim 0) of numpy
    arrays in the dtypes the model takes (int64 -> int32, float64 ->
    float32)."""
    return tree_map(lambda *xs: _cat_scenes(*xs).astype(narrow_dtype(np.asarray(xs[0]).dtype),
                                            copy=False), *batches)


def collate(batches: List[SceneBatch]) -> SceneBatch:
    """`collate_host` as CPU tensors; `.to(device)` moves the batch. The
    loader's slab collation (data/loader.py) gives the same arrays without
    allocating."""
    return tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x)), collate_host(batches))
