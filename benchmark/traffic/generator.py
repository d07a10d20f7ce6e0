"""Seeded scene generator: numpy arrays in the program's SceneBatch layout.

One general generator reads a traffic mix's parameters (a JSON file beside
this one) and draws scenes from a seed. Its geometry follows
prosim_torch/data/womd_synth.py: lanes are gently curved arcs in parallel
groups 3.6 m apart (here several such roads cross the scene at random
angles, so the map is as dense as a real one), and agents follow lanes at
varied speeds, with validity gaps in their history. The arrays are written
directly in the formatter's layout (prosim_torch/data/formatter.py): map
slots of 19 segments in each slot's own frame, obs windows in each agent's
frame at the window's last step, the policy agents first among the obs
agents, and logged futures for each replan step.

Every seed gets the same multiset of sizes (valid obs agents, policy
agents, valid lane slots), spread evenly over the mix's ranges and shuffled
by the seed; only the geometry and the order change with the seed.

The layout constants come from the configuration: PAD sizes, history and
replan steps, and the lane slot's points.
"""

import json
import math
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent
DT = 0.1
LANE_WIDTH = 3.6
SEGMENT_M = 1.0  # spacing of a lane polyline's points


def load_mix(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def _spread(lo: int, hi: int, n: int, rng) -> np.ndarray:
    """n sizes evenly over [lo, hi], in an order drawn from rng."""
    vals = np.round(np.linspace(lo, hi, n)).astype(np.int64)
    return vals[rng.permutation(n)]


def _arc(origin, heading, curvature, length):
    """Points every SEGMENT_M along an arc through `origin`, centred on it."""
    s = np.arange(-length / 2, length / 2 + 1e-6, SEGMENT_M)
    th = heading + curvature * s
    if abs(curvature) < 1e-9:
        x, y = s * math.cos(heading), s * math.sin(heading)
    else:
        x = (np.sin(th) - math.sin(heading)) / curvature
        y = (-np.cos(th) + math.cos(heading)) / curvature
    return np.stack([origin[0] + x, origin[1] + y], -1), th


def _offset(pts, th, d):
    """The polyline `pts` shifted d metres to its left."""
    return pts + d * np.stack([-np.sin(th), np.cos(th)], -1)


def _map_slots(rng, n_slots: int, P: int, map_range: float):
    """Lane parts (centre, left and right edge) of crossing roads, chunked
    into slots of P segments. Returns (vectors [n,P,11], mask [n,P],
    pos [n,2], ori [n], lanes: list of (centre points, headings))."""
    slots, lanes = [], []
    while len(slots) < n_slots:
        n_lanes = int(rng.integers(2, 5))
        heading = float(rng.uniform(-math.pi, math.pi))
        origin = rng.uniform(-60.0, 60.0, size=2)
        curvature = float(rng.uniform(-0.004, 0.004))
        length = float(rng.uniform(160.0, 260.0))
        centre, th = _arc(origin, heading, curvature, length)
        for li in range(n_lanes):
            c = _offset(centre, th, (li - (n_lanes - 1) / 2) * LANE_WIDTH)
            lanes.append((c, th))
            tls = float(rng.integers(0, 3))
            for kind, pts in ((1, c), (2, _offset(c, th, LANE_WIDTH / 2)),
                              (3, _offset(c, th, -LANE_WIDTH / 2))):
                keep = (np.abs(pts) < map_range).all(-1)
                pts = pts[keep]
                for i in range(0, len(pts) - 1, P):
                    seg = pts[i:i + P + 1]
                    if len(seg) >= 2:
                        slots.append((kind, tls, seg))
    order = rng.permutation(len(slots))[:n_slots]
    vec = np.zeros((n_slots, P, 11), np.float32)
    mask = np.zeros((n_slots, P), bool)
    pos = np.zeros((n_slots, 2), np.float32)
    ori = np.zeros((n_slots,), np.float32)
    for j, k in enumerate(order):
        kind, tls, seg = slots[k]
        n = len(seg) - 1
        start, end = seg[0], seg[-1]
        h = math.atan2(end[1] - start[1], end[0] - start[0])
        ctr = (start + end) / 2
        c, s = math.cos(h), math.sin(h)
        loc = seg - ctr
        loc = np.stack([loc[:, 0] * c + loc[:, 1] * s, loc[:, 1] * c - loc[:, 0] * s], -1)
        vec[j, :n, 0:2] = loc[:-1]
        vec[j, :n, 2:4] = loc[1:]
        vec[j, :n, 4] = kind
        vec[j, :n, 5] = tls
        vec[j, :n, 5 + kind] = 1.0
        d = loc[1:] - loc[:-1]
        vec[j, :n, 9:11] = d / np.clip(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6, None)
        mask[j, :n] = True
        pos[j] = ctr
        ori[j] = h
    return vec, mask, pos, ori, lanes


def _agent_tracks(rng, n_agents: int, lanes, total_steps: int):
    """Agents following lanes: states [A, T, 6] = (x, y, heading, vx, vy,
    speed), types [A], extents [A, 2], first valid step [A]."""
    states = np.zeros((n_agents, total_steps, 6), np.float64)
    types = np.ones(n_agents, np.int32)
    extents = np.zeros((n_agents, 2), np.float32)
    t = np.arange(total_steps) * DT
    for a in range(n_agents):
        c, th = lanes[int(rng.integers(len(lanes)))]
        u = rng.random()
        types[a] = 2 if u < 0.12 else (3 if u < 0.17 else 1)
        speed = (rng.uniform(0.5, 2.0) if types[a] == 2 else
                 rng.uniform(2.0, 8.0) if types[a] == 3 else rng.uniform(0.0, 15.0))
        acc = rng.uniform(-0.5, 0.5)
        s0 = rng.uniform(0.2, 0.8) * (len(c) - 1) * SEGMENT_M
        s = s0 + speed * t + 0.5 * acc * t * t
        s = np.clip(s, 0.0, (len(c) - 1) * SEGMENT_M)
        i = np.clip((s / SEGMENT_M).astype(np.int64), 0, len(c) - 2)
        f = (s / SEGMENT_M - i)[:, None]
        xy = c[i] * (1 - f) + c[i + 1] * f + rng.normal(0.0, 0.3)
        h = th[i] * (1 - f[:, 0]) + th[i + 1] * f[:, 0]
        v = np.gradient(s, DT)
        states[a, :, 0:2] = xy
        states[a, :, 2] = h
        states[a, :, 3] = v * np.cos(h)
        states[a, :, 4] = v * np.sin(h)
        states[a, :, 5] = v
        extents[a] = ((0.8, 0.8) if types[a] == 2 else (1.8, 0.7) if types[a] == 3
                      else (rng.uniform(4.2, 5.5), rng.uniform(1.9, 2.3)))
    first = np.where(rng.random(n_agents) < 0.3, rng.integers(1, 8, n_agents), 0)
    return states, types, extents, first


def _obs_windows(states, valid, types, extents, end: int, Th: int):
    """Obs features [A, Th, 24] of the window ending at step `end`
    (inclusive), each agent in its frame at that step; step mask, pos, ori."""
    w = states[:, end - Th + 1:end + 1]
    wv = valid[:, end - Th + 1:end + 1]
    o = w[:, -1]
    c, s = np.cos(o[:, 2])[:, None], np.sin(o[:, 2])[:, None]
    dx, dy = w[..., 0] - o[:, None, 0], w[..., 1] - o[:, None, 1]
    x, y = dx * c + dy * s, dy * c - dx * s
    rh = w[..., 2] - o[:, None, 2]
    vx, vy = w[..., 3] * c + w[..., 4] * s, w[..., 4] * c - w[..., 3] * s
    ax, ay = np.gradient(vx, DT, axis=1), np.gradient(vy, DT, axis=1)
    feat = np.stack([x, y, np.sin(rh), np.cos(rh), vx, vy, ax, ay], -1) * wv[..., None]
    A = states.shape[0]
    onehot = np.zeros((A, 3))
    onehot[np.arange(A), types - 1] = 1.0
    full = np.concatenate([feat, np.broadcast_to(extents[:, None], (A, Th, 2)),
                           np.broadcast_to(onehot[:, None], (A, Th, 3)),
                           np.broadcast_to(np.eye(Th)[None], (A, Th, Th))], -1)
    return full.astype(np.float32), wv, o[:, 0:2].astype(np.float32), o[:, 2].astype(np.float32)


def make_scene(rng, n_obs: int, n_slots: int, pad: dict) -> dict:
    """One scene (leading axis 1) in the SceneBatch layout, plus its world
    pose ('world_xy' [1, 2], 'world_h' [1])."""
    L, P, A_pad, N_pad = pad["lanes"], pad["lane_points"], pad["obs_agents"], pad["agents"]
    Th, R, replan = pad["hist_steps"], pad["replan_steps"], pad["replan"]
    vec, mmask, mpos, mori, lanes = _map_slots(rng, n_slots, P, pad["map_range"])
    total = Th + R * replan
    states, types, extents, first = _agent_tracks(rng, n_obs, lanes, total)
    valid = np.arange(total)[None] >= first[:, None]
    N = min(n_obs, N_pad)
    now = Th - 1

    def pad_to(x, n):
        return np.concatenate([x, np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)], 0)

    feat, smask, pos, ori = _obs_windows(states, valid, types, extents, now, Th)
    init_map = dict(vectors=pad_to(vec, L)[None], mask=pad_to(mmask, L)[None],
                    pos=pad_to(mpos, L)[None], ori=pad_to(mori, L)[None])
    init_obs = dict(feat=pad_to(feat, A_pad)[None], mask=pad_to(smask, A_pad)[None],
                    pos=pad_to(pos, A_pad)[None], ori=pad_to(ori, A_pad)[None])
    h = states[:N, now, 2]
    v = states[:N, now, 3:5]
    vel_agent = np.stack([v[:, 0] * np.cos(h) + v[:, 1] * np.sin(h),
                          v[:, 1] * np.cos(h) - v[:, 0] * np.sin(h)], -1)
    onehot = np.zeros((N, 3))
    onehot[np.arange(N), types[:N] - 1] = 1.0
    prompt = dict(
        feat=pad_to(np.concatenate([vel_agent, extents[:N], onehot], -1).astype(np.float32),
                    N_pad)[None],
        mask=pad_to(np.ones(N, bool), N_pad)[None],
        pos=pad_to(pos[:N], N_pad)[None],
        ori=pad_to(ori[:N], N_pad)[None],
        agent_type=pad_to(types[:N], N_pad)[None],
        obs_index=np.concatenate([np.arange(N), -np.ones(N_pad - N)]).astype(np.int32)[None],
        extent=pad_to(extents[:N], N_pad)[None],
        goal_point=pad_to(states[:N, -1, 0:2].astype(np.float32), N_pad)[None])
    fo = {k: [] for k in ("feat", "mask", "pos", "ori")}
    for r in range(R):
        f, m, p, o = _obs_windows(states, valid, types, extents, now + r * replan, Th)
        for k, x in zip(("feat", "mask", "pos", "ori"), (f, m, p, o)):
            fo[k].append(pad_to(x, A_pad))
    fut_obs = {k: np.stack(v)[None] for k, v in fo.items()}
    fut_obs["obs_index"] = np.broadcast_to(prompt["obs_index"][:, None], (1, R, N_pad)).copy()
    return dict(init_map=init_map, init_obs=init_obs, prompt=prompt, fut_obs=fut_obs,
                conditions={}, io_pairs=None,
                world_xy=rng.uniform(-3000.0, 3000.0, size=(1, 2)).astype(np.float32),
                world_h=rng.uniform(-math.pi, math.pi, size=(1,)).astype(np.float32))


def concat_scenes(scenes) -> dict:
    """Stack single-scene dicts along the scene axis."""
    def cat(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], dict):
            return {k: cat([x[k] for x in xs]) for k in xs[0]}
        return np.concatenate(xs, 0)
    return cat(list(scenes))


def program_arrays(scene: dict) -> dict:
    """A pool entry without the benchmark's own keys (the world pose): the
    arrays the program's SceneBatch is made from."""
    return {k: v for k, v in scene.items() if k not in ("world_xy", "world_h")}


def pad_sizes(cfg) -> dict:
    """The layout's sizes from a configuration (an attribute tree)."""
    ds = cfg.DATASET
    return dict(lanes=ds.FORMAT.MAP.MAX_POINTS, lane_points=ds.MAP.MAX_LANE_POINTS - 1,
                obs_agents=ds.FORMAT.PAD.NUM_OBS_AGENTS, agents=ds.FORMAT.PAD.NUM_AGENTS,
                hist_steps=ds.FORMAT.HISTORY.STEPS, replan=cfg.ROLLOUT.POLICY.REPLAN_FREQ,
                replan_steps=cfg.ROLLOUT.POLICY.MAX_STEPS // cfg.ROLLOUT.POLICY.REPLAN_FREQ,
                map_range=float(ds.MAP.RANGE.ROLLOUT))


def make_pool(mix: dict, cfg, seed: int):
    """The mix's pool of calls: a list of `mix['calls']` scene dicts, each
    of `mix['scenes_per_call']` scenes, from `seed`."""
    rng = np.random.default_rng(seed)
    n = mix["calls"] * mix["scenes_per_call"]
    obs = _spread(*mix["obs_agents"], n, rng)
    slots = _spread(*mix["lane_slots"], n, rng)
    pad = pad_sizes(cfg)
    scenes = [make_scene(rng, int(a), int(s), pad) for a, s in zip(obs, slots)]
    k = mix["scenes_per_call"]
    return [concat_scenes(scenes[i:i + k]) for i in range(0, n, k)]
