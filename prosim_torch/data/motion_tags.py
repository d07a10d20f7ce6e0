"""Motion tags: per-agent action labels over time intervals (the port's
copy of prosim_tpu/data/motion_tags.py; numpy only).

The reference sources motion tags from the prosim_instruct_520k JSON release
and post-processes them (reference: prosim/dataset/data_utils.py:524-575,
dataset/motion_tag_utils.py:4-211). This module provides both:

  * a JSON loader for the released tag format, and
  * a self-contained deriver that computes unary tags directly from cached
    trajectories (speed / heading profiles) so action-tag prompting works on
    any trajdata cache without the 520k download.

Interval post-processing honors the same config knobs: merge same-tag
intervals separated by <= INTEGRATE_TOLERANCE, drop intervals shorter than
MIN_DURATION, and resolve conflicts inside exclusion groups by priority.
"""

import json
import os
from dataclasses import dataclass
from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class VActionTag(IntEnum):
    """Unary tag vocab; values match the reference enum exactly
    (reference: prosim/dataset/motion_tag_utils.py:4-15) so tag ids in data,
    parameter-bank rows, and converted checkpoints line up."""

    Stopping = 0
    Accelerate = 1
    Decelerate = 2
    KeepSpeed = 3
    LeftLaneChange = 4
    RightLaneChange = 5
    KeepLane = 6
    LeftTurn = 7
    RightTurn = 8
    Straight = 9
    Parked = 10


class V2VTag(IntEnum):
    """Binary (pair) tag vocab (reference: motion_tag_utils.py:17-22)."""

    Following = 0
    ParallelDriving = 1
    Merging = 2
    ByPassing = 3
    Overtaking = 4


# per-tag exclusion lists and priorities, matching the reference values
# exactly (reference: motion_tag_utils.py:111-138). The map is asymmetric
# (e.g. KeepSpeed excludes Decelerate but not vice versa) and lower priority
# number wins on overlap; ties split at the later tag's start.
EXCLUSION_MAP = {
    "Accelerate": ("Stopping", "Decelerate", "KeepSpeed", "Parked"),
    "Stopping": ("Accelerate", "KeepSpeed", "Parked"),
    "Decelerate": ("Accelerate", "Stopping", "Parked"),
    "KeepSpeed": ("Accelerate", "Stopping", "Decelerate", "Parked"),
    "Parked": ("Accelerate", "Stopping", "Decelerate", "KeepSpeed",
               "Straight", "KeepLane"),
    "LeftTurn": ("RightTurn", "Straight"),
    "RightTurn": ("LeftTurn", "Straight"),
    "Straight": ("LeftTurn", "RightTurn", "Parked"),
    "LeftLaneChange": ("RightLaneChange", "KeepLane"),
    "RightLaneChange": ("LeftLaneChange", "KeepLane"),
    "KeepLane": ("LeftLaneChange", "RightLaneChange", "Parked"),
}
PRIORITY = {
    "LeftTurn": 1, "RightTurn": 1, "Straight": 3,
    "LeftLaneChange": 1, "RightLaneChange": 1, "KeepLane": 3,
    "Accelerate": 1, "Stopping": 1, "Decelerate": 1, "KeepSpeed": 3,
    "Parked": 2,
}


@dataclass
class MotionTag:
    tag: str
    agents: Tuple[str, ...]
    interval: Tuple[int, int]  # [start, end] in scene frames
    type: str = "unary"


# ------------------------------------------------------------- processing

def integrate_tags(tags: List[MotionTag], tolerance: int) -> List[MotionTag]:
    """Merge same-(tag, agents) intervals with gaps <= tolerance."""
    by_key: Dict[tuple, List[MotionTag]] = {}
    for t in tags:
        by_key.setdefault((t.tag, t.agents, t.type), []).append(t)
    out = []
    for (tag, agents, ttype), group in by_key.items():
        group.sort(key=lambda t: t.interval[0])
        cur_s, cur_e = group[0].interval
        for t in group[1:]:
            s, e = t.interval
            if s - cur_e <= tolerance:
                cur_e = max(cur_e, e)
            else:
                out.append(MotionTag(tag, agents, (cur_s, cur_e), ttype))
                cur_s, cur_e = s, e
        out.append(MotionTag(tag, agents, (cur_s, cur_e), ttype))
    return out


def remove_short_tags(tags: List[MotionTag], min_duration: int) -> List[MotionTag]:
    return [t for t in tags if t.interval[1] - t.interval[0] >= min_duration]


def resolve_conflicts(tags: List[MotionTag]) -> List[MotionTag]:
    """Sweep tags in start order, trimming overlaps between mutually
    exclusive same-agent tags by priority; equal priorities split at the
    later tag's start. Semantics match the reference sweep exactly
    (resolve_and_adjust_conflicts, motion_tag_utils.py:140-211; fuzz
    parity-tested against the reference in tests/test_reference_parity.py,
    this copy against prosim_tpu's in tests/test_torch_conditions_gen.py),
    including the final adjacent-run merge."""
    inf = float("inf")
    current: List[MotionTag] = []
    for tag in sorted(tags, key=lambda t: t.interval[0]):
        ns, ne = tag.interval
        p_new = PRIORITY.get(tag.tag, inf)
        adjusted: List[MotionTag] = []
        for cur in current:
            cs, ce = cur.interval
            p_cur = PRIORITY.get(cur.tag, inf)
            if (tag.agents == cur.agents
                    and tag.tag in EXCLUSION_MAP.get(cur.tag, ())
                    and max(cs, ns) < min(ce, ne)):
                if p_cur < p_new:
                    ns = ce          # push the new tag past the current one
                elif p_new < p_cur:
                    if cs < ns:      # keep the current tag's head
                        adjusted.append(
                            MotionTag(cur.tag, cur.agents, (cs, ns), cur.type))
                    ce = ns
                elif ns > cs:        # tie: split at the later start
                    adjusted.append(
                        MotionTag(cur.tag, cur.agents, (cs, ns), cur.type))
                    ce = ns
            if cs < ce:
                adjusted.append(MotionTag(cur.tag, cur.agents, (cs, ce), cur.type))
        if ns < ne:
            adjusted.append(MotionTag(tag.tag, tag.agents, (ns, ne), tag.type))
        current = adjusted
    if not current:
        return []
    merged = [current[0]]
    for t in current[1:]:
        last = merged[-1]
        if (t.tag == last.tag and t.agents == last.agents
                and t.interval[0] <= last.interval[1]):
            merged[-1] = MotionTag(
                last.tag, last.agents,
                (last.interval[0], max(last.interval[1], t.interval[1])),
                last.type)
        else:
            merged.append(t)
    return merged


def process_tags(tags, tolerance: int, min_duration: int) -> List[MotionTag]:
    tags = integrate_tags(tags, tolerance)
    tags = remove_short_tags(tags, min_duration)
    tags = resolve_conflicts(tags)
    return sorted(tags, key=lambda t: (t.agents, t.interval[0]))


# --------------------------------------------------------------- deriver

def derive_motion_tags(
    states: np.ndarray,       # [A, T, 8] world or scene frame
    valid: np.ndarray,        # [A, T]
    agent_names: Sequence[str],
    dt: float = 0.1,
    used_tags: Optional[Sequence[str]] = None,
    smooth: int = 5,
    acc_thresh: float = 0.4,       # m/s^2 sustained
    turn_rate_thresh: float = 0.1, # rad over the window per step ~ deg/s
    stop_speed: float = 0.5,
    parked_speed: float = 0.2,
) -> List[MotionTag]:
    """Heuristic unary tags from speed / heading profiles."""
    from prosim_torch.data.trajdata_cache import VX, VY, H

    used = set(used_tags) if used_tags is not None else {t.name for t in VActionTag}
    A, T, _ = states.shape
    tags: List[MotionTag] = []

    kernel = np.ones(smooth) / smooth

    for a in range(A):
        ok = valid[a]
        if ok.sum() < smooth + 2:
            continue
        idx = np.nonzero(ok)[0]
        s0, s1 = idx[0], idx[-1] + 1
        speed = np.nan_to_num(np.linalg.norm(states[a, s0:s1][:, [VX, VY]], axis=-1))
        heading = np.nan_to_num(states[a, s0:s1][:, H])
        n = len(speed)
        if n < smooth + 2:
            continue
        sm_speed = np.convolve(speed, kernel, mode="same")
        acc = np.gradient(sm_speed, dt)
        dhead = np.gradient(np.unwrap(heading), dt)  # rad/s

        name = (agent_names[a],)

        def emit(tag, mask):
            if tag not in used or not mask.any():
                return
            d = np.diff(np.concatenate([[0], mask.astype(int), [0]]))
            starts = np.nonzero(d == 1)[0]
            ends = np.nonzero(d == -1)[0]
            for st, en in zip(starts, ends):
                tags.append(MotionTag(tag, name, (int(st + s0), int(en - 1 + s0))))

        if (sm_speed < parked_speed).all():
            emit("Parked", np.ones(n, bool))
            continue

        emit("Accelerate", (acc > acc_thresh) & (sm_speed > stop_speed))
        emit("Decelerate", (acc < -acc_thresh) & (sm_speed > stop_speed))
        emit("KeepSpeed", (np.abs(acc) <= acc_thresh) & (sm_speed > stop_speed))
        emit("Stopping", (acc < -acc_thresh / 2) & (sm_speed <= stop_speed * 3)
             & (np.minimum.accumulate(sm_speed[::-1])[::-1] < stop_speed))
        emit("LeftTurn", (dhead > turn_rate_thresh) & (sm_speed > stop_speed))
        emit("RightTurn", (dhead < -turn_rate_thresh) & (sm_speed > stop_speed))
        emit("Straight", (np.abs(dhead) <= turn_rate_thresh) & (sm_speed > stop_speed))

    return tags


def derive_v2v_tags(
    states: np.ndarray,       # [A, T, 8]
    valid: np.ndarray,        # [A, T]
    agent_names: Sequence[str],
    dt: float = 0.1,
    used_tags: Optional[Sequence[str]] = None,
    max_range: float = 30.0,
    same_dir_thresh: float = 0.5,   # rad
    lane_width: float = 3.7,
    min_speed: float = 0.5,
) -> List[MotionTag]:
    """Heuristic binary (pair) tags from pairwise trajectory geometry - the
    self-contained substitute for the 520k release's GPT-labeled pair tags
    (reference vocab: motion_tag_utils.py:17-22; builder contract:
    condition_utils.py:317-364). Pair (i, j) reads as "agent i <tag> agent j".

      Following       - j ahead of i in i's lane direction, small lateral
                        offset, similar heading, both moving
      ParallelDriving - similar heading, ~a lane apart laterally, overlapping
                        longitudinally, both moving
      Merging         - lateral gap shrinking below a lane while headings
                        converge and i sits beside/behind j
      ByPassing       - i drives past a (near-)stopped j at a lateral offset
      Overtaking      - i goes from behind j to ahead of j while both move
    """
    from prosim_torch.data.trajdata_cache import H, VX, VY, X, Y

    used = set(used_tags) if used_tags is not None else {t.name for t in V2VTag}
    A, T, _ = states.shape
    tags: List[MotionTag] = []

    xy = np.nan_to_num(states[..., [X, Y]])
    heading = np.nan_to_num(states[..., H])
    speed = np.nan_to_num(np.linalg.norm(states[..., [VX, VY]], axis=-1))

    def emit(tag, i, j, mask, t0):
        if tag not in used or not mask.any():
            return
        d = np.diff(np.concatenate([[0], mask.astype(int), [0]]))
        for st, en in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
            tags.append(MotionTag(
                tag, (agent_names[i], agent_names[j]),
                (int(st + t0), int(en - 1 + t0)), "binary",
            ))

    for i in range(A):
        for j in range(A):
            if i == j:
                continue
            both = valid[i] & valid[j]
            if both.sum() < 5:
                continue
            idx = np.nonzero(both)[0]
            t0, t1 = idx[0], idx[-1] + 1
            sl = slice(t0, t1)

            rel = xy[j, sl] - xy[i, sl]                     # world frame
            c, s = np.cos(heading[i, sl]), np.sin(heading[i, sl])
            lon = rel[:, 0] * c + rel[:, 1] * s             # + = j ahead of i
            lat = -rel[:, 0] * s + rel[:, 1] * c            # + = j left of i
            dist = np.linalg.norm(rel, axis=-1)
            dh = np.abs(wrap_angle_np(heading[j, sl] - heading[i, sl]))
            near = (dist < max_range) & both[sl]
            same_dir = dh < same_dir_thresh
            i_moving = speed[i, sl] > min_speed
            j_moving = speed[j, sl] > min_speed

            emit("Following", i, j,
                 near & same_dir & i_moving & j_moving
                 & (lon > 2.0) & (lon < max_range)
                 & (np.abs(lat) < lane_width / 2), t0)

            emit("ParallelDriving", i, j,
                 near & same_dir & i_moving & j_moving
                 & (np.abs(lon) < 8.0)
                 & (np.abs(lat) > lane_width / 2)
                 & (np.abs(lat) < 2 * lane_width), t0)

            emit("ByPassing", i, j,
                 near & i_moving & ~j_moving
                 & (np.abs(lon) < 10.0)
                 & (np.abs(lat) > 0.8) & (np.abs(lat) < 2 * lane_width), t0)

            # Merging: beside/behind with the lateral gap closing and
            # headings converging
            if "Merging" in used and near.sum() >= 5:
                abs_lat = np.abs(lat)
                lat_closing = np.gradient(abs_lat) < -0.02
                converge = np.gradient(dh) <= 0.002
                emit("Merging", i, j,
                     near & i_moving & j_moving & lat_closing & converge
                     & (abs_lat > lane_width / 2) & (abs_lat < 2 * lane_width)
                     & (lon > -15.0) & (lon < 15.0), t0)

            # Overtaking: i starts behind j (j ahead, lon > 0) and ends up
            # ahead of j (lon < 0) while both move
            if "Overtaking" in used:
                j_ahead = (lon > 2.0) & near & same_dir
                j_behind = (lon < -2.0) & near & same_dir
                if j_ahead.any() and j_behind.any():
                    first_ahead = int(np.argmax(j_ahead))
                    after = np.nonzero(j_behind)[0]
                    after = after[after > first_ahead]
                    if len(after):
                        span = np.zeros(t1 - t0, bool)
                        span[first_ahead:after[0] + 1] = True
                        emit("Overtaking", i, j,
                             span & i_moving & j_moving, t0)
    return tags


def wrap_angle_np(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


# ----------------------------------------------------------------- loader

def load_tags_json(path: str) -> List[MotionTag]:
    """Load the released 520k-format tag JSON for one scene."""
    with open(path) as f:
        raw = json.load(f)
    out = []
    for t in raw if isinstance(raw, list) else raw.get("result", []):
        out.append(
            MotionTag(
                tag=t["tag"],
                agents=tuple(t["agents"]),
                interval=(int(t["interval"][0]), int(t["interval"][1])),
                type=t.get("type", "unary"),
            )
        )
    return out


def filter_to_interval(tags: List[MotionTag], start: int, end: int) -> List[MotionTag]:
    out = []
    for t in tags:
        s, e = t.interval
        s2, e2 = max(s, start), min(e, end)
        if e2 > s2:
            out.append(MotionTag(t.tag, t.agents, (s2 - start, e2 - start), t.type))
    return out
