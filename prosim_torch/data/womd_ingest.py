"""Raw Waymo Open Motion Dataset ingestion: TFRecord Scenario shards -> the
trajdata on-disk cache layout that `data/trajdata_cache.py` reads (the
port's copy of prosim_tpu/data/womd_ingest.py: both write byte-identical
caches, in whichever order they run in one process, since the trajdata
stand-in classes are shared through sys.modules and pickle by name).

The reference builds its cache from raw WOMD through the trajdata package
(reference: prosim/dataset/basic.py:430-564 -> trajdata's waymo loader); this
module removes that dependency entirely: it parses Scenario protos with a
vendored minimal schema (`protos/waymo_scenario.proto`, field numbers
transcribed from the public waymo-open-dataset schema) and writes the exact
cache artifacts the demo dataset ships:

  <cache>/<env>/scene_<i>/agent_data_dt0.10.feather
  <cache>/<env>/scene_<i>/tls_data_dt0.10.feather
  <cache>/<env>/scene_<i>/scene_metadata_dt0.10.dill
  <cache>/<env>/maps/<env>_<i>.pb            (trajdata VectorizedMap)
  <cache>/<env>/scenes_list.dill

The metadata dill is written with class paths spelled as trajdata's own
(`trajdata.data_structures.*`) so caches built here load both through our
stub unpickler AND through a real trajdata install; numeric conventions
(mm-delta map polylines, TrafficLightStatus values, agent naming) mirror
what the bundled demo cache (built by real trajdata) contains.

CLI:
    python -m prosim_torch.data.womd_ingest --tfrecord shard[,shard...] \
        --cache-dir out/cache --env waymo_train [--max-scenes N]
"""

import os
import pickle
import sys
import types
from typing import Dict, Iterable, List, Optional

import numpy as np

from prosim_torch.data.protos import vectorized_map_pb2 as _vm_pb
from prosim_torch.data.protos import waymo_scenario_pb2 as _sc_pb
from prosim_torch.data.tfrecord import read_tfrecords

# Waymo Track.ObjectType -> trajdata AgentType values
# (1 vehicle / 2 pedestrian / 3 bicycle, matching trajdata_cache.AgentMeta).
_AGENT_TYPE = {1: 1, 2: 2, 3: 3}

# Waymo TrafficSignalLaneState.State -> trajdata TrafficLightStatus value as
# stored in tls_data feathers (demo cache holds {1, 2}): GO states -> 1
# (green), STOP states -> 2 (red), caution/unknown -> 0 (unknown).
_TLS_STATUS = {0: 0, 1: 2, 2: 0, 3: 1, 4: 2, 5: 0, 6: 1, 7: 2, 8: 0}


# ---------------------------------------------------------------------------
# trajdata-compatible metadata pickles
#
# pickle stores classes by module.qualname; we register lightweight stand-ins
# under trajdata's module paths for the duration of the dump so the stream is
# loadable by trajdata itself, by dill, and by our _StubUnpickler.
# ---------------------------------------------------------------------------


def _fake_module(name: str):
    """Register `name` (and its parent packages — pickle's save_global
    __import__s the full chain) as in-memory modules."""
    parts = name.split(".")
    mod = None
    for i in range(len(parts)):
        qual = ".".join(parts[: i + 1])
        child = sys.modules.get(qual)
        if child is None:
            child = types.ModuleType(qual)
            sys.modules[qual] = child
        if mod is not None:
            setattr(mod, parts[i], child)
        mod = child
    return mod


class _AgentType(int):
    """Pickles as trajdata.data_structures.agent.AgentType(value)."""

    def __reduce__(self):
        return (type(self), (int(self),))


class _Bag:
    """Attribute bag that pickles via its __dict__ (like a plain object)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _trajdata_classes():
    """Stand-in classes registered under trajdata module paths."""
    agent_mod = _fake_module("trajdata.data_structures.agent")
    scene_mod = _fake_module("trajdata.data_structures.scene_metadata")

    defs = {}
    for mod, name, base in (
        (agent_mod, "AgentType", _AgentType),
        (agent_mod, "AgentMetadata", _Bag),
        (agent_mod, "FixedExtent", _Bag),
        (scene_mod, "Scene", _Bag),
        (scene_mod, "SceneMetadata", _Bag),
    ):
        cls = getattr(mod, name, None)
        if cls is None:
            cls = type(name, (base,), {"__module__": mod.__name__})
            setattr(mod, name, cls)
        defs[name] = cls
    return defs


def _scene_metadata(env_name: str, scene_name: str, location: str, dt: float,
                    length: int, agents: List[dict], raw_data_idx: int,
                    data_split: str, ego_object_id=None):
    td = _trajdata_classes()
    ag = [
        td["AgentMetadata"](
            name=a["name"],
            type=td["AgentType"](a["type"]),
            first_timestep=a["first_ts"],
            last_timestep=a["last_ts"],
            extent=td["FixedExtent"](
                length=a["length"], width=a["width"], height=a["height"]),
        )
        for a in agents
    ]
    return td["Scene"](
        env_metadata=None,
        env_name=env_name,
        name=scene_name,
        location=location,
        data_split=data_split,
        length_timesteps=length,
        raw_data_idx=raw_data_idx,
        # the SDC track is renamed 'ego' (trajdata convention), which would
        # otherwise discard its WOMD object id; WOSAC packaging must remap
        # 'ego' back to the real sim-agent id (reference: gpu_utils.py:286-288
        # ego_sim_agent_id), so stash it in the metadata side-channel
        data_access_info=(
            {"ego_object_id": int(ego_object_id)}
            if ego_object_id is not None else None),
        description=None,
        agents=ag,
        agent_presence=None,
        dt=dt,
    )


# ---------------------------------------------------------------------------
# per-scenario conversion
# ---------------------------------------------------------------------------


def _track_arrays(scenario) -> Dict[str, np.ndarray]:
    """Dense [A, T, ...] state arrays from scenario.tracks (NaN where absent)."""
    T = len(scenario.timestamps_seconds)
    A = len(scenario.tracks)
    xyz = np.full((A, T, 3), np.nan)
    vel = np.full((A, T, 2), np.nan)
    heading = np.full((A, T), np.nan)
    lwh = np.full((A, T, 3), np.nan)
    valid = np.zeros((A, T), bool)
    for i, tr in enumerate(scenario.tracks):
        for t, st in enumerate(tr.states):
            if t >= T or not st.valid:
                continue
            xyz[i, t] = (st.center_x, st.center_y, st.center_z)
            vel[i, t] = (st.velocity_x, st.velocity_y)
            heading[i, t] = st.heading
            lwh[i, t] = (st.length, st.width, st.height)
            valid[i, t] = True
    return dict(xyz=xyz, vel=vel, heading=heading, lwh=lwh, valid=valid)


def _accelerations(vel: np.ndarray, valid: np.ndarray, dt: float) -> np.ndarray:
    """[A, T, 2] finite-difference accelerations over contiguous valid spans
    (trajdata derives ax/ay the same way — WOMD ships velocities only)."""
    A, T, _ = vel.shape
    acc = np.zeros((A, T, 2))
    for i in range(A):
        idx = np.flatnonzero(valid[i])
        if len(idx) < 2:
            continue
        # split into contiguous runs; np.gradient needs >=2 samples
        runs = np.split(idx, np.flatnonzero(np.diff(idx) > 1) + 1)
        for run in runs:
            if len(run) >= 2:
                acc[i, run] = np.gradient(vel[i, run], dt, axis=0)
    return acc


def _agent_order(scenario) -> List[int]:
    """SDC first (trajdata's scene-centric convention: the demo cache lists
    the SDC track at meta.agents[0]), remaining tracks in shard order."""
    sdc = int(scenario.sdc_track_index)
    rest = [i for i in range(len(scenario.tracks)) if i != sdc]
    return [sdc] + rest


def _lane_edge(polylines: Dict[int, np.ndarray], segs) -> Optional[np.ndarray]:
    """Left/right lane edge from BoundarySegments: concatenate the referenced
    road-line/road-edge polylines in lane_start_index order. (trajdata keeps
    the full referenced feature geometry per segment; index ranges refer to
    the LANE polyline, not the boundary's, so no boundary slicing applies.)"""
    segs = sorted(segs, key=lambda s: s.lane_start_index)
    pts = [polylines[s.boundary_feature_id] for s in segs
           if s.boundary_feature_id in polylines]
    if not pts:
        return None
    out = [pts[0]]
    for p in pts[1:]:
        # drop a duplicated junction point between consecutive segments
        if len(out[-1]) and len(p) and np.allclose(out[-1][-1], p[0]):
            p = p[1:]
        if len(p):
            out.append(p)
    return np.concatenate(out, axis=0)


def _mm_delta(poly_xy: np.ndarray, origin: np.ndarray, pl) -> None:
    """Fill a VectorizedMap Polyline message with mm deltas (cumsum inverse:
    first delta is the first point's offset from the shifted origin)."""
    mm = np.round((poly_xy - origin[None, :]) * 1000.0).astype(np.int64)
    d = np.diff(mm, axis=0, prepend=np.zeros((1, 2), np.int64))
    # prepend=0 makes d[0] = mm[0] (offset from origin), d[i>0] = deltas
    pl.dx_mm.extend(int(v) for v in d[:, 0])
    pl.dy_mm.extend(int(v) for v in d[:, 1])


def build_vectorized_map(scenario, map_name: str):
    """trajdata VectorizedMap (road_lane elements with boundary edges) from
    Scenario.map_features."""
    # collect boundary feature geometry (road lines + road edges)
    boundary_poly: Dict[int, np.ndarray] = {}
    lanes = []
    for feat in scenario.map_features:
        which = feat.WhichOneof("feature_data")
        if which in ("road_line", "road_edge"):
            msg = getattr(feat, which)
            if len(msg.polyline):
                boundary_poly[feat.id] = np.array(
                    [(p.x, p.y) for p in msg.polyline])
        elif which == "lane":
            lanes.append(feat)

    all_pts = [np.array([(p.x, p.y) for p in f.lane.polyline])
               for f in lanes if len(f.lane.polyline)]
    all_pts += list(boundary_poly.values())
    if all_pts:
        cat = np.concatenate(all_pts, axis=0)
        lo, hi = cat.min(axis=0), cat.max(axis=0)
    else:
        lo = hi = np.zeros(2)

    vm = _vm_pb.VectorizedMap()
    vm.name = map_name
    vm.shifted_origin.x, vm.shifted_origin.y = float(lo[0]), float(lo[1])
    vm.min_pt.x, vm.min_pt.y = float(lo[0]), float(lo[1])
    vm.max_pt.x, vm.max_pt.y = float(hi[0]), float(hi[1])
    origin = lo

    for feat in lanes:
        lane = feat.lane
        center = np.array([(p.x, p.y) for p in lane.polyline])
        if len(center) < 2:
            continue
        el = vm.elements.add()
        el.id = str(feat.id).encode()
        rl = el.road_lane
        _mm_delta(center, origin, rl.center)
        for segs, target in ((lane.left_boundaries, rl.left_boundary),
                             (lane.right_boundaries, rl.right_boundary)):
            edge = _lane_edge(boundary_poly, segs)
            if edge is not None and len(edge) >= 2:
                _mm_delta(edge, origin, target)
        rl.entry_lanes.extend(str(i).encode() for i in lane.entry_lanes)
        rl.exit_lanes.extend(str(i).encode() for i in lane.exit_lanes)
        rl.adjacent_lanes_left.extend(
            str(n.feature_id).encode() for n in lane.left_neighbors)
        rl.adjacent_lanes_right.extend(
            str(n.feature_id).encode() for n in lane.right_neighbors)
    return vm


def _write_feather(path: str, columns: Dict[str, np.ndarray]) -> None:
    import pyarrow as pa
    import pyarrow.feather

    table = pa.table({k: pa.array(v) for k, v in columns.items()})
    pyarrow.feather.write_feather(table, path)


def ingest_scenario(scenario, cache_dir: str, env_name: str, scene_idx: int,
                    dt: float = 0.1, data_split: str = "train") -> dict:
    """Write one Scenario as scene_<i> under the cache; returns summary."""
    scene_name = f"scene_{scene_idx}"
    location = f"{env_name}_{scene_idx}"
    scene_dir = os.path.join(cache_dir, env_name, scene_name)
    maps_dir = os.path.join(cache_dir, env_name, "maps")
    os.makedirs(scene_dir, exist_ok=True)
    os.makedirs(maps_dir, exist_ok=True)

    tr = _track_arrays(scenario)
    order = _agent_order(scenario)
    ts_sec = np.asarray(scenario.timestamps_seconds)
    scene_dt = float(np.round(np.median(np.diff(ts_sec)), 6)) if len(ts_sec) > 1 else dt
    acc = _accelerations(tr["vel"], tr["valid"], scene_dt)
    T = len(ts_sec)

    # --- agent_data feather: one row per (agent, valid ts), SDC first ------
    cols = {k: [] for k in ("agent_id", "scene_ts", "x", "y", "z", "vx", "vy",
                            "ax", "ay", "heading", "length", "width", "height")}
    agents_meta = []
    sdc_idx = int(scenario.sdc_track_index)
    for i in order:
        track = scenario.tracks[i]
        v = np.flatnonzero(tr["valid"][i])
        if len(v) == 0:
            continue
        # trajdata names the SDC track 'ego' (the bundled demo cache does
        # too); trajdata_cache.load_scene keys its ego-first reordering and
        # ego_index lookup on that name, so match it exactly
        name = "ego" if i == sdc_idx else str(track.id)
        cols["agent_id"].extend([name] * len(v))
        cols["scene_ts"].extend(int(t) for t in v)
        cols["x"].extend(tr["xyz"][i, v, 0])
        cols["y"].extend(tr["xyz"][i, v, 1])
        cols["z"].extend(tr["xyz"][i, v, 2])
        cols["vx"].extend(tr["vel"][i, v, 0])
        cols["vy"].extend(tr["vel"][i, v, 1])
        cols["ax"].extend(acc[i, v, 0])
        cols["ay"].extend(acc[i, v, 1])
        cols["heading"].extend(tr["heading"][i, v])
        cols["length"].extend(tr["lwh"][i, v, 0])
        cols["width"].extend(tr["lwh"][i, v, 1])
        cols["height"].extend(tr["lwh"][i, v, 2])
        agents_meta.append(dict(
            name=name, type=_AGENT_TYPE.get(int(track.object_type), 0),
            first_ts=int(v[0]), last_ts=int(v[-1]),
            length=float(np.nanmax(tr["lwh"][i, v, 0])),
            width=float(np.nanmax(tr["lwh"][i, v, 1])),
            height=float(np.nanmax(tr["lwh"][i, v, 2])),
        ))
    tag = f"dt{dt:.2f}"
    _write_feather(os.path.join(scene_dir, f"agent_data_{tag}.feather"), {
        k: (np.asarray(v) if k in ("agent_id",)
            else np.asarray(v, np.int64) if k == "scene_ts"
            else np.asarray(v, np.float64))
        for k, v in cols.items()
    })

    # --- tls_data feather ---------------------------------------------------
    tls_cols = {"lane_id": [], "scene_ts": [], "status": []}
    for t, dms in enumerate(scenario.dynamic_map_states):
        if t >= T:
            break
        for ls in dms.lane_states:
            tls_cols["lane_id"].append(str(ls.lane))
            tls_cols["scene_ts"].append(t)
            tls_cols["status"].append(_TLS_STATUS.get(int(ls.state), 0))
    _write_feather(os.path.join(scene_dir, f"tls_data_{tag}.feather"), {
        "lane_id": np.asarray(tls_cols["lane_id"], object),
        "scene_ts": np.asarray(tls_cols["scene_ts"], np.int64),
        "status": np.asarray(tls_cols["status"], np.int64),
    })

    # --- map + metadata ------------------------------------------------------
    vm = build_vectorized_map(scenario, f"{env_name}:{location}")
    with open(os.path.join(maps_dir, f"{location}.pb"), "wb") as f:
        f.write(vm.SerializeToString())

    sdc_oid = str(scenario.tracks[sdc_idx].id) if scenario.tracks else None
    meta = _scene_metadata(
        env_name, scene_name, location, dt, T, agents_meta, scene_idx,
        data_split,
        ego_object_id=int(sdc_oid) if sdc_oid and sdc_oid.isdigit() else None)
    with open(os.path.join(scene_dir, f"scene_metadata_{tag}.dill"), "wb") as f:
        pickle.dump(meta, f)

    return dict(scene=scene_name, scenario_id=str(scenario.scenario_id),
                agents=len(agents_meta), timesteps=T,
                lanes=len(vm.elements))


def ingest_shards(tfrecord_paths: Iterable[str], cache_dir: str,
                  env_name: str = "waymo_train", dt: float = 0.1,
                  data_split: str = "train",
                  max_scenes: Optional[int] = None,
                  start_idx: int = 0) -> List[dict]:
    """Ingest scenarios from TFRecord shard(s) into a trajdata-layout cache."""
    summaries = []
    idx = start_idx
    for path in tfrecord_paths:
        for rec in read_tfrecords(path):
            if max_scenes is not None and len(summaries) >= max_scenes:
                break
            scenario = _sc_pb.Scenario()
            scenario.ParseFromString(rec)
            summaries.append(
                ingest_scenario(scenario, cache_dir, env_name, idx, dt,
                                data_split))
            idx += 1
    # scenes_list.dill: trajdata writes SceneMetadata entries; the readers
    # here list directories, so a plain name list keeps the file present
    # without fabricating unused structure.
    env_dir = os.path.join(cache_dir, env_name)
    if summaries:
        names = sorted(
            (d for d in os.listdir(env_dir) if d.startswith("scene_")),
            key=lambda s: int(s.split("_")[1]))
        with open(os.path.join(env_dir, "scenes_list.dill"), "wb") as f:
            pickle.dump(names, f)
    return summaries


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tfrecord", required=True,
                    help="comma-separated TFRecord shard paths")
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--env", default="waymo_train")
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--split", default="train")
    ap.add_argument("--max-scenes", type=int, default=None)
    args = ap.parse_args(argv)

    out = ingest_shards(args.tfrecord.split(","), args.cache_dir, args.env,
                        args.dt, args.split, args.max_scenes)
    for s in out:
        print(json.dumps(s))
    print(f"ingested {len(out)} scenes -> {args.cache_dir}/{args.env}")


if __name__ == "__main__":
    main()
