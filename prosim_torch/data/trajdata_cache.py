"""Host-side reader for the trajdata on-disk cache (the port's copy of
prosim_tpu/data/trajdata_cache.py; the map protos are imported as package
modules).

The reference consumes Waymo scenes through the trajdata package
(reference: prosim/dataset/basic.py:21-39); this module reads trajdata's cache
format directly - per-scene feather dataframes, dill scene metadata, and
protobuf vectorized maps - with no trajdata dependency:

  <cache>/<env>/scene_<i>/agent_data_dt0.10.feather   agent states per ts
  <cache>/<env>/scene_<i>/tls_data_dt0.10.feather     traffic light status
  <cache>/<env>/scene_<i>/scene_metadata_dt0.10.dill  agents, types, map id
  <cache>/<env>/maps/<map_id>.pb                      vectorized map
"""

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from prosim_torch.data.protos import vectorized_map_pb2 as _vm_pb


# state channel order used throughout the host pipeline
#   x, y, z, vx, vy, ax, ay, heading
STATE_DIM = 8
X, Y, Z, VX, VY, AX, AY, H = range(STATE_DIM)


class _StubUnpickler(pickle.Unpickler):
    """Unpickles trajdata metadata without trajdata installed: unknown
    classes become attribute bags; enum reconstructions keep their value in
    `_init_args`."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except Exception:
            def __init__(self, *a, **k):
                self.__dict__["_init_args"] = (a, k)

            def __setstate__(self, state):
                if isinstance(state, dict):
                    self.__dict__.update(state)
                else:
                    self.__dict__["_state"] = state

            return type(
                name,
                (),
                {
                    "__module__": module,
                    "__init__": __init__,
                    "__setstate__": __setstate__,
                },
            )


@dataclass
class AgentMeta:
    name: str
    type: int           # 1 vehicle / 2 pedestrian / 3 bicycle (trajdata values)
    first_ts: int
    last_ts: int


@dataclass
class LaneData:
    lane_id: str
    center: np.ndarray                  # [P, 2] world xy
    left_edge: Optional[np.ndarray]     # [P, 2] or None
    right_edge: Optional[np.ndarray]


@dataclass
class SceneMap:
    lanes: List[LaneData]
    lane_centers: np.ndarray            # [L, 2] mean xy per lane (for range query)
    tls: Dict[str, np.ndarray] = field(default_factory=dict)  # lane_id -> [T] status

    def traffic_light_status(self, lane_id: str, scene_ts: int) -> float:
        arr = self.tls.get(lane_id)
        if arr is None or scene_ts >= len(arr):
            return 0.0
        return float(arr[scene_ts])


@dataclass
class SceneData:
    name: str
    env_name: str
    location: str
    length: int
    agent_names: List[str]
    agent_types: np.ndarray      # [A]
    states: np.ndarray           # [A, T, 8] world frame, NaN where absent
    valid: np.ndarray            # [A, T]
    extents: np.ndarray          # [A, 2] (length, width) max over time
    ego_index: int
    map: Optional[SceneMap] = None
    # WOMD object id of the 'ego'-renamed SDC track (womd_ingest stores it in
    # scene_metadata.data_access_info; None for caches that never recorded it,
    # e.g. the bundled demo cache). WOSAC packaging remaps 'ego' back to this
    # id (reference: prosim/rollout/gpu_utils.py:286-288 ego_sim_agent_id).
    ego_object_id: Optional[int] = None


def _read_feather(path: str):
    """Read a Feather V2 (Arrow IPC file) dataframe. pyarrow deprecated
    feather.read_feather in 24.0; prefer the IPC reader, fall back for
    Feather V1 files."""
    import pyarrow.ipc  # deferred: heavy import

    try:
        with pyarrow.ipc.open_file(path) as r:
            return r.read_pandas()
    except Exception:
        import pyarrow.feather

        return pyarrow.feather.read_feather(path)


def _dt_tag(dt: float) -> str:
    return f"dt{dt:.2f}"


def load_scene_metadata(scene_dir: str, dt: float = 0.1):
    path = os.path.join(scene_dir, f"scene_metadata_{_dt_tag(dt)}.dill")
    with open(path, "rb") as f:
        return _StubUnpickler(f).load()


def load_scene(cache_dir: str, env_name: str, scene_name: str, dt: float = 0.1,
               with_map: bool = True) -> SceneData:
    scene_dir = os.path.join(cache_dir, env_name, scene_name)
    meta = load_scene_metadata(scene_dir, dt)
    T = int(meta.length_timesteps)

    agent_meta = []
    for a in meta.agents:
        # stub-unpickled enums keep their value in _init_args; a real
        # trajdata AgentType (IntEnum) or womd_ingest stand-in is int-like
        t = (int(a.type) if isinstance(a.type, int)
             else a.type.__dict__.get("_init_args", ((0,), {}))[0][0])
        agent_meta.append(
            AgentMeta(str(a.name), int(t), int(a.first_timestep), int(a.last_timestep))
        )

    df = _read_feather(
        os.path.join(scene_dir, f"agent_data_{_dt_tag(dt)}.feather")
    )

    names = [m.name for m in agent_meta]
    # ego leads the agent ordering if present (scene-centric convention)
    if "ego" in names:
        order = ["ego"] + [n for n in names if n != "ego"]
    else:
        order = names
    idx_of = {n: i for i, n in enumerate(order)}
    meta_of = {m.name: m for m in agent_meta}

    A = len(order)
    states = np.full((A, T, STATE_DIM), np.nan, np.float64)
    extents = np.full((A, 2), -1.0, np.float64)

    aid = df["agent_id"].to_numpy()
    ts = df["scene_ts"].to_numpy().astype(np.int64)
    cols = np.stack(
        [df[c].to_numpy().astype(np.float64)
         for c in ("x", "y", "z", "vx", "vy", "ax", "ay", "heading")],
        axis=-1,
    )
    lw = np.stack(
        [df["length"].to_numpy().astype(np.float64), df["width"].to_numpy().astype(np.float64)],
        axis=-1,
    )
    rows = np.array([idx_of[str(a)] for a in aid])
    states[rows, ts] = cols
    np.maximum.at(extents, rows, lw)

    valid = ~np.isnan(states[..., X])
    types = np.array([meta_of[n].type for n in order], np.int32)

    dai = getattr(meta, "data_access_info", None)
    ego_oid = (int(dai["ego_object_id"])
               if isinstance(dai, dict) and dai.get("ego_object_id") is not None
               else None)

    scene = SceneData(
        name=scene_name,
        env_name=env_name,
        location=str(meta.location),
        length=T,
        agent_names=order,
        agent_types=types,
        states=states,
        valid=valid,
        extents=extents,
        ego_index=idx_of.get("ego", 0),
        ego_object_id=ego_oid,
    )
    if with_map:
        scene.map = load_map(cache_dir, env_name, str(meta.location), scene_dir, dt)
    return scene


def load_map(cache_dir: str, env_name: str, location: str, scene_dir: str = None,
             dt: float = 0.1) -> SceneMap:
    map_path = os.path.join(cache_dir, env_name, "maps", f"{location}.pb")
    vm = _vm_pb.VectorizedMap()
    with open(map_path, "rb") as f:
        vm.ParseFromString(f.read())

    origin = np.array([vm.shifted_origin.x, vm.shifted_origin.y])

    def poly_xy(pl) -> Optional[np.ndarray]:
        n = len(pl.dx_mm)
        if n == 0:
            return None
        xy = np.stack(
            [np.cumsum(np.asarray(pl.dx_mm, np.float64)),
             np.cumsum(np.asarray(pl.dy_mm, np.float64))],
            axis=-1,
        ) / 1000.0
        return xy + origin

    lanes = []
    for el in vm.elements:
        if el.WhichOneof("element_data") != "road_lane":
            continue
        rl = el.road_lane
        center = poly_xy(rl.center)
        if center is None or len(center) < 2:
            continue
        lanes.append(
            LaneData(
                lane_id=el.id.decode(),
                center=center,
                left_edge=poly_xy(rl.left_boundary),
                right_edge=poly_xy(rl.right_boundary),
            )
        )

    lane_centers = np.stack([l.center.mean(axis=0) for l in lanes]) if lanes else np.zeros((0, 2))

    tls: Dict[str, np.ndarray] = {}
    if scene_dir is not None:
        tls_path = os.path.join(scene_dir, f"tls_data_{_dt_tag(dt)}.feather")
        if os.path.exists(tls_path):
            tdf = _read_feather(tls_path)
            max_ts = int(tdf["scene_ts"].max()) + 1 if len(tdf) else 0
            for lane_id, g in tdf.groupby("lane_id"):
                arr = np.zeros(max_ts, np.float32)
                arr[g["scene_ts"].to_numpy().astype(int)] = g["status"].to_numpy()
                tls[str(lane_id)] = arr
    return SceneMap(lanes=lanes, lane_centers=lane_centers, tls=tls)


def list_scenes(cache_dir: str, env_name: str) -> List[str]:
    env_dir = os.path.join(cache_dir, env_name)
    out = []
    for d in sorted(os.listdir(env_dir)):
        if d.startswith("scene_") and os.path.isdir(os.path.join(env_dir, d)):
            out.append(d)
    return out
