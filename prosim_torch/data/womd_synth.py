"""Synthetic WOMD Scenario generator for data-path load testing (the port's
copy of prosim_tpu/data/womd_synth.py: one seed writes the same shards).

Raw WOMD is not mounted in every environment, but the ingestion pipeline
(womd_ingest: TFRecord Scenario shards -> trajdata-layout cache) and
everything downstream of it (loader, trainer, rollout farm, submission
packaging) must be exercised at four-digit scene counts, not just the 16
bundled demo scenes (reference operating scale: 44,097 WOSAC val scenes,
prosim/rollout/package_submission.py:66). This module fabricates
structurally-faithful Scenario protos — multi-agent, multi-lane, varied
counts per scene — cheap enough to synthesize thousands on one host core.

Geometry is simple but non-degenerate: lanes are parallel offset arcs, agents
follow them at varied speeds with validity gaps, the SDC is a mid-list track
(ordering code must fix it), and every field class the ingester reads is
populated (boundaries, road edges, crosswalks, TLS states, tracks_to_predict).
"""

from typing import List, Tuple

import numpy as np

from prosim_torch.data import womd_ingest

pb = womd_ingest._sc_pb

DT = 0.1
T = 91  # 11 history + 80 future


def synthesize_scenario(rng: np.random.Generator, sid: str,
                        n_agents: int = 16, n_lanes: int = 8):
    """One random Scenario proto with `n_agents` tracks on `n_lanes` lanes."""
    s = pb.Scenario()
    s.scenario_id = sid
    s.timestamps_seconds.extend([i * DT for i in range(T)])
    s.current_time_index = 10
    s.sdc_track_index = int(rng.integers(0, n_agents))

    # --- map: parallel gentle arcs, 60-120 m long
    length = float(rng.uniform(60.0, 120.0))
    xs = np.linspace(0.0, length, 25)
    curve = float(rng.uniform(-0.002, 0.002))
    centers = []
    for li in range(n_lanes):
        y0 = (li - n_lanes / 2) * 3.6
        center = np.stack([xs, y0 + curve * xs ** 2], axis=-1)
        centers.append(center)
        lane = s.map_features.add(id=900 + li).lane
        for p in center:
            lane.polyline.add(x=float(p[0]), y=float(p[1]), z=0.0)
        lane.type = pb.LaneCenter.TYPE_SURFACE_STREET
        lane.speed_limit_mph = 35.0
        if li > 0:
            lane.entry_lanes.append(900 + li - 1)
        if li < n_lanes - 1:
            lane.exit_lanes.append(900 + li + 1)
        rl = s.map_features.add(id=1900 + li).road_line
        rl.type = pb.RoadLine.TYPE_BROKEN_SINGLE_WHITE
        for p in center + np.array([0.0, 1.8]):
            rl.polyline.add(x=float(p[0]), y=float(p[1]))
        seg = lane.left_boundaries.add()
        seg.lane_start_index, seg.lane_end_index = 0, 24
        seg.boundary_feature_id = 1900 + li

    re = s.map_features.add(id=2900).road_edge
    re.type = pb.RoadEdge.TYPE_ROAD_EDGE_BOUNDARY
    for p in centers[0] + np.array([0.0, -2.5]):
        re.polyline.add(x=float(p[0]), y=float(p[1]))
    cw = s.map_features.add(id=2910).crosswalk
    mid = length / 2
    for p in [(mid - 2, -8), (mid + 2, -8), (mid + 2, 8), (mid - 2, 8)]:
        cw.polygon.add(x=float(p[0]), y=float(p[1]))

    # --- agents: lane followers with varied speed, start offset and validity
    for a in range(n_agents):
        is_ped = rng.random() < 0.15
        otype = pb.Track.TYPE_PEDESTRIAN if is_ped else pb.Track.TYPE_VEHICLE
        tr = s.tracks.add(id=100 + a, object_type=otype)
        lane_c = centers[int(rng.integers(0, n_lanes))]
        speed = float(rng.uniform(0.5, 2.0) if is_ped else rng.uniform(0.0, 15.0))
        x0 = float(rng.uniform(0.0, max(1.0, length - speed * T * DT)))
        y_jit = float(rng.normal(0.0, 0.3))
        heading = float(np.arctan2(curve * 2 * x0, 1.0))
        if a == s.sdc_track_index:
            first, last = 0, T - 1  # SDC is always fully valid
        else:
            first = int(rng.integers(0, 20))
            last = int(rng.integers(T - 30, T))
        lwh = ((0.8, 0.8, 1.7) if is_ped
               else (float(rng.uniform(4.2, 5.5)), float(rng.uniform(1.9, 2.3)), 1.7))
        for t in range(T):
            st = tr.states.add()
            if first <= t <= last:
                x = x0 + speed * t * DT
                st.center_x = x
                st.center_y = float(np.interp(x, lane_c[:, 0], lane_c[:, 1])) + y_jit
                st.center_z = 1.5
                st.velocity_x = speed * float(np.cos(heading))
                st.velocity_y = speed * float(np.sin(heading))
                st.heading = heading
                st.length, st.width, st.height = lwh
                st.valid = True
            else:
                st.valid = False

    for t in range(T):
        dms = s.dynamic_map_states.add()
        ls = dms.lane_states.add(lane=900)
        ls.state = (pb.TrafficSignalLaneState.LANE_STATE_STOP if t < 10
                    else pb.TrafficSignalLaneState.LANE_STATE_GO)

    tp = s.tracks_to_predict.add()
    tp.track_index, tp.difficulty = 0, pb.RequiredPrediction.LEVEL_1
    return s


def synthesize_shards(out_dir: str, n_scenes: int, n_shards: int = 8,
                      seed: int = 0, agents: Tuple[int, int] = (8, 32),
                      lanes: Tuple[int, int] = (4, 12)) -> List[str]:
    """Write `n_scenes` random scenarios across `n_shards` TFRecord shards
    (WOMD shard naming). Returns the shard paths."""
    import os

    from prosim_torch.data.tfrecord import write_tfrecords

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    per = [n_scenes // n_shards + (1 if i < n_scenes % n_shards else 0)
           for i in range(n_shards)]
    paths = []
    k = 0
    for i, cnt in enumerate(per):
        recs = []
        for _ in range(cnt):
            sc = synthesize_scenario(
                rng, f"synth{k:06d}",
                n_agents=int(rng.integers(agents[0], agents[1] + 1)),
                n_lanes=int(rng.integers(lanes[0], lanes[1] + 1)),
            )
            recs.append(sc.SerializeToString())
            k += 1
        path = os.path.join(
            out_dir, f"training.tfrecord-{i:05d}-of-{n_shards:05d}")
        write_tfrecords(path, recs)
        paths.append(path)
    return paths
