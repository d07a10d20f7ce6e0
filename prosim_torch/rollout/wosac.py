"""WOSAC (Waymo Sim Agents Challenge) packaging (a copy of
prosim_tpu/rollout/wosac.py).

Host-side CPU post-processing: device emits [M, N, T, 3] world-frame
trajectories; this module packages them into the WOSAC submission structures
(reference: prosim/rollout/gpu_utils.py:283-317, waymo_utils.py:59-103,
package_submission.py:44-148).

The waymo-open-dataset pip package (TF C++ ops) is an optional dependency:
when present, `to_scenario_rollouts_proto` emits real protos and
`write_shard` writes submission shards; otherwise rollouts round-trip through
a self-describing npz format so the farm can run anywhere and protos can be
produced later on a machine with the package.
"""

import dataclasses
import json
import os
import tarfile
from typing import Dict, List, Optional, Sequence

import numpy as np

try:  # optional heavyweight dep
    from waymo_open_dataset.protos import sim_agents_submission_pb2 as _sas_pb2

    HAVE_WAYMO = True
except Exception:  # pragma: no cover
    _sas_pb2 = None
    HAVE_WAYMO = False

WOSAC_NUM_ROLLOUTS = 32
WOSAC_STEPS = 80


@dataclasses.dataclass
class JointScene:
    """One joint future: trajectories for every sim agent."""

    object_ids: List[int]
    center_x: np.ndarray  # [N, T]
    center_y: np.ndarray
    center_z: np.ndarray
    heading: np.ndarray


@dataclasses.dataclass
class ScenarioRollouts:
    scenario_id: str
    joint_scenes: List[JointScene]


def joint_scenes_from_rollout(
    world_xyh_m: np.ndarray,     # [M, N, T, 3]
    object_ids: Sequence[int],
    z_values: Sequence[float],   # per-agent z from the last observed frame
) -> List[JointScene]:
    """(reference: gpu_utils.py:283-317 - z is replicated from the current
    frame since the policy is planar)."""
    M, N, T, _ = world_xyh_m.shape
    assert len(object_ids) == N and len(z_values) == N
    scenes = []
    z = np.broadcast_to(np.asarray(z_values)[:, None], (N, T))
    for m in range(M):
        scenes.append(
            JointScene(
                object_ids=list(object_ids),
                center_x=world_xyh_m[m, :, :, 0],
                center_y=world_xyh_m[m, :, :, 1],
                center_z=z.copy(),
                heading=world_xyh_m[m, :, :, 2],
            )
        )
    return scenes


def validate_scenario_rollouts(rollouts: ScenarioRollouts,
                               num_rollouts: int = WOSAC_NUM_ROLLOUTS,
                               steps: int = WOSAC_STEPS):
    """Submission invariants (reference: submission_specs.validate_scenario_rollouts)."""
    if len(rollouts.joint_scenes) != num_rollouts:
        raise ValueError(
            f"expected {num_rollouts} joint scenes, got {len(rollouts.joint_scenes)}"
        )
    ids0 = rollouts.joint_scenes[0].object_ids
    for js in rollouts.joint_scenes:
        if js.object_ids != ids0:
            raise ValueError("object ids differ across joint scenes")
        for arr in (js.center_x, js.center_y, js.center_z, js.heading):
            if arr.shape != (len(ids0), steps):
                raise ValueError(f"bad trajectory shape {arr.shape}")
            if not np.isfinite(arr).all():
                raise ValueError("non-finite trajectory values")


def to_scenario_rollouts_proto(rollouts: ScenarioRollouts):
    if not HAVE_WAYMO:  # pragma: no cover
        raise ImportError("waymo-open-dataset is not installed")
    out = _sas_pb2.ScenarioRollouts(scenario_id=rollouts.scenario_id)
    for js in rollouts.joint_scenes:
        joint = out.joint_scenes.add()
        for i, oid in enumerate(js.object_ids):
            tr = joint.simulated_trajectories.add()
            tr.object_id = int(oid)
            tr.center_x.extend(js.center_x[i].tolist())
            tr.center_y.extend(js.center_y[i].tolist())
            tr.center_z.extend(js.center_z[i].tolist())
            tr.heading.extend(js.heading[i].tolist())
    return out


def save_rollouts_npz(rollouts: ScenarioRollouts, path: str):
    js = rollouts.joint_scenes
    np.savez_compressed(
        path,
        scenario_id=rollouts.scenario_id,
        object_ids=np.asarray(js[0].object_ids),
        center_x=np.stack([j.center_x for j in js]),
        center_y=np.stack([j.center_y for j in js]),
        center_z=np.stack([j.center_z for j in js]),
        heading=np.stack([j.heading for j in js]),
    )


def load_rollouts_npz(path: str) -> ScenarioRollouts:
    d = np.load(path, allow_pickle=False)
    M = d["center_x"].shape[0]
    js = [
        JointScene(
            object_ids=d["object_ids"].tolist(),
            center_x=d["center_x"][m],
            center_y=d["center_y"][m],
            center_z=d["center_z"][m],
            heading=d["heading"][m],
        )
        for m in range(M)
    ]
    return ScenarioRollouts(scenario_id=str(d["scenario_id"]), joint_scenes=js)


def package_submission(
    rollout_dir: str,
    out_dir: str,
    account: str = "",
    method_name: str = "prosim_torch",
    shard_size: int = 1024,
):
    """Shard per-scene rollouts into a WOSAC submission
    (reference: package_submission.py:44-148). With waymo-open-dataset
    present this writes proto shards + tar; otherwise it writes a manifest
    over the npz files."""
    files = sorted(
        f for f in os.listdir(rollout_dir) if f.endswith((".npz", ".pb"))
    )
    os.makedirs(out_dir, exist_ok=True)

    if not HAVE_WAYMO:
        manifest = {
            "method_name": method_name,
            "account": account,
            "num_scenarios": len(files),
            "files": files,
            "format": "npz",
        }
        with open(os.path.join(out_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        return os.path.join(out_dir, "manifest.json")

    shard_paths = []
    for si in range(0, len(files), shard_size):
        shard = _sas_pb2.SimAgentsChallengeSubmission(
            account_name=account,
            unique_method_name=method_name,
        )
        for f in files[si : si + shard_size]:
            path = os.path.join(rollout_dir, f)
            if f.endswith(".npz"):
                sr = to_scenario_rollouts_proto(load_rollouts_npz(path))
            else:
                sr = _sas_pb2.ScenarioRollouts()
                with open(path, "rb") as fh:
                    sr.ParseFromString(fh.read())
            shard.scenario_rollouts.append(sr)
        idx = si // shard_size
        shard_path = os.path.join(
            out_dir, f"submission.binproto-{idx:05d}-of-{(len(files)-1)//shard_size+1:05d}"
        )
        with open(shard_path, "wb") as fh:
            fh.write(shard.SerializeToString())
        shard_paths.append(shard_path)

    tar_path = os.path.join(out_dir, "submission.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tar:
        for p in shard_paths:
            tar.add(p, arcname=os.path.basename(p))
    return tar_path
