"""run.py without a card, in a tree without the program, and its look for
modules of JAX or of the JAX package (top-level names compared whole)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

ARGS = ["--workload", "no_text.wosac_m32", "--seed", "2147483659", "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=300)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not out.stdout.strip()


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("loaded,found", [
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["prosim_tpu.models.prosim"], ["prosim_tpu"]),
    (["prosim_torch.models.prosim", "prosim_tpu_notes", "jaxtyping", "flaxen"], []),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, loaded, found):
    import types

    from benchmark import core

    for name in loaded:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert core.loaded_forbidden() == found


def test_manifest_names_a_file_for_everything():
    from benchmark import core

    m = core.manifest()
    bench = ROOT / "benchmark"
    for c in m["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in m["workloads"]:
        cell = core.load_workload(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert (bench / "drivers" / f"{cell['driver']}.py").exists()
        assert core.cell_metrics(w["name"], False) and core.cell_metrics(w["name"], True)
    for e in m["end_to_end"] + m["per_layer"]:
        assert (bench / "metrics" / f"{e['name']}.py").exists(), e["name"]
    assert json.loads((ROOT / "BENCHMARK.json").read_text()) == m


def test_readers_on_a_record():
    """Every metric's reader on a record made by hand, and silent where its
    source is missing."""
    from benchmark import core

    trace = {"busy_s": 6.0, "kernel_s": {"b1_topk": 0.5, "b2_edge": 2.0, "b3_fused": 0.0},
             "kernel_launches": {"b1_topk": 10, "b2_edge": 40, "b3_fused": 0}}
    acc = {"kernels": {"b1_topk": [0.01, 0.0, 10], "b2_edge": [0.5, 1e12, 40],
                       "b3_fused": [0.0, 0.0, 0]}, "flops": 67e12 * 0.8}
    rec = {"setup_s": 21.5, "window_s": 8.0, "latencies_s": [0.1 * i for i in range(1, 21)],
           "units": {"rollouts": 640}, "spans": {"prepare_s": [0.1, 0.3],
                                                  "rollout_s": [0.8, 0.8]},
           "replan_steps": 8, "dtype": "float32", "trace": trace, "accounting": acc}
    want = {"setup_s": 21.5, "sim_rollouts_per_s": 80.0, "wosac_scene_p95_ms": 1905.0,
            "prepare_ms.default": 200.0, "replan_step_ms.default": 100.0,
            "rollout_mfu_pct.default": 10.0, "b1_topk_roofline.default": 2.0,
            "b2_edge_roofline.default": 25.0, "device_idle_pct.default": 25.0,
            "b3_fused_roofline.wosac": None}
    for name, v in want.items():
        got = core.read_metric(name, rec)
        assert got == pytest.approx(v) if v is not None else got is None, name
    bare = {"setup_s": 1.0, "window_s": 1.0, "latencies_s": [], "units": {}, "spans": {},
            "replan_steps": 8, "dtype": "bfloat16"}
    for e in core.manifest()["per_layer"]:
        assert core.read_metric(e["name"], bare) is None, e["name"]
