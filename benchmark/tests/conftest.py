"""Shared helpers of the benchmark's CPU tests: a cell's context at a tiny
size (the same configuration with small PAD sizes, a small traffic mix) on
the CPU, where the program takes its plain paths."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_PAD = {"NUM_LANES": 64, "NUM_OBS_AGENTS": 24, "NUM_AGENTS": 16}
TINY_MIX = {"calls": 2, "obs_agents": [12, 24], "lane_slots": [30, 60], "replicas": 2,
            "warmup_calls": 1, "check_calls": 1, "check_among": 2, "check_scenes": 2}


def tiny_cell(name: str) -> dict:
    from benchmark import core

    cell = core.load_workload(name)
    cell = copy.deepcopy(cell)
    pad = cell["config_file"]["config"]["DATASET"]["FORMAT"]["PAD"]
    pad.update(TINY_PAD)
    cell["config_file"]["config"]["DATASET"]["FORMAT"]["MAP"]["MAX_POINTS"] = TINY_PAD["NUM_LANES"]
    cell["mix"].update({k: v for k, v in TINY_MIX.items() if k in cell["mix"]})
    if "scenes_per_call" in cell["mix"] and cell["mix"]["scenes_per_call"] > 1:
        cell["mix"]["scenes_per_call"] = 2
    return cell


def tiny_ctx(name: str, seed: int = 3):
    import torch

    from benchmark import run

    torch.backends.cuda.matmul.allow_tf32 = False
    return run.make_ctx(tiny_cell(name), seed, torch, torch.device("cpu"))


@pytest.fixture
def make_tiny_ctx():
    return tiny_ctx
