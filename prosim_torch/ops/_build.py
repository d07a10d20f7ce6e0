"""Build and load the port's CUDA kernels.

Each source under prosim_torch/csrc/ is compiled by `nvcc` for sm_90a into a
shared library with a plain C interface, loaded with ctypes at first use.
Libraries go to <repo>/build/prosim_torch_kernels/, named by a hash of their
source and flags, so an edited source is rebuilt and an unchanged one is
reused. `build_all()` starts one nvcc per source, all at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "prosim_torch_kernels"
SOURCES = {"neighbor_topk": "neighbor_topk.cu", "edge_attn": "edge_attn.cu",
           "fused_stack": "fused_stack.cu", "flash_attn": "flash_attn.cu",
           # the edge core's earlier design, a baseline chip_smoke.py measures
           "edge_attn_table": "edge_attn_table.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names=None) -> Dict[str, str]:
    """Compile every missing library in parallel. Returns {name: ptxas log}
    for the sources compiled in this call; raises if any nvcc fails."""
    outs = {name: library_path(name) for name in names or SOURCES}  # raises before any nvcc runs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in outs.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
