"""What every cell shares: the manifest and its files, the device, the
weights, the host clock and the result line.

Nothing here imports the program at module level: `program_config` and
`build_kernels` import it when a run asks for it, so the reference and the
tests can use the rest without it.
"""

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every build and kernel cache of a run stays inside the checkout, at a fixed path
CACHE_DIRS = {"TRITON_CACHE_DIR": ROOT / "build" / "bench_cache" / "triton",
              "TORCH_EXTENSIONS_DIR": ROOT / "build" / "bench_cache" / "torch_extensions"}
# the program's CUDA libraries this benchmark's paths launch (prosim_torch/ops/_build.py)
KERNEL_LIBRARIES = ("neighbor_topk", "edge_attn", "fused_stack")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "prosim_tpu")


class BenchError(RuntimeError):
    """A run that cannot measure: it prints no result and exits non-zero."""


class Tree(dict):
    """A nested dict read by attribute (cfg.MODEL.HIDDEN_DIM)."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError:
            raise AttributeError(name) from None
        return Tree(v) if isinstance(v, dict) else v


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_workload(name: str) -> dict:
    """The cell's file (benchmark/workloads/<name>.json) with its config
    file and traffic mix read in."""
    path = BENCH_DIR / "workloads" / f"{name}.json"
    if not path.exists():
        raise BenchError(f"no workload file {path.relative_to(ROOT)}")
    cell = read_json(path)
    cell["name"] = name
    cell["config_file"] = read_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    cell["mix"] = read_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return cell


def cell_metrics(name: str, trace: bool) -> list:
    """The manifest's metric entries this cell reports: its end-to-end ones
    with --trace 0, its per-layer ones with --trace 1."""
    m = manifest()
    e2e = [e for e in m["end_to_end"] if name in e.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {e["name"] for e in e2e}
    return [e for e in m["per_layer"]
            if (name in e["workloads"] if "workloads" in e else e["moves"] in moved)]


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, record: dict):
    """The metric's reader (benchmark/metrics/<name>.py) over the run's
    record: a number, or None where it finds nothing to read."""
    mod = load_module(BENCH_DIR / "metrics" / f"{name}.py",
                      "bench_metric_" + name.replace(".", "_"))
    return mod.read(record)


def load_driver(name: str):
    return load_module(BENCH_DIR / "drivers" / f"{name}.py", f"bench_driver_{name}")


# ------------------------------------------------------------------ device


def set_cache_dirs() -> None:
    for k, v in CACHE_DIRS.items():
        v.mkdir(parents=True, exist_ok=True)
        os.environ[k] = str(v)


def require_cards(chips: int):
    """torch, with at least `chips` CUDA cards; a run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark measures the port on the card only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, found {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX package."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ------------------------------------------------------- program and config


def program_config(config_file: dict):
    """The program's config node: its defaults with the config file's tree
    merged over them."""
    from prosim_torch.config import fixup_derived_keys, get_default_config

    cfg = get_default_config()
    cfg.merge_from_other(config_file["config"])
    cfg = fixup_derived_keys(cfg)
    cfg.freeze()
    return cfg


def dtype_of(config_file: dict):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[config_file["dtype"]]


def build_kernels() -> None:
    """Build (first run in a checkout) or find the program's CUDA libraries."""
    from prosim_torch.ops import _build

    _build.build_all(list(KERNEL_LIBRARIES))
    for name in KERNEL_LIBRARIES:
        _build.load(name)


def weight_shapes(cfg_tree, dtype):
    """[(name, shape, kind)] of the model's parameters, from the reference
    built on the meta device: kind 'uniform' (a Linear weight, fan-in
    bound), 'normal' (embeddings and tag tables), 'ones' (norm scales) or
    'zeros' (biases)."""
    import torch

    from benchmark.reference.model import ReferenceProSim

    with torch.device("meta"):
        ref = ReferenceProSim(cfg_tree, dtype)
    out = []
    for name, p in ref.named_parameters():
        owner = ref.get_submodule(name.rsplit(".", 1)[0])
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(owner, torch.nn.Linear) and leaf == "weight":
            kind = "uniform"
        elif isinstance(owner, torch.nn.Embedding) or leaf == "tag_params":
            kind = "normal"
        elif leaf == "weight":
            kind = "ones"
        else:
            kind = "zeros"
        out.append((name, tuple(p.shape), kind))
    return out


def make_weights(cfg_tree, dtype, seed: int, device) -> dict:
    """{name: f32 tensor} drawn on the card from `seed` in two calls, as the
    program's seeded init draws them: Linear weights U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), embeddings N(0, 1), norm scales 1, biases 0. The
    parameters are f32 in both configurations (a bf16 model casts them)."""
    import torch

    shapes = weight_shapes(cfg_tree, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(math.prod(s) for _, s, k in shapes if k == "uniform")
    n_n = sum(math.prod(s) for _, s, k in shapes if k == "normal")
    uni = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    nrm = torch.randn(n_n, generator=gen, device=device)
    out, iu, i_n = {}, 0, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        if kind == "uniform":
            out[name] = (uni[iu:iu + n] * shape[1] ** -0.5).view(shape)
            iu += n
        elif kind == "normal":
            out[name] = nrm[i_n:i_n + n].view(shape)
            i_n += n
        else:
            out[name] = torch.full(shape, 1.0 if kind == "ones" else 0.0, device=device)
    return out


def load_weights(module, weights: dict) -> None:
    """Copy the benchmark's weights into a model; every parameter must be named."""
    import torch

    own = dict(module.named_parameters())
    missing, extra = sorted(set(own) - set(weights)), sorted(set(weights) - set(own))
    if missing or extra:
        raise BenchError(f"weights do not match the model: missing {missing[:5]}, "
                         f"unknown {extra[:5]}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(weights[k])


# ------------------------------------------------------------ result line


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    xs = sorted(values)
    if not xs:
        raise BenchError("no samples")
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def print_result(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                 checks: list, breakdown=None) -> None:
    """The contract's last line of standard output, with the numbers
    compared (each beside its limit) last, and the same numbers as the last
    lines of standard error."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        ok = "ok" if c["ok"] else "FAIL"
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
