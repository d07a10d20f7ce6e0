#!/usr/bin/env python3
"""Time source variants of the edge core's CUDA kernel on one card.

Run from the repository root on a machine with a CUDA card and nvcc:
    python3 scripts/edge_attn_variants.py
Each variant is prosim_torch/csrc/edge_attn.cu with one text substitution
(a stage taken out, or a constant changed), built by nvcc with the port's
flags into build/edge_attn_variants/, and timed with CUDA events (20
launches after a warm-up) at the shapes of the demo configuration's sites
(B=16, D=128, Dp=96, H=8), random rows, each row's valid edges a prefix of
random length, as top-K with a radius gives them. A variant that takes out
a stage computes wrong numbers by design; its error against the plain
version is printed beside its time. Prints one line per (site, variant)
and the card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from prosim_torch.ops import _build  # noqa: E402
from prosim_torch.ops.edge_attn import edge_attn_core_plain  # noqa: E402

VARIANTS = {  # name: [(text in the kernel source, replacement)]
    "kernel": [],
    "copies only": [("      if (nh == 0) continue;  // warp-uniform: a warp without heads only stages",
                     "      continue;")],
    "compute only": [("cp_async16(dst + per16 * lane, xrow + per16 * lane);", ";"),
                     ("cp_async16(dst + s.Dx + per16 * lane, zrow + per16 * lane);", ";")],
    "3 blocks/SM": [("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 3)")],
    "3-stage ring": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
}
SITES = {  # name: (B, Q, S, K, mean valid share of K)
    "a2a": (16, 160, 160, 100, 0.9), "s2s": (16, 2208, 2208, 32, 0.99),
    "s2p": (16, 128, 2208, 512, 0.9), "a2p": (16, 128, 160, 160, 0.78),
    "m2p": (16, 128, 2048, 768, 0.75),
}
OUT = os.path.join(ROOT, "build", "edge_attn_variants")


def build():
    src = open(os.path.join(_build.CSRC, "edge_attn.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for a, b in subs:
            if a not in text:
                raise KeyError(f"variant {name!r}: the kernel no longer contains {a!r}")
            text = text.replace(a, b)
        cu = os.path.join(OUT, f"v{i}.cu")
        open(cu, "w").write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", cu[:-3] + ".so", cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), cu[:-3] + ".so")
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(name, "|", "; ".join(l.strip() for l in log.splitlines() if "registers" in l or "spill" in l))
        fn = ctypes.CDLL(so).edge_attn_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def inputs(B, Q, S, K, share, D=128, Dp=96, H=8):
    g = torch.Generator(device="cuda").manual_seed(K)
    xs = torch.randn((B, S, D), generator=g, device="cuda")
    idx = torch.randint(0, S, (B, Q, K), generator=g, device="cuda", dtype=torch.int32)
    zr = torch.randn((B, Q, K, Dp), generator=g, device="cuda")
    qx = torch.randn((B, Q, H, D), generator=g, device="cuda") * 0.1
    qp = torch.randn((B, Q, H, Dp), generator=g, device="cuda") * 0.1
    n = (torch.rand((B, Q, 1), generator=g, device="cuda") * 2 * share * K).clamp(max=K)
    return xs, idx, zr, qx, qp, torch.arange(K, device="cuda") < n


def launch(fn, xs, idx, zr, qx, qp, valid):
    B, S, D = xs.shape
    Q, K = idx.shape[1:]
    Dp, H = zr.shape[-1], qx.shape[2]
    out = [torch.empty((B, Q, H, D), device="cuda"), torch.empty((B, Q, H, Dp), device="cuda"),
           torch.empty((B, Q, H), device="cuda")]
    err = fn(xs.data_ptr(), idx.data_ptr(), zr.data_ptr(), qx.data_ptr(), qp.data_ptr(),
             valid.data_ptr(), *(o.data_ptr() for o in out), B, Q, S, K, H, D, Dp, 0.25,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main():
    if not torch.cuda.is_available():
        print("edge_attn_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    fns = build()
    for site, shape in SITES.items():
        args = inputs(*shape)
        ref = edge_attn_core_plain(*args, 0.25)
        n_valid = int(args[-1].sum())
        for name, fn in fns.items():
            out = launch(fn, *args)
            err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
            for _ in range(3):
                launch(fn, *args)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                launch(fn, *args)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            print(f"{site} {name:13s} {ms:.4f} ms  {1e6 * ms / n_valid:.3f} ns per valid edge  "
                  f"max abs err {err:.1e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
