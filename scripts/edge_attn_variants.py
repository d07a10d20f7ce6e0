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

With --dtype bf16 it times the bf16 path (edge_attn_launch_bf16) on the
same inputs rounded to bf16. Where the source has the tensor-core kernel
(edge_attn_kernel_mma), the variants are BF16_VARIANTS, substitutions into
csrc/edge_mma.cuh (the edge engine): the copies alone (no tile computed),
the compute alone (no row copied: the engine computes on the ring as it
stands), a 3-stage ring. In a source without it (an earlier tree, whose
bf16 kernel is the f32 template's instantiation) VARIANTS as above. Each
variant builds from a directory of its own holding all of csrc/.
"""

import argparse
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
ENGINE = "edge_mma.cuh"
BF16_VARIANTS = {  # name: [(text, replacement, file of csrc/)]
    "kernel": [],
    "copies only": [("      tile_step<kRound>(s, ring",
                     "      if (lane < 0) tile_step<kRound>(s, ring", ENGINE)],
    "compute only": [("        cp_async16(dst, xrow + c0);", "        ;", ENGINE),
                     ("        cp_async16(dst, zrow + (c0 - c.Dx));", "        ;", ENGINE)],
    "3-stage ring": [("constexpr int kStages = 2;", "constexpr int kStages = 3;", ENGINE)],
}
SITES = {  # name: (B, Q, S, K, mean valid share of K)
    "a2a": (16, 160, 160, 100, 0.9), "s2s": (16, 2208, 2208, 32, 0.99),
    "s2p": (16, 128, 2208, 512, 0.9), "a2p": (16, 128, 160, 160, 0.78),
    "m2p": (16, 128, 2048, 768, 0.75),
}
OUT = os.path.join(ROOT, "build", "edge_attn_variants")


def build(bf16):
    csrc = {f: open(os.path.join(_build.CSRC, f)).read() for f in os.listdir(_build.CSRC)}
    mma = bf16 and "edge_attn_kernel_mma" in csrc["edge_attn.cu"]
    procs = {}
    for i, (name, subs) in enumerate((BF16_VARIANTS if mma else VARIANTS).items()):
        files = dict(csrc)
        for a, b, *where in subs:
            f = where[0] if where else "edge_attn.cu"
            if a not in files[f]:
                raise KeyError(f"variant {name!r}: {f} no longer contains {a!r}")
            files[f] = files[f].replace(a, b)
        d = os.path.join(OUT, f"v{i}")
        os.makedirs(d, exist_ok=True)
        for f, text in files.items():  # the source and the headers it includes
            open(os.path.join(d, f), "w").write(text)
        cu, so = os.path.join(d, "edge_attn.cu"), os.path.join(d, "edge_attn.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(name, "|", "; ".join(l.strip() for l in log.splitlines() if "registers" in l or "spill" in l))
        lib = ctypes.CDLL(so)
        fn = lib.edge_attn_launch_bf16 if bf16 else lib.edge_attn_launch
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
    out = [torch.empty(shape, dtype=xs.dtype, device="cuda")
           for shape in ((B, Q, H, D), (B, Q, H, Dp), (B, Q, H))]
    err = fn(xs.data_ptr(), idx.data_ptr(), zr.data_ptr(), qx.data_ptr(), qp.data_ptr(),
             valid.data_ptr(), *(o.data_ptr() for o in out), B, Q, S, K, H, D, Dp, 0.25,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    bf16 = parser.parse_args(argv).dtype == "bf16"
    if not torch.cuda.is_available():
        print("edge_attn_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(),
          "bf16" if bf16 else "f32")
    fns = build(bf16)
    for site, shape in SITES.items():
        args = inputs(*shape)
        if bf16:
            args = tuple(t.to(torch.bfloat16) if t.is_floating_point() else t for t in args)
        ref = edge_attn_core_plain(*args, 0.25)
        n_valid = int(args[-1].sum())
        for name, fn in fns.items():
            out = launch(fn, *args)
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(out, ref))
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
    sys.exit(main(sys.argv[1:]))
