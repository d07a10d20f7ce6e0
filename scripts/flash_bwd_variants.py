#!/usr/bin/env python3
"""Time source variants of the flash-attention backward's CUDA kernels (B4-bwd)
on one card.

Run from the repository root on a machine with a CUDA card and nvcc:
    python3 scripts/flash_bwd_variants.py [variant ...]
(no names: every variant below). nvcc's warnings (ptxas serialising wgmma,
for one) are printed with each variant's registers and spill stores.
Each variant is prosim_torch/csrc/flash_attn_bwd.cu with a tuned constant
set by an nvcc -D definition, or with the gathers or the products taken out
by a text substitution, built by nvcc with the port's flags into
build/flash_bwd_variants/ (all at once),
and timed by torch.profiler (device ms of each of its three kernels, 20
calls after a warm-up) at the shapes chip_smoke.py's phase 3 checks: the
Llama3-8B width in bf16 (B 16, T 384, Hq 32, Hkv 8, D 128) on the
tokenizer's holed mask and on the mask of the 8B train step's first batch,
and the f32 tiny() shape (Hq 4, Hkv 2, D 16). A variant that only changes
how the work is staged must give the first variant's output bitwise; one
that takes work out computes wrong numbers by design. Each line prints the
error against the f32 plain backward beside the bf16 plain backward's (the
2x rule of chip_smoke.py). Prints one line per (shape, variant) and the
card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from prosim_torch.ops import _build  # noqa: E402
from prosim_torch.ops.flash_attn import (  # noqa: E402
    _DTYPE_CODE,
    _flash_fwd,
    causal_attention_bwd_plain,
)

VARIANTS = {  # name: ([nvcc -D definitions], [(text in the kernel source, replacement)])
    "kernel": ([], []),
    # the bf16 kernels without their gathers (the stages keep stale rows:
    # wrong numbers, the consumers' time) or without their products (the
    # producers' time)
    "bf16 compute only": ([], [
        ("    cp_async16(da + sw_off(r, c, R), a + off, ok ? 16 : 0);\n"
         "    cp_async16(db + sw_off(r, c, R), b + off, ok ? 16 : 0);\n", "")]),
    "bf16 copies only": ([], [("      wgmma_ss_n32(", "      if (0) wgmma_ss_n32("),
                              ("wgmma_rs<DP>(", "if (0) wgmma_rs<DP>(")]),
    "rings of 4": (["-DFLASH_BWD_RING=4"], []),
    "producers 40 registers": (["-DFLASH_BWD_PRODUCER_REGS=40"], []),
    "prep 8 heads a block": (["-DFLASH_BWD_PREP_HEADS=8"], []),
}
OUT = os.path.join(ROOT, "build", "flash_bwd_variants")


def build(names):
    src = open(os.path.join(_build.CSRC, "flash_attn_bwd.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, (defines, subs)) in enumerate(VARIANTS.items()):
        if name not in names:
            continue
        text = src
        for a, b in subs:
            if a not in text:
                raise KeyError(f"variant {name!r}: the kernel no longer contains {a!r}")
            text = text.replace(a, b)
        cu = os.path.join(OUT, f"v{i}.cu")
        open(cu, "w").write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(_build.CSRC), "-o",
               cu[:-3] + ".so", cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), cu[:-3] + ".so")
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        use = chip_smoke.ptxas_usage(log)
        print(name, "|", chip_smoke.flash_bwd_usage(use, torch.bfloat16, 128))
        for line in log.splitlines():
            if "warning" in line.lower() or "C7515" in line:
                print("   ", line.strip())
        fn = ctypes.CDLL(so).flash_attn_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, q, k, v, o, lse, do, mask, scale):
    """One call of the C entry point, as ops/flash_attn.py's wrapper makes it."""
    B, T, Hq, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rows = torch.empty((B * T + B,), dtype=torch.int32, device="cuda")
    stats = torch.empty((2, B, Hq, -(-T // 64) * 64), dtype=torch.float32, device="cuda")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), mask.data_ptr(), rows.data_ptr(), stats.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, T, Hq, k.shape[2], D, scale, _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return dq, dk, dv


def inputs(B, T, Hq, Hkv, D, dtype, mask):
    g = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda h: torch.randn((B, T, h, D), generator=g, device="cuda").to(dtype)  # noqa: E731
    q, k, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
    scale = D ** -0.5
    out, lse = _flash_fwd(q, k, v, mask, scale, with_lse=True)
    do = (torch.randn(q.shape, generator=g, device="cuda") * mask[:, :, None, None]).to(dtype)
    return q, k, v, out, lse, do, mask, scale


def main(argv):
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"flash_bwd_variants: unknown variants {unknown}; known: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(names)
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch

    cfg = get_config(os.path.join(ROOT, chip_smoke.TEXT_TRAIN_YAML), chip_smoke.TEXT_OPTS)
    shape = dict(num_lanes=chip_smoke.LANES, num_obs_agents=chip_smoke.OBS_AGENTS,
                 num_agents=chip_smoke.AGENTS, num_replan=chip_smoke.REPLAN)
    train_mask = make_synthetic_batch(cfg, batch_size=16, seed=10, device="cuda",
                                      **shape).conditions[chip_smoke.TEXT_KEY]["token_mask"]
    holed = chip_smoke.text_layout_mask(torch, 16, 256, 128, seed=5)
    cases = {"8B holed": (16, 384, 32, 8, 128, torch.bfloat16, holed),
             "8B train mask": (16, 384, 32, 8, 128, torch.bfloat16, train_mask),
             "tiny f32": (16, 384, 4, 2, 16, torch.float32, holed)}
    for case, spec in cases.items():
        args = inputs(*spec)
        f32 = [x.float() for x in args[:4]]
        ref = causal_attention_bwd_plain(*f32, args[4], args[5].float(), *args[6:])
        mask = args[6]
        err_of = lambda xs: max(float((x.float() - r)[mask].abs().max())  # noqa: E731
                                for x, r in zip(xs, ref))
        plain_err = err_of(causal_attention_bwd_plain(*args))
        first = None
        for name, fn in fns.items():
            got = launch(fn, *args)
            torch.cuda.synchronize()
            same = first is not None and all(torch.equal(a, b) for a, b in zip(got, first))
            first = got if first is None else first
            total, names, _ = chip_smoke.device_ms(torch, lambda: launch(fn, *args), 20,
                                                   by_name=True)
            split = {kern: sum(t for n, t in names.items() if kern + "_" in n)
                     for kern in chip_smoke.FLASH_BWD_KERNELS}
            print(f"{case} {name:26s} {total:.4f} ms ("
                  + ", ".join(f"{k[10:]} {t:.4f}" for k, t in split.items())
                  + f"); err {err_of(got):.3e} (plain {plain_err:.3e})"
                  + ("; bitwise the first" if same else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
