#!/usr/bin/env python3
"""Time the fused policy stack (prosim_torch/csrc/fused_stack.cu) with one
stage taken out at a time, on one NVIDIA GPU, at the demo shape that
chip_smoke.py checks it at (B=16, lanes 2048, obs agents 160, agents 128,
random weights from seed 0).

Each variant is the kernel source with one text substitution, built by nvcc
like the shipped kernel; its output is not checked, only its time (CUDA
events, 5 launches after a warm-up; the variants run in order and then in
reverse). The difference to the full kernel is that stage's cost:
  no_edges   - no edge loop (what is left: norms, dense products, folds)
  no_dense   - no edge loop and no dense products (rowmat)
  no_sin     - the rel-PE's sinf replaced by its argument
  no_pe      - no rel-PE columns at all (no feature loads, no sines)
  no_zln     - the rel-PE's norm statistics not reduced across the warp
  no_gather  - a constant in place of the gathered source row
  no_reduce  - the per-head score sums not reduced across the warp
  no_acc     - the aggregates' multiply-adds replaced by one add
Run from the repository root:  python3 scripts/fused_stack_stages.py
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIN = "sinf(__fadd_rn(__fmul_rn(fe[fi[j]], fr[j]), ph[j]))"
NO_EDGES = ("  if (live) {\n    const size_t rg", "  if (false) {\n    const size_t rg")
NO_DENSE = ("  const int tid = threadIdx.x;\n  const int Kd = k1 + k2;",
            "  if (k1 >= 0) { __syncthreads(); return; }\n"
            "  const int tid = threadIdx.x;\n  const int Kd = k1 + k2;")
PE = ("    float z = 0.f;\n    if (j > 0 &&", "    float z = c < P ? 0.25f * j : 0.f;\n    if (false &&")
VARIANTS = {
    "full": [],
    "no_edges": [NO_EDGES],
    "no_dense": [NO_EDGES, NO_DENSE],
    "no_sin": [(SIN, "__fadd_rn(__fmul_rn(fe[fi[j]], fr[j]), ph[j])")],
    "no_pe": [PE, (SIN, "0.f")],
    "no_zln": [("  s = warp_sum(s);\n  ss = warp_sum(ss);\n  const float mu = s / P;",
                "  const float mu = s / P;")],
    "no_gather": [("    t[j] = c < D ? x_row[c] : 0.f;", "    t[j] = c < D ? 0.5f : 0.f;")],
    "no_reduce": [("reduce_scatter8(p0, lane)", "(p0[0] + p0[7])"),
                  ("reduce_scatter8(p1, lane)", "(p1[0] + p1[7])")],
    "no_acc": [("acc[h][j] = fmaf(bb, t1[j], fmaf(a, t0[j], acc[h][j] * c));",
                "acc[h][j] += a + bb + c;")],
}

def main():
    import torch

    if not torch.cuda.is_available():
        print("fused_stack_stages: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.ops import _build
    from prosim_torch.ops import fused_stack as fs
    from prosim_torch.utils.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    src_dir = _build.BUILD_DIR.parent / "fused_stack_stages"  # beside the kernels' build
    src_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "fused_stack.cu").read_text()
    for name, subs in VARIANTS.items():
        variant = text
        for old, new in subs:
            if old not in variant:
                raise RuntimeError(f"{name}: the source no longer has {old[:40]!r}")
            variant = variant.replace(old, new)
        (src_dir / f"fused_stack_{name}.cu").write_text(variant)
    for name in _build.SOURCES.values():
        (src_dir / name).write_text((_build.CSRC / name).read_text())
    _build.CSRC = src_dir
    _build.SOURCES.update({f"fused_stack_{n}": f"fused_stack_{n}.cu" for n in VARIANTS})
    for name, log in _build.build_all().items():
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines() if "registers" in line]
        print(f"  {name}: {'; '.join(regs)}")

    cfg = get_config(opts=["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"])
    batch = make_synthetic_batch(cfg, batch_size=chip_smoke.B_FULL, num_lanes=chip_smoke.LANES,
                                 num_obs_agents=chip_smoke.OBS_AGENTS,
                                 num_agents=chip_smoke.AGENTS, num_replan=chip_smoke.REPLAN,
                                 seed=0, device="cuda")
    model = ProSim(cfg, device="cuda")
    init_params(model, seed=0)
    policy, p = model.policy, batch.prompt
    times = {}
    with torch.inference_mode():
        scene, emd = model.prepare(batch)
        x = emd["emd"].contiguous()
        ta, tm = policy.fused_tables(scene, p.pos, p.ori, policy.site_graphs(scene, p.pos, p.mask))
        wa, wm = policy.pack_fused()
        kw = dict(num_heads=policy.num_heads, head_dim=policy.head_dim)
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            _build.SOURCES["fused_stack"] = f"fused_stack_{name}.cu"
            _build._loaded.pop("fused_stack", None)
            fs._launcher.cache_clear()
            times.setdefault(name, []).append(chip_smoke.cuda_ms(
                torch, lambda: fs.fused_two_site_stack(x, ta, tm, wa, wm, **kw), 5))
    for name, ms in times.items():
        print(f"  {name:9s} " + " ".join(f"{t:.3f}" for t in ms) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
