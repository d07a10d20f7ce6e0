#!/usr/bin/env python3
"""Time the fused policy stack (prosim_torch/csrc/fused_stack.cu) with one
stage taken out at a time, on one NVIDIA GPU, at the demo shape that
chip_smoke.py checks it at (B=16, lanes 2048, obs agents 160, agents 128,
random weights from seed 0).

Each variant is the kernel source with one text substitution, built by nvcc
like the shipped kernel; its output is not checked, only its time (CUDA
events, 5 launches after a warm-up; the variants run in order and then in
reverse). The difference to the full kernel is that stage's cost:
  no_edges    - no edge loop (what is left: the rel-PE pass, norms, dense
                products, folds)
  no_dense    - no edge loop and no dense products (rowmat)
  no_pe       - no rel-PE pass (the layers read whatever the table holds)
  no_edges_pe - no edge loop and no rel-PE pass
  no_sin      - the rel-PE pass's sinf replaced by its argument
  no_zln      - the rel-PE pass's norm statistics not reduced across the warp
  no_copy     - the edge tiles not copied (the edge loop computes on the
                ring as it stands)
  no_compute  - the edge tiles copied and not computed
  no_reduce   - the per-tile score sums not reduced across the warp
  no_acc      - the aggregates' multiply-adds replaced by one add
  in_order    - the rows taken in their natural order (b, n), not heaviest
                first (a negative cost is what the order saves)
A substitution that no longer matches the source fails the run. The layer
loop on the same graphs (the FUSED_STACK=False path), the yardstick, is
timed in device ms (torch.profiler) before and after the variants.
Run from the repository root:  python3 scripts/fused_stack_stages.py
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NO_EDGES = ("  if (row >= 0) {\n    const int stage_floats",
            "  if (false) {\n    const int stage_floats")
NO_DENSE = ("  const int tid = threadIdx.x;\n  const int Kd = k1 + k2;",
            "  if (k1 >= 0) { __syncthreads(); return; }\n"
            "  const int tid = threadIdx.x;\n  const int Kd = k1 + k2;")
NO_PE = ("  const int P = d.P, F = d.F, K = s.K;\n  const int npf = P / F;",
         "  const int P = d.P, F = d.F, K = s.K;\n  if (K >= 0) return;\n  const int npf = P / F;")
SIN = "sinf(__fadd_rn(__fmul_rn(fe[fi[j]], fr[j]), ph[j]))"
VARIANTS = {
    "full": [],
    "no_edges": [NO_EDGES],
    "no_dense": [NO_EDGES, NO_DENSE],
    "no_pe": [NO_PE],
    "no_edges_pe": [NO_EDGES, NO_PE],
    "no_sin": [(SIN, "__fadd_rn(__fmul_rn(fe[fi[j]], fr[j]), ph[j])")],
    "no_zln": [("      sum = warp_sum(sum);\n      ss = warp_sum(ss);\n", "")],
    "no_copy": [("  for (int e = hh; e < n; e += 2) {\n    const T* xrow",
                 "  for (int e = hh; e < 0; e += 2) {\n    const T* xrow")],
    "no_compute": [("        if (nh == 0) continue;", "        if (nh >= 0) continue;")],
    "no_reduce": [("const float sum = reduce_scatter32(p, lane);",
                   "const float sum = p[0] + p[31];")],
    "no_acc": [("for (int t2 = 0; t2 < 8; ++t2) acc[i][t2] = fmaf(w[i], v[t2], acc[i][t2]);",
                "for (int t2 = 0; t2 < 8; ++t2) acc[i][t2] += w[i];")],
    "in_order": [("slot < d.R ? order[slot] : -1", "slot < d.R ? slot : -1")],
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
    for path in _build.CSRC.iterdir():  # the sources and the headers they include
        (src_dir / path.name).write_text(path.read_text())
    _build.CSRC = src_dir
    _build.SOURCES.update({f"fused_stack_{n}": f"fused_stack_{n}.cu" for n in VARIANTS})
    for name, log in _build.build_all().items():
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
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
        graphs = policy.site_graphs(scene, p.pos, p.mask)
        ta, tm = policy.fused_tables(scene, p.pos, p.ori, graphs)
        wa, wm = policy.pack_fused()
        kw = dict(num_heads=policy.num_heads, head_dim=policy.head_dim)
        order = fs._row_order(ta[3], tm[3]).long()
        for site, (_, _, _, valid) in zip(("a2p", "m2p"), (ta, tm)):
            # a block's teams wait for its longest row: the share of team time
            # that runs edges, were every edge equally dear, with the rows in
            # their natural order and in the kernel's
            n = valid.sum(-1).flatten()
            busy = []
            for rows in (n, n[order]):
                rows = torch.nn.functional.pad(rows, (0, (-rows.numel()) % 8)).view(-1, 8)
                busy.append(float(rows.sum() / (8 * rows.amax(-1).sum())))
            print(f"  {site}: {int(n.sum())} valid edges; rows of a block busy "
                  f"{busy[0]:.3f} of the block's edge time in (b, n) order, "
                  f"{busy[1]:.3f} heaviest first")
        loop = lambda: policy.layer_loop(x, scene, p.pos, p.ori, graphs)
        loop_ms = [chip_smoke.device_ms(torch, loop, 5)]
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:
            _build.SOURCES["fused_stack"] = f"fused_stack_{name}.cu"
            _build._loaded.pop("fused_stack", None)
            fs._launcher.cache_clear()
            times.setdefault(name, []).append(chip_smoke.cuda_ms(
                torch, lambda: fs.fused_two_site_stack(x, ta, tm, wa, wm, **kw), 5))
        loop_ms.append(chip_smoke.device_ms(torch, loop, 5))
    for name, ms in times.items():
        print(f"  {name:11s} " + " ".join(f"{t:.3f}" for t in ms) + " ms")
    print("  layer loop (device ms, before and after the variants) "
          + " ".join(f"{t:.3f}" for t in loop_ms) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
