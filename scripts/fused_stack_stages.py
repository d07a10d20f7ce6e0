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
With --dtype bf16 it times the bf16 path instead: the model in bf16, its
weights packed in bf16. Where the source has the tensor-core kernel
(fused_stack_kernel_mma) the variants are BF16_VARIANTS, substitutions into
csrc/fused_stack.cu and csrc/edge_mma.cuh:
  no_edges    - no edge loop (the edge engine's row walk)
  no_dense    - no edge loop and no dense products (their weight slabs,
                run_slabs)
  no_pe       - no rel-PE pass
  no_edges_pe - no edge loop and no rel-PE pass
  no_norms    - the LayerNorms (warp_norm) return at once
  no_copy     - the edge tiles not staged (the engine computes on the ring
                as it stands)
  no_compute  - the edge tiles staged and not computed
  in_order    - the rows in their natural order
and in a source without it (an earlier tree, whose bf16 kernel is the f32
template's instantiation) VARIANTS as above. Each variant builds from a
directory of its own holding all of csrc/ with its substitutions.
A substitution that no longer matches the source fails the run. The layer
loop on the same graphs (the FUSED_STACK=False path), the yardstick, is
timed in device ms (torch.profiler) before and after the variants.
Run from the repository root:  python3 scripts/fused_stack_stages.py [--dtype bf16]
"""

import argparse
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
VARIANTS = {  # name: [(text in csrc/fused_stack.cu, replacement)]
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
MMA_EDGES = ("  if (row >= 0) {\n    int* list_k", "  if (false) {\n    int* list_k")
MMA_DENSE = [("  const int Np = pad16(w.Nd), Kp = pad16(w.Kd);\n  const int kr",
              "  if (w.Kd >= 0) { __syncthreads(); return sl; }\n"
              "  const int Np = pad16(w.Nd), Kp = pad16(w.Kd);\n  const int kr")]
ENGINE = "edge_mma.cuh"
BF16_VARIANTS = {  # name: [(text, replacement[, file of csrc/ other than fused_stack.cu])]
    "full": [],
    "no_edges": [MMA_EDGES],
    "no_dense": [MMA_EDGES, *MMA_DENSE],
    "no_pe": [NO_PE],
    "no_edges_pe": [MMA_EDGES, NO_PE],
    "no_norms": [("  float v[kMaxJ];\n  float s = 0.f, ss = 0.f;",
                  "  if (n > 0) return;\n  float v[kMaxJ];\n  float s = 0.f, ss = 0.f;")],
    "no_copy": [("  if (c0 < c.Cs) {\n    for (int e = hh; e < kTile; e += 2) {",
                 "  if (c0 < 0) {\n    for (int e = hh; e < kTile; e += 2) {", ENGINE)],
    "no_compute": [("      tile_step<kRound>(s, ring",
                    "      if (lane < 0) tile_step<kRound>(s, ring", ENGINE)],
    "in_order": [("slot < d.R ? order[slot] : -1", "slot < d.R ? slot : -1")],
}

def main(argv):
    import torch

    args = argparse.ArgumentParser()
    args.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.parse_args(argv).dtype]
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
    print(card, "dtype", dtype)
    src_dir = _build.BUILD_DIR.parent / "fused_stack_stages"  # beside the kernels' build
    csrc = {p.name: p.read_text() for p in _build.CSRC.iterdir()}
    mma = dtype == torch.bfloat16 and "fused_stack_kernel_mma" in csrc["fused_stack.cu"]
    variants = BF16_VARIANTS if mma else VARIANTS
    for name, subs in variants.items():
        files = dict(csrc)
        for old, new, *where in subs:
            f = where[0] if where else "fused_stack.cu"
            if old not in files[f]:
                raise RuntimeError(f"{name}: {f} no longer has {old[:40]!r}")
            files[f] = files[f].replace(old, new)
        (src_dir / name).mkdir(parents=True, exist_ok=True)
        for f, text in files.items():  # the sources and the headers they include
            (src_dir / name / f).write_text(text)
    for f, text in csrc.items():  # the other kernels, as they are
        (src_dir / f).write_text(text)
    _build.CSRC = src_dir
    _build.SOURCES.update({f"fused_stack_{n}": f"{n}/fused_stack.cu" for n in variants})
    for name, log in _build.build_all([f"fused_stack_{n}" for n in variants]).items():
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        print(f"  {name}: {'; '.join(regs)}")

    cfg = get_config(opts=["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"])
    batch = make_synthetic_batch(cfg, batch_size=chip_smoke.B_FULL, num_lanes=chip_smoke.LANES,
                                 num_obs_agents=chip_smoke.OBS_AGENTS,
                                 num_agents=chip_smoke.AGENTS, num_replan=chip_smoke.REPLAN,
                                 seed=0, device="cuda")
    model = ProSim(cfg, device="cuda", dtype=dtype)
    init_params(model, seed=0)
    policy, p = model.policy, batch.prompt
    times = {}
    with torch.inference_mode():
        scene, emd = model.prepare(batch)
        x = emd["emd"].to(dtype).contiguous()
        pos, ori = p.pos.to(dtype), p.ori.to(dtype)  # the poses as ProSim hands them over
        graphs = policy.site_graphs(scene, pos, p.mask)
        ta, tm = policy.fused_tables(scene, pos, ori, graphs)
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
        loop = lambda: policy.layer_loop(x, scene, pos, ori, graphs)
        loop_ms = [chip_smoke.device_ms(torch, loop, 5)]
        for name in list(variants) + list(variants)[::-1]:
            _build.SOURCES["fused_stack"] = f"{name}/fused_stack.cu"
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
    sys.exit(main(sys.argv[1:]))
