#!/usr/bin/env python3
"""Drive prosim_torch's main path on one NVIDIA GPU and check its kernels.

Run from the repository root:  python3 chip_smoke.py
(`--kernels-only` stops after phase 3; `--train-only` runs phases 1, 2, 7
and 8 and writes their records to chiprun_out/chip_smoke_train.json;
`--data-only` runs phases 1, 2 and 9, with phases 7 and 8's launch counts
from their formulas, and writes chiprun_out/chip_smoke_data.json;
`--data-only --diagnose` adds phase 9's train-step diagnosis;
`--serve-only` runs phases 1, 2 and 10 and writes
chiprun_out/chip_smoke_serve.json; `--bf16-train-only` runs phases 1, 2
and 11 and writes chiprun_out/chip_smoke_bf16_train.json; `--dp-child` is
phase 11 (d) alone, as phase 11 starts it; `--modes-only` runs phases 1, 2
and 12 and writes chiprun_out/chip_smoke_modes.json.)
Three configurations of the closed loop are driven at full width: the
default (the policy's a2p/m2p stack as a layer loop), FUSED_STACK=True
(the stack as one fused kernel per replan step), and the text-conditioned
loop (configs/waymo_demo.yaml's goal,
v_action_tag, drag_point and OneText conditions, the condition transformer
at policy_decoder, the Llama text path at Llama3-8B width with random bf16
weights); a fourth, configs/waymo_demo.yaml as shipped (its f32 tiny()
Llama), at B=2 in phase 5. The layer loop, the fused loop and the shipped
demo also run with the network body in bf16 (`ProSim(cfg, dtype=bf16)`,
the configuration bench.py measures), which runs B2's and B3's bf16
tensor-core kernels. Phases:
  1. device   - card name and power limit (nvidia-smi); TF32 and reduced-
                precision bf16 reductions off.
  2. build    - nvcc builds every CUDA kernel of the path from prosim_torch/csrc.
  3. kernels  - each kernel against its plain PyTorch version at the shapes
                of the rollout (demo padding, B=16): top-K at the six graph
                sites (bit-equal), the edge core on their real graphs (the
                top-K's idx and valid) and at the condition GNN's site
                (within EDGE_TOL, empty rows zero, two launches bitwise
                equal; beside it the earlier design over a gathered table,
                csrc/edge_attn_table.cu, and its gather), the fused stack on the policy's real a2p/m2p
                tables of the encoded batch with the fused model's random
                weights (within FUSED_TOL, two launches bitwise equal),
                flash attention at the Llama's
                shape on a holed tokenizer-layout mask (bf16 by the 2x rule
                below; f32 at tiny()'s shape within FLASH_F32_TOL; pad rows
                exactly zero), and its backward at the same two shapes on
                the forward kernel's out and lse (dq/dk/dv: bf16 by the 2x
                rule against the plain backward in f32, f32 within
                FLASH_F32_TOL of each tensor's largest magnitude; pad rows'
                dq and masked keys' dk/dv exactly zero, also with NaN in the
                pad rows; two launches bitwise equal; one launch each of its
                prep, dkv and dq kernels a call, each one's device ms and,
                from the build's ptxas log, registers and spill stores
                logged), the backward also at the Llama3-8B shape on the
                mask of phase 8's first train batch (29 valid tokens a
                scene), and at a head width
                of 40 (the wrapper pads it to 48) in both dtypes, forward
                and backward, by the same gates. The bf16 paths (tensor-core
                kernels on the edge engine of csrc/edge_mma.cuh; each one's
                registers and spill stores from the build's ptxas log):
                B2 on the same real graphs and B3 on the same real tables,
                values rounded to bf16, weights packed in bf16: the
                kernel's max error against the f32 plain version on the same
                values at most BF16_RULE's 2x the bf16 plain version's,
                plus 1e-5; empty rows zero, two launches bitwise equal;
                beside their times the f32 path's, the bf16 SDPA
                yardstick (B2) and the bf16 layer loop (B3). The rel-PE
                table kernel (csrc/rel_pe_table.cu) at the six sites on
                their real graphs, f32 and bf16, against the plain chain
                (f32 within REL_PE_F32_TOL, bf16 within one bf16 ulp; two
                launches bitwise equal), timed beside its bytes bound and
                the chain; every rollout's launches count its tables, and
                no table of a rollout may come from the plain chain; the
                plain paths of phases 5 and 12 build the chain.
                Times: device ms per call (torch.profiler,
                the call's device operations) beside the bound and a
                one-call PyTorch yardstick where one exists (for the fused
                stack, the layer loop instead; for the backward, the
                backward of one scaled_dot_product_attention call); wall ms per call between
                CUDA events (which at the small sites is the host's time to
                launch the call) for the kernel and the yardstick.
  4. rollout  - the full-width closed loop of each configuration (lanes
                2048, obs agents 160, agents 128, B=16, 8 replan steps):
                finite, bounded, deterministic, every kernel launched the
                expected number of times per forward; scenes/s. Then one
                forward of each under torch.profiler with every kernel
                launch's inputs recorded: each kernel's device ms, launches
                and bound per forward and per site, and the device time by
                kernel family (written to chip_smoke_kernels.json in the
                output directory). The layer loop and the fused loop again
                in bf16, with the same launch counts; every B2 and B3
                launch of a profiled forward must be the kernel of the
                model's dtype (by name: the f32 instantiation, or the bf16
                tensor-core kernel).
  5. parity   - each configuration's kernel path against its plain path (the
                model with its kernel calls pointed at the plain versions),
                and the fused rollout against the layer-loop rollout, all on
                the card, at B=2: rollouts within PARITY_TOL_M metres. For
                the text configuration the gate is the conditioned policy
                embedding (LlamaTextAttn's output): the kernel path's max
                deviation from a plain path whose attention runs in f32 on
                the same bf16 q/k/v is at most 2x the plain path's own
                deviation with the attention in bf16, plus 1e-5; its
                rollout deviation is logged. The shipped demo configuration
                (f32 Llama): launches per forward, its rollout within
                PARITY_TOL_M of its plain path, and one profiled forward.
                In bf16 (layer loop, fused, and the shipped demo built in
                bf16 with its f32 Llama): the kernel path's rollout sits
                no further from the f32 plain rollout than 2x the bf16
                plain rollout does, plus PARITY_TOL_M, over the first
                replan step (before random weights' drift compounds to
                metres) and over the whole rollout; launches as in f32.
  6. replicas - parallel_rollout with M=4 on B=2 matches the B=2 rollout.
  7. train    - configs/no_text.yaml at full width (random weights from a
                seed, demo padding, TRAIN.BATCH_SIZE 16, REMAT_POLICY full,
                WARMUP_STEPS 0) through Trainer.setup and Trainer.fit: one
                warm-up step and three timed (synchronised host clock), peak
                memory, B1 launches per step (forward and remat recompute;
                B2 and B3 must not launch: training takes the differentiable
                branch), every loss term finite, parameters moved, the
                goal_pred group (GOAL_MODEL_LR_SCALE 0) unchanged. At B=2:
                one train step with B1's kernel against the same step with
                the plain top-K (loss within TRAIN_LOSS_RTOL, each gradient
                leaf within TRAIN_GRAD_TOL of its largest magnitude), the
                kernel step twice (loss within DETERMINISM_RTOL: the
                gather's backward adds with atomics, so the gradients are
                not bitwise repeatable), the B2/B3 wrappers refusing inputs
                that require grad, and Trainer.evaluate and rollout_callback
                (M=4) finite through B1 and B2. If B=16 does not fit, B is
                halved until it does, and the cut is printed and recorded.
  8. text train - configs/with_text.yaml (OneText conditions through the
                Llama with LoRA on q/k/v and the embedding, the prompt-mask
                loss at PROMPT_WEIGHT 1000) through Trainer.setup and
                Trainer.fit in two configurations: as shipped (the f32
                tiny() Llama) and at Llama3-8B width (TEXT.LLM.ARCH
                llama3_8b, TEXT8_TRAIN_LAYERS of its 32 layers deep, a cut
                of the script's time limit; random bf16 body drawn on the card,
                per-block remat); demo padding, B=16 (halved until it fits,
                the cut recorded), REMAT full, WARMUP_STEPS 0; one warm-up
                step and three timed: step ms, peak memory, B4 forward and
                backward launches per step (exact: the forward, prepare's
                recompute and, with block remat, each block's own
                recompute; one backward per layer), every loss term finite
                (prompt_mask_pred_loss among them), every layer's q/k/v
                lora_b gradient non-zero at the first step, the LoRA and
                adapter leaves moved, the frozen body bitwise unchanged
                with no .grad. At B=2, at the weights before the fit (the
                seeded init with ln_prompt's bias and the lora_b leaves
                drawn, restored before the fit): the kernel step against the
                dense plain attention's step (Llama3-8B width: a plain path
                with f32 attention; on the first batch the loss within
                TRAIN_LOSS_RTOL and the worst LoRA/adapter leaf by the 2x
                rule against the plain path with bf16 attention; on each of
                GRAD_PARITY_BATCHES batches the LoRA leaves' gradient error,
                as one norm, by the same rule; every B4 backward launch of
                the kernel steps, observed through
                flash_attn.backward_observers, by the 2x rule against the
                plain backward in f32 and bf16 on its own inputs; tiny():
                the loss within TRAIN_LOSS_RTOL, each leaf within
                TRAIN_GRAD_TOL and every launch against the plain backward
                in f64 within 2x the f32 plain backward's error plus 1e-5,
                each tensor relative to its largest), then
                evaluate and rollout_callback (M=4) finite through B4's eval
                launch.
  9. data     - the host data pipeline at the demo padding: synthetic WOMD
                shards (DATA_SCENES scenes in DATA_SHARDS shards, a denser
                draw than womd_synth's default, logged as a cut: the
                repository holds no WOMD data) through the port's
                womd_ingest into a trajdata cache under build/ (ingest
                scenes/s), the dataset's formatting (scenes/s serial and
                through the pipelined producer; valid lanes and agents per
                scene against the padding), the same with DENSE_SCENES
                scenes at the densest lane draw womd_synth's geometry
                gives (DENSE_LANES; still sparser than real WOMD maps),
                loader batches of B=16 (each
                leaf bitwise equal to the same scenes collated and moved
                leaf by leaf; exactly one host-to-device copy a batch, its
                bytes and device ms; 3 slabs for 4 held batches), the layer
                loop and FUSED_STACK=True on dataset batches (phase 4's
                launches per forward, finite, deterministic; scenes/s fed
                from the loader with a cold and a warm format cache, cold on
                the dense maps, and the device's busy share),
                configs/no_text.yaml trained through Trainer.fit on dataset
                batches with its conditions drawn by the ConditionGenerator
                (one warm-up and three timed steps: every loss term finite,
                parameters moved, phase 7's B1 launches a step; the
                producer's host ms a scene by stage meanwhile; with
                --diagnose, three steps each on the same dataset batches
                held on the card and on phase 7's synthetic batches, and one
                profiled step of each), Trainer.evaluate and evaluate_cond_sets
                over DATA_COND_SETS (finite), configs/with_text.yaml as
                shipped for 2 steps on OneText conditions from the derived
                motion tags' texts (phase 8's B4 forward and backward
                launches a step), and a DeviceSceneBank of the dataset
                (banked batches bitwise equal to the streamed ones for the
                same (index, seed) pairs; its device bytes). Phase 9 runs
                as `chip_smoke.py --data-only` in a process of its own: after
                phase 8's profiles torch.profiler records no device event in
                the parent process.
  10. serve   - the weights and the serving entry points, at
                configs/waymo_demo.yaml as shipped (demo padding, the f32
                tiny() Llama), on a synthetic cache of SERVE_SCENES scenes
                at phase 9's draw (DATA_AGENTS agents and DATA_LANES lanes
                a scene) under build/: a reference
                Lightning checkpoint of the architecture at full width
                (tests/torch_checkpoint_synth.py) converted strictly
                (no key unmapped) and loaded by InteractiveSim (every leaf
                in, bitwise), the demo's rollouts before and after its
                controls (finite, moved, phase 5's launches at B=1, one
                generator seed bitwise repeatable); a Trainer's rollout
                request served by the farm at M=SERVE_M (one npz a scene,
                each valid at M and 80 steps; the realism metrics finite;
                the submission manifest; launches SERVE_SCENES x phase 5's;
                per-scene host ms by stage, agents scored and scenes/s);
                two workers
                writing the one-worker files bit for bit; one farm scene's
                kernel path within PARITY_TOL_M of its plain path, and its
                device busy time; `python -m prosim_torch.main` rollout and
                data_debug as child processes (exit 0, their outputs);
                HF-layout bf16 shards of a Llama at Llama3-8B width
                (LLAMA8_LAYERS layers deep) written from the card and
                loaded back bitwise (load seconds, peak host RSS); and
                TEXT.LLM.WEIGHTS_PATH (tiny f32 shards) through ProSim into
                one conditioned rollout through B4's f32 path. In a process
                of its own, as phase 9.
  11. bf16 train - training with the network body in bf16 (ProSim(cfg,
                device, dtype=bf16); parameters, gradients and AdamW state
                f32), in a process of its own, as phase 9: (a)
                configs/no_text.yaml as phase 7 (B=16, demo padding, full
                width and depth, REMAT full) through Trainer.fit, one
                warm-up and three timed steps: step ms, peak memory, B1
                launches a step (phase 7's), every loss term finite,
                parameters moved, B2/B3 not launched, one profiled step's
                busy share; then evaluate and rollout_callback (M=4, B=2)
                through B2's bf16 kernel, and with FUSED_STACK through B3's.
                (b) bench.py --mode train's defaults (bench.py:116-122,
                :261-321): B=BENCH_TRAIN_B, the body in bf16, every
                condition type (BENCH_CONDITIONS; the text one through the
                f32 tiny() Llama), synthetic batches at the demo padding, 8
                replan steps, the default config's optimizer and schedule;
                one warm-up and two timed steps through Trainer.fit: step
                ms, train scenes/s, peak memory (B=BENCH_TRAIN_B or the
                phase fails: it is not cut to fit), B1 and B4's forward and
                backward launches a step (exact), every loss term finite.
                (c) for both models at B=2 and one replan step: the bf16
                step's f32 gradients with the kernels against the same step
                with the plain versions, each leaf within GRAD_DIRECT_TOL of
                its largest plain gradient plus twice the spread of two
                plain steps (B1 is bit-equal to its plain version, B4 in f32
                within 1e-5), the loss likewise; and, as a second check,
                each leaf by BF16_RULE's 2x rule against an f32 copy's plain
                step (plus 1e-5 of the leaf's largest). (d) `--dp-child`: no_text in bf16, one
                Trainer.fit step on DP_B scenes twice in one process, then
                as rank 0 of an NCCL group of one through the data-parallel
                path (global counts, the gradients' all-reduce): its loss,
                gradients and parameters within 2x the spread of the two
                one-process steps plus 1e-6 of each leaf's largest, the
                collectives counted.
  12. modes   - the modes no shipped configuration reaches, in a process of
                its own, as phase 9: (a) four models at get_config()'s
                full width (HIDDEN_DIM 128, 6 layers a stack), demo padding,
                B=16, R=8, TOP_K=1, random weights from a seed, synthetic
                batches whose map vectors carry lane types 0-3 and light
                states -1-2 in channels 4-5 (`with_map_ids`): enc-mlp (the
                MLP map and obs encoders, pools 'max'), obs-update (FUSION
                'mlp' and ATTN_UPDATE: 2 more B1 and 2 x 6 more B2
                launches each replan step after the first), goal-cluster
                (PRED_MODE 'cluster' on MODES_K goals written to
                chiprun_out/ from a seed, CONTEXT.GOAL with USE_POSE_EMB)
                as a layer loop and with FUSED_STACK (B3 on the goal
                context's query rows). Each in f32 and with the body in
                bf16: phase 4's rollout gates (launches per forward exact,
                `modes_launches`), every B2/B3 launch its dtype's kernel, a
                profiled forward's busy share; at B=2 the kernel path's
                first replan step within PARITY_TOL_M of the plain path,
                and the rollout on average (`modes_parity`; bf16: phase
                5's 2x rule); one bf16 Trainer.fit step at B=MODES_TRAIN_B, every
                loss term finite and each new module moved. (b) B1 and B2
                (f32 and bf16) at ATTN_UPDATE's two sites (a2a: radius
                AGENT_RADIUS without self-loops; m2a: agents to the map at
                SCENE_RADIUS) by phase 3's gates and timings. (c) the QA
                probe (LlamaTextAttnQA) at Llama3-8B width, LLAMA8_LAYERS
                of 32 layers, bf16 body with its LM head [4096, vocab +
                128], f32 LoRA r=16, on build_qa_batch's ByteTokenizer
                batch at the 8B vocabulary (B=QA_B, QA_LEN tokens): one
                forward and backward with the body frozen; qa_loss finite
                and > 0, the agent-embedding gradient non-zero, B4 2 x
                LLAMA8_LAYERS forward (block remat) and LLAMA8_LAYERS
                backward launches a step, and the loss and the gradient
                against a plain path with f32 attention by BF16_RULE's 2x
                rule; step ms (median of 3) and peak memory.
Any failure raises and exits non-zero. Each phase prints its time. Every
torch.profiler trace records the device only: processing the host's records
of one ~100k-operation train step took about a minute. The
kernels JSON line (B2 and B3 in bf16 as entries of their own) comes just
before the last line, which is the device JSON.
"""

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

EDGE_TOL = 1e-4      # f32, unit-scale inputs; only the summation order differs
BF16_RULE = (2.0, 1e-5)  # bf16 kernels: err <= 2 * (plain in bf16's err) + 1e-5, both vs f32
FLASH_F32_TOL = 1e-5  # flash attention in f32: only the order of the sums differs
FUSED_TOL = 3e-4     # abs and rel; the bar tests/test_fused_stack.py holds the TPU kernel to
REL_PE_F32_TOL = 4e-6  # the rel-PE table in f32: only the statistics' sum order differs
PARITY_TOL_M = 1e-3  # metres, the bar the JAX package was held to
B_FULL, LANES, OBS_AGENTS, AGENTS, REPLAN = 16, 2048, 160, 128, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 dense tensor-core peak
LAYERS = 6
TEXT_YAML = "configs/waymo_demo.yaml"
TRAIN_YAML = "configs/no_text.yaml"
TRAIN_STEPS = 4          # one warm-up step, three timed
TRAIN_LOSS_RTOL = 1e-5   # B1 kernel step vs plain top-K step: B1 is bit-equal to its plain version
TRAIN_GRAD_TOL = 1e-4    # of each gradient leaf's largest magnitude
GRAD_PARITY_BATCHES = 4  # B=2 batches (seeds 1..4) of the bf16 8B gradient check
DETERMINISM_RTOL = 1e-6  # two runs of one train step, in loss
TEXT_OPTS = ["MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.ARCH", "llama3_8b"]
TEXT_TRAIN_YAML = "configs/with_text.yaml"
TEXT_KEY = "llm_text_OneText"  # with_text.yaml's text condition
DATA_SCENES, DATA_SHARDS = 64, 8  # phase 9's synthetic WOMD shards
DATA_AGENTS, DATA_LANES = (64, 160), (16, 48)  # a scene's draw (womd_synth defaults: 8-32, 4-12)
# womd_synth's lanes are parallel, 3.6 m apart: the 200 m map range keeps
# about 110 of them, ~300 valid lane slots a scene at most
DENSE_SCENES, DENSE_LANES = 32, (96, 160)
DATA_ENV = "waymo_train"
DATA_COND_SETS = ["goal_1.0", "all_no_text_0.25"]  # configs/cond_sampler sets of phase 9
SERVE_SCENES, SERVE_M = 8, 32  # phase 10's farm: scenes, joint futures a scene (WOSAC's M)
# phase 11 (b): bench.py --mode train's defaults (bench.py:116-122, :261-270)
BENCH_TRAIN_B, BENCH_TRAIN_STEPS = 64, 3  # one warm-up step, two timed
BENCH_CONDITIONS = ["goal", "v_action_tag", "drag_point", "llm_text_OneText"]  # --conditions all
DP_B = 4  # phase 11 (d)'s scenes
GRAD_DIRECT_TOL = 1e-5  # phase 11 (c): kernel vs plain bf16 step, of each leaf's largest
LLAMA8_LAYERS = 4  # phase 10's Llama3-8B-width shards, phase 12's QA probe: 4 of 32 layers
# phase 8's Llama3-8B-width training: 8 of 32 layers (CUT from 32 when phase 12
# came, to keep the script inside its time limit; each layer's shapes are
# the full model's, only their count is cut)
TEXT8_TRAIN_LAYERS = 8
FLASH_BWD_REPLACES = (  # the library Pallas kernels B4's backward replaces (jax 0.9.0)
    "jax/experimental/pallas/ops/tpu/flash_attention.py:941",   # _flash_attention_bwd_dkv
    "jax/experimental/pallas/ops/tpu/flash_attention.py:1287")  # _flash_attention_bwd_dq

FAMILIES = [  # (family, substrings of the kernel name), first match wins
    ("rel_pe_table (ours)", ("rel_pe_table_kernel",)),
    ("flash_attn_bwd (ours)", ("flash_bwd_",)),
    ("flash_attn (ours)", ("flash_attn_",)),
    ("fused_stack (ours)", ("fused_stack_kernel",)),
    ("edge_attn (ours)", ("edge_attn_kernel",)),
    ("neighbor_topk (ours)", ("neighbor_topk_",)),
    ("matmul", ("gemm", "sm90_xmma", "cutlass", "ampere_sgemm", "sgemm", "gemv", "nvjet")),
    ("gather/index", ("index", "gather", "scatter")),
    ("sort", ("sort", "radix")),
    ("reduce", ("reduce",)),
    ("copy/cat", ("copy", "cat", "Cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]
KERNEL_NAMES = {  # a substring of the name of one CUDA kernel each wrapper call launches once
    "neighbor_topk": "neighbor_topk_", "edge_attn_core": "edge_attn_kernel",
    "fused_two_site_stack": "fused_stack_kernel", "causal_attention": "flash_attn_",
    "causal_attention_bwd": "flash_bwd_prep_kernel", "rel_pe_table": "rel_pe_table_kernel"}
# the kernels of B2's and B3's bf16 paths (tensor-core products on the edge
# engine of csrc/edge_mma.cuh), and the template argument of their f32 ones
BF16_KERNELS = {"edge_attn_core": "edge_attn_kernel_mma",
                "fused_two_site_stack": "fused_stack_kernel_mma"}
F32_TAG = "<float"


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters):
    """Wall time per call between CUDA events: the device time, or the
    host's time to launch the call where that is longer (small launches)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, by_name=False):
    """Device time per call: the durations of the device operations (kernels,
    memsets, copies) the calls enqueue, from torch.profiler, over `iters`
    calls after a warm-up; the host's launch time is not in it. A trace
    with no device event (the profiler has returned one, once) is taken
    again, up to three times. With `by_name`, also {operation name: ms per
    call} and {operation name: launches per call}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            total = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
            if not by_name:
                return total
            names, counts = {}, {}
            for e in events:
                names[e.name] = names.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
                counts[e.name] = counts.get(e.name, 0) + 1 / iters
            return total, names, counts
        log("device_ms: the profiler recorded no device time; profiling again")
    raise RuntimeError("the profiler recorded no device time in three traces")


def ptxas_usage(log_text):
    """{mangled kernel name: (registers, spill store bytes)} from nvcc's
    -Xptxas -v output."""
    import re

    usage, name, spill = {}, None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)), spill)
            name = None
    return usage


def times(torch, fn, iters):
    """(device ms, wall ms) per call."""
    return device_ms(torch, fn, iters), cuda_ms(torch, fn, iters)


def kernel_fns():
    """{name: wrapper} of every kernel of the path; each counts its launches."""
    from prosim_torch.ops.attention import rel_pe_table
    from prosim_torch.ops.edge_attn import edge_attn_core
    from prosim_torch.ops.flash_attn import causal_attention, causal_attention_bwd
    from prosim_torch.ops.fused_stack import fused_two_site_stack
    from prosim_torch.ops.neighbors import neighbor_topk

    return {"neighbor_topk": neighbor_topk, "edge_attn_core": edge_attn_core,
            "fused_two_site_stack": fused_two_site_stack, "causal_attention": causal_attention,
            "causal_attention_bwd": causal_attention_bwd, "rel_pe_table": rel_pe_table}


def launch_counts():
    return {name: fn.launches for name, fn in kernel_fns().items()}


def rel_pe_table_chain(dst_pos, dst_ori, src_pos, src_ori, idx, pe, deterministic):
    """The rel-PE table op's plain version on every path: the eager chain
    (`rel_pe_table_plain`) where the op would launch csrc/rel_pe_table.cu."""
    from prosim_torch.ops.attention import rel_pe_table_plain

    return rel_pe_table_plain(dst_pos, dst_ori, src_pos, src_ori, idx, pe)


@contextlib.contextmanager
def kernel_calls(topk_fn, edge_fn, fused_fn, flash_fn, table_fn=None):
    """Point the model's kernel calls at other functions (the plain versions
    in phase 5, recording shims in phase 4's profiled forward); the
    originals come back on exit. `table_fn` takes the rel-PE table op's
    place where it is given (`rel_pe_table_chain` on the plain paths)."""
    from prosim_torch.models import decoder, policy, scene_encoder
    from prosim_torch.models.llm import llama
    from prosim_torch.ops import attention

    swaps = [(m, "neighbor_topk", topk_fn) for m in (scene_encoder, decoder, policy)]
    swaps.append((attention, "edge_attn_core", edge_fn))
    swaps.append((policy, "fused_two_site_stack", fused_fn))
    swaps.append((llama, "causal_attention", flash_fn))
    if table_fn is not None:
        swaps += [(m, "rel_pe_table", table_fn) for m in (scene_encoder, decoder, policy)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, fn in swaps:
            setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def site_inputs(torch, cfg, batch):
    """(dst_pos, src_pos, dst_mask, src_mask, k, radius, exclude_self) of the
    six neighbor-graph sites, as the model builds them from this batch."""
    m_pos, o_pos = batch.init_map.pos, batch.init_obs.pos
    m_mask, o_mask = batch.init_map.token_mask, batch.init_obs.token_mask
    s_pos = torch.cat([m_pos, o_pos], 1)
    s_mask = torch.cat([m_mask, o_mask], 1)
    p = batch.prompt
    se, de, po = cfg.MODEL.SCENE_ENCODER.ATTN, cfg.MODEL.DECODER.ATTN, cfg.MODEL.POLICY.ACT_DECODER.ATTN
    return {
        "a2a": (o_pos, o_pos, o_mask, o_mask, min(se.MAX_NUM_NEIGH * 4, 100), None, False),
        "s2s": (s_pos, s_pos, s_mask, s_mask, se.MAX_NUM_NEIGH, None, False),
        "p2p": (p.pos, p.pos, p.mask, p.mask, de.MAX_NUM_NEIGH, de.PROMPT_RADIUS, True),
        "s2p": (p.pos, s_pos, p.mask, s_mask, de.MAX_NUM_NEIGH, de.SCENE_RADIUS, False),
        "a2p": (p.pos, o_pos, p.mask, o_mask, po.MAX_NUM_NEIGH, po.AGENT_RADIUS, False),
        "m2p": (p.pos, m_pos, p.mask, m_mask, po.MAX_NUM_NEIGH, po.MAP_RADIUS, False),
    }


def check_topk(torch, sites):
    from prosim_torch.ops.neighbors import neighbor_topk, neighbor_topk_plain, pairwise_d2

    rows, graphs = [], {}
    for name, (dp, sp, dm, sm, k, r, ex) in sites.items():
        idx, val = neighbor_topk(dp, sp, dm, sm, k, radius=r, exclude_self=ex)
        idx_p, val_p = neighbor_topk_plain(dp, sp, dm, sm, k, radius=r, exclude_self=ex)
        torch.cuda.synchronize()
        if not (torch.equal(idx, idx_p) and torch.equal(val, val_p)):
            bad = (idx != idx_p) | (val != val_p)
            raise AssertionError(f"neighbor_topk[{name}] differs from its plain version "
                                 f"in {int(bad.sum())} of {bad.numel()} slots")
        graphs[name] = (idx, val)
        B, Q = dp.shape[:2]
        S = sp.shape[1]
        K = idx.shape[-1]
        iters = 5 if S > 1024 else 20
        ms, wall_ms = times(torch, lambda: neighbor_topk(dp, sp, dm, sm, k, radius=r, exclude_self=ex),
                            iters)
        plain_ms = device_ms(
            torch, lambda: neighbor_topk_plain(dp, sp, dm, sm, k, radius=r, exclude_self=ex), iters)
        d2 = pairwise_d2(dp, sp)
        bad = ~(sm[:, None, :] & dm[:, :, None])
        if r is not None:
            bad |= d2 > float(r) ** 2
        if ex:
            bad |= torch.eye(Q, S, dtype=torch.bool, device=d2.device)[None]
        d2 = torch.where(bad, torch.inf, d2)
        lib_ms, lib_wall_ms = times(torch, lambda: torch.topk(d2, K, dim=-1, largest=False), iters)
        rows.append(dict(site=name, B=B, Q=Q, S=S, K=K, ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_wall_ms=lib_wall_ms, max_abs_err=0.0,
                         **topk_cost(B, Q, S, K)))
        log(f"  neighbor_topk[{name}] B={B} Q={Q} S={S} K={K}: bit-equal; device ms: kernel "
            f"{ms:.4f}, plain {plain_ms:.4f}, torch.topk {lib_ms:.4f} ({lib_ms / ms:.2f}x the "
            f"kernel); wall ms: kernel {wall_ms:.4f}, torch.topk {lib_wall_ms:.4f}")
    return rows, graphs


@functools.cache
def _table_launcher():
    """The edge core's earlier design over a materialised table x_g
    (csrc/edge_attn_table.cu), the baseline phase 3 times beside the kernel."""
    import ctypes
    from prosim_torch.ops import _build

    fn = _build.load("edge_attn_table").edge_attn_table_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def edge_attn_table(torch, x_g, z_r, qx, qp, edge_valid, scale):
    B, Q, K, D = x_g.shape
    H, Dp = qx.shape[2], z_r.shape[-1]
    out = (torch.empty((B, Q, H, D), device="cuda"), torch.empty((B, Q, H, Dp), device="cuda"),
           torch.empty((B, Q, H), device="cuda"))
    err = _table_launcher()(
        x_g.data_ptr(), z_r.data_ptr(), qx.data_ptr(), qp.data_ptr(), edge_valid.data_ptr(),
        *(o.data_ptr() for o in out), B * Q, K, H, D, Dp, float(scale),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_attn_table launch failed: CUDA error {err}")
    return out


def check_edge(torch, graphs, H, D, scale):
    """graphs: {site: (idx [B,Q,K] int32, edge_valid [B,Q,K], S, D_pe)}, the
    sites' real graphs. The source rows x_src_n [B,S,D] are normalized
    random rows, z_r and the queries random; row 0 of every scene gets no
    valid edge. Beside the kernel: the earlier design (gather_src_features,
    then its kernel over the table, both timed) and the SDPA yardstick on
    the materialised [x_g | z_r] (with the time of the gather it needs)."""
    import torch.nn.functional as F
    from prosim_torch.ops import _build
    from prosim_torch.ops.attention import _norm_stats, gather_src_features
    from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
    from prosim_torch.ops.neighbors import gather_neighbors

    lib = _build.load("edge_attn")
    for Dp in sorted({g[3] for g in graphs.values()}):
        log(f"  edge_attn_core at D={D} Dp={Dp}: {lib.edge_attn_smem_bytes(D, Dp)} bytes of "
            f"dynamic shared memory a block; blocks of 4 warps per SM: short rows "
            f"{lib.edge_attn_blocks_per_sm(0, D, Dp)}, long rows {lib.edge_attn_blocks_per_sm(1, D, Dp)}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, (idx, valid, S, Dp) in graphs.items():
        B, Q, K = valid.shape
        valid = valid.clone()
        valid[:, 0] = False  # at least one row with no valid edge per scene
        x_src = torch.randn((B, S, D), generator=gen, device="cuda")
        x_src_n = _norm_stats(x_src)
        z_r = torch.randn((B, Q, K, Dp), generator=gen, device="cuda")
        qx = torch.randn((B, Q, H, D), generator=gen, device="cuda") * 0.1
        qp = torch.randn((B, Q, H, Dp), generator=gen, device="cuda") * 0.1
        args = (x_src_n, idx, z_r, qx, qp, valid, scale)
        out = edge_attn_core(*args)
        again = edge_attn_core(*args)
        ref = edge_attn_core_plain(*args)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
        if not err <= EDGE_TOL:
            raise AssertionError(f"edge_attn_core[{name}] max abs err {err} > {EDGE_TOL}")
        empty = ~valid.any(-1)
        if any(float(o[empty].abs().max()) != 0.0 for o in out):
            raise AssertionError(f"edge_attn_core[{name}] rows without a valid edge are not zero")
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"edge_attn_core[{name}]: two launches differ")
        x_g = gather_src_features(x_src, idx)
        old = edge_attn_table(torch, x_g, z_r, qx, qp, valid, scale)
        torch.cuda.synchronize()
        old_err = max(float((a - b).abs().max()) for a, b in zip(old, ref))
        iters = 5 if B * Q * K > 2_000_000 else 20
        ms, wall_ms = times(torch, lambda: edge_attn_core(*args), iters)
        plain_ms = device_ms(torch, lambda: edge_attn_core_plain(*args), iters)
        old_ms = device_ms(torch, lambda: edge_attn_table(torch, x_g, z_r, qx, qp, valid, scale),
                           iters)
        gather_ms = device_ms(torch, lambda: gather_src_features(x_src, idx), iters)
        old_path_ms = device_ms(torch, lambda: edge_attn_table(
            torch, gather_src_features(x_src, idx), z_r, qx, qp, valid, scale), iters)
        path_ms = device_ms(torch, lambda: edge_attn_core(_norm_stats(x_src), *args[1:]), iters)
        # yardstick: one SDPA call on [qx|qp] against the shared [x_g|z_r]
        # rows of each destination (one key/value head for H query heads)
        q = torch.cat([qx, qp], -1).reshape(B * Q, H, 1, D + Dp)
        kv_of = lambda: torch.cat([gather_neighbors(x_src_n, idx), z_r], -1).reshape(
            B * Q, 1, K, D + Dp)
        kv = kv_of()
        mask = valid.reshape(B * Q, 1, 1, K)
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kv, kv, attn_mask=mask, scale=scale, enable_gqa=True), iters)
        lib_gather_ms = device_ms(torch, kv_of, iters)
        del q, kv, x_g
        n_valid = int(valid.sum())
        rows.append(dict(site=name, B=B, Q=Q, K=K, S=S, Dp=Dp, valid_edges=n_valid, ms=ms,
                         wall_ms=wall_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library_gather_ms=lib_gather_ms, path_ms=path_ms, table_ms=old_ms,
                         table_gather_ms=gather_ms, table_path_ms=old_path_ms,
                         table_max_abs_err=old_err, max_abs_err=err,
                         **edge_cost(n_valid, B, Q, K, H, D, Dp, S)))
        log(f"  edge_attn_core[{name}] B={B} Q={Q} S={S} K={K} Dp={Dp} valid={n_valid}: err "
            f"{err:.2e}; device ms: kernel {ms:.4f} (norm + kernel {path_ms:.4f}), earlier "
            f"design {old_ms:.4f} + gather {gather_ms:.4f} (together {old_path_ms:.4f}), plain "
            f"{plain_ms:.4f}, sdpa {lib_ms:.4f} + gather {lib_gather_ms:.4f}, bound "
            f"{bound_ms(rows[-1]):.4f}; wall ms: kernel {wall_ms:.4f}")
    return rows


def check_edge_bf16(torch, graphs, H, D, scale, f32_rows, ptxas):
    """B2's bf16 path (edge_attn_kernel_mma, the tensor-core edge engine)
    on the same real graphs: normalized source rows, z_r and queries drawn
    as in check_edge and rounded to bf16. The kernel's max error against the
    f32 plain version on the same values is at most BF16_RULE's 2x the bf16
    plain version's, plus 1e-5; rows with no valid edge exactly zero; two
    launches bitwise equal. Beside its time: the f32 path's (check_edge's
    row of the site) and the bf16 SDPA yardstick with the gather it needs;
    from the build's ptxas log (empty where this process did not compile
    it), the short- and long-row kernels' registers and spill stores."""
    import torch.nn.functional as F
    from prosim_torch.ops import _build
    from prosim_torch.ops.attention import _norm_stats
    from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
    from prosim_torch.ops.neighbors import gather_neighbors

    lib = _build.load("edge_attn")
    usage = {f"{kind}_rows": next((u for n, u in ptxas.items()
                                   if f"{BF16_KERNELS['edge_attn_core']}ILb{b}E" in n), None)
             for kind, b in (("short", 0), ("long", 1))}
    log(f"  edge_attn_core bf16 (registers, spill store bytes): {usage}")
    for Dp in sorted({g[3] for g in graphs.values()}):
        log(f"  edge_attn_core bf16 at D={D} Dp={Dp}: {lib.edge_attn_smem_bytes_bf16(D, Dp)} "
            f"bytes of dynamic shared memory a block; blocks of 4 warps per SM: short rows "
            f"{lib.edge_attn_blocks_per_sm_bf16(0, D, Dp)}, long rows "
            f"{lib.edge_attn_blocks_per_sm_bf16(1, D, Dp)}")
    f32_ms = {r["site"]: r["ms"] for r in f32_rows}
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, (idx, valid, S, Dp) in graphs.items():
        B, Q, K = valid.shape
        valid = valid.clone()
        valid[:, 0] = False  # at least one row with no valid edge per scene
        x_src_n = _norm_stats(torch.randn((B, S, D), generator=gen, device="cuda")).to(bf)
        z_r = torch.randn((B, Q, K, Dp), generator=gen, device="cuda").to(bf)
        qx = (torch.randn((B, Q, H, D), generator=gen, device="cuda") * 0.1).to(bf)
        qp = (torch.randn((B, Q, H, Dp), generator=gen, device="cuda") * 0.1).to(bf)
        args = (x_src_n, idx, z_r, qx, qp, valid, scale)
        out = edge_attn_core(*args)
        again = edge_attn_core(*args)
        torch.cuda.synchronize()
        ref = edge_attn_core_plain(x_src_n.float(), idx, z_r.float(), qx.float(), qp.float(),
                                   valid, scale)
        err = max(float((a.float() - b).abs().max()) for a, b in zip(out, ref))
        ref16 = edge_attn_core_plain(*args)
        err16 = max(float((a.float() - b).abs().max()) for a, b in zip(ref16, ref))
        peak = max(float(b.abs().max()) for b in ref[:2])
        del ref, ref16
        bar = BF16_RULE[0] * err16 + BF16_RULE[1]
        if not err <= bar:
            raise AssertionError(f"edge_attn_core bf16[{name}] max abs err {err} > {bar} "
                                 f"(plain in bf16 {err16})")
        empty = ~valid.any(-1)
        if any(o.dtype != bf or float(o[empty].float().abs().max()) != 0.0 for o in out):
            raise AssertionError(f"edge_attn_core bf16[{name}]: outputs not bf16, or rows "
                                 "without a valid edge not zero")
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"edge_attn_core bf16[{name}]: two launches differ")
        iters = 5 if B * Q * K > 2_000_000 else 20
        ms, wall_ms = times(torch, lambda: edge_attn_core(*args), iters)
        plain_ms = device_ms(torch, lambda: edge_attn_core_plain(*args), iters)
        q = torch.cat([qx, qp], -1).reshape(B * Q, H, 1, D + Dp)
        kv_of = lambda: torch.cat([gather_neighbors(x_src_n, idx), z_r], -1).reshape(  # noqa: E731
            B * Q, 1, K, D + Dp)
        kv = kv_of()
        mask = valid.reshape(B * Q, 1, 1, K)
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kv, kv, attn_mask=mask, scale=scale, enable_gqa=True), iters)
        lib_gather_ms = device_ms(torch, kv_of, iters)
        del q, kv
        n_valid = int(valid.sum())
        rows.append(dict(site=name, B=B, Q=Q, K=K, S=S, Dp=Dp, valid_edges=n_valid, ms=ms,
                         wall_ms=wall_ms, plain_ms=plain_ms, f32_ms=f32_ms[name],
                         library_ms=lib_ms, library_gather_ms=lib_gather_ms, max_abs_err=err,
                         plain_bf16_err=err16, bar=bar, ref_max_abs=peak, ptxas=usage,
                         **edge_cost(n_valid, B, Q, K, H, D, Dp, S, size=2)))
        log(f"  edge_attn_core bf16[{name}] B={B} Q={Q} S={S} K={K} Dp={Dp} valid={n_valid}: "
            f"err {err:.3e} (plain in bf16 {err16:.3e}; bar {bar:.3e}, the f32 aggregates' "
            f"largest |value| {peak:.3e}); device ms: kernel {ms:.4f}, f32 "
            f"kernel {f32_ms[name]:.4f}, plain {plain_ms:.4f}, sdpa bf16 {lib_ms:.4f} + gather "
            f"{lib_gather_ms:.4f}, bound {bound_ms(rows[-1]):.4f}; wall ms: kernel {wall_ms:.4f}")
    return rows


def site_poses(torch, batch):
    """(dst_pos, dst_ori, src_pos, src_ori) of the six fixed-PE sites, as the
    model builds their rel-PE tables from this batch (site_inputs' order)."""
    m, o, p = batch.init_map, batch.init_obs, batch.prompt
    s_pos, s_ori = torch.cat([m.pos, o.pos], 1), torch.cat([m.ori, o.ori], 1)
    return {"a2a": (o.pos, o.ori, o.pos, o.ori), "s2s": (s_pos, s_ori, s_pos, s_ori),
            "p2p": (p.pos, p.ori, p.pos, p.ori), "s2p": (p.pos, p.ori, s_pos, s_ori),
            "a2p": (p.pos, p.ori, o.pos, o.ori), "m2p": (p.pos, p.ori, m.pos, m.ori)}


def check_rel_pe_table(torch, poses, graphs, D):
    """The rel-PE table kernel against its plain chain at each of the six
    fixed-PE sites, on the top-K's real graph `idx` (a2a's K=100 runs the
    partial chunk of 32 edges), f32 and bf16: f32 within REL_PE_F32_TOL,
    bf16 within one bf16 ulp of the plain value (or REL_PE_F32_TOL where
    that ulp is smaller), two launches bitwise equal; device and wall ms
    against the bytes bound (table_cost), and the plain chain's."""
    from prosim_torch.ops.attention import RelPE, rel_pe_table, rel_pe_table_plain

    rows = []
    for dt in (torch.float32, torch.bfloat16):
        pe = RelPE(D, dtype=dt).to("cuda")
        for site, pose in poses.items():
            idx = graphs[site][0]
            args = (*pose, idx)
            B, Q, K = idx.shape
            S = pose[2].shape[1]
            iters = 5 if Q * K > 100_000 else 20
            with torch.no_grad():
                want = rel_pe_table_plain(*args, pe)
                got, again = rel_pe_table(*args, pe, True), rel_pe_table(*args, pe, True)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"rel_pe_table[{site} {dt}]: two launches differ")
                err = (got.float() - want.float()).abs()
                if dt == torch.float32:
                    floor = torch.full_like(err, REL_PE_F32_TOL)
                else:  # one bf16 ulp of the plain value: |want| in [2^(e-1), 2^e) -> 2^(e-8)
                    floor = torch.ldexp(torch.ones_like(err), torch.frexp(want.float())[1] - 8)
                    floor = floor.clamp_min(REL_PE_F32_TOL)
                if bool((err > floor).any()):
                    raise AssertionError(f"rel_pe_table[{site} {dt}]: max error "
                                         f"{float(err.max()):.3g} past its bar")
                ms, wall_ms = times(torch, lambda: rel_pe_table(*args, pe, True), iters)
                plain_ms, plain_wall_ms = times(torch, lambda: rel_pe_table_plain(*args, pe),
                                                iters)
            row = dict(site=site, dtype=str(dt).removeprefix("torch."), B=B, Q=Q, K=K, S=S,
                       ms=ms, wall_ms=wall_ms, plain_ms=plain_ms, plain_wall_ms=plain_wall_ms,
                       library_ms=None, max_abs_err=float(err.max()),
                       **table_cost(B, Q, S, K, D // 4, got.element_size()))
            rows.append(row)
            log(f"rel_pe_table[{site} {row['dtype']}]: B={B} Q={Q} K={K} S={S}: {ms:.4f} device "
                f"ms (wall {wall_ms:.4f}), bound {bound_ms(row):.4f} ms (bytes), plain chain "
                f"{plain_ms:.3f} device ms (wall {plain_wall_ms:.3f}); max |err| "
                f"{row['max_abs_err']:.3g}")
            del want, got, again, err, floor
    return rows


def table_cost(B, Q, S, K, npf, size):
    """Bytes the rel-PE table must move (the table written once, `size`
    bytes a value; idx and both sides' f32 poses, 12 bytes a slot, read
    once); its sines are not counted."""
    return {"bytes": B * Q * K * (3 * npf * size + 4) + B * (S + Q) * 3 * 4, "ops": 0}


def topk_cost(B, Q, S, K):
    """Bytes the top-K must move (positions and masks read once, idx and
    valid written once) and its operations (2 sub, 2 mul, 1 add per pair)."""
    return {"bytes": B * Q * 2 * 4 + B * S * 2 * 4 + B * Q + B * S + B * Q * K * (4 + 1),
            "ops": 5 * B * Q * S}


def edge_cost(n_valid, B, Q, K, H, D, Dp, S, size=4):
    """Bytes the edge core must move (per valid edge its idx and its z_r
    row; the mask; each scene's source table x_src_n once; the queries; the
    outputs; the values `size` bytes each, 4 in f32, 2 in bf16) and its
    operations (a multiply-add for the score and one for the aggregate, per
    valid edge, head and dim), at the f32 peak, or in bf16 at the bf16
    tensor cores' (PERF.md's convention for a bf16 function)."""
    return {"bytes": (n_valid * (4 + Dp * size) + B * Q * K + B * S * D * size
                      + B * Q * H * (D + Dp) * size * 2 + B * Q * H * size),
            "ops": n_valid * 4 * H * (D + Dp), "peak": F32_FLOPS if size == 4 else BF16_FLOPS}


def flash_cost(token_mask, Hq, D, Hkv, dtype):
    """Bytes the causal attention must move (in the inputs' dtype, once each:
    every output row, the q rows of valid tokens, the k and v rows of valid
    keys; and the mask) and its operations: the q.k and p.v multiply-adds
    over the valid (query, key) pairs at or below the diagonal, 4 Hq D per
    pair, at the peak of the path's units (bf16: the tensor cores; f32: the
    CUDA cores' FMA). A pad query row needs no input (its output is zero)
    and a masked key takes part in no pair."""
    import torch

    size, peak = (2, BF16_FLOPS) if dtype == torch.bfloat16 else (4, F32_FLOPS)
    B, T = token_mask.shape
    n = token_mask.sum(dim=1).long()  # valid tokens per scene
    pairs = int((n * (n + 1) // 2).sum())  # the i-th valid query sees i valid keys
    return {"bytes": size * D * (B * T * Hq + int(n.sum()) * (Hq + 2 * Hkv)) + B * T,
            "ops": 4 * Hq * D * pairs, "peak": peak}


def text_layout_mask(torch, B, text_len, block, seed):
    """The tokenizer's layout of [B, text_len + block] tokens: text of a
    random valid length 32..text_len, pad, then the prompt block with about
    half of its slots on (holes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mask = np.zeros((B, text_len + block), bool)
    for b in range(B):
        mask[b, : rng.integers(32, text_len + 1)] = True
        mask[b, text_len:] = rng.random(block) > 0.5
    return torch.from_numpy(mask).cuda()


def check_flash(torch, cfg_llm, B, text_len, block, site):
    """B4 at a Llama's shape and dtype: q/k/v from a seed, the tokenizer's
    holed mask. bf16: the kernel's max error against the plain version in
    f32 on the same inputs must be at most 2x the plain version's own error
    in bf16, plus 1e-5, on valid rows. f32: within FLASH_F32_TOL of the f32
    plain version on valid rows. Pad rows exactly zero."""
    import torch.nn.functional as F
    from prosim_torch.ops.flash_attn import causal_attention, causal_attention_plain

    T, Hq, Hkv, D = text_len + block, cfg_llm.num_heads, cfg_llm.num_kv_heads, cfg_llm.head_dim
    dtype = cfg_llm.dtype
    gen = torch.Generator(device="cuda").manual_seed(4)
    rnd = lambda h: torch.randn((B, T, h, D), generator=gen, device="cuda").to(dtype)
    q, k, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
    mask = text_layout_mask(torch, B, text_len, block, seed=4)
    scale = 1.0 / D ** 0.5
    out = causal_attention(q, k, v, mask, scale)
    ref = causal_attention_plain(q.float(), k.float(), v.float(), mask, scale)
    torch.cuda.synchronize()
    err = float((out.float() - ref)[mask].abs().max())
    extra = {}
    if dtype == torch.bfloat16:
        ref_bf16 = causal_attention_plain(q, k, v, mask, scale)
        err_bf16 = float((ref_bf16.float() - ref)[mask].abs().max())
        bar = BF16_RULE[0] * err_bf16 + BF16_RULE[1]
        extra = {"plain_bf16_err": err_bf16}
        note = f"plain in bf16 {err_bf16:.3e}"
        del ref_bf16
    else:
        bar = FLASH_F32_TOL
        note = f"bar {bar:.0e}"
    if not err <= bar:
        raise AssertionError(f"causal_attention[{site}] max abs err {err} > {bar} ({note})")
    if not bool(torch.isfinite(out).all()) or float(out[~mask].float().abs().max()) != 0.0:
        raise AssertionError(f"causal_attention[{site}]: pad rows are not exactly zero, or "
                             "non-finite values")
    del ref
    ms, wall_ms = times(torch, lambda: causal_attention(q, k, v, mask, scale), 20)
    plain_ms = device_ms(torch, lambda: causal_attention_plain(q, k, v, mask, scale), 5)
    # yardstick: one SDPA call, the same boolean mask, GQA
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    causal = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    bmask = (causal[None] & mask[:, None, :])[:, None]
    lib_ms, lib_wall_ms = times(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bmask, scale=scale, enable_gqa=True), 20)
    row = dict(site=site, B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, dtype=str(dtype).split(".")[-1],
               valid_tokens=int(mask.sum()), ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_wall_ms=lib_wall_ms, max_abs_err=err, **extra,
               **flash_cost(mask, Hq, D, Hkv, dtype))
    log(f"  causal_attention[{site}] B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} {row['dtype']}: err "
        f"{err:.3e} ({note}); device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, sdpa {lib_ms:.4f} "
        f"({lib_ms / ms:.2f}x the kernel); wall ms: kernel {wall_ms:.4f}, sdpa {lib_wall_ms:.4f}")
    return [row]


def flash_bwd_cost(token_mask, Hq, D, Hkv, dtype):
    """Bytes the attention's backward must move (in the inputs' dtype, once
    each: q, o and dO rows of valid tokens, k and v rows of valid keys, their
    f32 lse, and the mask; dq, dk and dv written whole) and its operations:
    the five products per valid causal (query, key) pair and query head
    (q.k, dO.v, P^T dO, dS^T q, dS k), 10 D multiply-add operations, at the
    peak of the path's units (bf16: the tensor cores; f32: FMA)."""
    import torch

    size, peak = (2, BF16_FLOPS) if dtype == torch.bfloat16 else (4, F32_FLOPS)
    B, T = token_mask.shape
    n = token_mask.sum(dim=1).long()
    pairs = int((n * (n + 1) // 2).sum())
    valid = int(n.sum())
    read = size * D * valid * (3 * Hq + 2 * Hkv) + 4 * valid * Hq + B * T
    write = size * D * B * T * (Hq + 2 * Hkv)
    return {"bytes": read + write, "ops": 10 * Hq * D * pairs, "peak": peak}


FLASH_BWD_KERNELS = ("flash_bwd_prep", "flash_bwd_dkv", "flash_bwd_dq")  # one launch each a call


def flash_bwd_usage(ptxas, dtype, D):
    """{kernel: (registers, spill store bytes)} of B4-bwd's three kernels
    in the instantiation a (dtype, padded D) launch runs, from the build's
    ptxas log (empty where this process did not compile them)."""
    import torch

    bf16 = dtype == torch.bfloat16
    keys = {"flash_bwd_prep": "flash_bwd_prep_kernelI" + ("13__nv_bfloat16E" if bf16 else "fE"),
            "flash_bwd_dkv": f"flash_bwd_dkv_{'' if bf16 else 'f32_'}kernelILi{D}E",
            "flash_bwd_dq": f"flash_bwd_dq_{'' if bf16 else 'f32_'}kernelILi{D}E"}
    return {k: next((u for n, u in ptxas.items() if key in n), None) for k, key in keys.items()}


def check_flash_bwd(torch, cfg_llm, B, text_len, block, site, mask=None, ptxas=None):
    """B4's backward at a Llama's shape and dtype, on the forward kernel's
    out and lse, with an upstream gradient zero on pad rows; the mask is
    the tokenizer's holed layout unless one is given. bf16: the
    kernel's max dq/dk/dv error against the plain backward in f32 on the
    same inputs at most 2x the bf16 plain backward's, plus 1e-5 (valid rows
    and keys). f32: within FLASH_F32_TOL of each tensor's largest magnitude.
    Pad rows' dq and masked keys' dk/dv exactly zero, also with NaN in every
    pad row of q, k, v, out and dO; two launches bitwise equal. Times beside
    the backward of scaled_dot_product_attention (bool mask, GQA); the
    device ms of each of the three kernels (FLASH_BWD_KERNELS) and, from
    the build's ptxas log, each one's registers and spill stores."""
    import torch.nn.functional as F
    from prosim_torch.ops.flash_attn import (
        _flash_fwd,
        causal_attention_bwd,
        causal_attention_bwd_plain,
    )

    T, Hq, Hkv, D = text_len + block, cfg_llm.num_heads, cfg_llm.num_kv_heads, cfg_llm.head_dim
    dtype = cfg_llm.dtype
    gen = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda h: torch.randn((B, T, h, D), generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
    if mask is None:
        mask = text_layout_mask(torch, B, text_len, block, seed=5)
    scale = 1.0 / D ** 0.5
    out, lse = _flash_fwd(q, k, v, mask, scale, with_lse=True)
    do = (torch.randn(q.shape, generator=gen, device="cuda") * mask[:, :, None, None]).to(dtype)
    got = causal_attention_bwd(q, k, v, out, lse, do, mask, scale)
    again = causal_attention_bwd(q, k, v, out, lse, do, mask, scale)
    ref = causal_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                     do.float(), mask, scale)
    torch.cuda.synchronize()

    def err_of(xs):
        return max(float((x.float() - r)[mask].abs().max()) for x, r in zip(xs, ref))

    err = err_of(got)
    extra = {}
    if dtype == torch.bfloat16:
        err_bf16 = err_of(causal_attention_bwd_plain(q, k, v, out, lse, do, mask, scale))
        bar = BF16_RULE[0] * err_bf16 + BF16_RULE[1]
        extra = {"plain_bf16_err": err_bf16}
        note = f"plain in bf16 {err_bf16:.3e}"
        ok = err <= bar
    else:
        rel = max(float((x - r).abs().max()) / float(r.abs().max()) for x, r in zip(got, ref))
        extra = {"max_rel_err": rel}
        note = f"{rel:.3e} of each tensor's largest, bar {FLASH_F32_TOL:.0e}"
        ok = rel <= FLASH_F32_TOL
    if not ok:
        raise AssertionError(f"causal_attention_bwd[{site}] max abs err {err} ({note})")
    del ref
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"causal_attention_bwd[{site}]: two launches differ")
    poisoned = []
    for x, val in ((q, "nan"), (k, "nan"), (v, "inf"), (out, "nan"), (do, "nan")):
        x = x.clone()
        x[~mask] = float(val)
        poisoned.append(x)
    dirty = causal_attention_bwd(*poisoned[:4], lse, poisoned[4], mask, scale)
    if not all(torch.equal(a, b) and float(a[~mask].float().abs().max()) == 0.0
               for a, b in zip(dirty, got)):
        raise AssertionError(f"causal_attention_bwd[{site}]: pad rows are not exactly zero, or "
                             "NaN in pad rows reached a gradient")
    del poisoned, dirty, again
    bwd = lambda: causal_attention_bwd(q, k, v, out, lse, do, mask, scale)  # noqa: E731
    # The profiler can lose device events (seen once here: every kernel of
    # one of 20 calls); a trace whose launches are not one each a call is
    # taken again, as profile_forward does, and three such traces fail.
    for _ in range(3):
        ms, names, counts = device_ms(torch, bwd, 20, by_name=True)
        launched = {kern: sum(c for n, c in counts.items() if kern + "_" in n)
                    for kern in FLASH_BWD_KERNELS}
        if all(abs(c - 1) <= 1e-9 for c in launched.values()):
            break
        log(f"causal_attention_bwd[{site}]: the trace holds {launched} launches a call; "
            "profiling again")
    else:
        raise AssertionError(f"causal_attention_bwd[{site}]: kernels launched a call {launched} "
                             "in three traces, not one each of " + ", ".join(FLASH_BWD_KERNELS))
    wall_ms = cuda_ms(torch, bwd, 20)
    per_kernel = {kern: sum(t for n, t in names.items() if kern + "_" in n)
                  for kern in FLASH_BWD_KERNELS}
    usage = flash_bwd_usage(ptxas or {}, dtype, -(-D // 16) * 16)
    plain_ms = device_ms(
        torch, lambda: causal_attention_bwd_plain(q, k, v, out, lse, do, mask, scale), 3)
    # yardstick: the backward of one SDPA call, the same boolean mask, GQA
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    causal = torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    bmask = (causal[None] & mask[:, None, :])[:, None]
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask, scale=scale,
                                           enable_gqa=True)
    do_lib = do.transpose(1, 2).contiguous()
    lib = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_lib, retain_graph=True)  # noqa: E731
    lib_ms, lib_wall_ms = times(torch, lib, 20)
    del o_lib
    row = dict(site=site, B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, dtype=str(dtype).split(".")[-1],
               valid_tokens=int(mask.sum()), ms=ms, wall_ms=wall_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_wall_ms=lib_wall_ms, max_abs_err=err, **extra,
               kernel_ms=per_kernel,
               kernel_usage={k: (None if u is None else {"registers": u[0], "spill_stores": u[1]})
                             for k, u in usage.items()},
               **flash_bwd_cost(mask, Hq, D, Hkv, dtype))
    log(f"  causal_attention_bwd[{site}] B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} {row['dtype']}: "
        f"err {err:.3e} ({note}); device ms: kernel {ms:.4f}, bound {bound_ms(row):.4f}, plain "
        f"{plain_ms:.4f}, sdpa backward {lib_ms:.4f} ({lib_ms / ms:.2f}x the kernel); wall ms: "
        f"kernel {wall_ms:.4f}, sdpa backward {lib_wall_ms:.4f}")
    log("    " + ", ".join(
        f"{kern} {per_kernel[kern]:.4f} ms ("
        + ("not in this build's log" if usage[kern] is None
           else f"{usage[kern][0]} registers, {usage[kern][1]} bytes spill stores") + ")"
        for kern in FLASH_BWD_KERNELS))
    return [row]


def check_fused(torch, model, batch):
    """The fused stack at the demo shape: the policy's real a2p/m2p tables at
    the prompt agents' poses, built from the encoded batch as the policy
    builds them (its graphs, rel-PE features and source tokens), x the
    policy embeddings, the model's random weights packed; row 0 of every
    scene has no valid edge. Also times the layer loop (FUSED_STACK=False,
    12 edge-core launches) and the fused path (tables + kernel) from the
    same graphs."""
    from prosim_torch.ops import _build
    from prosim_torch.ops.fused_stack import fused_two_site_stack, fused_two_site_stack_plain

    policy = model.policy
    p = batch.prompt
    lib = _build.load("fused_stack")
    dims = (policy.hidden_dim, policy.num_heads, policy.head_dim, policy.hidden_dim)
    log(f"  fused_two_site_stack at D=P={dims[0]}, H={dims[1]}, hd={dims[2]}: "
        f"{lib.fused_stack_smem_bytes(*dims)} bytes of dynamic shared memory a block; "
        f"blocks of 16 warps per SM: {lib.fused_stack_blocks_per_sm(*dims)}")
    with torch.inference_mode():
        scene, emd = model.prepare(batch)
        x = emd["emd"].contiguous()
        graphs = [(idx, valid.clone()) for idx, valid in policy.site_graphs(scene, p.pos, p.mask)]
        for _, valid in graphs:
            valid[:, 0] = False
        ta, tm = policy.fused_tables(scene, p.pos, p.ori, graphs)
        wa, wm = policy.pack_fused()
        kw = dict(num_heads=policy.num_heads, head_dim=policy.head_dim)
        out = fused_two_site_stack(x, ta, tm, wa, wm, **kw)
        ref = fused_two_site_stack_plain(x, ta, tm, wa, wm, **kw)
        again = fused_two_site_stack(x, ta, tm, wa, wm, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError("fused_two_site_stack: two launches on the same inputs differ")
        diff = (out - ref).abs()
        err = float(diff.max())
        over = float((diff - FUSED_TOL * ref.abs()).max())
        if not over <= FUSED_TOL:
            raise AssertionError(f"fused_two_site_stack differs from its plain version: max abs "
                                 f"err {err}, {over} over {FUSED_TOL} + {FUSED_TOL} * |plain|")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("fused_two_site_stack gave non-finite values")
        ms, wall_ms = times(torch, lambda: fused_two_site_stack(x, ta, tm, wa, wm, **kw), 5)
        plain_ms = device_ms(torch, lambda: fused_two_site_stack_plain(x, ta, tm, wa, wm, **kw), 3)
        loop_ms = device_ms(torch, lambda: policy.layer_loop(x, scene, p.pos, p.ori, graphs), 5)
        path_ms = device_ms(torch, lambda: fused_two_site_stack(
            x, *policy.fused_tables(scene, p.pos, p.ori, graphs), wa, wm, **kw), 5)
        cost = fused_cost(x, (ta, tm), (wa, wm), **kw)
    ctx = dict(x=x, scene=scene, graphs=graphs, ta=ta, tm=tm, wa=wa, wm=wm)
    B, N, _ = x.shape
    n_valid = [int(t[3].sum()) for t in (ta, tm)]
    row = dict(site="policy", B=B, N=N, Ka=ta[1].shape[-1], Km=tm[1].shape[-1],
               valid_edges=n_valid, ms=ms, wall_ms=wall_ms, plain_ms=plain_ms, library_ms=None,
               layer_loop_ms=loop_ms, fused_path_ms=path_ms, max_abs_err=err, **cost)
    log(f"  fused_two_site_stack[policy] B={B} N={N} Ka={row['Ka']} Km={row['Km']} "
        f"valid={n_valid}: err {err:.2e}, two launches bitwise equal; device ms: kernel "
        f"{ms:.4f}, plain {plain_ms:.4f}, tables + kernel {path_ms:.4f}, layer loop "
        f"{loop_ms:.4f}; wall ms: kernel {wall_ms:.4f}")
    return [row], ctx


def check_fused_bf16(torch, model16, batch, ctx, f32_row, ptxas):
    """B3's bf16 path (fused_stack_kernel_mma: tensor-core dense products,
    the edge engine) on check_fused's tables (the policy's real a2p/m2p
    graphs and features), x and the source tokens rounded to bf16, the
    weights of the same random layers packed in bf16 by the bf16 model.
    The kernel's max error against the f32 plain version (f32 weights, the
    same bf16-rounded x and sources) is at most BF16_RULE's 2x the bf16 plain
    version's, plus 1e-5; two launches bitwise equal. Beside its time: the
    f32 path's (check_fused's) and the bf16 layer loop's; from the build's
    ptxas log, the kernel's registers and spill stores."""
    from prosim_torch.ops import _build
    from prosim_torch.ops.fused_stack import fused_two_site_stack, fused_two_site_stack_plain

    policy = model16.policy
    p = batch.prompt
    bf = torch.bfloat16
    lib = _build.load("fused_stack")
    dims = (policy.hidden_dim, policy.num_heads, policy.head_dim, policy.hidden_dim)
    usage = next((u for n, u in ptxas.items() if BF16_KERNELS["fused_two_site_stack"] in n), None)
    log(f"  fused_two_site_stack bf16: {lib.fused_stack_smem_bytes_bf16(*dims)} bytes of dynamic "
        f"shared memory a block; blocks of 16 warps per SM: "
        f"{lib.fused_stack_blocks_per_sm_bf16(*dims)}; (registers, spill store bytes) {usage}")
    kw = dict(num_heads=policy.num_heads, head_dim=policy.head_dim)
    with torch.inference_mode():
        x = ctx["x"].to(bf)
        t16 = [(t[0].to(bf),) + tuple(t[1:]) for t in (ctx["ta"], ctx["tm"])]
        t32 = [(t[0].float(),) + t[1:] for t in t16]
        wa, wm = policy.pack_fused()
        if any(w.dtype != bf for w in wa + wm):
            raise AssertionError("the bf16 model did not pack its fused weights in bf16")
        out = fused_two_site_stack(x, *t16, wa, wm, **kw)
        again = fused_two_site_stack(x, *t16, wa, wm, **kw)
        torch.cuda.synchronize()
        ref = fused_two_site_stack_plain(x.float(), *t32, ctx["wa"], ctx["wm"], **kw)
        ref16 = fused_two_site_stack_plain(x, *t16, wa, wm, **kw)
        err = float((out.float() - ref).abs().max())
        err16 = float((ref16.float() - ref).abs().max())
        peak = float(ref.abs().max())
        del ref, ref16
        bar = BF16_RULE[0] * err16 + BF16_RULE[1]
        if not err <= bar:
            raise AssertionError(f"fused_two_site_stack bf16: max abs err {err} > {bar} (plain "
                                 f"in bf16 {err16})")
        if out.dtype != bf or not bool(torch.isfinite(out).all()):
            raise AssertionError("fused_two_site_stack bf16: output not bf16, or non-finite")
        if not torch.equal(out, again):
            raise AssertionError("fused_two_site_stack bf16: two launches on the same inputs differ")
        ms, wall_ms = times(torch, lambda: fused_two_site_stack(x, *t16, wa, wm, **kw), 5)
        plain_ms = device_ms(torch, lambda: fused_two_site_stack_plain(x, *t16, wa, wm, **kw), 3)
        scene16 = ctx["scene"].replace(tokens=ctx["scene"].tokens.to(bf))
        loop_ms = device_ms(torch, lambda: policy.layer_loop(
            x, scene16, p.pos.to(bf), p.ori.to(bf), ctx["graphs"]), 5)
        cost = fused_cost(x, t16, (wa, wm), **kw)
    row = dict({k: f32_row[k] for k in ("site", "B", "N", "Ka", "Km", "valid_edges")}, ms=ms,
               wall_ms=wall_ms, plain_ms=plain_ms, f32_ms=f32_row["ms"], library_ms=None,
               layer_loop_ms=loop_ms, max_abs_err=err, plain_bf16_err=err16, bar=bar,
               ref_max_abs=peak, ptxas=usage, **cost)
    log(f"  fused_two_site_stack bf16[policy]: err {err:.3e} (plain in bf16 {err16:.3e}; bar "
        f"{bar:.3e}, the f32 output's largest |value| {peak:.3e}), two launches bitwise equal; device ms: kernel {ms:.4f}, f32 kernel {f32_row['ms']:.4f}, "
        f"plain {plain_ms:.4f}, bf16 layer loop {loop_ms:.4f}, bound {bound_ms(row):.4f}; "
        f"wall ms: kernel {wall_ms:.4f}")
    return [row]


def fused_cost(x_p, tables, weights, num_heads, head_dim):
    """Bytes the fused stack must move (x, both sites' source tokens, idx,
    feats and valid, both sites' packed weights, each read once; the output
    written once) and its operations: per valid edge and layer, 2 H (D + P)
    multiply-adds for the score and the aggregate (2 operations each); per
    valid edge once per call (the function's rel-PE does not change from
    layer to layer), the rel-PE expansion at 8 operations per column (the
    argument's multiply-add, one sin, the norm's sum, sum of squares and
    scaling); per query row and layer, the dense products' multiply-adds
    (to_q, the two folds, to_g, to_s, to_out, the FFN). In bf16 the bytes
    are at the bf16 sizes and the operations at the bf16 peak."""
    from prosim_torch.ops.fused_stack import _FIELDS

    B, N, D = x_p.shape
    H, I = num_heads, num_heads * head_dim
    L, P = weights[0][0].shape[0], weights[0][_FIELDS.index("wkvr")].shape[1]
    es = x_p.element_size()  # x, the sources, the weights and the output; feats are f32
    dense = D * I + 2 * I * (D + P) + (I + D) * I + 2 * D * I + 8 * D * D
    nbytes = 2 * B * N * D * es + es * sum(t.numel() for w in weights for t in w)
    ops = 0
    for x_src, idx, feats, valid in tables:
        nbytes += es * x_src.numel() + 4 * (idx.numel() + feats.numel()) + valid.numel()
        n_valid = int(valid.sum())
        ops += L * n_valid * 4 * H * (D + P) + n_valid * 8 * P + 2 * L * B * N * dense
    return {"bytes": nbytes, "ops": ops, "peak": F32_FLOPS if es == 4 else BF16_FLOPS}


def _bound_s(cost):
    """(bytes time, operations time) in seconds; operations at the cost's
    own peak (f32 CUDA cores unless it names the bf16 tensor cores)."""
    return cost["bytes"] / HBM_BYTES_PER_S, cost["ops"] / cost.get("peak", F32_FLOPS)


def bound_ms(cost):
    return 1e3 * max(_bound_s(cost))


def family(name):
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def profile_forward(torch, model, batch, topk_rows, edge_rows):
    """One forward under torch.profiler, with every kernel launch's inputs
    recorded by a shim around its wrapper. Each kernel launch's device time
    (matched to its shim record in launch order) and its bound at these
    inputs are added up per site; the site is the phase-3 site of the same
    shape ("policy" for the fused stack; a rel-PE table's is its top-K
    graph's). Also returns the device time by kernel family."""
    from torch.profiler import ProfilerActivity, profile

    fns = kernel_fns()
    topk_site = {(r["Q"], r["S"], r["K"]): r["site"] for r in topk_rows}
    edge_site = {(r["Q"], r["K"], r["Dp"]): r["site"] for r in edge_rows}
    calls = {name: [] for name in fns}  # (site, cost or the inputs it is computed from)

    def topk(*a, **kw):
        idx, valid = fns["neighbor_topk"](*a, **kw)
        B, Q, K = idx.shape
        S = a[1].shape[1]
        calls["neighbor_topk"].append((topk_site[Q, S, K], topk_cost(B, Q, S, K)))
        return idx, valid

    def table(dst_pos, dst_ori, src_pos, src_ori, idx, pe, deterministic):
        n = fns["rel_pe_table"].launches
        z = fns["rel_pe_table"](dst_pos, dst_ori, src_pos, src_ori, idx, pe, deterministic)
        if fns["rel_pe_table"].launches > n:  # the kernel's table, not the plain chain's
            B, Q, K = idx.shape
            S = src_pos.shape[1]
            calls["rel_pe_table"].append(
                (topk_site[Q, S, K], table_cost(B, Q, S, K, pe.hidden_dim // 4, z.element_size())))
        return z

    def edge(x_src_n, idx, z_r, qx, qp, edge_valid, scale):
        out = fns["edge_attn_core"](x_src_n, idx, z_r, qx, qp, edge_valid, scale)
        B, S, D = x_src_n.shape
        Q, K = idx.shape[1:]
        dims = (B, Q, K, qx.shape[2], D, z_r.shape[-1], S, x_src_n.element_size())
        calls["edge_attn_core"].append((edge_site[Q, K, z_r.shape[-1]], (edge_valid, dims)))
        return out

    def flash(q, k, v, token_mask, scale):
        out = fns["causal_attention"](q, k, v, token_mask, scale)
        site = "llama" if q.dtype == torch.bfloat16 else "tiny_f32"
        calls["causal_attention"].append(
            (site, (token_mask, q.shape[2], q.shape[3], k.shape[2], q.dtype)))
        return out

    def fused(x_p, a2p_tables, m2p_tables, weights_a, weights_m, **kw):
        out = fns["fused_two_site_stack"](x_p, a2p_tables, m2p_tables, weights_a, weights_m, **kw)
        calls["fused_two_site_stack"].append(
            ("policy", (x_p, (a2p_tables, m2p_tables), (weights_a, weights_m), kw)))
        return out

    # The profiler can drop device events of a forward with ~18k launches
    # (seen once in the text forward: 111 of 123 edge-core launches); such a
    # trace cannot be matched to the shims, so it is taken again.
    for attempt in range(3):
        for recs in calls.values():
            recs.clear()
        before = launch_counts()
        with kernel_calls(topk, edge, fused, flash, table_fn=table), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        if launched != {k: len(v) for k, v in calls.items()}:
            raise AssertionError(f"the shims saw {[len(v) for v in calls.values()]} of "
                                 f"{launched} kernel launches")
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if not device:
            raise RuntimeError("the profiler recorded no device time")
        seen = {k: sum(KERNEL_NAMES[k] in e.name for e in device) for k in calls}
        if seen == launched:
            break
        log(f"profile: the trace holds {seen} of {launched} kernel launches; profiling again")
    else:
        raise AssertionError("the profiler dropped kernel launches in three traces")
    calls["edge_attn_core"] = [
        (site, edge_cost(int(valid.sum()), *dims)) for site, (valid, dims) in calls["edge_attn_core"]]
    calls["causal_attention"] = [
        (site, flash_cost(*args)) for site, args in calls["causal_attention"]]
    calls["fused_two_site_stack"] = [
        (site, fused_cost(x, tables, weights, **kw))
        for site, (x, tables, weights, kw) in calls["fused_two_site_stack"]]
    device.sort(key=lambda e: e.time_range.start)
    by_fam, by_name, count = {}, {}, {}
    for e in device:
        us = e.time_range.elapsed_us()
        by_fam[family(e.name)] = by_fam.get(family(e.name), 0.0) + us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
        count[e.name] = count.get(e.name, 0) + 1
    per_site = {}
    for kernel, recs in calls.items():
        evs = [e for e in device if KERNEL_NAMES[kernel] in e.name]
        sites = per_site[kernel] = {}
        for e, (site, cost) in zip(evs, recs):
            s = sites.setdefault(site, {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
            s["launches"] += 1
            s["ms"] += e.time_range.elapsed_us() / 1e3
            s["bound_ms"] += bound_ms(cost)
    busy = sum(by_fam.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # which path of B2 and B3 ran: the bf16 paths' kernels by name, the f32
    # ones by their template argument
    inst = {k: sorted({"bf16" if mma in e.name else "f32" if F32_TAG in e.name else e.name[:80]
                       for e in device if KERNEL_NAMES[k] in e.name})
            for k, mma in BF16_KERNELS.items()}
    return per_site, {"wall_ms": wall_ms, "busy_ms": busy, "launches": len(device),
                      "families_ms": dict(sorted(by_fam.items(), key=lambda kv: -kv[1])),
                      "top_kernels": [(n[:110], ms, count[n]) for n, ms in top],
                      "instantiations": inst}


def text_parity(torch, model, small, plain, flash_plain):
    """The text configuration at B=2: the conditioned policy embedding
    (LlamaTextAttn's output, from `prepare`) of the kernel path against a
    plain path whose attention runs in f32 on the same bf16 q/k/v; the
    kernel path's max deviation must be at most 2x the deviation of the
    plain path with the attention in bf16, plus 1e-5. The rollouts'
    deviation is logged."""
    from prosim_torch.ops.flash_attn import causal_attention

    def f32_attention(q, k, v, token_mask, scale):
        return flash_plain(q.float(), k.float(), v.float(), token_mask, scale)

    m2 = small.prompt.mask
    emd = model.prepare(small)[1]["emd"]
    out = model(small)
    before = launch_counts()
    with kernel_calls(*plain, f32_attention, table_fn=rel_pe_table_chain):
        emd_ref = model.prepare(small)[1]["emd"]
        out_ref = model(small)
    with kernel_calls(*plain, flash_plain, table_fn=rel_pe_table_chain):
        emd_bf16 = model.prepare(small)[1]["emd"]
    if launch_counts() != before:
        raise AssertionError("text: the plain path launched a kernel")
    dev = float((emd - emd_ref)[m2].abs().max())
    dev_bf16 = float((emd_bf16 - emd_ref)[m2].abs().max())
    dxy = float((out["rollout_traj"] - out_ref["rollout_traj"])[m2][..., :2].abs().max())
    log(f"parity: B=2 text conditioned embedding, kernel path vs plain path (f32 attention) "
        f"max dev {dev:.3e}; plain path with bf16 attention {dev_bf16:.3e}; "
        f"rollout max |dxy| {dxy:.3e} m; {causal_attention.launches} B4 launches so far")
    bar = BF16_RULE[0] * dev_bf16 + BF16_RULE[1]
    if not dev <= bar:
        raise AssertionError(f"text: conditioned embedding deviates by {dev} > {bar} "
                             f"(2x the bf16 plain path's {dev_bf16} + 1e-5)")
    return {"embedding_dev": dev, "embedding_dev_plain_bf16": dev_bf16, "rollout_dxy_m": dxy}


def train_launches():
    """B1's launches a train step of phases 7 and 9 (each forward's graphs,
    again in its recompute) and B4's forward and backward launches a step of
    configs/with_text.yaml as shipped (the tiny() Llama)."""
    from prosim_torch.models.llm.llama import LlamaConfig

    tiny = LlamaConfig.tiny()
    return 2 * (4 + 2 * REPLAN), {
        "causal_attention": (3 if tiny.remat else 2) * tiny.num_layers,
        "causal_attention_bwd": tiny.num_layers}


def forward_launches():
    """Each kernel's launches per forward of the full-width closed loop: the
    layer loop's and FUSED_STACK=True's. Each graph's site builds its rel-PE
    table through csrc/rel_pe_table.cu, but B3 reads raw features."""
    steps = 2 + 2 + 2 * REPLAN  # graph builds: scene encoder, decoder, policy per step
    want = {"neighbor_topk": steps, "edge_attn_core": LAYERS * steps, "fused_two_site_stack": 0,
            "causal_attention": 0, "causal_attention_bwd": 0, "rel_pe_table": steps}
    return want, dict(want, edge_attn_core=LAYERS * 4, fused_two_site_stack=REPLAN,
                      rel_pe_table=4)


def run_rollout(torch, cfg, model, batch, want, label):
    """Warm-up forward, then three timed forwards of the full-width B=16
    closed loop: launches per forward as `want`, no rel-PE table built by
    the plain chain, finite, bounded, (sin, cos) on the unit circle,
    bitwise deterministic. Returns the sorted forward times in seconds."""
    from prosim_torch.ops.attention import rel_pe_table

    t0 = time.perf_counter()
    model(batch)
    torch.cuda.synchronize()
    log(f"rollout[{label}]: first forward {time.perf_counter() - t0:.2f} s")
    for fn in kernel_fns().values():
        fn.launches = 0
    plain0 = rel_pe_table.plain_builds
    t0 = time.perf_counter()
    out = model(batch)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = launch_counts()
    plain = rel_pe_table.plain_builds - plain0
    log(f"rollout[{label}]: launches per forward {launches} (expected {want}); rel-PE tables "
        f"by the plain chain {plain}")
    if launches != want or plain:
        raise AssertionError(f"{label}: kernel launches {launches} != {want}, or {plain} "
                             "rel-PE tables by the plain chain")
    for _ in range(2):
        t0 = time.perf_counter()
        out2 = model(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    traj = out["rollout_traj"]
    valid_traj = traj[batch.prompt.mask]
    if traj.shape != (B_FULL, AGENTS, REPLAN * cfg.ROLLOUT.POLICY.REPLAN_FREQ, 4):
        raise AssertionError(f"{label}: rollout_traj shape {tuple(traj.shape)}")
    if not bool(torch.isfinite(valid_traj).all()):
        raise AssertionError(f"{label}: rollout_traj has non-finite values")
    if float(valid_traj[..., :2].abs().max()) > 1e4:
        raise AssertionError(f"{label}: rollout_traj leaves a 10 km box")
    unit = (valid_traj[..., 2] ** 2 + valid_traj[..., 3] ** 2 - 1).abs().max()
    if float(unit) > 1e-4:
        raise AssertionError(f"{label}: (sin, cos) off the unit circle by {float(unit)}")
    if not torch.equal(out["rollout_traj"], out2["rollout_traj"]):
        raise AssertionError(f"{label}: two forwards of the same batch differ")
    times.sort()
    log(f"rollout[{label}]: B={B_FULL} forward s {['%.4f' % t for t in times]}, "
        f"median {B_FULL / times[1]:.3f} scenes/s, "
        f"max |xy| {float(valid_traj[..., :2].abs().max()):.2f} m, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, times


def traj_err(torch, a, b, what, mask):
    """Max |dxy| of two B=2 rollouts over the valid agents `mask`, within
    PARITY_TOL_M."""
    diff = (a["rollout_traj"] - b["rollout_traj"])[mask][..., :2].abs()
    err_m = float(diff.max())
    per_step = diff.amax(dim=(0, 2)).view(REPLAN, -1).amax(dim=1)
    log(f"parity: B=2 rollout {what} max |dxy| {err_m:.3e} m (mean {float(diff.mean()):.3e}); "
        f"max per replan step {['%.2e' % float(x) for x in per_step]}")
    if not err_m <= PARITY_TOL_M:
        raise AssertionError(f"{what}: {err_m} m > {PARITY_TOL_M} m")
    return err_m


def bf16_parity(torch, out, out_plain16, out_plain32, what, mask):
    """The bf16 kernel path's rollout sits no further from the f32 plain
    rollout than 2x the bf16 plain rollout does, plus PARITY_TOL_M: over
    the first replan step, before the random weights' drift compounds
    (bf16 against f32 reaches metres by the last step, on both paths),
    and over the whole rollout."""
    def dev(a):  # max |dxy| from the f32 plain rollout, per replan step
        d = (a["rollout_traj"] - out_plain32["rollout_traj"])[mask][..., :2].abs()
        return [float(x) for x in d.amax(dim=(0, 2)).view(REPLAN, -1).amax(dim=1)]

    if not bool(torch.isfinite(out["rollout_traj"][mask]).all()):
        raise AssertionError(f"{what} bf16: rollout_traj has non-finite values")
    dk, dp = dev(out), dev(out_plain16)
    log(f"parity: B=2 rollout {what} bf16, max |dxy| from the f32 plain path per replan "
        f"step: kernel path {['%.2e' % x for x in dk]} m, bf16 plain path "
        f"{['%.2e' % x for x in dp]} m")
    for span, k, p in (("first replan step", dk[0], dp[0]),
                       ("rollout", max(dk), max(dp))):
        if not k <= 2 * p + PARITY_TOL_M:
            raise AssertionError(f"{what} bf16, {span}: the kernel path is {k} m from the "
                                 f"f32 plain path, more than 2x the bf16 plain path's {p} "
                                 f"+ {PARITY_TOL_M}")
    return {"first_step_kernel_vs_f32_plain_m": dk[0],
            "first_step_bf16_plain_vs_f32_plain_m": dp[0],
            "kernel_vs_f32_plain_m": max(dk), "bf16_plain_vs_f32_plain_m": max(dp),
            "per_step_kernel_m": dk, "per_step_bf16_plain_m": dp}


def log_profile(label, per_site, prof):
    log(f"profile[{label}]: forward wall {prof['wall_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), "
        f"{prof['launches']} kernel launches")
    for fam, ms in prof["families_ms"].items():
        log(f"  {fam:22s} {ms:10.3f} ms  {100 * ms / prof['busy_ms']:5.1f} %")
    for kernel, sites in per_site.items():
        if sites:
            log(f"  {kernel} per forward: " + ", ".join(
                f"{s} x{v['launches']} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})"
                for s, v in sites.items()))


def summarize(name, route, source, replaces, rows, launches, forward, extra=()):
    """One kernel's JSON entry: times and bounds summed over one launch at
    each of its phase-3 sites; forward_ms, forward_bound_ms and the sites'
    forward_* fields come from phase 4's profiled forward of the
    configuration that runs the kernel; `extra` names more row fields to
    sum."""
    for r in rows:
        r["bound_ms"] = bound_ms(r)
        t_bytes, t_ops = _bound_s(r)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        f = forward.get(r["site"], {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
        r.update({f"forward_{k}": v for k, v in f.items()})
    tot = lambda key: sum(r[key] for r in rows)
    lib = [r["library_ms"] for r in rows]
    lib_wall = [r.get("library_wall_ms") for r in rows]
    return {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
        "bound_by": ("bytes" if sum(_bound_s(r)[0] for r in rows) >= sum(_bound_s(r)[1] for r in rows)
                     else "operations"),
        "library_ms": None if None in lib else sum(lib),
        "wall_ms": tot("wall_ms"), "library_wall_ms": None if None in lib_wall else sum(lib_wall),
        **{key: tot(key) for key in extra},
        "forward_ms": tot("forward_ms"), "forward_bound_ms": tot("forward_bound_ms"),
        "sites": rows,
    }


def train_phase(torch, root, shape, batch_size=None, steps=TRAIN_STEPS, device="cuda"):
    """Phase 7: configs/no_text.yaml trained through Trainer.fit at full
    width, then the B=2 gates (see the module docstring). Returns the
    phase's record; raises on a failed gate."""
    import shutil

    import numpy as np

    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.ops.edge_attn import edge_attn_core, edge_attn_core_plain
    from prosim_torch.ops.flash_attn import causal_attention_plain
    from prosim_torch.ops.fused_stack import fused_two_site_stack, fused_two_site_stack_plain
    from prosim_torch.ops.neighbors import neighbor_topk_plain
    from prosim_torch.train.losses import paired_mse_k
    from prosim_torch.train.optim import param_groups
    from prosim_torch.train.trainer import Trainer, find_latest_checkpoint

    build = os.path.join(root, "build")
    shutil.rmtree(os.path.join(build, "chip_smoke_train"), ignore_errors=True)
    cfg = get_config(os.path.join(root, TRAIN_YAML), [
        "EXPERIMENT_DIR", build, "EXPERIMENT_NAME", "chip_smoke_train",
        "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.REMAT_POLICY", "full"])
    B = batch_size or cfg.TRAIN.BATCH_SIZE
    R = shape["num_replan"]
    while True:
        trainer = Trainer(cfg, device=device)
        trainer.setup()
        batches = [make_synthetic_batch(cfg, batch_size=B, seed=10 + i, device=device, **shape)
                   for i in range(steps)]
        p0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        for fn in kernel_fns().values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer.fit(batches, max_steps=steps)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if B == 1:
                raise
            log(f"train: B={B} does not fit in device memory; halving it")
            del trainer, batches, p0
            torch.cuda.empty_cache()
            B //= 2
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    recs = [json.loads(line) for line in open(trainer.log_path)]
    train_recs = [r for r in recs if "train/full_loss" in r]
    walls = [r["wall"] for r in train_recs]
    step_ms = [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    terms = {k: v for k, v in train_recs[-1].items() if k.startswith("train/")}
    if B != cfg.TRAIN.BATCH_SIZE:
        log(f"train: CUT: B={B} instead of TRAIN.BATCH_SIZE {cfg.TRAIN.BATCH_SIZE}")
    log(f"train: {TRAIN_YAML} B={B} steps {len(train_recs)}: step ms (synchronised host clock) "
        f"{['%.1f' % t for t in step_ms]}, median {sorted(step_ms)[len(step_ms) // 2]:.1f}; "
        f"peak memory {peak / 2**30:.2f} GiB; B1 launches per step "
        f"{launches['neighbor_topk'] / steps:g}; kernel launches in {steps} steps {launches}")
    log("train: last step's terms " + ", ".join(f"{k[6:]}={v:.6g}" for k, v in terms.items()))
    # gates
    want_topk = steps * 2 * (4 + 2 * R)  # each forward's graphs, again in its recompute
    if launches["neighbor_topk"] != want_topk:
        raise AssertionError(f"train: neighbor_topk launched {launches['neighbor_topk']} times, "
                             f"expected {want_topk}")
    if launches["edge_attn_core"] or launches["fused_two_site_stack"]:
        raise AssertionError(f"train: a forward-only kernel ran where gradients are wanted: {launches}")
    bad = [(r["step"], k) for r in train_recs for k, v in r.items()
           if k.startswith("train/") and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"train: non-finite loss terms {bad}")
    moved = {n: float((p.detach() - p0[n]).abs().max()) for n, p in trainer.model.named_parameters()}
    goal_pred = {n for n, p in trainer.model.named_parameters()
                 if any(p is q for q in param_groups(trainer.model, cfg)["goal_pred"])}
    if not goal_pred or any(moved[n] != 0.0 for n in goal_pred):
        raise AssertionError("train: the goal_pred group (GOAL_MODEL_LR_SCALE 0) moved or is empty")
    if max(v for n, v in moved.items() if n not in goal_pred) == 0.0:
        raise AssertionError("train: no parameter moved")
    if find_latest_checkpoint(trainer.run_dir) is None:
        raise AssertionError("train: fit saved no checkpoint")
    prof = profile_train_step(torch, trainer, batches[0])
    log(f"profile[train step, B={B}]: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), "
        f"{prof['launches']} device operations")
    for fam, ms in prof["families_ms"].items():
        log(f"  {fam:22s} {ms:10.3f} ms  {100 * ms / prof['busy_ms']:5.1f} %")
    for name, ms, n in prof["top_kernels"]:
        log(f"    {ms:9.3f} ms x{n:<6d} {name}")
    del batches
    torch.cuda.empty_cache()

    # B=2: B1's kernel against the plain top-K in one train step, determinism
    model = trainer.model
    small = make_synthetic_batch(cfg, batch_size=2, seed=1, device=device, **shape)

    def grad_step():
        model.zero_grad(set_to_none=True)
        out = model.forward_train(small, seed=7)
        loss = paired_mse_k(small, out, cfg)["full_loss"]
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    loss_k, g_k = grad_step()
    loss_k2, g_k2 = grad_step()
    before = launch_counts()
    with kernel_calls(neighbor_topk_plain, edge_attn_core_plain, fused_two_site_stack_plain,
                      causal_attention_plain, table_fn=rel_pe_table_chain):
        loss_p, g_p = grad_step()
    if launch_counts() != before:
        raise AssertionError("train: the plain path launched a kernel")
    model.zero_grad(set_to_none=True)

    def leaf_err(a, b):
        errs = {n: float((a[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                for n, g in b.items()}
        name = max(errs, key=errs.get)
        return errs[name], name

    loss_dev = abs(loss_k - loss_p) / abs(loss_p)
    grad_dev = leaf_err(g_k, g_p)
    rerun_loss_dev = abs(loss_k - loss_k2) / abs(loss_k)
    rerun_grad_dev = leaf_err(g_k, g_k2)
    log(f"train parity (B=2): B1 kernel vs plain top-K: loss {loss_k:.8g} vs {loss_p:.8g} "
        f"(rel {loss_dev:.2e}), worst gradient leaf {grad_dev[1]} at {grad_dev[0]:.2e} of its max; "
        f"the kernel step twice: loss rel {rerun_loss_dev:.2e}, worst gradient leaf "
        f"{rerun_grad_dev[1]} at {rerun_grad_dev[0]:.2e}")
    if set(g_k) != set(g_p) or not loss_dev <= TRAIN_LOSS_RTOL or not grad_dev[0] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"train: B1 kernel step vs plain step: loss {loss_dev}, "
                             f"gradient {grad_dev}")
    if not rerun_loss_dev <= DETERMINISM_RTOL:
        raise AssertionError(f"train: two runs of one step differ in loss by {rerun_loss_dev}")

    # the forward-only kernels refuse inputs that require grad
    x = torch.randn((1, 4, 16), device=device)
    idx = torch.zeros((1, 3, 2), dtype=torch.int32, device=device)
    z = torch.randn((1, 3, 2, 8), device=device)
    qx = torch.randn((1, 3, 2, 16), device=device, requires_grad=True)
    qp = torch.randn((1, 3, 2, 8), device=device)
    ok = torch.ones((1, 3, 2), dtype=torch.bool, device=device)
    refused = []
    for name, call in (("edge_attn_core", lambda: edge_attn_core(x, idx, z, qx, qp, ok, 0.5)),
                       ("fused_two_site_stack", lambda: fused_two_site_stack(
                           qx, (x, idx, z, ok), (x, idx, z, ok), [], [], num_heads=2,
                           head_dim=8))):
        try:
            call()
        except RuntimeError as e:
            if "no backward" in str(e):
                refused.append(name)
    if refused != ["edge_attn_core", "fused_two_site_stack"]:
        raise AssertionError(f"train: only {refused} refused inputs that require grad")

    # evaluate and the M-replica validation rollout, through the kernels
    for fn in kernel_fns().values():
        fn.launches = 0
    metrics = trainer.evaluate([small])
    rollout = trainer.rollout_callback([small], m=4)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    log(f"train eval (B=2): evaluate {metrics}; rollout_callback M=4 {rollout}; "
        f"kernel launches {eval_launches}")
    if not all(np.isfinite(v) for v in list(metrics.values()) + list(rollout.values())):
        raise AssertionError("train: evaluate or rollout_callback gave a non-finite metric")
    if not (eval_launches["neighbor_topk"] and eval_launches["edge_attn_core"]):
        raise AssertionError(f"train: evaluate/rollout_callback did not run B1 and B2: {eval_launches}")
    return {"config": TRAIN_YAML, "batch_size": B, "batch_size_configured": cfg.TRAIN.BATCH_SIZE,
            "steps": len(train_recs), "step_ms": step_ms, "peak_memory_bytes": peak,
            "launches": launches, "neighbor_topk_per_step": launches["neighbor_topk"] / steps,
            "terms": terms, "parity": {"loss_rel": loss_dev, "grad_leaf": grad_dev[0],
                                       "rerun_loss_rel": rerun_loss_dev,
                                       "rerun_grad_leaf": rerun_grad_dev[0]},
            "eval": metrics, "rollout": rollout, "eval_launches": eval_launches,
            "profile": prof}


def text_train_phase(torch, root, shape, label, opts, steps=TRAIN_STEPS, device="cuda"):
    """Phase 8: configs/with_text.yaml trained through Trainer.setup and
    Trainer.fit at full width (see the module docstring). Returns the
    phase's record; raises on a failed gate."""
    import shutil

    import numpy as np

    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.train.optim import param_groups
    from prosim_torch.train.trainer import Trainer

    build = os.path.join(root, "build")
    name = f"chip_smoke_text_train_{label}"
    shutil.rmtree(os.path.join(build, name), ignore_errors=True)
    cfg = get_config(os.path.join(root, TEXT_TRAIN_YAML), list(opts) + [
        "EXPERIMENT_DIR", build, "EXPERIMENT_NAME", name,
        "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.REMAT_POLICY", "full"])
    B = cfg.TRAIN.BATCH_SIZE
    R = shape["num_replan"]
    while True:
        trainer = Trainer(cfg, device=device)
        trainer.setup()
        model = trainer.model
        text_attn = model.condition_transformer_policy_decoder.text_attn
        llm = text_attn.llm
        with torch.no_grad():
            # At the seeded init (zero biases) an agent the text names but the
            # batch does not hold is injected as an exactly zero row, which
            # stays zero through every block; each RMSNorm's backward then
            # scales its gradient by 1/sqrt(eps), so 32 layers overflow to NaN,
            # in the JAX package as in the port (PERF.md §6). A drawn
            # ln_prompt bias makes no injected row zero.
            gen = torch.Generator(device=device).manual_seed(2)
            text_attn.ln_prompt.bias.copy_(
                torch.randn(text_attn.ln_prompt.bias.shape, generator=gen, device=device) * 0.02)
        groups = param_groups(model, cfg)
        names = {id(p): n for n, p in model.named_parameters()}
        frozen = [names[id(p)] for p in groups["llm_frozen"]]
        trained = [names[id(p)] for g in ("lora", "adapter") for p in groups[g]]
        batches = [make_synthetic_batch(cfg, batch_size=B, seed=10 + i, device=device, **shape)
                   for i in range(steps)]
        # the frozen body, bitwise, on the host (15 GB at Llama3-8B width)
        body = {n: model.get_parameter(n).detach().cpu() for n in frozen}
        p0 = {n: model.get_parameter(n).detach().clone() for n in trained}
        # B=2 at the weights before the fit, so they depend on no kernel
        parity = text_grad_parity(torch, cfg, model, trained, llm.cfg.dtype, shape, label,
                                  device)
        with torch.no_grad():
            for n in trained:
                model.get_parameter(n).copy_(p0[n])
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer.fit(batches[:1], max_steps=1)  # the warm-up step
            torch.cuda.synchronize()
            first = {n: model.get_parameter(n).grad for n in trained if n.endswith("lora_b")}
            qkv_zero = [n for n, g in first.items() if "_proj." in n and not bool(g.any())]
            for fn in kernel_fns().values():
                fn.launches = 0
            trainer.fit(batches[1:], max_steps=steps)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            if B == 1:
                raise
            log(f"text train[{label}]: B={B} does not fit in device memory; halving it")
            del trainer, model, text_attn, llm, batches, body, p0, groups
            torch.cuda.empty_cache()
            B //= 2
    timed = steps - 1
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    recs = [json.loads(line) for line in open(trainer.log_path)]
    train_recs = [r for r in recs if "train/full_loss" in r]
    walls = [r["wall"] for r in train_recs[1:]]  # the second fit's clock starts at its own t0
    step_ms = [1e3 * w for w in walls[:1]] + [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    terms = {k: v for k, v in train_recs[-1].items() if k.startswith("train/")}
    L = llm.cfg.num_layers
    per_fwd = 3 if llm.cfg.remat else 2  # forward, prepare's recompute (+ the block's own)
    want = {"neighbor_topk": timed * 2 * (4 + 2 * R), "edge_attn_core": 0,
            "fused_two_site_stack": 0, "causal_attention": timed * per_fwd * L,
            "causal_attention_bwd": timed * L, "rel_pe_table": 0}
    if B != cfg.TRAIN.BATCH_SIZE:
        log(f"text train[{label}]: CUT: B={B} instead of TRAIN.BATCH_SIZE {cfg.TRAIN.BATCH_SIZE}")
    log(f"text train[{label}]: {TEXT_TRAIN_YAML} {llm.cfg.dtype} Llama ({L} layers, remat "
        f"{llm.cfg.remat}) B={B} timed steps {len(step_ms)}: step ms (synchronised host clock) "
        f"{['%.1f' % t for t in step_ms]}, median {sorted(step_ms)[len(step_ms) // 2]:.1f}; "
        f"peak memory {peak / 2**30:.2f} GiB; per step B4 forward "
        f"{launches['causal_attention'] / timed:g}, B4 backward "
        f"{launches['causal_attention_bwd'] / timed:g}; launches in {timed} steps {launches}")
    log(f"text train[{label}]: last step's terms " + ", ".join(
        f"{k[6:]}={v:.6g}" for k, v in terms.items()))
    if launches != want:
        raise AssertionError(f"text train[{label}]: kernel launches {launches} != {want}")
    bad = [(r["step"], k) for r in train_recs for k, v in r.items()
           if k.startswith("train/") and not np.isfinite(v)]
    if bad or "train/prompt_mask_pred_loss" not in terms:
        raise AssertionError(f"text train[{label}]: non-finite or missing loss terms {bad}")
    if qkv_zero or len(first) != 3 * L:
        raise AssertionError(f"text train[{label}]: first-step q/k/v lora_b gradients zero or "
                             f"missing: {qkv_zero}, {len(first)} of {3 * L}")
    still = [n for n in trained if torch.equal(model.get_parameter(n).detach(), p0[n])]
    if still:
        raise AssertionError(f"text train[{label}]: LoRA/adapter leaves did not move: {still[:5]}")
    for n in frozen:
        prm = model.get_parameter(n)
        if prm.requires_grad or prm.grad is not None or not torch.equal(prm.detach().cpu(), body[n]):
            raise AssertionError(f"text train[{label}]: frozen {n} has a gradient or moved")
    del body, p0
    prof = profile_train_step(torch, trainer, batches[0])
    log(f"profile[text train {label}, B={B}]: wall {prof['wall_ms']:.1f} ms, device busy "
        f"{prof['busy_ms']:.1f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), "
        f"{prof['launches']} device operations")
    for fam, ms in prof["families_ms"].items():
        log(f"  {fam:22s} {ms:10.3f} ms  {100 * ms / prof['busy_ms']:5.1f} %")
    for kname, ms, n in prof["top_kernels"]:
        log(f"    {ms:9.3f} ms x{n:<6d} {kname}")
    tmask = batches[0].conditions[TEXT_KEY]["token_mask"]
    q_heads, kv_heads, hd = llm.cfg.num_heads, llm.cfg.num_kv_heads, llm.cfg.head_dim
    step_bwd = {"launches": L,
                "ms": prof["families_ms"].get("flash_attn_bwd (ours)", 0.0),
                "bound_ms": L * bound_ms(flash_bwd_cost(tmask, q_heads, hd, kv_heads,
                                                        llm.cfg.dtype))}
    del batches
    torch.cuda.empty_cache()

    small = make_synthetic_batch(cfg, batch_size=2, seed=1, device=device, **shape)
    # evaluate and the M-replica validation rollout, through B4's eval launch
    for fn in kernel_fns().values():
        fn.launches = 0
    metrics = trainer.evaluate([small])
    rollout = trainer.rollout_callback([small], m=4)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    log(f"text train eval[{label}] (B=2): evaluate {metrics}; rollout_callback M=4 {rollout}; "
        f"kernel launches {eval_launches}")
    if not all(np.isfinite(v) for v in list(metrics.values()) + list(rollout.values())):
        raise AssertionError(f"text train[{label}]: evaluate or rollout_callback non-finite")
    if not eval_launches["causal_attention"] or eval_launches["causal_attention_bwd"]:
        raise AssertionError(f"text train[{label}]: eval launches {eval_launches}")
    rec = {"config": TEXT_TRAIN_YAML, "label": label, "opts": list(opts),
           "llama": {"dtype": str(llm.cfg.dtype), "layers": L, "remat": llm.cfg.remat},
           "batch_size": B, "batch_size_configured": cfg.TRAIN.BATCH_SIZE,
           "timed_steps": len(step_ms), "step_ms": step_ms, "peak_memory_bytes": peak,
           "launches": launches, "per_step": {k: v / timed for k, v in launches.items()},
           "terms": terms, "parity": parity, "eval": metrics, "rollout": rollout,
           "eval_launches": eval_launches, "profile": prof, "flash_bwd_per_step": step_bwd}
    del trainer, model, text_attn, llm
    torch.cuda.empty_cache()
    return rec


def text_grad_parity(torch, cfg, model, trained, dtype, shape, label, device):
    """Phase 8 at B=2: the kernel step's loss and LoRA/adapter gradients
    against plain steps through the dense attention (autograd), and each B4
    backward launch of the kernel steps against the plain backward on its
    own inputs (see the module docstring). Draws the lora_b leaves (the
    caller restores them). Returns the record; raises on a failed gate."""
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.llm import llama
    from prosim_torch.ops import flash_attn
    from prosim_torch.ops.flash_attn import causal_attention_bwd_plain, causal_attention_plain
    from prosim_torch.train.losses import paired_mse_k

    bf16 = dtype == torch.bfloat16
    smalls = [make_synthetic_batch(cfg, batch_size=2, seed=s, device=device, **shape)
              for s in range(1, 1 + (GRAD_PARITY_BATCHES if bf16 else 1))]
    with torch.no_grad():  # adapters that do work in both factors
        gen = torch.Generator(device=device).manual_seed(1)
        for n in trained:
            if n.endswith(("lora_b", "lora_embed_b")):
                prm = model.get_parameter(n)
                prm.copy_(torch.randn(prm.shape, generator=gen, device=device) * 0.02)
    lora = [n for n in trained if "lora" in n]

    def grad_step(batch):
        model.zero_grad(set_to_none=True)
        loss = paired_mse_k(batch, model.forward_train(batch, seed=7), cfg)["full_loss"]
        loss.backward()
        return float(loss.detach()), {n: model.get_parameter(n).grad.detach().clone()
                                      for n in trained}

    def f32_attention(q, k, v, token_mask, scale):
        return causal_attention_plain(q.float(), k.float(), v.float(), token_mask,
                                      scale).to(q.dtype)

    launch_rows = []  # each backward launch of the kernel steps: (err, bar)

    def hold_launch(inputs, got):
        """bf16: phase 3's 2x rule against the plain backward in f32. f32:
        the error of each tensor, over its largest magnitude, against the
        plain backward in f64, within twice the f32 plain backward's own
        plus FLASH_F32_TOL (a train step's gradients can cancel to far
        below their terms, where f32 rounding alone exceeds 1e-5)."""
        q, k, v, o, lse, do, mask, scale = inputs
        plain = causal_attention_bwd_plain(q, k, v, o, lse, do, mask, scale)
        if bf16:
            ref = causal_attention_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                             do.float(), mask, scale)
            err_of = lambda xs: max(float((x.float() - r)[mask].abs().max())  # noqa: E731
                                    for x, r in zip(xs, ref))
            launch_rows.append((err_of(got), BF16_RULE[0] * err_of(plain) + BF16_RULE[1]))
        else:
            ref = causal_attention_bwd_plain(*(x.double() for x in (q, k, v, o, lse, do)), mask,
                                             scale)
            err_of = lambda xs: max(  # noqa: E731
                float((x.double() - r).abs().max()) / max(float(r.abs().max()), 1e-300)
                for x, r in zip(xs, ref))
            launch_rows.append((err_of(got), BF16_RULE[0] * err_of(plain) + FLASH_F32_TOL))

    def leaf_errs(a, ref):
        return {n: float((a[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                for n, g in ref.items()}

    def lora_norm_err(a, ref):  # of all LoRA leaves together
        num = sum(float((a[n] - ref[n]).double().square().sum()) for n in lora)
        den = sum(float(ref[n].double().square().sum()) for n in lora)
        return (num / max(den, 1e-300)) ** 0.5

    draws, kernel_launches = [], 0
    for batch in smalls:
        before = launch_counts()["causal_attention_bwd"]
        flash_attn.backward_observers.append(hold_launch)
        try:
            loss_k, g_k = grad_step(batch)
        finally:
            flash_attn.backward_observers.remove(hold_launch)
        kernel_launches += launch_counts()["causal_attention_bwd"] - before
        plain_before = launch_counts()
        saved = llama.causal_attention
        try:
            llama.causal_attention = f32_attention if bf16 else causal_attention_plain
            loss_p, g_p = grad_step(batch)
            if bf16:
                llama.causal_attention = causal_attention_plain
                loss_b, g_b = grad_step(batch)
        finally:
            llama.causal_attention = saved
        if any(launch_counts()[k] != plain_before[k]
               for k in ("causal_attention", "causal_attention_bwd")):
            raise AssertionError(f"text train[{label}]: the plain path launched B4")
        errs_k = leaf_errs(g_k, g_p)
        worst = max(errs_k, key=errs_k.get)
        draw = {"loss_kernel": loss_k, "loss_plain": loss_p,
                "loss_rel": abs(loss_k - loss_p) / abs(loss_p), "grad_leaf": errs_k[worst],
                "grad_leaf_name": worst, "lora_norm": lora_norm_err(g_k, g_p)}
        if bf16:
            worst_b = max(leaf_errs(g_b, g_p).values())
            norm_b = lora_norm_err(g_b, g_p)
            draw.update(loss_plain_bf16=loss_b, loss_rel_plain_bf16=abs(loss_b - loss_p) /
                        abs(loss_p), grad_leaf_plain_bf16=worst_b,
                        grad_bar=BF16_RULE[0] * worst_b + BF16_RULE[1],
                        lora_norm_plain_bf16=norm_b,
                        lora_norm_bar=BF16_RULE[0] * norm_b + BF16_RULE[1])
        draws.append(draw)
    model.zero_grad(set_to_none=True)
    if not launch_rows or kernel_launches != len(launch_rows):
        raise AssertionError(f"text train[{label}]: the kernel steps' backward launches "
                             f"{kernel_launches}, held {len(launch_rows)}")
    worst_launch = max(launch_rows, key=lambda r: r[0] / r[1])
    first = draws[0]
    parity = dict(first, launches_held=len(launch_rows), launch_err=worst_launch[0],
                  launch_bar=worst_launch[1], draws=draws)
    if bf16:
        log(f"text train parity[{label}] (B=2, weights before the fit): kernel vs plain with "
            f"f32 attention: loss {first['loss_kernel']:.8g} vs {first['loss_plain']:.8g} (rel "
            f"{first['loss_rel']:.2e}; plain with bf16 attention "
            f"{first['loss_rel_plain_bf16']:.2e}); worst LoRA/adapter leaf "
            f"{first['grad_leaf_name']} at {first['grad_leaf']:.2e} of its max (plain with "
            f"bf16 attention: worst {first['grad_leaf_plain_bf16']:.2e}, bar "
            f"{first['grad_bar']:.2e}); {len(launch_rows)} backward launches in {len(draws)} "
            f"batches within the 2x rule (worst {worst_launch[0]:.3e}, bar "
            f"{worst_launch[1]:.3e}); per batch, the LoRA leaves' gradient error norm / bar "
            + ", ".join(f"{d['lora_norm']:.3e}/{d['lora_norm_bar']:.3e}" for d in draws)
            + "; worst leaf / bar " + ", ".join(
                f"{d['grad_leaf']:.2e}/{d['grad_bar']:.2e}" for d in draws))
        bad = [i + 1 for i, d in enumerate(draws) if not d["lora_norm"] <= d["lora_norm_bar"]]
        if not (first["loss_rel"] <= TRAIN_LOSS_RTOL and first["grad_leaf"] <= first["grad_bar"]
                and worst_launch[0] <= worst_launch[1] and not bad):
            raise AssertionError(
                f"text train[{label}]: kernel step vs plain step: loss {first['loss_rel']} (bar "
                f"{TRAIN_LOSS_RTOL}), worst leaf {first['grad_leaf']} (bar {first['grad_bar']}), "
                f"worst launch {worst_launch[0]} (bar {worst_launch[1]}), LoRA norm over its bar "
                f"in batches {bad}")
    else:
        log(f"text train parity[{label}] (B=2, weights before the fit): kernel vs plain: loss "
            f"{first['loss_kernel']:.8g} vs {first['loss_plain']:.8g} (rel "
            f"{first['loss_rel']:.2e}); {len(launch_rows)} backward launches against the f64 "
            f"plain backward within 2x the f32 plain's error plus 1e-5 of each tensor's largest "
            f"(worst {worst_launch[0]:.3e}, bar {worst_launch[1]:.3e}); "
            f"worst LoRA/adapter leaf {first['grad_leaf_name']} at {first['grad_leaf']:.2e} of "
            "its max")
        if not (first["loss_rel"] <= TRAIN_LOSS_RTOL and first["grad_leaf"] <= TRAIN_GRAD_TOL
                and worst_launch[0] <= worst_launch[1]):
            raise AssertionError(f"text train[{label}]: kernel step vs plain step: loss "
                                 f"{first['loss_rel']}, worst leaf {first['grad_leaf']}, worst "
                                 f"launch {worst_launch[0]} (bar {worst_launch[1]})")
    return parity


def text_train_phases(torch, root, shape):
    """Phase 8 in both configurations: configs/with_text.yaml as shipped
    (ARCH auto without weights: the f32 tiny() Llama) and at Llama3-8B width
    (random bf16 body drawn on the card), TEXT8_TRAIN_LAYERS layers deep."""
    from prosim_torch.models.llm.llama import LlamaConfig

    rec = {"as_shipped": text_train_phase(torch, root, shape, "as_shipped", [])}
    full = LlamaConfig.__dict__["llama3_8b"]
    LlamaConfig.llama3_8b = classmethod(lambda cls, lora_rank=16: dataclasses.replace(
        full.__func__(cls, lora_rank), num_layers=TEXT8_TRAIN_LAYERS))
    try:
        log(f"text train[llama3_8b]: CUT: {TEXT8_TRAIN_LAYERS} of 32 layers")
        rec["llama3_8b"] = text_train_phase(torch, root, shape, "llama3_8b", TEXT_OPTS)
    finally:
        LlamaConfig.llama3_8b = full
    return rec



def bitwise_equal(torch, a, b):
    """Same dtype, shape and bytes (NaNs in the same places)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def assert_batches_equal(torch, got, want, what):
    from prosim_torch.data.batch import tree_leaves_with_path

    la, lb = tree_leaves_with_path(got), tree_leaves_with_path(want)
    if [p for p, _ in la] != [p for p, _ in lb]:
        raise AssertionError(f"{what}: the batches' leaves differ")
    bad = [p for (p, x), (_, y) in zip(la, lb) if not bitwise_equal(torch, x, y)]
    if bad:
        raise AssertionError(f"{what}: leaves differ: {bad[:6]}")
    return len(la)


def device_busy(torch, fn):
    """(wall ms, device busy ms, the host-to-device copies' profiler events,
    fn's result): fn under torch.profiler, tracing the device only; busy is
    the union of the device operations' intervals."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    h2d = [e for e in device if "HtoD" in e.name]
    return wall_ms, busy_union_ms(device), h2d, res


def busy_union_ms(device):
    """The union of device events' intervals, in ms."""
    busy, end = 0.0, None
    for e in sorted(device, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if end is None or s >= end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy / 1e3


def producer_rate(torch, cfg, cache, batch_size):
    """Scenes/s through `batches` with one producer thread and a cold
    format cache: formatted, conditioned, collated and copied."""
    from prosim_torch.data.dataset import ProSimImitationDataset

    cold = ProSimImitationDataset(cfg, "val", cache)
    t0 = time.perf_counter()
    n = sum(b.batch_size for b in cold.batches(batch_size, num_workers=1))
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


@contextlib.contextmanager
def stage_timer(ds):
    """Host ms spent in the producer by stage while the block runs: a
    scene's get_scene_batch (formatting on a format-cache miss, and its
    conditions), its condition sampling alone, and a batch's collation into
    a slab with the start of its copy. Yields {stage: [ms, calls]}."""
    from prosim_torch.data.loader import SlabCollator

    ms = {"get_scene": [0.0, 0], "conditions": [0.0, 0], "collate_copy": [0.0, 0]}

    def timed(fn, stage):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ms[stage][0] += 1e3 * (time.perf_counter() - t0)
                ms[stage][1] += 1
        return run

    ship = SlabCollator.ship
    ds.get_scene_batch = timed(ds.get_scene_batch, "get_scene")
    ds.cond_gen.generate = timed(ds.cond_gen.generate, "conditions")
    SlabCollator.ship = timed(ship, "collate_copy")
    try:
        yield ms
    finally:
        SlabCollator.ship = ship
        del ds.get_scene_batch, ds.cond_gen.generate


def fit_steps(torch, trainer, batches, n):
    """n more Trainer.fit steps on `batches`: each step's ms by the train
    log's wall clock (the first includes fetching the first batch) and the
    caching allocator's retries meanwhile."""
    first = trainer.step
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    trainer.fit(batches, max_steps=first + n)
    torch.cuda.synchronize()
    walls = [r["wall"] for r in map(json.loads, open(trainer.log_path))
             if "train/full_loss" in r and r["step"] > first]
    if len(walls) != n:
        raise AssertionError(f"train: {len(walls)} logged steps, expected {n}")
    step_ms = [1e3 * walls[0]] + [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    return step_ms, torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries


def data_phase(torch, root, want, want_f, topk_per_step, text_per_step, device="cuda",
               diagnose=False):
    """Phase 9: the host data pipeline at the demo padding (see the module
    docstring); `diagnose` adds the train-step diagnosis. Returns the
    phase's record; raises on a failed gate."""
    import shutil

    import numpy as np

    from prosim_torch.config import get_config
    from prosim_torch.data import womd_ingest, womd_synth
    from prosim_torch.data.batch import tree_leaves
    from prosim_torch.data.dataset import ProSimImitationDataset
    from prosim_torch.data.formatter import collate
    from prosim_torch.data.scene_bank import DeviceSceneBank, banked_batches
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.train.trainer import Trainer
    from prosim_torch.utils.params import init_params

    rec = {"cut": f"synthetic WOMD scenes (no WOMD data in the repository): {DATA_SCENES} "
                  f"scenes in {DATA_SHARDS} shards, {DATA_AGENTS[0]}-{DATA_AGENTS[1]} agents "
                  f"and {DATA_LANES[0]}-{DATA_LANES[1]} lanes a scene; random weights"}
    out = os.path.join(root, "build", "chip_smoke_data")
    shutil.rmtree(out, ignore_errors=True)
    src = ["DATASET.SOURCE.TRAIN", f"['{DATA_ENV}']", "DATASET.SOURCE.VAL", f"['{DATA_ENV}']",
           "DATASET.SOURCE.ROLLOUT", f"['{DATA_ENV}']"]
    B = B_FULL
    rec["section_s"] = {}
    last = [time.perf_counter()]

    def lap(section):  # the phase's seconds by section, kept within budget
        now = time.perf_counter()
        rec["section_s"][section] = now - last[0]
        log(f"data: {section}: {now - last[0]:.1f} s")
        last[0] = now

    free, total = torch.cuda.mem_get_info()
    rec["device_free_gib_at_start"] = free / 2**30
    log(f"data: {free / 2**30:.2f} of {total / 2**30:.2f} GiB of device memory free at the start")

    # the data: synthetic shards -> the port's ingest -> a trajdata cache
    t0 = time.perf_counter()
    shards = womd_synth.synthesize_shards(os.path.join(out, "shards"), DATA_SCENES, DATA_SHARDS,
                                          seed=0, agents=DATA_AGENTS, lanes=DATA_LANES)
    t1 = time.perf_counter()
    cache = os.path.join(out, "cache")
    summ = womd_ingest.ingest_shards(shards, cache, DATA_ENV)
    t2 = time.perf_counter()
    rec["synth_scenes_per_s"] = DATA_SCENES / (t1 - t0)
    rec["ingest_scenes_per_s"] = DATA_SCENES / (t2 - t1)
    rec["agents_per_scene"] = [min(s["agents"] for s in summ), max(s["agents"] for s in summ)]
    rec["lanes_per_scene"] = [min(s["lanes"] for s in summ), max(s["lanes"] for s in summ)]
    log(f"data: CUT: {rec['cut']}")
    log(f"data: synthesized {DATA_SCENES} scenes in {t1 - t0:.2f} s; ingested them "
        f"({rec['agents_per_scene']} agents, {rec['lanes_per_scene']} lanes a scene) in "
        f"{t2 - t1:.2f} s: {rec['ingest_scenes_per_s']:.2f} scenes/s (host)")

    lap("synthesis and ingest")

    # formatting, serial and through the pipelined producer (cold caches)
    cfg = get_config(opts=src)
    ds = ProSimImitationDataset(cfg, "val", cache)
    if len(ds) != DATA_SCENES:
        raise AssertionError(f"data: the dataset holds {len(ds)} scenes")
    t0 = time.perf_counter()
    ds.get_scene_batch(0, device=None)  # builds the native lane engine
    rec["native_build_s"] = time.perf_counter() - t0
    cold = ProSimImitationDataset(cfg, "val", cache)
    cold._fmt_cache_cap = 0
    t0 = time.perf_counter()
    singles = [cold.get_scene_batch(i, seed=i, device=None) for i in range(DATA_SCENES)]
    rec["format_serial_scenes_per_s"] = DATA_SCENES / (time.perf_counter() - t0)
    pad = cfg.DATASET.FORMAT
    occ = {"lanes": [int(s.init_map.mask.any(-1).sum()) for s in singles],
           "obs_agents": [int(s.init_obs.mask.any(-1).sum()) for s in singles],
           "agents": [int(s.prompt.mask.sum()) for s in singles]}
    rec["valid_per_scene"] = {k: {"mean": float(np.mean(v)), "max": max(v)} for k, v in occ.items()}
    rec["padding"] = {"lanes": pad.MAP.MAX_POINTS, "obs_agents": pad.PAD.NUM_OBS_AGENTS,
                      "agents": pad.PAD.NUM_AGENTS}
    log(f"data: format (host, native lane engine built in {rec['native_build_s']:.2f} s): "
        f"serial {rec['format_serial_scenes_per_s']:.2f} scenes/s; valid per scene "
        + ", ".join(f"{k} mean {v['mean']:.1f} max {v['max']} of {rec['padding'][k]}"
                    for k, v in rec["valid_per_scene"].items()))

    # loader batches: bitwise the plain moves of the same scenes, one
    # host-to-device copy a batch, slabs reused (prefetch 1: 3 slabs for 4
    # batches) without corrupting a held batch
    def loader_pass():
        return list(ds.batches(B, num_workers=1, prefetch=1))

    # a trace holding fewer copies than batches lost events (the profiler
    # can); it is taken again, and three such traces fail
    for attempt in range(3):
        wall, busy, h2d, held = device_busy(torch, loader_pass)
        if len(held) != DATA_SCENES // B:
            raise AssertionError(f"data: the loader gave {len(held)} batches")
        if len(h2d) >= len(held):
            break
        log(f"data: the trace holds {len(h2d)} host-to-device copies for {len(held)} batches; "
            "profiling again")
    if len(h2d) != len(held):
        raise AssertionError(f"data: {len(h2d)} host-to-device copies for {len(held)} batches")
    for k, got in enumerate(held):
        ref = collate(singles[k * B:(k + 1) * B]).to(device)
        n_leaves = assert_batches_equal(torch, got, ref, f"data: loader batch {k}")
    copy_bytes = sum(int(t.numel() * t.element_size()) for t in tree_leaves(held[0]))
    rec["loader"] = {"batches": len(held), "leaves": n_leaves, "copies": len(h2d),
                     "copy_ms": [e.time_range.elapsed_us() / 1e3 for e in h2d],
                     "leaf_bytes": copy_bytes, "pass_ms": wall, "traces": attempt + 1}
    log(f"data: loader B={B}: {len(held)} batches of {n_leaves} leaves bitwise equal to plain "
        f"moves; {len(h2d)} host-to-device copies ({copy_bytes / 2**20:.2f} MiB of leaves a "
        f"batch), copy ms {['%.3f' % x for x in rec['loader']['copy_ms']]}")
    del singles
    # formatting through the pipelined producer, with a cold format cache
    # (after the loader pass above has set up the pinned host allocator)
    rec["format_pipelined_scenes_per_s"] = producer_rate(torch, cfg, cache, B)

    # the same on the densest maps womd_synth's geometry gives
    t0 = time.perf_counter()
    shards = womd_synth.synthesize_shards(os.path.join(out, "dense_shards"), DENSE_SCENES,
                                          DATA_SHARDS // 2, seed=1, agents=DATA_AGENTS,
                                          lanes=DENSE_LANES)
    t1 = time.perf_counter()
    dense_cache = os.path.join(out, "dense_cache")
    womd_ingest.ingest_shards(shards, dense_cache, DATA_ENV)
    t2 = time.perf_counter()
    dense = ProSimImitationDataset(cfg, "val", dense_cache)
    dense._fmt_cache_cap = 0
    singles = [dense.get_scene_batch(i, seed=i, device=None) for i in range(DENSE_SCENES)]
    t3 = time.perf_counter()
    lanes = [int(s.init_map.mask.any(-1).sum()) for s in singles]
    del singles
    rec["dense"] = {"scenes": DENSE_SCENES, "lanes_drawn": list(DENSE_LANES),
                    "ingest_scenes_per_s": DENSE_SCENES / (t2 - t1),
                    "format_serial_scenes_per_s": DENSE_SCENES / (t3 - t2),
                    "valid_lanes": {"mean": float(np.mean(lanes)), "max": max(lanes)},
                    "format_pipelined_scenes_per_s": producer_rate(torch, cfg, dense_cache, B)}
    d = rec["dense"]
    log(f"data: dense maps ({DENSE_SCENES} scenes, {DENSE_LANES[0]}-{DENSE_LANES[1]} lanes "
        f"drawn): valid lane slots mean {d['valid_lanes']['mean']:.1f} max "
        f"{d['valid_lanes']['max']} of {pad.MAP.MAX_POINTS}; ingest "
        f"{d['ingest_scenes_per_s']:.2f}, format serial {d['format_serial_scenes_per_s']:.2f} "
        f"scenes/s (host)")
    log(f"data: format through the pipelined producer (collated and copied): "
        f"{rec['format_pipelined_scenes_per_s']:.2f} scenes/s, dense maps "
        f"{d['format_pipelined_scenes_per_s']:.2f}")

    lap("formatting, loader and dense maps")

    # the closed loop on dataset batches: phase 4's launches, finite and
    # deterministic, fed by the loader (cold: formatting in the producer;
    # warm: the format cache hit)
    rec["rollout"] = {}
    for label, opts, want_l in (("layer loop", [], want),
                                ("fused", ["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"],
                                 want_f)):
        c = get_config(opts=src + opts)
        model = ProSim(c, device=device)
        init_params(model, seed=0)
        launches, times = run_rollout(torch, c, model, held[0], want_l, f"{label}, dataset")
        r = {"launches": launches, "forward_s": times, "scenes_per_s": B / times[1]}
        for tag in ("cold", "dense_cold", "warm"):
            fed = {"cold": lambda: ProSimImitationDataset(c, "val", cache),
                   "dense_cold": lambda: ProSimImitationDataset(c, "val", dense_cache),
                   "warm": lambda: ds}[tag]()
            n = len(fed)

            def fed_pass():
                for b in fed.batches(B, num_workers=1):
                    model(b)

            t0 = time.perf_counter()
            fed_pass()
            torch.cuda.synchronize()
            fwall = 1e3 * (time.perf_counter() - t0)
            r[f"loader_fed_{tag}"] = {"scenes_per_s": n / fwall * 1e3, "wall_ms": fwall}
            log(f"rollout[{label}, dataset]: fed from the loader ({tag} format cache) "
                f"{n / fwall * 1e3:.3f} scenes/s over {n} scenes")
        # the device's busy share of the warm loader-fed pass, profiled apart
        # (the profiler slows a host-bound loop)
        pwall, pbusy, _, _ = device_busy(torch, fed_pass)
        r["loader_fed_warm"].update(profiled_wall_ms=pwall, busy_ms=pbusy)
        log(f"rollout[{label}, dataset]: profiled warm loader-fed pass: device busy "
            f"{pbusy:.1f} of {pwall:.1f} ms ({100 * pbusy / pwall:.1f} %)")
        rec["rollout"][label] = r
        del model
    del held
    torch.cuda.empty_cache()

    lap("closed loop")

    # training on dataset batches: no_text with its conditions (phase 7's
    # B1 launches a step), evaluate, evaluate_cond_sets
    build = os.path.join(root, "build")
    shutil.rmtree(os.path.join(build, "chip_smoke_data_train"), ignore_errors=True)
    cfg_t = get_config(os.path.join(root, TRAIN_YAML), src + [
        "EXPERIMENT_DIR", build, "EXPERIMENT_NAME", "chip_smoke_data_train",
        "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.REMAT_POLICY", "full",
        "PROMPT.CONDITION.EVAL_COND_SETS", str(DATA_COND_SETS),
        "DATASET.SCENE.SAMPLE_RATE.VAL", str(DATA_SCENES // B)])  # one val batch a pass
    trainer = Trainer(cfg_t, device=device)
    trainer.setup()
    ds_t = ProSimImitationDataset(cfg_t, "train", cache)
    p0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    trainer.fit(lambda: ds_t.batches(B, shuffle=True, seed=1, num_workers=1), max_steps=1)
    for fn in kernel_fns().values():
        fn.launches = 0
    with stage_timer(ds_t) as stages:
        trainer.fit(lambda: ds_t.batches(B, shuffle=True, seed=2, num_workers=1),
                    max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
    timed = TRAIN_STEPS - 1
    launches = launch_counts()
    recs = [json.loads(line) for line in open(trainer.log_path)]
    train_recs = [r for r in recs if "train/full_loss" in r]
    walls = [r["wall"] for r in train_recs[1:]]
    step_ms = [1e3 * walls[0]] + [1e3 * (b - a) for a, b in zip(walls, walls[1:])]
    terms = {k: v for k, v in train_recs[-1].items() if k.startswith("train/")}
    log(f"data train: {TRAIN_YAML} on dataset batches B={B}, conditions "
        f"{list(cfg_t.PROMPT.CONDITION.TYPES)}: step ms {['%.1f' % t for t in step_ms]} (the "
        f"first includes the loader's start); B1 launches per step "
        f"{launches['neighbor_topk'] / timed:g} (phase 7: {topk_per_step:g}); terms "
        + ", ".join(f"{k[6:]}={v:.6g}" for k, v in terms.items()))
    bad = [(r["step"], k) for r in train_recs for k, v in r.items()
           if k.startswith("train/") and not np.isfinite(v)]
    if bad or len(train_recs) != TRAIN_STEPS:
        raise AssertionError(f"data train: non-finite loss terms {bad} or missing steps")
    if launches["neighbor_topk"] != timed * topk_per_step or any(
            v for k, v in launches.items() if k != "neighbor_topk"):
        raise AssertionError(f"data train: kernel launches {launches}, expected "
                             f"{timed * topk_per_step:g} of B1 only")
    if max(float((p.detach() - p0[n]).abs().max())
           for n, p in trainer.model.named_parameters()) == 0.0:
        raise AssertionError("data train: no parameter moved")
    del p0

    lap("no_text training")

    # what the producer costs the steps: its host ms by stage (above); with
    # `diagnose`, the same trainer on the same dataset batches held on the
    # card (no producer) and on phase 7's synthetic batches, and one profiled
    # step of each; the allocator's retries say whether memory was short
    per_scene = {k: v[0] / max(v[1], 1) for k, v in stages.items()}
    per_scene["format"] = (stages["get_scene"][0] - stages["conditions"][0]) / max(
        stages["get_scene"][1], 1)
    diag = {"fed_ms": step_ms, "producer_stage_ms": {k: v for k, v in stages.items()},
            "producer_ms_per_call": per_scene}
    log(f"data train: producer host ms a call while fed: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_scene.items())
        + f" (calls {[v[1] for v in stages.values()]})")
    if diagnose:
        import itertools

        held_t = list(itertools.islice(ds_t.batches(B, shuffle=True, seed=2, num_workers=0),
                                       timed))
        synth = [make_synthetic_batch(cfg_t, batch_size=B, seed=10 + i, device=device,
                                      num_lanes=LANES, num_obs_agents=OBS_AGENTS,
                                      num_agents=AGENTS, num_replan=REPLAN)
                 for i in range(timed)]
        held_ms, held_retries = fit_steps(torch, trainer, held_t, timed)
        synth_ms, synth_retries = fit_steps(torch, trainer, synth, timed)
        diag.update({
            "held_ms": held_ms, "synthetic_ms": synth_ms,
            "alloc_retries": {"held": held_retries, "synthetic": synth_retries,
                              "total": torch.cuda.memory_stats().get("num_alloc_retries", 0)},
            "valid_agents": {"dataset": int(held_t[0].prompt.mask.sum()),
                             "synthetic": int(synth[0].prompt.mask.sum())},
            "profiled": {"dataset": profile_train_step(torch, trainer, held_t[0]),
                         "synthetic": profile_train_step(torch, trainer, synth[0])}})
        log(f"data train: step ms fed by the producer {['%.1f' % t for t in step_ms]}; the "
            f"same batches held on the card {['%.1f' % t for t in held_ms]}; phase 7's "
            f"synthetic batches {['%.1f' % t for t in synth_ms]}; allocator retries "
            f"{diag['alloc_retries']}; valid agents in the first batch {diag['valid_agents']}")
        for tag, pr in diag["profiled"].items():
            log(f"data train: profiled step on {tag} batches: device busy {pr['busy_ms']:.1f} "
                f"of {pr['wall_ms']:.1f} ms wall, {pr['launches']} device operations; "
                + ", ".join(f"{k} {v:.1f}" for k, v in list(pr["families_ms"].items())[:6]))
        del held_t, synth
        lap("train step diagnosis")
    ds_v = ProSimImitationDataset(cfg_t, "val", cache)
    t0 = time.perf_counter()
    metrics = trainer.evaluate(lambda: ds_v.batches(B, num_workers=1))
    cond_sets = trainer.evaluate_cond_sets(cache, "val", batch_size=B)
    eval_s = time.perf_counter() - t0
    log(f"data eval: evaluate {metrics}; evaluate_cond_sets {cond_sets} ({eval_s:.1f} s)")
    vals = list(metrics.values()) + [v for m in cond_sets.values() for v in m.values()]
    if not vals or not all(np.isfinite(v) for v in vals) or list(cond_sets) != DATA_COND_SETS:
        raise AssertionError("data eval: evaluate or evaluate_cond_sets non-finite or missing")
    rec["train"] = {"config": TRAIN_YAML, "step_ms": step_ms, "launches": launches,
                    "terms": terms, "eval": metrics, "cond_sets": cond_sets, "diagnosis": diag}
    del trainer
    torch.cuda.empty_cache()

    lap("evaluate and evaluate_cond_sets")

    # with_text.yaml as shipped: OneText conditions from the derived motion
    # tags' texts (no released texts: motion_tag_texts) through the byte
    # tokenizer; phase 8's B4 launches a step
    shutil.rmtree(os.path.join(build, "chip_smoke_data_text"), ignore_errors=True)
    cfg_x = get_config(os.path.join(root, TEXT_TRAIN_YAML), src + [
        "EXPERIMENT_DIR", build, "EXPERIMENT_NAME", "chip_smoke_data_text",
        "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.REMAT_POLICY", "full"])
    trainer = Trainer(cfg_x, device=device)
    trainer.setup()
    text_attn = trainer.model.condition_transformer_policy_decoder.text_attn
    with torch.no_grad():  # as phase 8: no injected agent row exactly zero
        gen = torch.Generator(device=device).manual_seed(2)
        text_attn.ln_prompt.bias.copy_(
            torch.randn(text_attn.ln_prompt.bias.shape, generator=gen, device=device) * 0.02)
    ds_x = ProSimImitationDataset(cfg_x, "train", cache)
    max_text = cfg_x.MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS
    first = ds_x.get_scene_batch(0, seed=0, device=None).conditions[TEXT_KEY]
    n_text = int(first["token_mask"][0, :max_text].sum())
    for fn in kernel_fns().values():
        fn.launches = 0
    trainer.fit(lambda: ds_x.batches(B, shuffle=True, seed=3, num_workers=1), max_steps=2)
    torch.cuda.synchronize()
    launches_x = launch_counts()
    recs = [json.loads(line) for line in open(trainer.log_path)]
    terms_x = {k: v for k, v in [r for r in recs if "train/full_loss" in r][-1].items()
               if k.startswith("train/")}
    per_step = {k: launches_x[k] / 2 for k in ("causal_attention", "causal_attention_bwd")}
    log(f"data text train: {TEXT_TRAIN_YAML} as shipped on dataset batches B={B}, scene 0's "
        f"text {n_text} tokens; B4 per step {per_step} (phase 8: "
        f"{ {k: text_per_step[k] for k in per_step} }); terms "
        + ", ".join(f"{k[6:]}={v:.6g}" for k, v in terms_x.items()))
    if any(per_step[k] != text_per_step[k] for k in per_step):
        raise AssertionError(f"data text train: B4 launches per step {per_step}")
    if not all(np.isfinite(v) for v in terms_x.values()) or "train/prompt_mask_pred_loss" \
            not in terms_x or n_text <= 0:
        raise AssertionError(f"data text train: terms {terms_x}, text tokens {n_text}")
    rec["text_train"] = {"config": TEXT_TRAIN_YAML, "per_step": per_step, "terms": terms_x,
                         "text_tokens_scene0": n_text}
    del trainer, text_attn
    torch.cuda.empty_cache()

    lap("with_text training")

    # the scene bank (no_text's conditions): banked batches bitwise the streamed ones
    ds_v = ProSimImitationDataset(get_config(os.path.join(root, TRAIN_YAML), src), "val", cache)
    t0 = time.perf_counter()
    bank = DeviceSceneBank(ds_v, device=device)
    build_s = time.perf_counter() - t0
    pairs = [(i, i) for i in range(DATA_SCENES)]
    t0 = time.perf_counter()
    banked = list(banked_batches(ds_v, pairs, B, bank=bank, device=device))
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    streamed = list(ds_v.batches(B, num_workers=1))
    for k, (a, b) in enumerate(zip(banked, streamed)):
        assert_batches_equal(torch, a, b, f"data: banked batch {k}")
    if len(banked) != len(streamed) or len(banked) != DATA_SCENES // B:
        raise AssertionError("data: banked and streamed batch counts differ")
    rec["bank"] = {"device_bytes": bank.bank_bytes, "per_scene_bytes": bank.per_scene_bytes,
                   "build_s": build_s, "batches_per_s": len(banked) / bank_s}
    log(f"data: scene bank of {DATA_SCENES} scenes on the card: {bank.bank_bytes / 2**20:.1f} "
        f"MiB ({bank.per_scene_bytes / 2**20:.2f} MiB a scene), built in {build_s:.1f} s; "
        f"{len(banked)} banked batches bitwise equal to the streamed ones "
        f"({len(banked) / bank_s:.2f} batches/s with conditions sampled on the host)")
    del bank, banked, streamed
    torch.cuda.empty_cache()
    lap("scene bank")
    return rec


def profile_train_step(torch, trainer, batch):
    """One more train step under torch.profiler: its wall time, the device
    time by kernel family and the busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer._train_step(batch, 0)["full_loss"])
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    by_fam, by_name, count = {}, {}, {}
    for e in device:
        ms = e.time_range.elapsed_us() / 1e3
        by_fam[family(e.name)] = by_fam.get(family(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        count[e.name] = count.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "busy_ms": sum(by_fam.values()), "launches": len(device),
            "families_ms": dict(sorted(by_fam.items(), key=lambda kv: -kv[1])),
            "top_kernels": [(n[:110], ms, count[n]) for n, ms in top]}


def demo_launches():
    """Each kernel's launches per forward of configs/waymo_demo.yaml as
    shipped (phase 5): the layer loop's, the condition GNN's layers through
    B2, and the f32 tiny() Llama's layers through B4."""
    from prosim_torch.config import get_config
    from prosim_torch.models.llm.llama import LlamaConfig

    want, _ = forward_launches()
    nlayer = get_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                     TEXT_YAML)).MODEL.CONDITION_TRANSFORMER.NLAYER
    return dict(want, edge_attn_core=want["edge_attn_core"] + nlayer,
                causal_attention=LlamaConfig.tiny().num_layers)


def reset_launches():
    for fn in kernel_fns().values():
        fn.launches = 0


def hf_llama_tensors(model):
    """{HF checkpoint name: tensor} of a LlamaModel's body (the layout
    load_hf_llama_params reads: no agent-token rows, no LoRA)."""
    c = model.cfg
    out = {"model.embed_tokens.weight": model.embed_tokens[: c.vocab_size],
           "model.norm.weight": model.final_norm.weight}
    for i in range(c.num_layers):
        b, p = getattr(model, f"layer_{i}"), f"model.layers.{i}"
        out[f"{p}.input_layernorm.weight"] = b.input_norm.weight
        out[f"{p}.post_attention_layernorm.weight"] = b.post_attn_norm.weight
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{p}.self_attn.{proj}.weight"] = getattr(b, proj).weight
        for proj in ("gate_proj", "up_proj", "down_proj"):
            out[f"{p}.mlp.{proj}.weight"] = getattr(b, proj).weight
    return out


def write_hf_shards(model, out_dir):
    """The model's body as HF-layout safetensors shards, one for the
    embedding and final norm and one per layer. Returns the bytes written."""
    from prosim_torch.utils.safetensors_io import save_file

    os.makedirs(out_dir, exist_ok=True)
    tensors = hf_llama_tensors(model)
    groups = [{k: v for k, v in tensors.items() if not k.startswith("model.layers.")}]
    groups += [{k: v for k, v in tensors.items() if k.startswith(f"model.layers.{i}.")}
               for i in range(model.cfg.num_layers)]
    total = 0
    for i, g in enumerate(groups):
        path = os.path.join(out_dir, f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors")
        save_file(g, path)
        total += os.path.getsize(path)
    return total


def peak_rss_during(fn):
    """(fn's result, its seconds, the process's peak resident host memory in
    GiB while it ran, sampled every 5 ms from /proc/self/statm, and the
    resident memory before it)."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    before = rss()
    peak, stop = [before], threading.Event()

    def watch():
        while not stop.wait(0.005):
            peak[0] = max(peak[0], rss())

    t = threading.Thread(target=watch)
    t.start()
    t0 = time.perf_counter()
    try:
        res = fn()
    finally:
        secs = time.perf_counter() - t0
        stop.set()
        t.join()
    return res, secs, max(peak[0], rss()) / 2**30, before / 2**30


def serve_phase(torch, root, want_d, device="cuda", opts=(), m=SERVE_M):
    """Phase 10: the serving entry points at the demo architecture's full
    width and padding (see the module docstring). Returns the phase's
    record; raises on a failed gate."""
    import dataclasses
    import glob
    import shutil

    import numpy as np

    from prosim_torch.config import get_config
    from prosim_torch.data import womd_ingest, womd_synth
    from prosim_torch.data.dataset import ProSimImitationDataset
    from prosim_torch.demo.api import InteractiveSim
    from prosim_torch.models.condition.transformer import load_text_llm_weights
    from prosim_torch.models.llm.llama import LlamaConfig, LlamaModel, load_hf_llama_params
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.ops.edge_attn import edge_attn_core_plain
    from prosim_torch.ops.flash_attn import causal_attention_plain
    from prosim_torch.ops.fused_stack import fused_two_site_stack_plain
    from prosim_torch.ops.neighbors import neighbor_topk_plain
    from prosim_torch.rollout import runner
    from prosim_torch.rollout.rollout import parallel_rollout
    from prosim_torch.rollout.wosac import (load_rollouts_npz, package_submission,
                                            validate_scenario_rollouts)
    from prosim_torch.train.trainer import Trainer
    from prosim_torch.utils.checkpoint_convert import load_reference_checkpoint
    from prosim_torch.utils.params import init_params

    sys.path.insert(0, os.path.join(root, "tests"))
    from torch_checkpoint_synth import reference_state_dict  # numpy and the port alone

    out = os.path.join(root, "build", "chip_smoke_serve")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    src = ["DATASET.SOURCE.TRAIN", f"['{DATA_ENV}']", "DATASET.SOURCE.VAL", f"['{DATA_ENV}']",
           "DATASET.SOURCE.ROLLOUT", f"['{DATA_ENV}']", *opts]
    yaml = os.path.join(root, TEXT_YAML)
    cfg = get_config(yaml, src)
    horizon = cfg.ROLLOUT.POLICY.MAX_STEPS
    rec = {"cut": f"synthetic WOMD scenes (no WOMD data in the repository): {SERVE_SCENES} "
                  f"scenes at phase 9's draw, {DATA_AGENTS[0]}-{DATA_AGENTS[1]} agents and "
                  f"{DATA_LANES[0]}-{DATA_LANES[1]} lanes a scene; random weights; the "
                  f"Llama3-8B-width shards {LLAMA8_LAYERS} of 32 layers deep",
           "m": m, "section_s": {}}
    log(f"serve: CUT: {rec['cut']}")
    last = [time.perf_counter()]

    def lap(section):
        now = time.perf_counter()
        rec["section_s"][section] = now - last[0]
        log(f"serve: {section}: {now - last[0]:.1f} s")
        last[0] = now

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    shards = womd_synth.synthesize_shards(os.path.join(out, "shards"), SERVE_SCENES, 2, seed=1,
                                          agents=DATA_AGENTS, lanes=DATA_LANES)
    cache = os.path.join(out, "cache")
    womd_ingest.ingest_shards(shards, cache, DATA_ENV)
    lap("synthetic cache")

    # 1. a reference (Lightning) checkpoint of the demo architecture at full
    # width, converted strictly
    sd = reference_state_dict(cfg, seed=0)
    ckpt = os.path.join(out, "reference.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    t0 = time.perf_counter()
    state, unmapped = load_reference_checkpoint(ckpt, strict=True)
    rec["reference_ckpt"] = {"keys": len(sd), "converted_leaves": len(state),
                             "mb": os.path.getsize(ckpt) / 1e6,
                             "convert_s": time.perf_counter() - t0}
    if unmapped:
        raise AssertionError(f"serve: {len(unmapped)} reference keys unmapped: {unmapped[:5]}")
    log(f"serve: reference checkpoint {rec['reference_ckpt']}")

    # 2. the demo API on the card: the converted checkpoint, controls, rollouts
    sim = InteractiveSim(cfg, cache, device=device)
    sim.load_scene(0)
    unloaded = sim.load_checkpoint(ckpt)
    if unloaded:
        raise AssertionError(f"serve: converted leaves the model lacks: {unloaded[:5]}")
    own = sim.model.state_dict()
    bad = [k for k, v in state.items() if not torch.equal(own[k].cpu(), torch.from_numpy(v))]
    rest = [k for k in own if k not in state and not (".llm." in k and "lora" not in k)]
    if bad or rest:
        raise AssertionError(f"serve: leaves not loaded {bad[:5]}; parameters the checkpoint "
                             f"did not cover (beyond the Llama body) {rest[:5]}")
    sim.rollout()  # warm-up
    reset_launches()
    t0 = time.perf_counter()
    out1 = sim.rollout()
    sync()
    rec["demo_rollout_ms"] = 1e3 * (time.perf_counter() - t0)
    rec["demo_launches"] = launch_counts()
    if rec["demo_launches"] != want_d:
        raise AssertionError(f"serve: demo launches {rec['demo_launches']} != {want_d}")
    mask = sim.batch.prompt.mask[0]
    agents = [int(i) for i in torch.nonzero(mask)[:3, 0]]
    sim.set_goal(agents[0], (20.0, 2.0))
    sim.set_drag_points(agents[1], [(3.0, 0.0), (8.0, 1.0), (14.0, 3.0)])
    sim.set_action_tag(agents[2], "Stopping")
    sim.set_text("slows down and yields", agents=[agents[0], agents[2]])
    out2 = sim.rollout()
    for o in (out1, out2):
        if not bool(torch.isfinite(o["rollout_traj"][0][mask]).all()):
            raise AssertionError("serve: a demo rollout has non-finite values")
    moved = float((out2["rollout_traj"] - out1["rollout_traj"])[0][mask].abs().max())
    if not moved > 0:
        raise AssertionError("serve: the controls did not change the rollout")
    rep = [sim.rollout(torch.Generator(device=device).manual_seed(7))["rollout_traj"]
           for _ in range(2)]
    if not torch.equal(rep[0], rep[1]):
        raise AssertionError("serve: two demo rollouts from one generator seed differ")
    rec["demo_controls_moved_m"] = moved
    log(f"serve: demo: checkpoint loaded ({len(state)} leaves), B=1 rollout "
        f"{rec['demo_rollout_ms']:.1f} ms, launches {rec['demo_launches']}; controls moved the "
        f"rollout by up to {moved:.3f} m; same seed bitwise equal")
    lap("reference checkpoint and demo")

    # 3. the farm through the request path: a trainer's checkpoint and
    # request, served at M joint futures a scene
    cfg_farm = get_config(yaml, src + ["EXPERIMENT_DIR", out, "EXPERIMENT_NAME", "farm",
                                       "ROLLOUT_REQUEST_PATH", os.path.join(out, "requests")])
    trainer = Trainer(cfg_farm, device=device)
    trainer.setup()
    with open(trainer.submit_rollout_request(0)) as f:
        req = json.load(f)
    del trainer
    reset_launches()
    t0 = time.perf_counter()
    served = runner.serve_rollout_requests(cfg_farm, cache, once=True, m=m,
                                           max_scenes=SERVE_SCENES, max_failures=0, device=device)
    sync()
    farm_s = time.perf_counter() - t0
    launches = launch_counts()
    want_farm = {k: v * SERVE_SCENES for k, v in want_d.items()}
    if served != 1 or launches != want_farm:
        raise AssertionError(f"serve: {served} requests served, launches {launches} != "
                             f"{want_farm}")
    farm_dir = os.path.join(req["exp_folder"], "rollouts_ep0")
    files = sorted(glob.glob(os.path.join(farm_dir, "*.npz")))
    if len(files) != SERVE_SCENES:
        raise AssertionError(f"serve: {len(files)} npz files for {SERVE_SCENES} scenes")
    scored = []  # agents a scene
    for path in files:
        sr = load_rollouts_npz(path)
        validate_scenario_rollouts(sr, num_rollouts=m, steps=horizon)
        scored.append(len(sr.joint_scenes[0].object_ids))
    with open(os.path.join(farm_dir, "wosac_metrics.json")) as f:
        realism = json.load(f)
    if not realism or not all(np.isfinite(v) for v in realism.values()):
        raise AssertionError(f"serve: wosac_metrics.json {realism}")
    with open(package_submission(farm_dir, os.path.join(out, "submission"))) as f:
        if json.load(f)["num_scenarios"] != SERVE_SCENES:
            raise AssertionError("serve: the submission manifest misses scenes")
    with open(os.path.join(farm_dir, "timing_w0.json")) as f:
        timing = json.load(f)
    per = {k: [t[k] for t in timing] for k in timing[0] if k.endswith("_ms")}
    rec["farm"] = {"scenes": SERVE_SCENES, "seconds": farm_s,
                   "scenes_per_s": SERVE_SCENES / farm_s, "launches": launches,
                   "agents_per_scene": scored,
                   "per_scene_ms": {k: {"median": float(np.median(v)), "max": max(v)}
                                    for k, v in per.items()},
                   "realism": realism}
    log(f"serve: farm: {SERVE_SCENES} scenes ({min(scored)}-{max(scored)} agents scored, "
        f"median {float(np.median(scored)):.1f}) at M={m} in {farm_s:.2f} s "
        f"({rec['farm']['scenes_per_s']:.3f} scenes/s, the checkpoint restore included); "
        "per scene host ms (median / max): " + ", ".join(
            f"{k} {v['median']:.1f} / {v['max']:.1f}" for k, v in rec["farm"]["per_scene_ms"].items())
        + f"; launches {launches}; realism {({k: round(v, 4) for k, v in realism.items() if '/' not in k})}")
    lap("farm (request path, W=1)")

    # two workers, run one after the other, write the W=1 files bit for bit
    model = runner.restore_eval_params(cfg_farm, req["ckpt_path"], device=device)
    w2 = os.path.join(out, "rollouts_w2")
    for w in (0, 1):
        runner.run_rollout_eval(cfg_farm, cache, out_dir=w2, worker_id=w, num_workers=2, m=m,
                                model=model, compute_metrics=False, max_failures=0)
    names = [os.path.basename(p) for p in files]
    if sorted(os.path.basename(p) for p in glob.glob(os.path.join(w2, "*.npz"))) != names:
        raise AssertionError("serve: the W=2 run wrote other files")
    for name in names:
        a, b = np.load(os.path.join(farm_dir, name)), np.load(os.path.join(w2, name))
        if any(not np.array_equal(a[k], b[k]) for k in a.files):
            raise AssertionError(f"serve: {name} differs between W=1 and W=2")
    lap("farm W=2")

    # one scene's kernel path against its plain path (TOP_K=1, no sampler),
    # and its device time under the profiler
    batch = ProSimImitationDataset(cfg_farm, "rollout", cache).get_scene_batch(0, device=device)

    def roll():
        gen = torch.Generator(device=device).manual_seed(runner.scene_seed(cfg.SEED, 0))
        return parallel_rollout(model, batch, m, generator=gen)

    k_out = roll()
    with kernel_calls(neighbor_topk_plain, edge_attn_core_plain, fused_two_site_stack_plain,
                      causal_attention_plain, table_fn=rel_pe_table_chain):
        p_out = roll()
    valid = batch.prompt.mask[0]
    err = float((k_out["rollout_traj"] - p_out["rollout_traj"])[:, valid][..., :2].abs().max())
    log(f"serve: farm scene 0 at M={m}: kernel path vs plain path max |dxy| {err:.3e} m")
    if not err <= PARITY_TOL_M:
        raise AssertionError(f"serve: farm kernel path {err} m from its plain path")
    rec["farm"]["parity_m"] = err
    if device == "cuda":
        wall_ms, busy_ms, _, _ = device_busy(torch, roll)
        rec["farm"]["scene_rollout"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms}
        log(f"serve: farm scene rollout (B={m}, profiled): wall {wall_ms:.1f} ms, device busy "
            f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    del model, k_out, p_out
    lap("farm parity and profile")

    # 4. the CLI as child processes: a rollout of SERVE_SCENES/4 scenes at
    # M=4, and data_debug
    cli = os.path.join(out, "cli")
    over = src + ["EXPERIMENT_DIR", cli, "ROLLOUT.SAMPLE_NUM", "4",
                  "DATASET.SCENE.SAMPLE_RATE.ROLLOUT", "4", "TRAIN.BATCH_SIZE", "4"]
    base = [sys.executable, "-m", "prosim_torch.main", "--exp-config", yaml,
            "--cache-dir", cache, "--device", device]
    procs = {rt: subprocess.Popen(base + ["--run-type", rt] + over, cwd=root, text=True,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rt in ("rollout", "data_debug")}
    logs = {}
    try:
        for rt, p in procs.items():
            logs[rt] = p.communicate(timeout=300)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = {rt: p.returncode for rt, p in procs.items()}
    cli_npz = glob.glob(os.path.join(cli, cfg.EXPERIMENT_NAME, "rollouts", "*.npz"))
    batches = [l for l in logs["data_debug"].splitlines() if l.startswith("batch ")]
    rec["cli"] = {"rcs": rcs, "rollout_npz": len(cli_npz), "data_debug_batches": len(batches)}
    log(f"serve: CLI: {rec['cli']}")
    if rcs != {"rollout": 0, "data_debug": 0} or len(cli_npz) != SERVE_SCENES // 4 or \
            len(batches) != SERVE_SCENES // 4:
        for rt, text in logs.items():
            log(f"--- {rt} ---\n{text[-4000:]}")
        raise AssertionError(f"serve: CLI children {rec['cli']}")
    lap("CLI")

    # 5. the HF Llama loader at Llama3-8B width (depth cut), bf16 shards
    # written from a model drawn on the card
    c8 = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=LLAMA8_LAYERS)
    with torch.device(device):
        src8 = LlamaModel(c8)
    src8.init_weights(3)
    shard_dir = os.path.join(out, "llama3_8b_width")
    t0 = time.perf_counter()
    nbytes = write_hf_shards(src8, shard_dir)
    write_s = time.perf_counter() - t0
    with torch.device(device):
        dst = LlamaModel(c8)
    dst.init_weights(4)
    _, load_s, rss_gib, rss0 = peak_rss_during(lambda: load_hf_llama_params(shard_dir, dst))
    sync()
    V = c8.vocab_size
    want = hf_llama_tensors(src8)
    got = hf_llama_tensors(dst)
    diff = [k for k in want if not torch.equal(got[k], want[k])]
    mean = src8.embed_tokens[:V].float().mean(0).to(c8.dtype)
    rows_ok = bool((dst.embed_tokens[V:] == mean).all())
    zero_b = all(float(p.detach().abs().max()) == 0 for n, p in dst.named_parameters()
                 if n.endswith(("lora_b", "lora_embed_b")))
    rec["llama8b_load"] = {"layers": LLAMA8_LAYERS, "shard_gb": nbytes / 1e9,
                           "write_s": write_s, "load_s": load_s, "peak_rss_gib": rss_gib,
                           "rss_before_gib": rss0,
                           "load_gb_per_s": nbytes / 1e9 / load_s}
    log(f"serve: Llama3-8B width, {LLAMA8_LAYERS} layers (CUT from 32): {nbytes / 1e9:.2f} GB "
        f"of bf16 shards written in {write_s:.1f} s, loaded onto the card in {load_s:.2f} s "
        f"({nbytes / 1e9 / load_s:.2f} GB/s), peak host RSS {rss_gib:.2f} GiB ({rss0:.2f} "
        "before the load)")
    if diff or not rows_ok or not zero_b:
        raise AssertionError(f"serve: 8B-width load: leaves differ {diff[:5]}, agent rows "
                             f"{rows_ok}, lora_b zero {zero_b}")
    del src8, dst, want, got
    shutil.rmtree(shard_dir)
    if device == "cuda":
        torch.cuda.empty_cache()
    lap("Llama loader at 8B width")

    # waymo_demo with TEXT.LLM.WEIGHTS_PATH (tiny f32 shards) through ProSim,
    # one conditioned rollout through B4's f32 path
    lc = LlamaConfig.tiny(lora_rank=cfg.MODEL.CONDITION_TRANSFORMER.TEXT_ATTN.LORA.R)
    with torch.device(device):
        src_t = LlamaModel(lc)
    src_t.init_weights(5)
    tiny_dir = os.path.join(out, "llama_tiny")
    write_hf_shards(src_t, tiny_dir)
    llm_opts = "MODEL.CONDITION_TRANSFORMER.CONDITION_ENCODER.TEXT.LLM."
    cfg_w = get_config(yaml, src + [llm_opts + "ARCH", "tiny", llm_opts + "WEIGHTS_PATH", tiny_dir])
    model_w = ProSim(cfg_w, device=device)
    init_params(model_w, 0)
    load_text_llm_weights(cfg_w, model_w)
    llm = model_w.condition_transformer_policy_decoder.text_attn.llm
    want, got = hf_llama_tensors(src_t), hf_llama_tensors(llm)
    if any(not torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("serve: WEIGHTS_PATH did not load the shards into ProSim's Llama")
    reset_launches()
    out_w = model_w(sim.batch)
    sync()
    lw = launch_counts()
    if lw["causal_attention"] != lc.num_layers or not bool(
            torch.isfinite(out_w["rollout_traj"][0][mask]).all()):
        raise AssertionError(f"serve: WEIGHTS_PATH rollout launches {lw} or non-finite")
    rec["weights_path_launches"] = lw
    log(f"serve: WEIGHTS_PATH (tiny, f32 shards) through ProSim: loaded; conditioned rollout "
        f"launches {lw}")
    lap("WEIGHTS_PATH through ProSim")
    return rec


def _train_record(torch, trainer, steps):
    """(step ms between consecutive logged steps, finite-terms failures,
    the last step's terms) from a trainer's JSONL log."""
    import numpy as np

    recs = [r for r in map(json.loads, open(trainer.log_path)) if "train/full_loss" in r]
    walls = [r["wall"] for r in recs]
    if len(recs) != steps:
        raise AssertionError(f"train: {len(recs)} logged steps, expected {steps}")
    bad = [(r["step"], k) for r in recs for k, v in r.items()
           if k.startswith("train/") and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"train: non-finite loss terms {bad}")
    return ([1e3 * (b - a) for a, b in zip(walls, walls[1:])],
            {k: v for k, v in recs[-1].items() if k.startswith("train/")})


def bf16_fit(torch, cfg, B, shape, steps, device, seed0=10):
    """A bf16-body model (ProSim(cfg, device, dtype=bf16)) through
    Trainer.setup and Trainer.fit for `steps` steps of synthetic batches of
    B scenes; running out of device memory fails the phase. Returns
    (trainer, batches, start parameters, launches, peak bytes)."""
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.train.trainer import Trainer

    trainer = Trainer(cfg, model=ProSim(cfg, device=device, dtype=torch.bfloat16), device=device)
    trainer.setup()
    batches = [make_synthetic_batch(cfg, batch_size=B, seed=seed0 + i, device=device, **shape)
               for i in range(steps)]
    p0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    trainer.fit(batches, max_steps=steps)
    torch.cuda.synchronize()
    return trainer, batches, p0, launch_counts(), torch.cuda.max_memory_allocated()


def bf16_grad_gate(torch, cfg, model16, shape, device, label):
    """Phase 11 (c): at B=2 and one replan step, the bf16 train step's f32
    gradients with the kernels against the same step with their plain
    versions. Direct gate: each leaf within GRAD_DIRECT_TOL of the plain
    step's largest plus twice the distance between two plain steps (the
    bf16 gather backward's atomics need not repeat), the loss likewise.
    Second check: each leaf by BF16_RULE's 2x rule against the step of an
    f32 copy of the model with the plain versions (plus 1e-5 of the leaf's
    largest f32 gradient). Returns the record."""
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.ops.edge_attn import edge_attn_core_plain
    from prosim_torch.ops.flash_attn import causal_attention_plain
    from prosim_torch.ops.fused_stack import fused_two_site_stack_plain
    from prosim_torch.ops.neighbors import neighbor_topk_plain
    from prosim_torch.train.losses import paired_mse_k

    small = make_synthetic_batch(cfg, batch_size=2, seed=1, device=device,
                                 **dict(shape, num_replan=1))
    m32 = ProSim(cfg, device=device)
    m32.load_state_dict(model16.state_dict())
    for p32, p16 in zip(m32.parameters(), model16.parameters()):
        p32.requires_grad_(p16.requires_grad)

    def grad_step(model):
        model.zero_grad(set_to_none=True)
        out = model.forward_train(small, seed=7)
        if out["motion_pred"].dtype != model.dtype:
            raise AssertionError(f"{label}: the {model.dtype} body gave {out['motion_pred'].dtype}")
        loss = paired_mse_k(small, out, cfg)["full_loss"]
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().float().clone()
                                      for n, p in model.named_parameters() if p.grad is not None}

    reset_launches()
    loss_k, g_k = grad_step(model16)
    kernel_launches = launch_counts()
    plain = (neighbor_topk_plain, edge_attn_core_plain, fused_two_site_stack_plain,
             causal_attention_plain)
    with kernel_calls(*plain, table_fn=rel_pe_table_chain):
        loss_p, g_p = grad_step(model16)
        loss_p2, g_p2 = grad_step(model16)
        loss_32, g_32 = grad_step(m32)
    if launch_counts() != kernel_launches:
        raise AssertionError(f"{label}: the plain path launched a kernel")
    model16.zero_grad(set_to_none=True)
    del m32
    direct = (-1.0, None, 0.0, 0.0)  # (share of the bar, leaf, kernel vs plain, plain repeat)
    for n, g in g_p.items():
        scale = max(float(g.abs().max()), 1e-30)
        err = float((g_k[n] - g).abs().max()) / scale
        spread = float((g_p2[n] - g).abs().max()) / scale
        share = err / (2 * spread + GRAD_DIRECT_TOL)
        if share > direct[0]:
            direct = (share, n, err, spread)
    loss_bar = 2 * abs(loss_p2 - loss_p) + GRAD_DIRECT_TOL * abs(loss_p)
    log(f"{label} (B=2, R=1), direct: kernel vs plain bf16 step, worst leaf {direct[1]}: "
        f"{direct[2]:.3e} of its max, two plain steps {direct[3]:.3e} ({direct[0]:.3f} of the "
        f"bar); loss {loss_k:.8g} vs {loss_p:.8g}, repeat {loss_p2:.8g}")
    if set(g_k) != set(g_p) or direct[0] > 1.0 or abs(loss_k - loss_p) > loss_bar:
        raise AssertionError(f"{label}: the bf16 kernel step is not the plain bf16 step: "
                             f"{direct}, loss {loss_k} vs {loss_p} (bar {loss_bar})")
    worst = (0.0, None, 0.0, 0.0)
    for n, g in g_32.items():
        scale = max(float(g.abs().max()), 1e-30)
        err_k = float((g_k[n] - g).abs().max()) / scale
        err_p = float((g_p[n] - g).abs().max()) / scale
        ratio = err_k / (BF16_RULE[0] * err_p + 1e-5)
        if ratio > worst[0]:
            worst = (ratio, n, err_k, err_p)
    loss_rule = BF16_RULE[0] * abs(loss_p - loss_32) + 1e-5 * abs(loss_32)
    log(f"{label} (B=2, R=1): kernel launches {kernel_launches}; loss kernel {loss_k:.8g}, "
        f"plain bf16 {loss_p:.8g}, plain f32 {loss_32:.8g}; worst gradient leaf {worst[1]}: "
        f"{worst[2]:.3e} of its max against the plain bf16 path's {worst[3]:.3e} "
        f"({worst[0]:.3f} of the 2x bar)")
    if set(g_k) != set(g_32) or worst[0] > 1.0 or abs(loss_k - loss_32) > loss_rule:
        raise AssertionError(f"{label}: the bf16 kernel step fails the 2x rule: {worst}, loss "
                             f"{loss_k} vs {loss_32} (bar {loss_rule})")
    if not kernel_launches["neighbor_topk"]:
        raise AssertionError(f"{label}: the kernel step launched no B1")
    return {"loss": [loss_k, loss_p, loss_32], "loss_plain_repeat": loss_p2,
            "direct_worst_leaf": direct[1], "direct_share_of_bar": direct[0],
            "direct_err": direct[2], "plain_repeat_err": direct[3], "worst_leaf": worst[1],
            "worst_ratio_of_bar": worst[0], "kernel_err": worst[2], "plain_bf16_err": worst[3],
            "kernel_launches": kernel_launches}


def bf16_train_phase(torch, root, shape, device="cuda"):
    """Phase 11: bf16 training (see the module docstring). Returns the
    phase's record; raises on a failed gate."""
    import shutil

    import numpy as np

    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.train.trainer import Trainer
    from prosim_torch.utils.params import init_params

    build = os.path.join(root, "build")
    t0 = time.perf_counter()
    rec = {}
    topk_per_step, text_per_step = train_launches()

    # (a) configs/no_text.yaml, the body in bf16, as phase 7
    name = "chip_smoke_train_bf16"
    shutil.rmtree(os.path.join(build, name), ignore_errors=True)
    cfg = get_config(os.path.join(root, TRAIN_YAML), [
        "EXPERIMENT_DIR", build, "EXPERIMENT_NAME", name,
        "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.REMAT_POLICY", "full"])
    B = cfg.TRAIN.BATCH_SIZE
    trainer, batches, p0, launches, peak = bf16_fit(torch, cfg, B, shape, TRAIN_STEPS, device)
    step_ms, terms = _train_record(torch, trainer, TRAIN_STEPS)
    moved = max(float((p.detach() - p0[n]).abs().max())
                for n, p in trainer.model.named_parameters())
    if {p.dtype for p in trainer.model.parameters()} != {torch.float32} or trainer.model.dtype \
            != torch.bfloat16:
        raise AssertionError("train bf16: the model is not a bf16 body on f32 parameters")
    if moved == 0.0:
        raise AssertionError("train bf16: no parameter moved")
    if launches["neighbor_topk"] != TRAIN_STEPS * topk_per_step:
        raise AssertionError(f"train bf16: neighbor_topk launched {launches['neighbor_topk']} "
                             f"times, expected {TRAIN_STEPS * topk_per_step}")
    if launches["edge_attn_core"] or launches["fused_two_site_stack"]:
        raise AssertionError(f"train bf16: a forward-only kernel ran in training: {launches}")
    log(f"train bf16: fit {time.perf_counter() - t0:.1f} s")
    prof = profile_train_step(torch, trainer, batches[0])
    log(f"train bf16: {TRAIN_YAML} B={B} steps {TRAIN_STEPS}: step ms (synchronised host clock) "
        f"{['%.1f' % t for t in step_ms]}, median {sorted(step_ms)[len(step_ms) // 2]:.1f}; "
        f"peak memory {peak / 2**30:.2f} GiB; B1 launches per step "
        f"{launches['neighbor_topk'] / TRAIN_STEPS:g}; profiled step: wall {prof['wall_ms']:.1f} "
        f"ms, device busy {prof['busy_ms']:.1f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), {prof['launches']} device operations")
    for fam, ms in prof["families_ms"].items():
        log(f"  {fam:22s} {ms:10.3f} ms  {100 * ms / prof['busy_ms']:5.1f} %")
    for kname, ms, n in prof["top_kernels"]:
        log(f"    {ms:9.3f} ms x{n:<6d} {kname}")
    rec["no_text"] = {"config": TRAIN_YAML, "batch_size": B, "steps": TRAIN_STEPS,
                      "step_ms": step_ms, "peak_memory_bytes": peak, "launches": launches,
                      "neighbor_topk_per_step": launches["neighbor_topk"] / TRAIN_STEPS,
                      "terms": terms, "profile": prof}
    del batches
    torch.cuda.empty_cache()
    # the validation rollout in bf16: evaluate and rollout_callback (M=4)
    # through B1 and B2's bf16 kernel, and with FUSED_STACK through B3's
    small = make_synthetic_batch(cfg, batch_size=2, seed=1, device=device, **shape)
    reset_launches()
    ev = trainer.evaluate([small])
    roll = trainer.rollout_callback([small], m=4)
    ev_launches = launch_counts()
    cfg_f = get_config(os.path.join(root, TRAIN_YAML), [
        "EXPERIMENT_DIR", build, "EXPERIMENT_NAME", name + "_fused",
        "MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"])
    fused = Trainer(cfg_f, model=ProSim(cfg_f, device=device, dtype=torch.bfloat16),
                    device=device)
    fused.model.load_state_dict(trainer.model.state_dict())
    reset_launches()
    roll_f = fused.rollout_callback([small], m=4)
    torch.cuda.synchronize()
    ev_launches_f = launch_counts()
    log(f"train bf16 eval (B=2): evaluate {ev}; rollout_callback M=4 {roll}, launches "
        f"{ev_launches}; FUSED_STACK {roll_f}, launches {ev_launches_f}")
    if not all(np.isfinite(v) for v in [*ev.values(), *roll.values(), *roll_f.values()]):
        raise AssertionError("train bf16: evaluate or rollout_callback gave a non-finite metric")
    if not (ev_launches["edge_attn_core"] and ev_launches_f["fused_two_site_stack"]):
        raise AssertionError("train bf16: the validation rollout ran no B2 or no B3")
    rec["no_text"].update(eval=ev, rollout=roll, rollout_fused=roll_f,
                          eval_launches=ev_launches, eval_launches_fused=ev_launches_f)
    log(f"train bf16: profile and the validation rollouts {time.perf_counter() - t0:.1f} s")
    del fused
    rec["grad_gate_no_text"] = bf16_grad_gate(torch, cfg, trainer.model, shape, device,
                                              "train bf16 gradient gate, no_text")
    log(f"== phase 11 (a), (c): {time.perf_counter() - t0:.1f} s")
    del trainer
    torch.cuda.empty_cache()

    # (b) bench.py --mode train's defaults (bench.py:261-321): B=64, the body
    # in bf16, every condition type (the text one through the tiny() Llama),
    # synthetic batches at the demo padding, 8 replan steps
    t1 = time.perf_counter()
    name = "chip_smoke_bench_train"
    shutil.rmtree(os.path.join(build, name), ignore_errors=True)
    cfg_b = get_config(opts=[
        "DATASET.FORMAT.PAD.NUM_LANES", str(LANES),
        "DATASET.FORMAT.PAD.NUM_OBS_AGENTS", str(OBS_AGENTS),
        "DATASET.FORMAT.PAD.NUM_AGENTS", str(AGENTS),
        "MODEL.DTYPE", "bfloat16",
        "PROMPT.CONDITION.TYPES", repr(BENCH_CONDITIONS),
        "PROMPT.CONDITION.SAMPLE_MODE.TRAIN", "fix", "PROMPT.CONDITION.SAMPLE_MODE.VAL", "fix",
        "PROMPT.CONDITION.RANDOM_SAMPLE.TRAIN", "True", "PROMPT.CONDITION.SAMPLE_RATE", "1.0",
        "EXPERIMENT_DIR", build, "EXPERIMENT_NAME", name, "SAVE_CHECKPOINT", "False"])
    Bb = BENCH_TRAIN_B
    trainer, batches, _, launches_b, peak_b = bf16_fit(torch, cfg_b, Bb, shape,
                                                      BENCH_TRAIN_STEPS, device)
    step_ms_b, terms_b = _train_record(torch, trainer, BENCH_TRAIN_STEPS)
    want_b = {k: BENCH_TRAIN_STEPS * v for k, v in text_per_step.items()}
    got_b = {k: launches_b[k] for k in want_b}
    med = sorted(step_ms_b)[len(step_ms_b) // 2]
    log(f"bench train (bf16, conditions {BENCH_CONDITIONS}): B={Bb} steps {BENCH_TRAIN_STEPS}: "
        f"step ms {['%.1f' % t for t in step_ms_b]}, median {med:.1f} = "
        f"{1e3 * Bb / med:.3f} train scenes/s; peak memory {peak_b / 2**30:.2f} GiB; launches "
        f"{launches_b} ({ {k: v / BENCH_TRAIN_STEPS for k, v in got_b.items()} } B4 a step); "
        f"grad norm {terms_b.get('train/grad_norm')}")
    if got_b != want_b or launches_b["neighbor_topk"] != BENCH_TRAIN_STEPS * topk_per_step:
        raise AssertionError(f"bench train: launches {launches_b}, expected B4 {want_b} and "
                             f"B1 {BENCH_TRAIN_STEPS * topk_per_step}")
    if launches_b["edge_attn_core"] or launches_b["fused_two_site_stack"]:
        raise AssertionError(f"bench train: a forward-only kernel ran in training: {launches_b}")
    rec["bench_train"] = {"batch_size": Bb, "conditions": BENCH_CONDITIONS, "steps": BENCH_TRAIN_STEPS,
                          "step_ms": step_ms_b, "train_scenes_per_s": 1e3 * Bb / med,
                          "peak_memory_bytes": peak_b, "launches": launches_b,
                          "b4_per_step": {k: v / BENCH_TRAIN_STEPS for k, v in got_b.items()},
                          "terms": terms_b}
    del batches
    torch.cuda.empty_cache()
    rec["grad_gate_bench"] = bf16_grad_gate(torch, cfg_b, trainer.model, shape, device,
                                            "bench train gradient gate")
    log(f"== phase 11 (b), (c): {time.perf_counter() - t1:.1f} s")
    del trainer
    torch.cuda.empty_cache()

    # (d) data-parallel on NCCL at world size 1, in a process of its own
    t2 = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--dp-child"], cwd=root)
    if child.returncode != 0:
        raise RuntimeError(f"phase 11 (d) (chip_smoke.py --dp-child) exited {child.returncode}")
    with open(os.path.join(root, "chiprun_out", "chip_smoke_dp.json")) as f:
        rec["data_parallel"] = json.load(f)
    log(f"== phase 11 (d): {time.perf_counter() - t2:.1f} s")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def dp_child(torch, root, device="cuda"):
    """Phase 11 (d), in a process of its own: configs/no_text.yaml with the
    body in bf16, one Trainer.fit step on DP_B scenes at full width, twice
    in one process without a process group, then once as rank 0 of an NCCL
    group of one through the data-parallel path (global counts, the
    gradients' all-reduce, the losses' sum). Gates: the data-parallel
    step's loss, gradients and parameters within 2x the spread of the two
    one-process steps plus 1e-6 (each leaf relative to its largest), and
    the collectives ran. Returns the record."""
    import datetime
    import shutil
    import socket

    import torch.distributed as dist

    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.parallel import mesh as pm
    from prosim_torch.train.trainer import Trainer

    build = os.path.join(root, "build")
    shape = dict(num_lanes=LANES, num_obs_agents=OBS_AGENTS, num_agents=AGENTS, num_replan=REPLAN)

    def one_step(tag):
        name = f"chip_smoke_dp_{tag}"
        shutil.rmtree(os.path.join(build, name), ignore_errors=True)
        cfg = get_config(os.path.join(root, TRAIN_YAML), [
            "EXPERIMENT_DIR", build, "EXPERIMENT_NAME", name, "SAVE_CHECKPOINT", "False",
            "TRAIN.SCHEDULER.WARMUP_STEPS", "0", "TRAIN.REMAT_POLICY", "full"])
        trainer = Trainer(cfg, model=ProSim(cfg, device=device, dtype=torch.bfloat16),
                          device=device)
        trainer.setup()
        batch = make_synthetic_batch(cfg, batch_size=DP_B, seed=20, device=device, **shape)
        t = time.perf_counter()
        trainer.fit([batch], max_steps=1)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        loss = [r for r in map(json.loads, open(trainer.log_path)) if "train/full_loss" in r]
        out = (loss[-1]["train/full_loss"],
               {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()
                if p.grad is not None},
               {n: p.detach().clone() for n, p in trainer.model.named_parameters()}, ms,
               pm.data_parallel(trainer.mesh))
        del trainer
        return out

    def leaf_err(a, b):
        return max(float((a[n] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                   for n, v in b.items())

    s1, s2 = one_step("single_1"), one_step("single_2")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    calls = {"all_reduce": 0}
    all_reduce = dist.all_reduce

    def counted(*a, **k):
        calls["all_reduce"] += 1
        return all_reduce(*a, **k)

    dist.all_reduce = counted
    world = pm.initialize_multihost(f"127.0.0.1:{port}", 1, 0, device=device,
                                    timeout=datetime.timedelta(seconds=60))
    try:
        backend = dist.get_backend()
        dp = one_step("nccl")
    finally:
        dist.destroy_process_group()
        dist.all_reduce = all_reduce
    spread = {"loss": abs(s2[0] - s1[0]) / abs(s1[0]), "grads": leaf_err(s2[1], s1[1]),
              "params": leaf_err(s2[2], s1[2])}
    err = {"loss": abs(dp[0] - s1[0]) / abs(s1[0]), "grads": leaf_err(dp[1], s1[1]),
           "params": leaf_err(dp[2], s1[2])}
    log(f"data-parallel (NCCL, world size {world}, backend {backend}, B={DP_B}): "
        f"{calls['all_reduce']} all-reduces; step ms one-process {s1[3]:.1f}, {s2[3]:.1f}, "
        f"data-parallel {dp[3]:.1f}; data-parallel vs one-process {err}; two one-process "
        f"steps {spread}")
    if not dp[4] or s1[4] or world != 1 or backend != "nccl" or not calls["all_reduce"]:
        raise AssertionError(f"data-parallel: the path did not run on NCCL: world {world}, "
                             f"backend {backend}, {calls}")
    bad = {k: (err[k], spread[k]) for k in err if err[k] > 2 * spread[k] + 1e-6}
    if bad:
        raise AssertionError(f"data-parallel step outside the one-process spread: {bad}")
    return {"world_size": world, "backend": backend, "batch_size": DP_B,
            "all_reduces": calls["all_reduce"], "err": err, "spread": spread,
            "step_ms": {"single": [s1[3], s2[3]], "data_parallel": dp[3]}}


MODES_K = 6  # phase 12's cluster goals (TRAJ.K)
MODES_TRAIN_B = 4  # phase 12's bf16 train step
QA_B, QA_LEN = 4, 128  # phase 12 (c): QA probe scenes and tokens a scene


def modes_configs(goals_path):
    """Phase 12's models: {label: options over get_config()'s defaults}."""
    cluster = ["MODEL.POLICY.ACT_DECODER.TRAJ.PRED_MODE", "cluster",
               "MODEL.POLICY.ACT_DECODER.TRAJ.CLUSTER_PATH", goals_path,
               "MODEL.POLICY.ACT_DECODER.TRAJ.K", str(MODES_K),
               "MODEL.POLICY.ACT_DECODER.CONTEXT.GOAL", "True",
               "MODEL.POLICY.ACT_DECODER.CONTEXT.USE_POSE_EMB", "True"]
    return {
        "enc-mlp": ["MODEL.SCENE_ENCODER.MAP_TYPE", "mlp", "MODEL.SCENE_ENCODER.OBS_TYPE", "mlp",
                    "MODEL.MAP_ENCODER.MLP.POOL", "max", "MODEL.OBS_ENCODER.MLP.POOL", "max"],
        "obs-update": ["MODEL.OBS_UPDATE.FUSION", "mlp", "MODEL.OBS_UPDATE.ATTN_UPDATE", "True"],
        "goal-cluster": cluster,
        "goal-cluster fused": cluster + ["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"],
    }


# the parameters each phase-12 model adds, which its train step must move
MODES_NEW_PARAMS = {
    "enc-mlp": ("scene_encoder.map_encoder.lane_encode.", "scene_encoder.map_encoder.type_embedding.",
                "scene_encoder.map_encoder.traf_embedding.", "scene_encoder.obs_encoder.hist_encoder."),
    "obs-update": ("scene_encoder.obs_update_mlp.",),
    "goal-cluster": ("policy.goal_encoder.", "policy.context_fuse.", "policy.cluster_mlp."),
    "goal-cluster fused": ("policy.goal_encoder.", "policy.context_fuse.", "policy.cluster_mlp."),
}


def modes_launches(cfg):
    """Each kernel's launches per forward of a phase-12 model: phase 4's
    layer loop or fused loop, plus, with ATTN_UPDATE, each update_obs call's
    (one per replan step after the first) two graphs through B1 and its
    2 x NUM_LAYER re-attention layers through B2, and its two rel-PE tables."""
    want, want_f = forward_launches()
    w = dict(want_f if cfg.MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK else want)
    if cfg.MODEL.OBS_UPDATE.ATTN_UPDATE:
        w["neighbor_topk"] += 2 * (REPLAN - 1)
        w["rel_pe_table"] += 2 * (REPLAN - 1)
        w["edge_attn_core"] += 2 * cfg.MODEL.SCENE_ENCODER.ATTN.NUM_LAYER * (REPLAN - 1)
    return w


def with_map_ids(torch, batch, seed):
    """The batch with its map vectors' lane-type (channel 4) and
    traffic-light (channel 5) values drawn in the formatter's ranges, 0-3 and
    -1-2: a synthetic batch draws every channel N(0, 1), and the MLP map
    encoder, as the JAX package's, gives a NaN row for an id out of range."""
    vec = batch.init_map.vectors.clone()
    gen = torch.Generator(device=vec.device).manual_seed(seed)
    shape = vec.shape[:-1]
    vec[..., 4] = torch.randint(0, 4, shape, generator=gen, device=vec.device).to(vec.dtype)
    vec[..., 5] = torch.randint(-1, 3, shape, generator=gen, device=vec.device).to(vec.dtype)
    return batch.replace(init_map=batch.init_map.replace(vectors=vec))


def forward_profile(torch, fn):
    """(wall ms, device busy ms, B2's and B3's instantiations) of one call
    under torch.profiler, tracing the device only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    inst = {k: sorted({"bf16" if mma in e.name else "f32" if F32_TAG in e.name else e.name[:80]
                       for e in device if KERNEL_NAMES[k] in e.name})
            for k, mma in BF16_KERNELS.items()}
    return wall_ms, busy_union_ms(device), inst


def modes_fit(torch, root, label, opts, shape, device):
    """One Trainer.fit step of a phase-12 model with the body in bf16 at
    B=MODES_TRAIN_B: every loss term finite and each of the model's new
    modules moved. Returns the record."""
    import shutil

    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.train.trainer import Trainer

    build = os.path.join(root, "build")
    name = "chip_smoke_modes_" + label.replace(" ", "_")
    shutil.rmtree(os.path.join(build, name), ignore_errors=True)
    cfg = get_config(opts=opts + ["EXPERIMENT_DIR", build, "EXPERIMENT_NAME", name,
                                  "TRAIN.BATCH_SIZE", str(MODES_TRAIN_B),
                                  "TRAIN.SCHEDULER.WARMUP_STEPS", "0",
                                  "TRAIN.REMAT_POLICY", "full"])
    trainer = Trainer(cfg, model=ProSim(cfg, device=device, dtype=torch.bfloat16), device=device)
    trainer.setup()
    batch = with_map_ids(torch, make_synthetic_batch(cfg, batch_size=MODES_TRAIN_B, seed=10,
                                                     device=device, **shape), 10)
    p0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    reset_launches()
    t0 = time.perf_counter()
    trainer.fit([batch], max_steps=1)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = launch_counts()
    _, terms = _train_record(torch, trainer, 1)
    moved = {pre: max(float((p.detach() - p0[n]).abs().max())
                      for n, p in trainer.model.named_parameters() if n.startswith(pre))
             for pre in MODES_NEW_PARAMS[label]}
    log(f"modes[{label}] bf16 train step B={MODES_TRAIN_B}: {1e3 * step_s:.1f} ms (with the "
        f"first call's setup), launches {launches}, new modules' largest move {moved}")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"modes[{label}] bf16 train step: a new module did not move: {moved}")
    if launches["edge_attn_core"] or launches["fused_two_site_stack"]:
        raise AssertionError(f"modes[{label}]: a forward-only kernel ran in training: {launches}")
    return {"batch_size": MODES_TRAIN_B, "step_s": step_s, "launches": launches, "terms": terms,
            "moved": moved}


def qa_phase(torch, device="cuda"):
    """Phase 12 (c): the QA probe (LlamaTextAttnQA) at Llama3-8B width,
    LLAMA8_LAYERS layers deep, bf16 body with its LM head, f32 LoRA r=16,
    on build_qa_batch's ByteTokenizer batch at the 8B vocabulary; one
    forward and backward with the body frozen, as a train step has it.
    Gates in the module docstring. Returns the record."""
    import numpy as np

    from prosim_torch.models.llm.llama import LlamaConfig
    from prosim_torch.models.llm.text_attn import LlamaTextAttnQA
    from prosim_torch.models.llm.tokenizer import ByteTokenizer, build_qa_batch
    from prosim_torch.ops.flash_attn import causal_attention_plain
    from prosim_torch.utils.params import init_params

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(lora_rank=16), num_layers=LLAMA8_LAYERS)
    D = 128
    rng = np.random.default_rng(0)
    tok = ByteTokenizer(base_vocab=cfg.vocab_size, num_agent_tokens=cfg.num_agent_tokens)
    valid = rng.random((QA_B, AGENTS)) > 0.2
    gt = rng.normal(scale=20, size=(QA_B, AGENTS, 2)).astype(np.float32)
    qa = {k: torch.from_numpy(v).to(device) for k, v in
          build_qa_batch(tok, gt, valid, QA_LEN, rng).items()}
    t0 = time.perf_counter()
    with torch.device(device):
        probe = LlamaTextAttnQA(D, cfg)
    init_params(probe, seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        for n, p in probe.named_parameters():
            if n.endswith(("lora_b", "lora_embed_b")):  # adapters that do work in both factors
                p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
            if n.startswith("llm.") and "lora" not in n:
                p.requires_grad_(False)  # the frozen body and LM head, as build_optimizer has it
    emb = torch.randn((QA_B, AGENTS, D), generator=gen, device=device)
    torch.cuda.synchronize()
    log(f"qa: probe built and drawn on the card in {time.perf_counter() - t0:.1f} s: "
        f"{cfg.num_layers} of 32 layers (CUT), LM head {tuple(probe.llm.lm_head.shape)} "
        f"{probe.llm.lm_head.dtype}")

    def step():
        probe.zero_grad(set_to_none=True)
        e = emb.clone().requires_grad_(True)
        loss = probe(qa, e, None)[1]["qa_loss"]
        loss.backward()
        return float(loss.detach()), e.grad.detach().clone()

    fns = kernel_fns()
    originals = (fns["neighbor_topk"], fns["edge_attn_core"], fns["fused_two_site_stack"])

    def attention(fn):
        return kernel_calls(*originals, fn)

    step()  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        loss, grad = step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v / 3 for k, v in launch_counts().items()}
    want = {"causal_attention": (2 if cfg.remat else 1) * cfg.num_layers,
            "causal_attention_bwd": cfg.num_layers}
    log(f"qa: qa_loss {loss:.6f}, agent-embedding gradient max {float(grad.abs().max()):.3e}; "
        f"step ms {['%.1f' % t for t in step_ms]}, peak {peak / 2**30:.2f} GiB; launches a step "
        f"{launches} (B4 expected {want})")
    if not (np.isfinite(loss) and loss > 0):
        raise AssertionError(f"qa: qa_loss {loss}")
    if not float(grad.abs().max()) > 0:
        raise AssertionError("qa: the agent-embedding gradient is zero")
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"qa: B4 launches a step {launches}, expected {want}")
    before = launch_counts()
    with attention(lambda q, k, v, m, s: causal_attention_plain(
            q.float(), k.float(), v.float(), m, s).to(q.dtype)):
        loss_32, grad_32 = step()
    with attention(causal_attention_plain):
        loss_16, grad_16 = step()
    if launch_counts() != before:
        raise AssertionError("qa: the plain path launched a kernel")
    scale = max(float(grad_32.abs().max()), 1e-30)
    errs = {"loss": abs(loss - loss_32), "loss_plain_bf16": abs(loss_16 - loss_32),
            "grad": float((grad - grad_32).abs().max()) / scale,
            "grad_plain_bf16": float((grad_16 - grad_32).abs().max()) / scale}
    log(f"qa: kernel path vs the plain path with f32 attention: loss {errs['loss']:.3e} "
        f"(bf16 plain {errs['loss_plain_bf16']:.3e}), agent-embedding gradient "
        f"{errs['grad']:.3e} of its largest (bf16 plain {errs['grad_plain_bf16']:.3e})")
    for k in ("loss", "grad"):
        bar = BF16_RULE[0] * errs[f"{k}_plain_bf16"] + BF16_RULE[1]
        if not errs[k] <= bar:
            raise AssertionError(f"qa: {k} deviates by {errs[k]} > {bar}")
    return {"layers": cfg.num_layers, "batch": QA_B, "tokens": QA_LEN,
            "lm_head_shape": list(probe.llm.lm_head.shape), "qa_loss": loss,
            "step_ms": step_ms, "peak_memory_bytes": peak, "launches_per_step": launches,
            "parity": errs}


def modes_parity(torch, out, out_plain, out_noisy, what, mask):
    """Phase 12's f32 gate at B=2: the kernel path's first replan step
    within PARITY_TOL_M of the plain path's (each kernel of the step against
    its plain version in the loop, before any step feeds the next), and
    the whole rollout within PARITY_TOL_M on average over the valid
    agent-steps. The rollout's largest distance is recorded beside the
    plain path's own distance when its weights move by 1e-7 relative: at
    random weights a top-K graph or a max pool that a tiny position change
    flips moves one agent by centimetres (seen in the first chip call of
    the enc-mlp model at replan step 6 of 8), so the maximum is not a
    gate."""
    d = (out["rollout_traj"] - out_plain["rollout_traj"])[mask][..., :2].abs()
    own = (out_noisy["rollout_traj"] - out_plain["rollout_traj"])[mask][..., :2].abs()
    per_step = [float(x) for x in d.amax(dim=(0, 2)).view(REPLAN, -1).amax(dim=1)]
    own_step = [float(x) for x in own.amax(dim=(0, 2)).view(REPLAN, -1).amax(dim=1)]
    rec = {"first_step_m": per_step[0], "mean_m": float(d.mean()), "max_m": float(d.max()),
           "per_step_m": per_step, "plain_own_per_step_m": own_step,
           "agents_over_tol": int((d.amax(dim=(1, 2)) > PARITY_TOL_M).sum()),
           "agents": int(d.shape[0])}
    log(f"parity: B=2 rollout {what} kernel path vs plain path, max |dxy| per replan step "
        f"{['%.2e' % x for x in per_step]} m, mean {rec['mean_m']:.3e} m, "
        f"{rec['agents_over_tol']} of {rec['agents']} agents over {PARITY_TOL_M} m; the plain "
        f"path with its weights moved by 1e-7: {['%.2e' % x for x in own_step]} m")
    if not (per_step[0] <= PARITY_TOL_M and rec["mean_m"] <= PARITY_TOL_M):
        raise AssertionError(f"{what}: the first replan step {per_step[0]} m or the mean "
                             f"{rec['mean_m']} m over {PARITY_TOL_M} m")
    return rec


def modes_phase(torch, root, shape, ptxas, device="cuda"):
    """Phase 12: the modes no shipped configuration reaches (see the module
    docstring). Returns the record; raises on a failed gate."""
    import numpy as np

    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.ops.edge_attn import edge_attn_core_plain
    from prosim_torch.ops.flash_attn import causal_attention_plain
    from prosim_torch.ops.fused_stack import fused_two_site_stack_plain
    from prosim_torch.ops.neighbors import neighbor_topk_plain
    from prosim_torch.utils.params import init_params

    t0 = time.perf_counter()
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    goals_path = os.path.join(out_dir, "chip_smoke_modes_goals.npy")
    np.save(goals_path, np.random.default_rng(0).normal(scale=20, size=(MODES_K, 2))
            .astype(np.float32))
    plain = (neighbor_topk_plain, edge_attn_core_plain, fused_two_site_stack_plain,
             causal_attention_plain)
    rec = {"models": {}}
    for label, opts in modes_configs(goals_path).items():
        cfg = get_config(opts=opts)
        batch = with_map_ids(torch, make_synthetic_batch(cfg, batch_size=B_FULL, seed=0,
                                                         device=device, **shape), 0)
        small = with_map_ids(torch, make_synthetic_batch(cfg, batch_size=2, seed=1,
                                                         device=device, **shape), 1)
        m2 = small.prompt.mask
        want = modes_launches(cfg)
        r, plain32 = {"launches_expected": want}, None
        for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model = ProSim(cfg, device=device, dtype=dt)
            init_params(model, seed=0)
            launches, fwd_s = run_rollout(torch, cfg, model, batch, want, f"modes {label} {tag}")
            wall_ms, busy_ms, inst = forward_profile(torch, lambda: model(batch))
            check_instantiations(f"modes {label} {tag}", {"instantiations": inst}, tag)
            out = model(small)
            before = launch_counts()
            with kernel_calls(*plain, table_fn=rel_pe_table_chain):
                out_plain = model(small)
            if launch_counts() != before:
                raise AssertionError(f"modes {label} {tag}: the plain path launched a kernel")
            if plain32 is None:
                plain32 = out_plain
                with torch.no_grad():  # the loop's own conditioning: weights moved by 1e-7
                    gen = torch.Generator(device=device).manual_seed(3)
                    saved = [p.detach().clone() for p in model.parameters()]
                    for p in model.parameters():
                        p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen, device=device))
                    with kernel_calls(*plain, table_fn=rel_pe_table_chain):
                        out_noisy = model(small)
                    for p, v in zip(model.parameters(), saved):
                        p.copy_(v)
                par = modes_parity(torch, out, out_plain, out_noisy, f"[modes {label}]", m2)
            else:
                par = bf16_parity(torch, out, out_plain, plain32, f"[modes {label}]", m2)
            log(f"modes[{label}] {tag}: profiled forward wall {wall_ms:.1f} ms, device busy "
                f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} %)")
            r[tag] = {"launches": launches, "forward_s": fwd_s, "scenes_per_s": B_FULL / fwd_s[1],
                      "busy_ms": busy_ms, "wall_ms": wall_ms, "parity": par}
            del model, out, out_plain
        r["train_bf16"] = modes_fit(torch, root, label, opts, shape, device)
        rec["models"][label] = r
        torch.cuda.empty_cache()
    log(f"== phase 12 (a): {time.perf_counter() - t0:.1f} s")

    # (b) B1 and B2 at ATTN_UPDATE's two new sites, at the batch's positions
    t1 = time.perf_counter()
    cfg = get_config()
    batch = make_synthetic_batch(cfg, batch_size=B_FULL, seed=0, device=device, **shape)
    se = cfg.MODEL.SCENE_ENCODER.ATTN
    o_pos, m_pos = batch.init_obs.pos, batch.init_map.pos
    o_mask, m_mask = batch.init_obs.token_mask, batch.init_map.token_mask
    sites = {"a2a_update": (o_pos, o_pos, o_mask, o_mask, se.MAX_NUM_NEIGH, se.AGENT_RADIUS, True),
             "m2a_update": (o_pos, m_pos, o_mask, m_mask, se.MAX_NUM_NEIGH, se.SCENE_RADIUS, False)}
    topk_rows, graphs = check_topk(torch, sites)
    D = cfg.MODEL.HIDDEN_DIM
    graphs = {n: (idx, v, sites[n][1].shape[1], 3 * D // 4) for n, (idx, v) in graphs.items()}
    scale = se.FF_DIM ** -0.5
    edge_rows = check_edge(torch, graphs, se.NUM_HEAD, D, scale)
    edge_rows16 = check_edge_bf16(torch, graphs, se.NUM_HEAD, D, scale, edge_rows, ptxas)
    rec["sites"] = {"neighbor_topk": topk_rows, "edge_attn_core": edge_rows,
                    "edge_attn_core_bf16": edge_rows16}
    del graphs, batch
    torch.cuda.empty_cache()
    log(f"== phase 12 (b): {time.perf_counter() - t1:.1f} s")

    t2 = time.perf_counter()
    rec["qa"] = qa_phase(torch, device)
    torch.cuda.empty_cache()
    log(f"== phase 12 (c): {time.perf_counter() - t2:.1f} s")
    return rec


def check_instantiations(label, prof, dtype_tag):
    """Every B2 and B3 launch of a profiled forward ran the kernel of the
    model's dtype (f32: the f32 instantiation; bf16: the tensor-core kernel,
    BF16_KERNELS): no upcast to reach the other one, and no other kernel."""
    bad = {k: v for k, v in prof["instantiations"].items() if v and v != [dtype_tag]}
    if bad:
        raise AssertionError(f"{label}: kernel instantiations {bad}, expected {dtype_tag} only")


def main(argv):
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "prosim_torch", "csrc")):
        print("chip_smoke: prosim_torch/ is not beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from prosim_torch.config import get_config
    from prosim_torch.data.synthetic import make_synthetic_batch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.ops import _build
    from prosim_torch.models.condition.attn import condition_edge_mask
    from prosim_torch.models.llm.llama import LlamaConfig
    from prosim_torch.ops.edge_attn import edge_attn_core_plain
    from prosim_torch.ops.flash_attn import causal_attention_plain
    from prosim_torch.ops.fused_stack import fused_two_site_stack_plain
    from prosim_torch.ops.neighbors import neighbor_topk_plain
    from prosim_torch.rollout.rollout import parallel_rollout
    from prosim_torch.utils.params import init_params

    marks = [time.perf_counter()]

    def phase_done(name):
        marks.append(time.perf_counter())
        log(f"== {name}: {marks[-1] - marks[-2]:.1f} s (total {marks[-1] - marks[0]:.1f} s)")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = {}  # of the kernels this process compiled
    for text in logs.values():
        ptxas.update(ptxas_usage(text))
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(_build.SOURCES)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")
    phase_done("phases 1-2, device and build")

    shape = dict(num_lanes=LANES, num_obs_agents=OBS_AGENTS, num_agents=AGENTS, num_replan=REPLAN)
    want, want_f = forward_launches()
    if "--data-only" in argv:
        rec = {"card": smi, "data": data_phase(torch, root, want, want_f, *train_launches(),
                                               diagnose="--diagnose" in argv)}
        phase_done("phase 9, data pipeline")
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out", "chip_smoke_data.json"), "w") as f:
            json.dump(rec, f, indent=1)
        return 0
    if "--serve-only" in argv:
        rec = {"card": smi, "serve": serve_phase(torch, root, demo_launches())}
        phase_done("phase 10, serving")
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out", "chip_smoke_serve.json"), "w") as f:
            json.dump(rec, f, indent=1)
        return 0
    if "--bf16-train-only" in argv:
        rec = {"card": smi, "bf16_train": bf16_train_phase(torch, root, shape)}
        phase_done("phase 11, bf16 and data-parallel training")
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out", "chip_smoke_bf16_train.json"), "w") as f:
            json.dump(rec, f, indent=1)
        return 0
    if "--dp-child" in argv:
        rec = dp_child(torch, root)
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out", "chip_smoke_dp.json"), "w") as f:
            json.dump(rec, f, indent=1)
        return 0
    if "--modes-only" in argv:
        rec = {"card": smi, "modes": modes_phase(torch, root, shape, ptxas)}
        phase_done("phase 12, the modes no shipped configuration reaches")
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out", "chip_smoke_modes.json"), "w") as f:
            json.dump(rec, f, indent=1)
        return 0
    if "--train-only" in argv:
        rec = {"card": smi, "train": train_phase(torch, root, shape),
               "text_train": text_train_phases(torch, root, shape)}
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out", "chip_smoke_train.json"), "w") as f:
            json.dump(rec, f, indent=1)
        return 0

    # 3. kernels against their plain versions at the rollout's shapes
    cfg = get_config()
    cfg_fused = get_config(opts=["MODEL.POLICY.ACT_DECODER.ATTN.FUSED_STACK", "True"])
    cfg_text = get_config(os.path.join(root, TEXT_YAML), TEXT_OPTS)
    batch = make_synthetic_batch(cfg, batch_size=B_FULL, seed=0, device="cuda", **shape)
    batch_t = make_synthetic_batch(cfg_text, batch_size=B_FULL, seed=0, device="cuda", **shape)
    sites = site_inputs(torch, cfg, batch)
    topk_rows, graphs = check_topk(torch, sites)
    hd = cfg.MODEL.POLICY.ACT_DECODER.ATTN.FF_DIM
    H = cfg.MODEL.POLICY.ACT_DECODER.ATTN.NUM_HEAD
    D = cfg.MODEL.HIDDEN_DIM
    graphs = {name: (idx, v, sites[name][1].shape[1], 3 * D // 4)
              for name, (idx, v) in graphs.items()}
    # the condition GNN's site: Q = K = N, rel-PE at full width D
    ct_cfg = cfg_text.MODEL.CONDITION_TRANSFORMER
    if (ct_cfg.NHEAD, ct_cfg.FF_DIM) != (H, hd):
        raise AssertionError("the GNN site is timed with the policy's heads; they differ")
    N = batch_t.prompt.mask.shape[1]
    graphs["gnn"] = (torch.arange(N, dtype=torch.int32, device="cuda").expand(B_FULL, N, N)
                     .contiguous(),
                     condition_edge_mask(batch_t.conditions, cfg_text.PROMPT.CONDITION.TYPES,
                                         batch_t.prompt.mask), N, D)
    edge_rows = check_edge(torch, graphs, H, D, hd ** -0.5)
    edge_rows16 = check_edge_bf16(torch, graphs, H, D, hd ** -0.5, edge_rows, ptxas)
    table_rows = check_rel_pe_table(torch, site_poses(torch, batch), graphs, D)
    del graphs
    llm_cfg = LlamaConfig.llama3_8b(lora_rank=ct_cfg.TEXT_ATTN.LORA.R)  # TEXT_OPTS' ARCH
    text_len = ct_cfg.CONDITION_ENCODER.TEXT.LLM.MAX_TEXT_TOKENS
    flash_rows = check_flash(torch, llm_cfg, B_FULL, text_len, AGENTS, "llama")
    # the f32 instantiation at tiny()'s shape, what the shipped demo configuration runs
    llm_tiny = LlamaConfig.tiny(
        lora_rank=ct_cfg.TEXT_ATTN.LORA.R if ct_cfg.TEXT_ATTN.LORA.ENABLE else 0)
    flash_rows_f32 = check_flash(torch, llm_tiny, B_FULL, text_len, AGENTS, "tiny_f32")
    # B4's backward at the same two shapes
    flash_bwd_rows = check_flash_bwd(torch, llm_cfg, B_FULL, text_len, AGENTS, "llama",
                                     ptxas=ptxas)
    flash_bwd_rows_f32 = check_flash_bwd(torch, llm_tiny, B_FULL, text_len, AGENTS, "tiny_f32",
                                         ptxas=ptxas)
    # and at the mask of phase 8's first 8B train batch (its text is ~29
    # valid tokens a scene), beside SDPA's backward at that mask
    cfg_tt = get_config(os.path.join(root, TEXT_TRAIN_YAML), TEXT_OPTS)
    train_mask = make_synthetic_batch(cfg_tt, batch_size=B_FULL, seed=10, device="cuda",
                                      **shape).conditions[TEXT_KEY]["token_mask"]
    flash_bwd_rows += check_flash_bwd(torch, llm_cfg, B_FULL, train_mask.shape[1] - AGENTS,
                                      AGENTS, "llama_train", mask=train_mask, ptxas=ptxas)
    # a head width that is not a multiple of 16 (the wrapper pads it), both
    # dtypes, forward and backward, by the same gates
    d40_rows = []
    for dt in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(llm_tiny, hidden_size=320, num_heads=8, num_kv_heads=2, dtype=dt)
        tag = "d40_" + ("bf16" if dt == torch.bfloat16 else "f32")
        d40_rows += (check_flash(torch, c, 4, 64, 32, tag)
                     + check_flash_bwd(torch, c, 4, 64, 32, tag, ptxas=ptxas))
    torch.cuda.empty_cache()
    model_f = ProSim(cfg_fused, device="cuda")
    init_params(model_f, seed=0)
    if not model_f.policy.uses_fused_stack():
        raise AssertionError("FUSED_STACK=True did not select the fused stack")
    fused_rows, fused_ctx = check_fused(torch, model_f, batch)
    # the same configuration and weights in bf16
    model_f16 = ProSim(cfg_fused, device="cuda", dtype=torch.bfloat16)
    init_params(model_f16, seed=0)
    fused_rows16 = check_fused_bf16(torch, model_f16, batch, fused_ctx, fused_rows[0], ptxas)
    del fused_ctx
    torch.cuda.empty_cache()
    phase_done("phase 3, kernels")
    if "--kernels-only" in argv:
        return 0

    # 4. full-width rollout of the three configurations
    model = ProSim(cfg, device="cuda")
    init_params(model, seed=0)
    launches, times = run_rollout(torch, cfg, model, batch, want, "layer loop")
    per_site, prof = profile_forward(torch, model, batch, topk_rows, edge_rows)
    log_profile("layer loop", per_site, prof)
    launches_f, times_f = run_rollout(torch, cfg_fused, model_f, batch, want_f, "fused")
    per_site_f, prof_f = profile_forward(torch, model_f, batch, topk_rows, edge_rows)
    log_profile("fused", per_site_f, prof_f)
    for label, pr in (("layer loop", prof), ("fused", prof_f)):
        check_instantiations(label, pr, "f32")
    # the bf16 network body: the same two configurations and weights in bf16
    # launch the same wrappers as often, each its bf16 kernel
    t16 = time.perf_counter()
    model16 = ProSim(cfg, device="cuda", dtype=torch.bfloat16)
    init_params(model16, seed=0)
    launches16, times16 = run_rollout(torch, cfg, model16, batch, want, "layer loop bf16")
    per_site16, prof16 = profile_forward(torch, model16, batch, topk_rows, edge_rows)
    log_profile("layer loop bf16", per_site16, prof16)
    launches_f16, times_f16 = run_rollout(torch, cfg_fused, model_f16, batch, want_f, "fused bf16")
    per_site_f16, prof_f16 = profile_forward(torch, model_f16, batch, topk_rows, edge_rows)
    log_profile("fused bf16", per_site_f16, prof_f16)
    for label, pr in (("layer loop bf16", prof16), ("fused bf16", prof_f16)):
        check_instantiations(label, pr, "bf16")
    log(f"rollout[bf16]: both configurations in {time.perf_counter() - t16:.1f} s")
    t0 = time.perf_counter()
    model_t = ProSim(cfg_text, device="cuda")
    init_params(model_t, seed=0)
    with torch.no_grad():  # LoRA B factors start at zero; make the adapters do work
        gen = torch.Generator(device="cuda").manual_seed(1)
        for name, prm in model_t.named_parameters():
            if name.endswith(("lora_b", "lora_embed_b")):
                prm.copy_(torch.randn(prm.shape, generator=gen, device="cuda") * 0.02)
    torch.cuda.synchronize()
    n_llm = sum(p.numel() for p in model_t.condition_transformer_policy_decoder.text_attn.llm.parameters())
    log(f"text model: built and initialised on the card in {time.perf_counter() - t0:.1f} s, "
        f"Llama {n_llm / 1e9:.3f} B parameters in {llm_cfg.dtype}")
    want_t = dict(want, edge_attn_core=want["edge_attn_core"] + ct_cfg.NLAYER,
                  causal_attention=llm_cfg.num_layers)
    launches_t, times_t = run_rollout(torch, cfg_text, model_t, batch_t, want_t, "text")
    per_site_t, prof_t = profile_forward(torch, model_t, batch_t, topk_rows, edge_rows)
    log_profile("text", per_site_t, prof_t)
    phase_done("phase 4, rollouts")

    # 5. kernel path against plain path, both on the card; fused against layer loop
    small = make_synthetic_batch(cfg, batch_size=2, num_lanes=LANES,
                                 num_obs_agents=OBS_AGENTS, num_agents=AGENTS,
                                 num_replan=REPLAN, seed=1, device="cuda")
    m2 = small.prompt.mask

    plain = (neighbor_topk_plain, edge_attn_core_plain, fused_two_site_stack_plain)
    outs, parity, plain32 = {}, {}, {}
    for label, m in (("layer loop", model), ("fused", model_f)):
        outs[label] = m(small)
        before = launch_counts()
        with kernel_calls(*plain, causal_attention_plain, table_fn=rel_pe_table_chain):
            out_plain = plain32[label] = m(small)
        if launch_counts() != before:
            raise AssertionError(f"{label}: the plain path launched a kernel")
        parity[label] = traj_err(torch, outs[label], out_plain,
                                 f"[{label}] kernel path vs plain path", m2)
    for label, m in (("layer loop", model16), ("fused", model_f16)):
        out16 = m(small)
        before = launch_counts()
        with kernel_calls(*plain, causal_attention_plain, table_fn=rel_pe_table_chain):
            out_plain16 = m(small)
        if launch_counts() != before:
            raise AssertionError(f"{label} bf16: the plain path launched a kernel")
        parity[f"{label} bf16"] = bf16_parity(torch, out16, out_plain16, plain32[label],
                                              f"[{label}]", m2)
    del model16, model_f16, out16, out_plain16, plain32
    parity["fused vs layer loop"] = traj_err(torch, outs["fused"], outs["layer loop"],
                                          "fused stack vs layer loop (kernel paths)", m2)
    out_gpu = outs["layer loop"]
    parity["text"] = text_parity(torch, model_t, make_synthetic_batch(
        cfg_text, batch_size=2, seed=1, device="cuda", **shape), plain, causal_attention_plain)
    del model_t
    torch.cuda.empty_cache()
    # configs/waymo_demo.yaml as shipped: TEXT.LLM.ARCH auto without weights
    # resolves to the f32 tiny() Llama, whose attention is B4's f32 path
    cfg_demo = get_config(os.path.join(root, TEXT_YAML))
    model_d = ProSim(cfg_demo, device="cuda")
    init_params(model_d, seed=0)
    if model_d.condition_transformer_policy_decoder.text_attn.llm.cfg != llm_tiny:
        raise AssertionError("the shipped demo configuration did not resolve to the f32 tiny() Llama")
    small_d = make_synthetic_batch(cfg_demo, batch_size=2, seed=1, device="cuda", **shape)
    model_d(small_d)
    for fn in kernel_fns().values():
        fn.launches = 0
    out_d = model_d(small_d)
    torch.cuda.synchronize()
    launches_d = launch_counts()
    want_d = dict(want_t, causal_attention=llm_tiny.num_layers)
    log(f"demo (shipped, f32 Llama): launches per B=2 forward {launches_d} (expected {want_d})")
    if launches_d != want_d:
        raise AssertionError(f"demo: kernel launches {launches_d} != {want_d}")
    if not bool(torch.isfinite(out_d["rollout_traj"][small_d.prompt.mask]).all()):
        raise AssertionError("demo: rollout_traj has non-finite values")
    before = launch_counts()
    with kernel_calls(*plain, causal_attention_plain, table_fn=rel_pe_table_chain):
        out_dp = model_d(small_d)
    if launch_counts() != before:
        raise AssertionError("demo: the plain path launched a kernel")
    parity["demo"] = traj_err(torch, out_d, out_dp, "[demo, f32 Llama] kernel path vs plain path",
                              small_d.prompt.mask)
    per_site_d, prof_d = profile_forward(torch, model_d, small_d, topk_rows, edge_rows)
    log_profile("demo B=2", per_site_d, prof_d)
    del model_d
    # the shipped demo configuration built in bf16: conditions and text
    # adapters in bf16, its tiny() Llama f32 as its LlamaConfig says
    model_d16 = ProSim(cfg_demo, device="cuda", dtype=torch.bfloat16)
    init_params(model_d16, seed=0)
    text_attn = model_d16.condition_transformer_policy_decoder.text_attn
    if text_attn.llm.cfg != llm_tiny or text_attn.ln_prompt.dtype != torch.bfloat16:
        raise AssertionError("demo bf16: the Llama is not the f32 tiny() one, or the text "
                             "adapters are not bf16")
    model_d16(small_d)
    for fn in kernel_fns().values():
        fn.launches = 0
    out_d16 = model_d16(small_d)
    torch.cuda.synchronize()
    launches_d16 = launch_counts()
    log(f"demo bf16 (shipped, f32 Llama): launches per B=2 forward {launches_d16} "
        f"(expected {want_d})")
    if launches_d16 != want_d:
        raise AssertionError(f"demo bf16: kernel launches {launches_d16} != {want_d}")
    before = launch_counts()
    with kernel_calls(*plain, causal_attention_plain, table_fn=rel_pe_table_chain):
        out_dp16 = model_d16(small_d)
    if launch_counts() != before:
        raise AssertionError("demo bf16: the plain path launched a kernel")
    parity["demo bf16"] = bf16_parity(torch, out_d16, out_dp16, out_dp, "[demo, f32 Llama]",
                                      small_d.prompt.mask)
    del model_d16, out_d16, out_dp16

    # 6. M-replica rollout
    M = 4
    rep = parallel_rollout(model, small.to("cuda"), M)
    rt = rep["rollout_traj"].view(2, M, *rep["rollout_traj"].shape[1:])
    rep_err = float((rt - out_gpu["rollout_traj"][:, None]).abs()[m2[:, None].expand(2, M, -1)].max())
    log(f"replicas: parallel_rollout M={M} on B=2 -> {tuple(rep['rollout_traj'].shape)}, "
        f"max |replica - single| {rep_err:.3e}")
    if not rep_err <= PARITY_TOL_M:
        raise AssertionError(f"replicas differ from the single rollout by {rep_err}")
    phase_done("phases 5-6, parity and replicas")

    # 7. training (configs/no_text.yaml), its main path counted on its own
    del model, model_f, out_gpu, outs
    torch.cuda.empty_cache()
    train = train_phase(torch, root, shape)
    phase_done("phase 7, training")

    # 8. text training (configs/with_text.yaml), as shipped and at Llama3-8B width
    text_train = text_train_phases(torch, root, shape)
    phase_done("phase 8, text training")

    # 9. the host data pipeline: synthetic WOMD shards through ingest, the
    # dataset and the loader into the closed loop, the trainer and the bank.
    # In a process of its own: after phase 8's profiles the profiler records
    # no device event in this process (seen in two runs), and phase 9 counts
    # its copies with it. It holds its train steps to train_launches(), which
    # phases 7 and 8 measured here.
    topk_per_step, text_per_step = train_launches()
    measured = (train["neighbor_topk_per_step"],
                {k: text_train["as_shipped"]["per_step"][k] for k in text_per_step})
    if measured != (topk_per_step, text_per_step):
        raise AssertionError(f"phases 7-8 launched {measured} a step, not "
                             f"{(topk_per_step, text_per_step)}")
    torch.cuda.empty_cache()  # the child allocates beside this process
    log(f"phase 9: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of "
        f"device memory while it runs")
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--data-only"], cwd=root)
    if child.returncode != 0:
        raise RuntimeError(f"phase 9 (chip_smoke.py --data-only) exited {child.returncode}")
    with open(os.path.join(root, "chiprun_out", "chip_smoke_data.json")) as f:
        data = json.load(f)["data"]
    phase_done("phase 9, data pipeline (its own process)")

    # 10. serving: the weights and the serving entry points (checkpoint
    # converter, demo API, the WOSAC farm through a trainer's request, the
    # CLI, the HF Llama loader), in a process of its own for the same
    # reason as phase 9 (its farm scene is profiled)
    if want_d != demo_launches():
        raise AssertionError(f"phase 5's demo launches {want_d} != demo_launches()")
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-only"], cwd=root)
    if child.returncode != 0:
        raise RuntimeError(f"phase 10 (chip_smoke.py --serve-only) exited {child.returncode}")
    with open(os.path.join(root, "chiprun_out", "chip_smoke_serve.json")) as f:
        serve = json.load(f)["serve"]
    phase_done("phase 10, serving (its own process)")

    # 11. bf16 training (no_text and bench.py's train default) and the
    # data-parallel step on NCCL, in a process of its own for the same
    # reason as phase 9 (its train step is profiled)
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--bf16-train-only"],
                           cwd=root)
    if child.returncode != 0:
        raise RuntimeError(f"phase 11 (chip_smoke.py --bf16-train-only) exited {child.returncode}")
    with open(os.path.join(root, "chiprun_out", "chip_smoke_bf16_train.json")) as f:
        bf16_train = json.load(f)["bf16_train"]
    a16 = bf16_train["no_text"]
    for label, r in (("f32 (phase 7)", train), ("bf16 (phase 11)", a16)):
        pr = r["profile"]
        log(f"train {label}: B={r['batch_size']} median step "
            f"{sorted(r['step_ms'])[len(r['step_ms']) // 2]:.1f} ms, peak "
            f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, B1 {r['neighbor_topk_per_step']:g} a step, "
            f"busy {pr['busy_ms']:.1f} of {pr['wall_ms']:.1f} ms, {pr['launches']} operations")
    phase_done("phase 11, bf16 and data-parallel training (its own process)")

    # 12. the modes no shipped configuration reaches (the MLP encoders, the
    # 'mlp' fusion and ATTN_UPDATE, goal context and the cluster head, the
    # QA probe), in a process of its own for the same reason as phase 9
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--modes-only"], cwd=root)
    if child.returncode != 0:
        raise RuntimeError(f"phase 12 (chip_smoke.py --modes-only) exited {child.returncode}")
    with open(os.path.join(root, "chiprun_out", "chip_smoke_modes.json")) as f:
        modes = json.load(f)["modes"]
    phase_done("phase 12, the modes no shipped configuration reaches (its own process)")
    modes_paths = {}
    for label, r in modes["models"].items():
        modes_paths[f"modes {label}"] = r["f32"]["launches"]
        modes_paths[f"modes {label} bf16"] = r["bf16"]["launches"]
        modes_paths[f"modes {label} train bf16 (1 step)"] = r["train_bf16"]["launches"]
    qa_path = "modes QA probe (a step)"
    modes_paths[qa_path] = modes["qa"]["launches_per_step"]

    # B1, B2 and B4 are read from the text configuration (it runs every site
    # of B1 and B2, the GNN's included), B3 from the fused one
    by_path = {"layer loop": launches, "fused": launches_f, "text": launches_t,
               "demo (B=2)": launches_d, "layer loop bf16": launches16, "fused bf16": launches_f16,
               "demo bf16 (B=2)": launches_d16,
               f"train ({train['steps']} steps)": train["launches"],
               "train eval (B=2)": train["eval_launches"],
               **{f"text train {k} ({v['timed_steps']} steps)": v["launches"]
                  for k, v in text_train.items()},
               "serve demo (B=1)": serve["demo_launches"],
               f"serve farm ({SERVE_SCENES} scenes, M={SERVE_M})": serve["farm"]["launches"],
               f"train bf16 ({TRAIN_STEPS} steps)": a16["launches"],
               "train bf16 eval (B=2)": a16["eval_launches"],
               "train bf16 eval FUSED_STACK (B=2)": a16["eval_launches_fused"],
               f"bench train bf16 ({BENCH_TRAIN_STEPS} steps)": bf16_train["bench_train"]["launches"],
               **modes_paths}
    bwd_path = {k: f"text train {k} ({v['timed_steps']} steps)" for k, v in text_train.items()}
    # the sites of phase 12 (ATTN_UPDATE's a2a and m2a) join phase 3's
    topk_rows += modes["sites"]["neighbor_topk"]
    edge_rows += modes["sites"]["edge_attn_core"]
    edge_rows16 += modes["sites"]["edge_attn_core_bf16"]
    kernels = [
        summarize("neighbor_topk", "cuda", "prosim_torch/csrc/neighbor_topk.cu",
                  "prosim_tpu/ops/pallas_topk.py:95", topk_rows,
                  launches_t["neighbor_topk"], per_site_t["neighbor_topk"]),
        summarize("edge_attn_core", "cuda", "prosim_torch/csrc/edge_attn.cu",
                  "prosim_tpu/ops/edge_attn.py:91", edge_rows,
                  launches_t["edge_attn_core"], per_site_t["edge_attn_core"],
                  extra=("path_ms", "table_ms", "table_gather_ms", "table_path_ms",
                         "library_gather_ms")),
        summarize("fused_two_site_stack", "cuda", "prosim_torch/csrc/fused_stack.cu",
                  "prosim_tpu/ops/fused_stack.py:260", fused_rows,
                  launches_f["fused_two_site_stack"], per_site_f["fused_two_site_stack"],
                  extra=("layer_loop_ms", "fused_path_ms")),
        # the bf16 paths (tensor-core kernels on csrc/edge_mma.cuh), read
        # from the bf16 layer loop (B2) and the bf16 fused loop (B3); beside
        # each, the f32 path's ms
        summarize("edge_attn_core_bf16", "cuda", "prosim_torch/csrc/edge_attn.cu",
                  "prosim_tpu/ops/edge_attn.py:91", edge_rows16,
                  launches16["edge_attn_core"], per_site16["edge_attn_core"],
                  extra=("f32_ms", "library_gather_ms")),
        summarize("fused_two_site_stack_bf16", "cuda", "prosim_torch/csrc/fused_stack.cu",
                  "prosim_tpu/ops/fused_stack.py:260", fused_rows16,
                  launches_f16["fused_two_site_stack"], per_site_f16["fused_two_site_stack"],
                  extra=("f32_ms", "layer_loop_ms")),
        summarize("causal_attention", "cuda", "prosim_torch/csrc/flash_attn.cu",
                  "prosim_tpu/models/llm/llama.py:134", flash_rows,
                  launches_t["causal_attention"], per_site_t["causal_attention"]),
        # B4's f32 instantiation, read from the shipped demo configuration
        summarize("causal_attention_f32", "cuda", "prosim_torch/csrc/flash_attn.cu",
                  "prosim_tpu/models/llm/llama.py:134", flash_rows_f32,
                  launches_d["causal_attention"], per_site_d["causal_attention"]),
        # B4's backward (the library kernel's dkv and dq), read from phase 8;
        # its forward_* fields are per train step
        summarize("causal_attention_bwd", "cuda", "prosim_torch/csrc/flash_attn_bwd.cu",
                  FLASH_BWD_REPLACES[0], flash_bwd_rows,
                  text_train["llama3_8b"]["launches"]["causal_attention_bwd"],
                  {"llama": text_train["llama3_8b"]["flash_bwd_per_step"]}),
        summarize("causal_attention_bwd_f32", "cuda", "prosim_torch/csrc/flash_attn_bwd.cu",
                  FLASH_BWD_REPLACES[0], flash_bwd_rows_f32,
                  text_train["as_shipped"]["launches"]["causal_attention_bwd"],
                  {"tiny_f32": text_train["as_shipped"]["flash_bwd_per_step"]}),
    ]
    for k in kernels[-2:]:
        k["replaces_also"] = FLASH_BWD_REPLACES[1]
    for k in kernels[3:5]:  # the bf16 paths' edge engine
        k["source_also"] = "prosim_torch/csrc/edge_mma.cuh"
    # the rel-PE table kernel, read from the layer loop (f32) and the bf16
    # layer loop: 4 tables in prepare and 2 a replan step
    for name, dt, n, site in (("rel_pe_table", "float32", launches, per_site),
                              ("rel_pe_table_bf16", "bfloat16", launches16, per_site16)):
        kernels.append(summarize(name, "cuda", "prosim_torch/csrc/rel_pe_table.cu",
                                 "none: XLA fuses the chain on the TPU",
                                 [r for r in table_rows if r["dtype"] == dt],
                                 n["rel_pe_table"], site["rel_pe_table"],
                                 extra=("plain_wall_ms",)))
    # B4's one launch count covers both instantiations: bf16 in the text
    # configuration, f32 in the shipped demo one
    f32_paths = [p for p in by_path if "bf16" not in p]
    bf16_paths = ("layer loop bf16", "fused bf16", "demo bf16 (B=2)", "train bf16 eval (B=2)",
                  "train bf16 eval FUSED_STACK (B=2)",
                  *(f"modes {label} bf16" for label in modes["models"]))
    bench_path = f"bench train bf16 ({BENCH_TRAIN_STEPS} steps)"  # its tiny() Llama is f32
    paths = {"edge_attn_core": f32_paths, "fused_two_site_stack": f32_paths,
             "edge_attn_core_bf16": bf16_paths, "fused_two_site_stack_bf16": bf16_paths,
             "causal_attention": ("layer loop", "fused", "text", bwd_path["llama3_8b"], qa_path),
             "causal_attention_f32": ("demo (B=2)", bwd_path["as_shipped"], "serve demo (B=1)",
                                      f"serve farm ({SERVE_SCENES} scenes, M={SERVE_M})",
                                      bench_path),
             "causal_attention_bwd": (bwd_path["llama3_8b"], qa_path),
             "causal_attention_bwd_f32": (bwd_path["as_shipped"], bench_path),
             "rel_pe_table": f32_paths, "rel_pe_table_bf16": bf16_paths}
    for k in kernels:
        wrapper = k["name"].removesuffix("_f32").removesuffix("_bf16")
        k["launches_per_path"] = {p: by_path[p][wrapper] for p in paths.get(k["name"], by_path)}
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke_kernels.json"), "w") as f:
        json.dump({"card": smi,
                   "rollout": {"layer loop": {"scenes_per_s": B_FULL / times[1], "forward_s": times,
                                              "profile": prof, "per_site": per_site},
                               "fused": {"scenes_per_s": B_FULL / times_f[1], "forward_s": times_f,
                                         "profile": prof_f, "per_site": per_site_f},
                               "text": {"scenes_per_s": B_FULL / times_t[1], "forward_s": times_t,
                                        "profile": prof_t, "per_site": per_site_t},
                               "demo (B=2)": {"profile": prof_d, "per_site": per_site_d},
                               "layer loop bf16": {"scenes_per_s": B_FULL / times16[1],
                                                   "forward_s": times16, "profile": prof16,
                                                   "per_site": per_site16},
                               "fused bf16": {"scenes_per_s": B_FULL / times_f16[1],
                                              "forward_s": times_f16, "profile": prof_f16,
                                              "per_site": per_site_f16}},
                   "flash_d40": d40_rows,
                   "parity_m": parity, "train": train, "text_train": text_train, "data": data,
                   "serve": serve, "bf16_train": bf16_train, "modes": modes,
                   "kernels": kernels}, f, indent=1)
    log(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "sites"} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
