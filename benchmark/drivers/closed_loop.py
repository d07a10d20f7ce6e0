"""The unconditioned closed loop: `ProSim.forward(batch, mode="val")` over a
batch of scenes with one replica each, calls back to back.

Each call is the port's main path: `prepare` (scene encoder, prompt
encoder, decoder) once, then the replan loop. The call ends when the
device has finished (a synchronise), as a caller that reads the rollout
waits. In the traced run the benchmark calls the two halves itself,
`prepare` and then `rollout`, with a synchronise after each, and keeps their
host times as spans.

The check follows the program's rollout step by step against the
reference (its trajectories read as the program returned them), over a
sample of the scenes of the sampled calls, drawn from the seed.
"""

import time

import numpy as np

from benchmark import compare, core
from benchmark.reference import model as refm
from benchmark.reference.precision import tf32_products
from benchmark.traffic.generator import program_arrays

ROWS_PER_BLOCK = 8  # scenes the reference holds at once


def setup(ctx):
    torch = ctx.torch
    from prosim_torch.data.batch import SceneBatch
    from prosim_torch.models.prosim import ProSim

    st, dev = ctx.state, ctx.device
    if dev.type == "cuda":
        core.build_kernels()
    st.weights = core.make_weights(ctx.tree, ctx.dtype, ctx.seed, dev)
    st.model = ProSim(ctx.cfg, dev, ctx.dtype)
    core.load_weights(st.model, st.weights)
    st.pool = ctx.make_pool()
    st.batches = [SceneBatch.from_numpy(program_arrays(p)).to(dev) for p in st.pool]
    for i in range(ctx.mix["warmup_calls"]):
        call(ctx, i)
    return st


def input_key(ctx, i):
    return i % len(ctx.state.pool)


def _sync(ctx):
    if ctx.device.type == "cuda":
        ctx.torch.cuda.synchronize()


def call(ctx, i, spans=None):
    """One forward over the call's batch; with `spans`, as its two halves,
    each timed on the host clock to a synchronise."""
    st = ctx.state
    j = input_key(ctx, i)
    batch = st.batches[j]
    if spans is None:
        out = st.model(batch, mode="val")
        _sync(ctx)
    else:
        t0 = time.perf_counter()
        scene, policy_emd = st.model.prepare(batch, "val")
        _sync(ctx)
        t1 = time.perf_counter()
        out = st.model.rollout(batch, scene, policy_emd, "val")
        _sync(ctx)
        spans.setdefault("prepare_s", []).append(t1 - t0)
        spans.setdefault("rollout_s", []).append(time.perf_counter() - t1)
    return {"j": j, "traj": out["rollout_traj"]}


def units(ctx, n_calls):
    return {"rollouts": n_calls * ctx.mix["scenes_per_call"]}


def release_program(ctx):
    ctx.state.model = ctx.state.batches = None


def make_control(ctx):
    torch, st = ctx.torch, ctx.state
    st.control = refm.ReferenceProSim(ctx.tree, torch.float32).to(ctx.device)
    core.load_weights(st.control, st.weights)


def control_call(ctx, i):
    """The reference with TF32 products put in the program's place, free-running."""
    torch, st = ctx.torch, ctx.state
    j = input_key(ctx, i)
    sc = refm.scene_from_arrays(st.pool[j], ctx.device)
    trajs = []
    with torch.no_grad(), tf32_products():
        for a in range(0, sc.prompt.mask.shape[0], ROWS_PER_BLOCK):
            rows = sc.rows(lambda x: x[a:a + ROWS_PER_BLOCK])
            s_tok, pol = st.control.prepare(rows)
            trajs.append(st.control.rollout(rows, s_tok, pol, ctx.replan_steps)["traj"])
    return {"j": j, "traj": torch.cat(trajs)}


def check(ctx, kept: list, seed: int) -> dict:
    torch, st, mix = ctx.torch, ctx.state, ctx.mix
    ref = refm.ReferenceProSim(ctx.tree, torch.float32).to(ctx.device)
    core.load_weights(ref, st.weights)
    rng = np.random.default_rng([seed, 2])
    gaps = compare.Gaps()
    for k in kept:
        sc = refm.scene_from_arrays(st.pool[k["j"]], ctx.device)
        n = sc.prompt.mask.shape[0]
        scenes = np.sort(rng.choice(n, size=min(mix["check_scenes"], n), replace=False))
        for a in range(0, len(scenes), ROWS_PER_BLOCK):
            idx = torch.as_tensor(scenes[a:a + ROWS_PER_BLOCK], device=ctx.device)
            rows = sc.rows(lambda x: x[idx])
            with torch.no_grad():
                s_tok, pol = ref.prepare(rows)
                prog = k["traj"][idx]
                r = ref.rollout(rows, s_tok, pol, ctx.replan_steps, forced_traj=prog)
            compare.step_gaps(gaps, prog, r, rows.prompt.mask, ref.replan)
    return gaps.values()
