"""WOSAC evaluation: one scene, M replicas with per-replica sampled goals.

Each request is what the farm's `_rollout_one_scene` puts on the card:
`parallel_rollout_with_sampler(model, batch, M, model, top_k, stop_smooth,
picks)` with the eval model as its own goal sampler, then `rollout_to_world`
and one copy of the world-frame futures to the host. Requests run back to
back from one client (a closed loop, like a farm worker), over a pool of
scenes and per-replica goal picks drawn from the seed.

The check follows each sampled request stage by stage against the
reference: the sampler's goal heads, the goal sampling from the program's
own heads and the benchmark's picks (exact), and, with the program's goals
as the replicas' conditions, the closed loop step by step from the
world-frame futures the program handed out (read back into each agent's
frame). The per-replica decoder's goal heads come before the conditions
enter (at 'policy_decoder'), so they repeat the sampler's; the conditions
reach the futures through the GNN.
"""

import numpy as np

from benchmark import compare, core
from benchmark.reference import model as refm
from benchmark.reference.precision import fp8_products
from benchmark.traffic.generator import program_arrays

ROWS_PER_BLOCK = 8  # replica rows the reference's closed loop holds at once


class Capture:
    """Keeps the inputs and the result of the program's goal sampling
    (`sample_goal_conditions`) in the request that calls it."""

    def __init__(self, fn):
        self.fn, self.last = fn, None

    def __call__(self, goal_point, goal_prob, prompt_mask, m, generator=None, **kw):
        cond = self.fn(goal_point, goal_prob, prompt_mask, m, generator, **kw)
        self.last = (goal_point, goal_prob, cond.feat)
        return cond


def setup(ctx):
    """The program's model with the benchmark's weights, the scene pool on
    the card, the picks; two warm-up requests."""
    torch = ctx.torch
    from prosim_torch.data.batch import SceneBatch
    from prosim_torch.models.prosim import ProSim
    from prosim_torch.rollout import rollout as prog_rollout

    st = ctx.state
    mix, dev = ctx.mix, ctx.device
    if dev.type == "cuda":
        core.build_kernels()
    st.weights = core.make_weights(ctx.tree, ctx.dtype, ctx.seed, dev)
    st.model = ProSim(ctx.cfg, dev, ctx.dtype)
    core.load_weights(st.model, st.weights)
    st.pool = ctx.make_pool()
    st.batches = [SceneBatch.from_numpy(program_arrays(p)).to(dev) for p in st.pool]
    M = mix["replicas"]
    K = ctx.tree.MODEL.DECODER.GOAL_PRED.K
    N = ctx.tree.DATASET.FORMAT.PAD.NUM_AGENTS
    rng = np.random.default_rng([ctx.seed, 1])
    st.picks = [torch.as_tensor(rng.integers(0, min(mix["top_k"], K), (1, M, N)), device=dev)
                for _ in st.pool]
    st.center = [(torch.as_tensor(p["world_xy"], device=dev).repeat_interleave(M, 0),
                  torch.as_tensor(p["world_h"], device=dev).repeat_interleave(M, 0))
                  for p in st.pool]
    st.rollout_mod = prog_rollout
    st.capture = Capture(prog_rollout.sample_goal_conditions)
    prog_rollout.sample_goal_conditions = st.capture
    for i in range(mix["warmup_calls"]):
        call(ctx, i)
    return st


def input_key(ctx, i):
    return i % len(ctx.state.pool)


def call(ctx, i, spans=None):
    """One request, to its world-frame futures on the host. Returns what
    the check reads of it (the futures and the small goal tensors)."""
    torch, st, mix = ctx.torch, ctx.state, ctx.mix
    j = input_key(ctx, i)
    R = st.rollout_mod
    with torch.inference_mode():
        out = R.parallel_rollout_with_sampler(
            st.model, st.batches[j], mix["replicas"], st.model, top_k=mix["top_k"],
            stop_smooth=mix["stop_smooth"], picks=st.picks[j])
        world = R.rollout_to_world(out, None, *st.center[j]).cpu()
    gp, gprob, feat = st.capture.last
    return {"j": j, "world": world, "s_goal_point": gp, "s_goal_prob": gprob, "goal_feat": feat,
            "goal_point": out["goal_point"], "goal_prob": out["goal_prob"]}


def units(ctx, n_calls):
    return {"rollouts": n_calls * ctx.mix["replicas"]}


def release_program(ctx):
    st = ctx.state
    st.rollout_mod.sample_goal_conditions = st.capture.fn
    st.model = st.batches = None


def control_call(ctx, i):
    """The reference in the control's precision (bf16 with fp8 products)
    put in the program's place: the same request, free-running."""
    torch, st, mix = ctx.torch, ctx.state, ctx.mix
    j = input_key(ctx, i)
    ctl = st.control
    sc = refm.scene_from_arrays(st.pool[j], ctx.device)
    M = mix["replicas"]
    with torch.no_grad(), fp8_products():
        s_tok, s_emd = ctl.prepare(sc)
        feat = refm.sample_goals(s_emd["goal_point"], s_emd["goal_prob"], st.picks[j],
                                 mix["top_k"], mix["stop_smooth"])
        scm, s_m, pe_m = _tiled(ctl, sc, s_tok, feat, M)
        pol = ctl.generate_policy(scm, s_m, pe_m)
        worlds = []
        for a in range(0, M, ROWS_PER_BLOCK):
            b = slice(a, a + ROWS_PER_BLOCK)
            r = ctl.rollout(scm.rows(lambda x: x[b]), _rows_tokens(s_m, b),
                            {k: v[b] for k, v in pol.items()}, ctx.replan_steps)
            worlds.append(refm.to_world(r["traj"], r["init_pos"], r["init_heading"],
                                        st.center[j][0][b], st.center[j][1][b]))
    return {"j": j, "world": torch.cat(worlds).cpu(), "s_goal_point": s_emd["goal_point"],
            "s_goal_prob": s_emd["goal_prob"], "goal_feat": feat, "goal_point": pol["goal_point"],
            "goal_prob": pol["goal_prob"]}


def make_control(ctx):
    torch, st = ctx.torch, ctx.state
    st.control = refm.ReferenceProSim(ctx.tree, torch.bfloat16).to(ctx.device)
    core.load_weights(st.control, st.weights)


def _tiled(ref, sc, s_tok, feat, M):
    scm = sc.rows(lambda x: refm.tile_rows(x, M))
    scm.conditions = {"goal": refm.goal_condition(feat, sc.prompt.mask, M)}
    return (scm, refm.tile_scene_tokens(s_tok, M),
            refm.tile_rows(ref.prompt_encoder(sc.prompt), M))


def _rows_tokens(s, b):
    return refm.SceneTokens(s.tokens[b], s.pos[b], s.ori[b], s.mask[b], s.num_map)


def check(ctx, kept: list, seed: int) -> dict:
    """The numbers over the sampled requests (`kept`, drawn from the seed)."""
    torch, st, mix = ctx.torch, ctx.state, ctx.mix
    ref = refm.ReferenceProSim(ctx.tree, torch.float32).to(ctx.device)
    core.load_weights(ref, st.weights)
    gaps = compare.Gaps()
    M = mix["replicas"]
    for k in kept:
        j = k["j"]
        sc = refm.scene_from_arrays(st.pool[j], ctx.device)
        mask = sc.prompt.mask
        with torch.no_grad():
            s_tok, s_emd = ref.prepare(sc)
            gaps.rel("goal_rel", k["s_goal_point"], s_emd["goal_point"], mask)
            # the sampling stage, from the program's own heads, in its dtype
            feat = refm.sample_goals(k["s_goal_point"], k["s_goal_prob"], st.picks[j],
                                     mix["top_k"], mix["stop_smooth"])
            gaps.mismatches("sample_mismatches", (feat != k["goal_feat"]).any(-1).sum())
            scm, s_m, pe_m = _tiled(ref, sc, s_tok, k["goal_feat"].float(), M)
            pol = ref.generate_policy(scm, s_m, pe_m)
            world = k["world"].to(ctx.device)
            cxy, ch = st.center[j]
            for a in range(0, M, ROWS_PER_BLOCK):
                b = slice(a, a + ROWS_PER_BLOCK)
                rows = scm.rows(lambda x: x[b])
                _, _, init_pos, init_h = ref.init_agent_trajs(rows, 1 + ref.hist_steps)
                prog = compare.world_to_local(world[b], init_pos, init_h, cxy[b], ch[b])
                r = ref.rollout(rows, _rows_tokens(s_m, b), {k2: v[b] for k2, v in pol.items()},
                                ctx.replan_steps, forced_traj=prog)
                compare.step_gaps(gaps, prog, r, rows.prompt.mask, ref.replan)
    return gaps.values()
