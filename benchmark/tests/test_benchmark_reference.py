"""The reference against the program's CPU path (plain PyTorch versions of
every kernel) at a tiny size, and its independence from the program."""

import subprocess
import sys

import torch

from conftest import ROOT, tiny_ctx


def _reference(ctx):
    from benchmark.core import load_weights
    from benchmark.reference.model import ReferenceProSim

    ref = ReferenceProSim(ctx.tree, ctx.dtype)
    load_weights(ref, ctx.state.weights)
    return ref


def test_closed_loop_bitwise_on_the_cpu():
    from benchmark.reference.model import scene_from_arrays

    ctx = tiny_ctx("default.closed_loop_b64")
    from benchmark.core import load_driver

    drv = load_driver("closed_loop")
    drv.setup(ctx)
    out = drv.call(ctx, 0)
    sc = scene_from_arrays(ctx.state.pool[0], "cpu")
    ref = _reference(ctx)
    with torch.no_grad():
        s, pol = ref.prepare(sc)
        r = ref.rollout(sc, s, pol, ctx.replan_steps)
    assert torch.equal(r["traj"], out["traj"])
    assert drv.check(ctx, [out], 4) == {"step_rel": 0.0, "step_max_m": 0.0,
                                        "heading_max_rad": 0.0}


def test_sampler_path_in_f32_on_the_cpu():
    """The WOSAC request in f32 (the configuration's dtype swapped): the
    sampler's goals, the goal conditions and the world-frame futures."""
    from benchmark.core import load_driver
    from benchmark.reference import model as refm

    ctx = tiny_ctx("no_text.wosac_m32")
    ctx.dtype = torch.float32
    drv = load_driver("wosac")
    drv.setup(ctx)
    k = drv.call(ctx, 1)
    st = ctx.state
    ref = _reference(ctx)
    sc = refm.scene_from_arrays(st.pool[k["j"]], "cpu")
    M = ctx.mix["replicas"]
    with torch.no_grad():
        s_tok, s_emd = ref.prepare(sc)
        feat = refm.sample_goals(s_emd["goal_point"], s_emd["goal_prob"], st.picks[k["j"]],
                                 ctx.mix["top_k"], ctx.mix["stop_smooth"])
        torch.testing.assert_close(k["s_goal_point"], s_emd["goal_point"], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(feat, k["goal_feat"])
        scm = sc.rows(lambda x: refm.tile_rows(x, M))
        scm.conditions = {"goal": refm.goal_condition(feat, sc.prompt.mask, M)}
        pol = ref.generate_policy(scm, refm.tile_scene_tokens(s_tok, M),
                                  refm.tile_rows(ref.prompt_encoder(sc.prompt), M))
        r = ref.rollout(scm, refm.tile_scene_tokens(s_tok, M), pol, ctx.replan_steps)
        world = refm.to_world(r["traj"], r["init_pos"], r["init_heading"], *st.center[k["j"]])
    # the program's fused stack sums in another order than the layer loop
    torch.testing.assert_close(k["world"], world, rtol=0, atol=2e-3)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.model, "
            "benchmark.reference.precision, benchmark.compare, benchmark.costs.costs, "
            "benchmark.traffic.generator; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'prosim_torch', 'prosim_tpu', 'jax', 'jaxlib', 'flax'}); print(bad)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"
