"""What decides `correct`: the rest of a run (set-up, window, the program
freed, the check, the cell's limits) on the CPU at a tiny size, without the
look for a card, with the timed path sound, broken underneath, or replaced
by the cell's control."""

import pytest
import torch

from conftest import tiny_ctx

CELLS = ["default.closed_loop_b64", "no_text.wosac_m32"]


def run_cell(name, seed=5, seconds=0.5, control=False):
    """A run as run.py makes it after its look for a card: -> [checks]."""
    from benchmark import compare, core, run

    ctx = tiny_ctx(name, seed)
    drv = core.load_driver(ctx.cell["driver"])
    drv.setup(ctx)
    w = run.run_window(ctx, drv, seconds, False)
    drv.release_program(ctx)
    kept = w["kept"]
    if control:
        drv.make_control(ctx)
        kept = [drv.control_call(ctx, i) for i in range(2)]
    return compare.judge(drv.check(ctx, kept, seed), ctx.cell["checks"])


def correct(checks):
    return all(c["ok"] for c in checks)


def test_sound_closed_loop_is_correct():
    assert correct(run_cell("default.closed_loop_b64"))


def _state_unchanged(orig):
    def step(self, batch, num_map, policy_emd, consts, carry, r, mode, generator, packed):
        new, ys = orig(self, batch, num_map, policy_emd, consts, carry, r, mode, generator,
                       packed)
        return (*new[:4], carry[4], carry[5]), ys
    return step


def _token_altered(orig):
    def step(self, batch, num_map, policy_emd, consts, carry, r, mode, generator, packed):
        new, ys = orig(self, batch, num_map, policy_emd, consts, carry, r, mode, generator,
                       packed)
        traj = new[4].clone()
        cursor = self.hist_steps + r * self.replan
        traj[0, 0, cursor:cursor + self.replan, :2] += 5.0  # one agent, 5 m off
        return (*new[:4], traj, new[5]), ys
    return step


def _half_left_out(orig):
    def rollout(self, batch, scene, policy_emd, mode="val", generator=None):
        out = orig(self, batch, scene, policy_emd, mode, generator)
        traj = out["rollout_traj"].clone()
        traj[traj.shape[0] // 2:] = 0.0  # the second half of the rows never computed
        return dict(out, rollout_traj=traj)
    return rollout


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault,attr", [(_state_unchanged, "_step"), (_token_altered, "_step"),
                                        (_half_left_out, "rollout")])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault, attr):
    from prosim_torch.models.prosim import ProSim

    monkeypatch.setattr(ProSim, attr, fault(getattr(ProSim, attr)))
    assert not correct(run_cell(cell))


def test_fp8_control_is_not_correct():
    """The WOSAC cell's control (the reference in bf16 with fp8 products in
    the program's place) fails the cell's limits."""
    assert not correct(run_cell("no_text.wosac_m32", control=True))


@pytest.mark.gpu
def test_tf32_control_is_not_correct_on_the_card():
    """The closed-loop cell's control (the reference with TF32 products in
    the program's place) fails the cell's limits; TF32 exists on the card
    only. Tiny sizes, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need a CUDA card")
    from benchmark import compare, core

    ctx = tiny_ctx("default.closed_loop_b64")
    ctx.device = torch.device("cuda", 0)
    drv = core.load_driver("closed_loop")
    drv.setup(ctx)
    drv.release_program(ctx)
    drv.make_control(ctx)
    kept = [drv.control_call(ctx, 0)]
    assert not correct(compare.judge(drv.check(ctx, kept, 5), ctx.cell["checks"]))
