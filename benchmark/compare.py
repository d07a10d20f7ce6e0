"""The numbers that decide `correct`, and their accumulation over blocks.

Each number is compared with the limit the cell's workload file gives it
(`checks`). Relative gaps are L2: the norm of the program's difference from
the reference over the norm of the reference's value, over the valid agents
of every block checked. Widest gaps are maxima over the same. Mismatch
counts are exact comparisons (limit 0).
"""

import math

import torch

from benchmark.reference.layers import rotate_2d, wrap_angle


class Gaps:
    def __init__(self):
        self.sq = {}    # name -> [sum of squared differences, sum of squared reference]
        self.max = {}   # name -> widest gap
        self.count = {}  # name -> mismatches

    def rel(self, name, prog, ref, mask=None):
        d = (prog.float() - ref.float())
        r = ref.float()
        if mask is not None:
            m = mask.reshape(*mask.shape, *([1] * (d.ndim - mask.ndim))).to(d.dtype)
            d, r = d * m, r * m
        acc = self.sq.setdefault(name, [0.0, 0.0])
        acc[0] += float((d.double() ** 2).sum())
        acc[1] += float((r.double() ** 2).sum())

    def widest(self, name, value):
        self.max[name] = max(self.max.get(name, 0.0), float(value))

    def mismatches(self, name, n):
        self.count[name] = self.count.get(name, 0) + int(n)

    def values(self) -> dict:
        out = {k: math.sqrt(a / b) if b > 0 else math.inf for k, (a, b) in self.sq.items()}
        out.update(self.max)
        out.update(self.count)
        return out


def judge(values: dict, limits: dict) -> list:
    """[{name, value, limit, ok}] for every limit; a number missing or not
    finite fails."""
    out = []
    for name, limit in limits.items():
        v = values.get(name)
        ok = v is not None and math.isfinite(v) and v <= limit
        out.append({"name": name, "value": v, "limit": limit, "ok": bool(ok)})
    return out


def world_to_local(world, init_pos, init_h, center_xy, center_h):
    """World (x, y, heading) [B, N, T, 3] -> each agent's initial frame as
    (x, y, sin, cos) [B, N, T, 4]: the inverse of the program's world
    transform, so the reference reads what the program handed out."""
    xy_scene = rotate_2d(world[..., :2] - center_xy[:, None, None, :], -center_h[:, None, None])
    xy = rotate_2d(xy_scene - init_pos[..., None, :], -init_h[..., None])
    h = wrap_angle(world[..., 2] - center_h[:, None, None] - init_h[..., None])
    return torch.cat([xy, torch.sin(h)[..., None], torch.cos(h)[..., None]], dim=-1)


def step_gaps(gaps: Gaps, prog_traj, ref_out, mask, replan: int):
    """The program's trajectory against the reference's step by step:
    'step_rel' over each step's displacements from the state it started at,
    'step_max_m' the widest distance between a program point and the
    reference's, 'heading_max_rad' the widest heading gap."""
    segs, last = ref_out["segs"], ref_out["last"]  # [R, B, N, S, 4], [R, B, N, 4]
    R = segs.shape[0]
    B, N = prog_traj.shape[:2]
    prog = prog_traj.float().reshape(B, N, R, replan, 4).permute(2, 0, 1, 3, 4)
    d_ref = segs[..., :2] - last[..., None, :2]
    d_prog = prog[..., :2] - last[..., None, :2]
    diff = prog[..., :2] - segs[..., :2]
    m = mask[None, :, :, None, None]
    gaps.rel("step_rel", d_prog, d_ref, mask[None].expand(R, B, N))
    gaps.widest("step_max_m", torch.where(m, diff, 0.0).norm(dim=-1).max())
    dh = wrap_angle(torch.atan2(prog[..., 2], prog[..., 3]) - torch.atan2(segs[..., 2],
                                                                          segs[..., 3]))
    gaps.widest("heading_max_rad", torch.where(m[..., 0], dh.abs(), 0.0).max())
