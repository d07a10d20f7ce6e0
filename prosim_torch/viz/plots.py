"""Scene / rollout visualization (port of prosim_tpu/viz/plots.py).

Matplotlib plotting equivalent to the reference demo API
(reference: prosim/demo/vis.py:19-569, models/utils/visualization.py:31-301):
scene map + agent boxes + GT futures + rollout trajectories + prompt markers
(goals, drag points), all in the scene frame of a formatted SceneBatch.
Host code: tensors (on any device) come to numpy first, and matplotlib
(Agg backend) is imported when a figure is drawn, on a host that has it.
"""

from typing import Dict, Optional

import numpy as np
import torch

from prosim_torch.data.batch import SceneBatch

AGENT_COLORS = {1: "#1f77b4", 2: "#2ca02c", 3: "#ff7f0e"}  # veh / ped / cyc


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _box_corners(xy, heading, extent):
    l, w = extent[0] / 2, extent[1] / 2
    local = np.array([[l, w], [l, -w], [-l, -w], [-l, w]])
    c, s = np.cos(heading), np.sin(heading)
    R = np.array([[c, -s], [s, c]])
    return local @ R.T + xy


def plot_scene(
    batch: SceneBatch,
    bidx: int = 0,
    output: Optional[Dict] = None,
    show_gt: bool = True,
    show_goals: bool = False,
    ax=None,
    xlim=(-120, 120),
    ylim=(-120, 120),
):
    """Plot one scene (map + agents) with optional rollout overlay.

    Returns the matplotlib figure.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=(9, 9))
    else:
        fig = ax.figure

    # map: plot lane segments in the scene frame (undo per-lane sym frames)
    mv = _np(batch.init_map.vectors[bidx])
    mm = _np(batch.init_map.mask[bidx])
    mp = _np(batch.init_map.pos[bidx])
    mo = _np(batch.init_map.ori[bidx])
    for li in np.nonzero(mm.any(-1))[0]:
        seg = mv[li][mm[li]]
        c, s = np.cos(mo[li]), np.sin(mo[li])
        R = np.array([[c, -s], [s, c]])
        start = seg[:, 0:2] @ R.T + mp[li]
        end = seg[:, 2:4] @ R.T + mp[li]
        is_center = seg[:, 4] == 1
        color = "#cccccc" if is_center.any() else "#999999"
        for a, b in zip(start, end):
            ax.plot([a[0], b[0]], [a[1], b[1]], color=color, lw=0.5, zorder=0)

    pmask = _np(batch.prompt.mask[bidx])
    pos = _np(batch.prompt.pos[bidx])
    ori = _np(batch.prompt.ori[bidx])
    ext = _np(batch.prompt.extent[bidx])
    types = _np(batch.prompt.agent_type[bidx])

    for n in np.nonzero(pmask)[0]:
        corners = _box_corners(pos[n], ori[n], ext[n])
        ax.fill(
            corners[:, 0], corners[:, 1],
            color=AGENT_COLORS.get(int(types[n]), "#555"), alpha=0.8, zorder=3,
        )

    if show_gt and batch.io_pairs is not None:
        gt = _np(batch.io_pairs.full_traj_xy[bidx])
        gv = _np(batch.io_pairs.full_traj_valid[bidx])
        for n in np.nonzero(pmask)[0]:
            if not gv[n].any():
                continue
            # GT is in each agent's local frame; rotate out
            c, s = np.cos(ori[n]), np.sin(ori[n])
            R = np.array([[c, -s], [s, c]])
            world = gt[n][gv[n]] @ R.T + pos[n]
            ax.plot(world[:, 0], world[:, 1], color="#aaaaaa", lw=1.0, zorder=1)

    if output is not None:
        traj = _np(output["rollout_traj"][bidx])
        init_pos = _np(output["init_pos"][bidx])
        init_h = _np(output["init_heading"][bidx])
        for n in np.nonzero(pmask)[0]:
            c, s = np.cos(init_h[n]), np.sin(init_h[n])
            R = np.array([[c, -s], [s, c]])
            world = traj[n, :, :2] @ R.T + init_pos[n]
            ax.plot(world[:, 0], world[:, 1],
                    color=AGENT_COLORS.get(int(types[n]), "#555"), lw=1.5, zorder=2)

    if show_goals:
        goals = _np(batch.prompt.goal_point[bidx])
        ax.scatter(goals[pmask, 0], goals[pmask, 1], marker="*", s=80,
                   color="#d62728", zorder=4)

    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    ax.set_axis_off()
    return fig


def save_scene_png(batch, path, **kwargs):
    fig = plot_scene(batch, **kwargs)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path

def save_rollout_gif(batch, output, path, bidx=0, stride=2, fps=10, **kwargs):
    """Animate a closed-loop rollout as a GIF (reference wandb gif logging,
    models/utils/visualization.py:303-329): map + GT futures stay static,
    agent boxes move along the rolled-out trajectory."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    fig = plot_scene(batch, bidx=bidx, output=None, **kwargs)
    ax = fig.axes[0]

    pmask = _np(batch.prompt.mask[bidx])
    types = _np(batch.prompt.agent_type[bidx])
    ext = _np(batch.prompt.extent[bidx])
    traj = _np(output["rollout_traj"][bidx])      # [N, T, 4]
    init_pos = _np(output["init_pos"][bidx])
    init_h = _np(output["init_heading"][bidx])

    agents = np.nonzero(pmask)[0]
    world, heading = {}, {}
    for n in agents:
        c, s = np.cos(init_h[n]), np.sin(init_h[n])
        R = np.array([[c, -s], [s, c]])
        world[n] = traj[n, :, :2] @ R.T + init_pos[n]
        heading[n] = init_h[n] + np.arctan2(traj[n, :, 2], traj[n, :, 3])

    patches = {
        n: ax.fill(
            [], [], color=AGENT_COLORS.get(int(types[n]), "#555"),
            alpha=0.9, zorder=5,
        )[0]
        for n in agents
    }
    frames = range(0, traj.shape[1], stride)

    def update(t):
        for n in agents:
            corners = _box_corners(world[n][t], heading[n][t], ext[n])
            patches[n].set_xy(corners)
        return list(patches.values())

    anim = FuncAnimation(fig, update, frames=frames, blit=True)
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return path

def plot_goal_heatmap(batch, goal_point, goal_prob, path, bidx=0, agent=0,
                      sigma=8.0, bins=200, **kwargs):
    """Heatmap of an agent's predicted K-goal distribution over the scene
    (reference: models/utils/visualization.py:22-115
    vis_scene_goal_pred_heatmap). goal_point [B, N, K, 2] in the agent frame,
    goal_prob [B, N, K]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.ndimage import gaussian_filter

    fig = plot_scene(batch, bidx=bidx, **kwargs)
    ax = fig.axes[0]

    ori = float(_np(batch.prompt.ori[bidx, agent]))
    pos = _np(batch.prompt.pos[bidx, agent])
    c, s = np.cos(ori), np.sin(ori)
    R = np.array([[c, -s], [s, c]])
    pts = _np(goal_point[bidx, agent]) @ R.T + pos  # [K, 2] scene frame
    prob = _np(goal_prob[bidx, agent])
    prob = np.exp(prob - prob.max())
    prob = prob / prob.sum()

    lim = ax.get_xlim()
    hm, xe, ye = np.histogram2d(
        pts[:, 0], pts[:, 1], bins=bins,
        range=[ax.get_xlim(), ax.get_ylim()], weights=prob,
    )
    hm = gaussian_filter(hm.T, sigma=sigma)
    ax.imshow(
        hm, extent=(*ax.get_xlim(), *ax.get_ylim()), origin="lower",
        cmap="jet", alpha=0.5, zorder=6,
    )
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def agent_color_map(agent_ids, cmap_name: str = "tab20"):
    """Stable distinct color per agent slot (reference:
    prosim_demo/text_prompt_inference.ipynb `obtain_agent_name_to_color`)."""
    import matplotlib

    cm = matplotlib.colormaps[cmap_name]
    return {int(a): cm(i % cm.N) for i, a in enumerate(agent_ids)}


def plot_batch_prompts(batch: SceneBatch, bidx: int = 0, ax=None,
                       texts: Optional[list] = None, **kwargs):
    """Overlay every prompt condition on the scene (reference:
    prosim/demo/vis.py plot_batch_prompts): goal stars, drag-point sketch
    paths, per-agent action-tag labels, pair-tag arrows, and the text prompt
    as the title. Agent-frame condition features are rotated out into the
    scene frame."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plot_scene(batch, bidx=bidx, ax=ax, **kwargs)
    ax = fig.axes[0]

    pos = _np(batch.prompt.pos[bidx])
    ori = _np(batch.prompt.ori[bidx])
    conds = batch.conditions or {}

    def to_scene(n, xy):
        c, s = np.cos(ori[n]), np.sin(ori[n])
        return xy @ np.array([[c, -s], [s, c]]).T + pos[n]

    colors = agent_color_map(range(pos.shape[0]))

    c = conds.get("goal")
    if c is not None and not isinstance(c, dict):
        feat = _np(c.feat[bidx])
        mask = _np(c.mask[bidx])
        pidx = _np(c.prompt_idx[bidx])
        for ci in np.nonzero(mask)[0]:
            n = int(pidx[ci, 0])
            g = to_scene(n, feat[ci, :2][None])[0]
            ax.scatter([g[0]], [g[1]], marker="*", s=140, zorder=6,
                       color=colors[n], edgecolors="black", linewidths=0.5)

    c = conds.get("drag_point")
    if c is not None and not isinstance(c, dict):
        feat = _np(c.feat[bidx])
        mask = _np(c.mask[bidx])
        pidx = _np(c.prompt_idx[bidx])
        for ci in np.nonzero(mask)[0]:
            n = int(pidx[ci, 0])
            pts = feat[ci].reshape(-1, 2)
            pts = pts[~np.isnan(pts).any(-1)]
            if len(pts) == 0:
                continue
            w = to_scene(n, pts)
            ax.plot(w[:, 0], w[:, 1], ls=":", lw=2.0, marker="o", ms=4,
                    color=colors[n], zorder=6)

    c = conds.get("v_action_tag")
    if c is not None and not isinstance(c, dict):
        from prosim_torch.data.motion_tags import VActionTag

        feat = _np(c.feat[bidx])
        mask = _np(c.mask[bidx])
        pidx = _np(c.prompt_idx[bidx])
        for ci in np.nonzero(mask)[0]:
            n = int(pidx[ci, 0])
            tid = int(feat[ci, 0])
            if not any(t.value == tid for t in VActionTag):
                continue  # padded / malformed row
            ax.annotate(VActionTag(tid).name, pos[n],
                        textcoords="offset points",
                        xytext=(6, 6), fontsize=7, color=colors[n], zorder=7)

    c = conds.get("v2v_tag")
    if c is not None and not isinstance(c, dict):
        from prosim_torch.data.motion_tags import V2VTag

        feat = _np(c.feat[bidx])
        mask = _np(c.mask[bidx])
        pidx = _np(c.prompt_idx[bidx])
        for ci in np.nonzero(mask)[0]:
            a, b = int(pidx[ci, 0]), int(pidx[ci, 1])
            tid = int(feat[ci, 0])
            if a < 0 or b < 0 or not any(t.value == tid for t in V2VTag):
                continue
            tag = V2VTag(tid).name
            ax.annotate(
                "", xy=pos[b], xytext=pos[a], zorder=7,
                arrowprops=dict(arrowstyle="->", color=colors[a], lw=1.5),
            )
            mid = (pos[a] + pos[b]) / 2
            ax.annotate(tag, mid, fontsize=7, color=colors[a], zorder=7)

    if texts:
        ax.set_title(texts[bidx] if bidx < len(texts) else texts[0],
                     fontsize=8, wrap=True)
    return fig


def plot_model_output(batch: SceneBatch, output: Dict, bidx: int = 0,
                      label_agents: bool = True, **kwargs):
    """Rollout overlay with per-agent distinct colors and slot labels
    (reference: prosim/demo/vis.py plot_model_output)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plot_scene(batch, bidx=bidx, output=None, **kwargs)
    ax = fig.axes[0]

    pmask = _np(batch.prompt.mask[bidx])
    traj = _np(output["rollout_traj"][bidx])
    init_pos = _np(output["init_pos"][bidx])
    init_h = _np(output["init_heading"][bidx])
    colors = agent_color_map(range(pmask.shape[0]))

    for n in np.nonzero(pmask)[0]:
        c, s = np.cos(init_h[n]), np.sin(init_h[n])
        world = traj[n, :, :2] @ np.array([[c, -s], [s, c]]).T + init_pos[n]
        ax.plot(world[:, 0], world[:, 1], color=colors[int(n)], lw=1.8, zorder=4)
        ax.scatter([world[-1, 0]], [world[-1, 1]], s=16, color=colors[int(n)],
                   zorder=5)
        if label_agents:
            ax.annotate(f"A{int(n)}", world[0], fontsize=7,
                        color=colors[int(n)], zorder=7,
                        textcoords="offset points", xytext=(4, -8))
    return fig


def plot_full_map(scene, ax=None, show_ids: bool = False,
                  color_center: str = "#bbbbbb", color_edge: str = "#777777"):
    """Whole-scene vector map in world coordinates from a SceneData
    (reference: prosim/demo/vis.py plot_full_map): lane centerlines +
    left/right boundaries, optional lane-id labels."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=(10, 10))
    else:
        fig = ax.figure
    if scene.map is None:
        return fig
    for lane in scene.map.lanes:
        c = _np(lane.center)
        if len(c) >= 2:
            ax.plot(c[:, 0], c[:, 1], color=color_center, lw=0.6, zorder=0)
        for edge in (lane.left_edge, lane.right_edge):
            if edge is not None and len(edge) >= 2:
                e = _np(edge)
                ax.plot(e[:, 0], e[:, 1], color=color_edge, lw=0.4, zorder=0)
        if show_ids and len(c):
            ax.annotate(str(lane.lane_id), c[len(c) // 2], fontsize=5,
                        color="#444444")
    ax.set_aspect("equal")
    ax.set_axis_off()
    return fig


def save_comparison_png(batch: SceneBatch, output: Dict, path: str,
                        bidx: int = 0, **kwargs):
    """Side-by-side GT (log-replay) vs closed-loop rollout panels
    (reference: models/utils/visualization.py comparison figures)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(16, 8))
    plot_scene(batch, bidx=bidx, output=None, show_gt=True, ax=axes[0], **kwargs)
    axes[0].set_title("logged future", fontsize=10)
    plot_model_output(batch, output, bidx=bidx, ax=axes[1], show_gt=False, **kwargs)
    axes[1].set_title("closed-loop rollout", fontsize=10)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
