"""Offroad and collision losses (port of prosim_tpu/train/safety_losses.py).

Equivalents of the reference's safety losses
(reference: prosim/loss/loss_func.py:617-1383, loss/offroad_loss.py:55-203):

  offroad   - signed distance from rollout bounding-box corners to road-edge
              polylines (positive = outside the drivable area, using the
              Waymo convention that road edges are oriented with the road on
              their left); hinge on positive distances.
  collision - separating-axis signed distance between oriented boxes of
              top-K nearest agent pairs (SAT penetration depth is exact for
              overlaps, which is the regime the hinge penalizes).

Dense padded tensors throughout; the JAX package's per-scene vmaps are a
leading scene axis here.
"""

import torch
import torch.nn.functional as F

from prosim_torch.parallel.mesh import global_count
from prosim_torch.utils.geometry import rotate_2d


def _segment_distance(p, a, b):
    """p [B, M, 2] points, a/b [B, E, 2] segment ends -> distances [B, M, E]
    and the segment vectors ab."""
    q = p[:, :, None, :]
    a, ab = a[:, None], (b - a)[:, None]
    ab_len2 = (ab * ab).sum(-1).clamp_min(1e-9)
    t = (((q - a) * ab).sum(-1) / ab_len2).clamp(0.0, 1.0)
    proj = a + t[..., None] * ab
    return torch.linalg.vector_norm(q - proj, dim=-1)


def signed_distance_to_edges(points, edge_pts, edge_next, edge_valid):
    """Signed distance from points to oriented edge segments.

    points [B, *, 2]; edge_pts/edge_next [B, E, 2] segment start/end;
    edge_valid [B, E]. Positive = right of the edge direction (off-road for
    Waymo-oriented edges). Distance is to the nearest valid segment.
    """
    B = points.shape[0]
    lead = points.shape[1:-1]
    p = points.reshape(B, -1, 2)
    dist = _segment_distance(p, edge_pts, edge_next)  # [B, M, E]
    dist = torch.where(edge_valid[:, None], dist, torch.inf)
    d_min, nearest = dist.min(dim=-1)  # [B, M]

    gather = lambda t: t.gather(1, nearest[..., None].expand(B, nearest.shape[1], 2))
    a_n = gather(edge_pts)
    ab_n = gather(edge_next - edge_pts)
    p_off = p - a_n
    cross = ab_n[..., 0] * p_off[..., 1] - ab_n[..., 1] * p_off[..., 0]
    sign = torch.where(cross < 0, 1.0, -1.0)  # right of edge -> positive (offroad)
    out = torch.where(torch.isfinite(d_min), sign * d_min, 0.0)
    return out.reshape(B, *lead)


def box_corners(xy, heading, extent):
    """xy [*, 2], heading [*], extent [*, 2] -> corners [*, 4, 2]."""
    l, w = extent[..., 0] / 2, extent[..., 1] / 2
    local = torch.stack(
        [
            torch.stack([l, w], -1),
            torch.stack([l, -w], -1),
            torch.stack([-l, -w], -1),
            torch.stack([-l, w], -1),
        ],
        dim=-2,
    )  # [*, 4, 2]
    return rotate_2d(local, heading[..., None]) + xy[..., None, :]


def _centerline_distance(xy, seg_pts, seg_next, seg_valid):
    """xy [B, N, T, 2] -> distance to the nearest valid segment [B, N, T]
    (0 where a scene has none)."""
    B, N, T, _ = xy.shape
    d = _segment_distance(xy.reshape(B, -1, 2), seg_pts, seg_next)
    d = torch.where(seg_valid[:, None], d, torch.inf).amin(dim=-1).reshape(B, N, T)
    return torch.where(torch.isfinite(d), d, 0.0)


def offroad_loss_centerline(
    traj_xyh,      # [B, N, T, 3] scene frame
    extents,       # [B, N, 2]
    agent_mask,    # [B, N]
    seg_pts,       # [B, E, 2] lane CENTER segment starts
    seg_next,      # [B, E, 2]
    seg_valid,     # [B, E]
    t_sample: int = 10,
    margin: float = 3.0,
    gt_traj_xyh=None,  # [B, N, T, 3] logged trajectory for GT-offroad masking
):
    """Fallback offroad penalty when dedicated road-edge data is absent:
    hinge on (distance to the nearest lane centerline - margin). GT traffic
    stays within ~half a lane of some centerline, so this is zero on logged
    trajectories while penalizing rollouts that leave the road network."""
    dmin = _centerline_distance(traj_xyh[..., ::t_sample, :2], seg_pts, seg_next, seg_valid)
    pen = F.relu(dmin - margin)
    valid = agent_mask[..., None].expand(pen.shape)
    if gt_traj_xyh is not None:
        # skip agents whose LOGGED trajectory already leaves the mapped road
        # network (parking lots etc.) - reference OFFROAD_TGT_MODE semantics
        gt_d = _centerline_distance(gt_traj_xyh[..., ::t_sample, :2], seg_pts, seg_next,
                                    seg_valid)
        gt_on_road = (gt_d <= margin).all(dim=-1)  # [B, N]
        valid = valid & gt_on_road[..., None]
    return torch.where(valid, pen, 0.0).sum() / global_count(valid)


def offroad_loss(
    traj_xyh,        # [B, N, T, 3] scene-frame rollout (x, y, heading)
    extents,         # [B, N, 2]
    agent_mask,      # [B, N]
    edge_pts,        # [B, E, 2] road-edge segment starts (scene frame)
    edge_next,       # [B, E, 2] segment ends
    edge_valid,      # [B, E]
    gt_offroad=None, # [B, N] optional: skip agents whose GT is already offroad
    t_sample: int = 10,
    margin: float = 0.0,
):
    """Hinge on max corner signed distance (reference: loss_func.py:788-1010)."""
    xy = traj_xyh[..., ::t_sample, :2]
    h = traj_xyh[..., ::t_sample, 2]
    corners = box_corners(xy, h, extents[..., None, :])  # [B, N, Ts, 4, 2]
    sd = signed_distance_to_edges(corners, edge_pts, edge_next, edge_valid)  # [B,N,Ts,4]
    worst = sd.amax(dim=-1)  # [B, N, Ts] most-offroad corner
    pen = F.relu(worst + margin)
    valid = agent_mask[..., None].expand(pen.shape)
    if gt_offroad is not None:
        valid = valid & ~gt_offroad[..., None]
    return torch.where(valid, pen, 0.0).sum() / global_count(valid)


def _sat_signed_distance(xy_a, h_a, ext_a, xy_b, h_b, ext_b):
    """Separating-axis signed distance between two oriented boxes.

    Negative = penetration (exact depth); positive = lower bound on the true
    separation. Shapes broadcast over leading dims.
    """
    axes = []
    for hh in (h_a, h_b):
        c, s = torch.cos(hh), torch.sin(hh)
        axes.append(torch.stack([c, s], -1))
        axes.append(torch.stack([-s, c], -1))
    d = xy_b - xy_a

    seps = []
    for ax in axes:
        center = (d * ax).sum(-1).abs()
        ra = (
            (torch.stack([torch.cos(h_a), torch.sin(h_a)], -1) * ax).sum(-1).abs() * ext_a[..., 0] / 2
            + (torch.stack([-torch.sin(h_a), torch.cos(h_a)], -1) * ax).sum(-1).abs() * ext_a[..., 1] / 2
        )
        rb = (
            (torch.stack([torch.cos(h_b), torch.sin(h_b)], -1) * ax).sum(-1).abs() * ext_b[..., 0] / 2
            + (torch.stack([-torch.sin(h_b), torch.cos(h_b)], -1) * ax).sum(-1).abs() * ext_b[..., 1] / 2
        )
        seps.append(center - ra - rb)
    return torch.stack(seps, -1).amax(-1)


def collision_loss(
    traj_xyh,       # [B, N, T, 3] scene frame
    extents,        # [B, N, 2]
    agent_mask,     # [B, N]
    agent_types=None,
    k: int = 4,
    t_sample: int = 10,
    threshold: float = 0.0,
    vehicle_only: bool = True,
    gt_traj_xyh=None,  # [B, N, T, 3] logged trajectories for GT masking
):
    """Hinge on SAT distance to the K nearest neighbors at sampled steps
    (reference: loss_func.py:1012-1383). Pairs that collide in the LOGGED
    data (parked cars measured as overlapping, annotation noise) are skipped
    when gt_traj_xyh is given."""
    xy = traj_xyh[..., ::t_sample, :2]   # [B, N, Ts, 2]
    h = traj_xyh[..., ::t_sample, 2]
    B, N, Ts, _ = xy.shape

    mask = agent_mask
    if vehicle_only and agent_types is not None:
        mask = mask & (agent_types == 1)

    # K nearest by first-step distance (static K), ties to the lower index
    # as lax.top_k
    d0 = torch.linalg.vector_norm(xy[:, :, None, 0] - xy[:, None, :, 0], dim=-1)  # [B,N,N]
    eye = torch.eye(N, dtype=torch.bool, device=xy.device)
    pair_ok = mask[:, :, None] & mask[:, None, :] & ~eye[None]
    d0 = torch.where(pair_ok, d0, torch.inf)
    k_eff = min(k, N - 1) if N > 1 else 1
    neg_sorted, order = torch.sort(-d0, dim=-1, descending=True, stable=True)
    nbr = order[..., :k_eff]                 # [B, N, K]
    nbr_ok = neg_sorted[..., :k_eff] > -torch.inf

    def gather(arr, idx):
        # arr [B, N, ...], idx [B, N, K] -> [B, N, K, ...]
        tail = arr.shape[2:]
        flat = idx.reshape(B, -1)
        out = arr.gather(1, flat.reshape(B, -1, *([1] * len(tail))).expand(B, flat.shape[1], *tail))
        return out.reshape(B, N, idx.shape[-1], *tail)

    xy_n = gather(xy, nbr)       # [B, N, K, Ts, 2]
    h_n = gather(h, nbr)         # [B, N, K, Ts]
    ext_n = gather(extents, nbr) # [B, N, K, 2]

    sd = _sat_signed_distance(
        xy[:, :, None], h[:, :, None], extents[:, :, None, None, :],
        xy_n, h_n, ext_n[:, :, :, None, :],
    )  # [B, N, K, Ts]

    pen = F.relu(threshold - sd)
    valid = (mask[:, :, None] & nbr_ok)[..., None].expand(pen.shape)
    if gt_traj_xyh is not None:
        gxy = gt_traj_xyh[..., ::t_sample, :2]
        gh = gt_traj_xyh[..., ::t_sample, 2]
        gsd = _sat_signed_distance(
            gxy[:, :, None], gh[:, :, None], extents[:, :, None, None, :],
            gather(gxy, nbr), gather(gh, nbr), ext_n[:, :, :, None, :],
        )
        valid = valid & ~((threshold - gsd) > 0).any(dim=-1, keepdim=True)
    return torch.where(valid, pen, 0.0).sum() / global_count(valid)
