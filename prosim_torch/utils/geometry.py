"""2D geometry primitives (port of prosim_tpu/utils/geometry.py)."""

import math

import torch


def wrap_angle(angle, min_val: float = -math.pi, max_val: float = math.pi):
    """Wrap angles into [min_val, max_val)."""
    return min_val + torch.remainder(angle + max_val, max_val - min_val)


def rotate_2d(xy, theta):
    """Rotate 2D points by theta (counter-clockwise). xy [..., 2], theta [...]."""
    c, s = torch.cos(theta), torch.sin(theta)
    x = xy[..., 0] * c - xy[..., 1] * s
    y = xy[..., 1] * c + xy[..., 0] * s
    return torch.stack([x, y], dim=-1)


def angle_between_2d_vectors(ctr_vector, nbr_vector):
    """Signed angle from ctr_vector to nbr_vector."""
    cross = ctr_vector[..., 0] * nbr_vector[..., 1] - ctr_vector[..., 1] * nbr_vector[..., 0]
    dot = (ctr_vector[..., :2] * nbr_vector[..., :2]).sum(dim=-1)
    return torch.atan2(cross, dot)


def heading_from_sincos(traj_sc):
    """Heading angle from (sin, cos) channels. traj_sc [..., 2] = (sin, cos)."""
    return torch.atan2(traj_sc[..., 0], traj_sc[..., 1])


def rel_traj_to_last_step(traj):
    """Re-center a (x, y, sin, cos) trajectory [..., T, 4] onto its last
    step's frame (position subtracted, rotated by -theta_last)."""
    theta = torch.atan2(traj[..., 2], traj[..., 3])  # [..., T]
    origin_xy = traj[..., -1:, :2]
    theta_last = theta[..., -1:]

    xy_off = rotate_2d(traj[..., :2] - origin_xy, -theta_last)
    theta_off = wrap_angle(theta - theta_last)
    return torch.cat(
        [xy_off, torch.sin(theta_off)[..., None], torch.cos(theta_off)[..., None]], dim=-1
    )


def rel_vel_to_last_step(traj, vel):
    """Rotate velocities into the frame of the trajectory's last step."""
    theta = torch.atan2(traj[..., 2], traj[..., 3])
    return rotate_2d(vel, -theta[..., -1:])


def integrate_delta_traj(delta_xy, delta_theta, last_xy, last_theta):
    """Integrate cumulative per-step deltas [..., S, 2] / [..., S] into the
    frame anchored at (last_xy, last_theta)."""
    xy = rotate_2d(delta_xy, last_theta[..., None]) + last_xy[..., None, :]
    theta = wrap_angle(last_theta[..., None] + delta_theta)
    return xy, theta


def transform_to_frame(points_xy, frame_xy, frame_theta):
    """Express world points in a local frame at (frame_xy, frame_theta)."""
    return rotate_2d(points_xy - frame_xy, -frame_theta)


def transform_from_frame(points_xy, frame_xy, frame_theta):
    """Express local-frame points in world coordinates."""
    return rotate_2d(points_xy, frame_theta) + frame_xy
