# Frozen copy of `drone2d_tpu_torch/ops/geometry.py` at commit 012002a (the port's plain math);
# imports rewritten to this package, nothing of the port imported.
"""Drone-obstacle geometry, batch-first.

Counterpart of `drone2d_tpu/ops/geometry.py`: the frame box's world
corners, the frame-box vs circle collision test (Chipmunk's poly-circle
narrow phase: contact iff the box SDF at the circle center is below the
radius), and the rounded-box obstacles of `parallel_boxes`: their
vertex-sampled distances and the mixed circle/box collision test.
"""

from __future__ import annotations

import torch

from benchmark.reference.device import constant
from benchmark.reference.transforms import rotate


def frame_vertices(
    pos: torch.Tensor, angle: torch.Tensor, half_w: float, half_h: float
) -> torch.Tensor:
    """World corners of the frame box: pos (N, 2), angle (N,) -> (N, 4, 2)."""
    corners = constant(
        ((-half_w, -half_h), (-half_w, half_h), (half_w, half_h), (half_w, -half_h)), pos)
    return pos[:, None, :] + rotate(angle[:, None], corners[None])


def any_collision(
    pos: torch.Tensor,
    angle: torch.Tensor,
    half_w: float,
    half_h: float,
    centers: torch.Tensor,
    radii: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """(N,) bool: the frame box overlaps a live circle.

    pos (N, 2), angle (N,), centers (N, K, 2), radii and mask (N, K).
    """
    rel = centers - pos[:, None, :]
    local = rotate(-angle[:, None], rel)                  # world -> body
    q = local.abs() - constant((half_w, half_h), pos)
    outside = torch.sqrt(torch.sum(torch.clamp(q, min=0.0) ** 2, dim=-1))
    inside = torch.clamp(torch.maximum(q[..., 0], q[..., 1]), max=0.0)
    hit = (outside + inside < radii) & mask
    return hit.any(dim=-1)


# ---------------------------------------------------------------------------
# Box obstacles (reference obstacles.py:20-45 Square/Rectangle), as the JAX
# package models them: every obstacle is a ROUNDED axis-aligned box, the
# half-extents half_wh (N, K, 2) plus the radius r.  half_wh == 0 gives the
# circle formulas; r == 0 with half_wh > 0 a sharp Square/Rectangle.
# ---------------------------------------------------------------------------


def vertex_circle_distances(
    verts: torch.Tensor, centers: torch.Tensor, radii: torch.Tensor
) -> torch.Tensor:
    """Min over vertices of (|v - c| - r) for every circle: verts (N, V, 2),
    centers (N, K, 2), radii (N, K) -> (N, K) (drone_2d_env.py:953-961)."""
    d = verts[:, :, None, :] - centers[:, None, :, :]       # (N, V, K, 2)
    dist = torch.sqrt(torch.sum(d * d, dim=-1))             # (N, V, K)
    return (dist - radii[:, None, :]).min(dim=1).values


def box_circle_sdf(
    pos: torch.Tensor, angle: torch.Tensor, half_w: float, half_h: float,
    centers: torch.Tensor,
) -> torch.Tensor:
    """Signed distance from the rotated frame box to each circle center,
    negative inside: pos (N, 2), angle (N,), centers (N, K, 2) -> (N, K)."""
    rel = centers - pos[:, None, :]
    local = rotate(-angle[:, None], rel)                  # world -> body
    q = local.abs() - constant((half_w, half_h), pos)
    outside = torch.sqrt(torch.sum(torch.clamp(q, min=0.0) ** 2, dim=-1))
    inside = torch.clamp(torch.maximum(q[..., 0], q[..., 1]), max=0.0)
    return outside + inside


def point_aabb_sdf(points: torch.Tensor, centers: torch.Tensor,
                   half_wh: torch.Tensor) -> torch.Tensor:
    """Signed distance from each point to each axis-aligned box: points
    (N, V, 2), centers and half_wh (N, K, 2) -> (N, V, K).  half_wh == 0
    gives the point-to-center distance."""
    rel = points[:, :, None, :] - centers[:, None, :, :]    # (N, V, K, 2)
    q = rel.abs() - half_wh[:, None, :, :]
    outside = torch.sqrt(torch.sum(torch.clamp(q, min=0.0) ** 2, dim=-1))
    inside = torch.clamp(torch.maximum(q[..., 0], q[..., 1]), max=0.0)
    return outside + inside


def vertex_rounded_box_distances(
    verts: torch.Tensor, centers: torch.Tensor, half_wh: torch.Tensor,
    radii: torch.Tensor,
) -> torch.Tensor:
    """Min over the frame's vertices of (aabb_sdf - r) per obstacle -> (N, K):
    the observation's vertex-sampled metric for rounded boxes; with
    half_wh == 0 it equals `vertex_circle_distances`."""
    d = point_aabb_sdf(verts, centers, half_wh) - radii[:, None, :]
    return d.min(dim=1).values


def any_collision_mixed(
    pos: torch.Tensor,
    angle: torch.Tensor,
    half_w: float,
    half_h: float,
    centers: torch.Tensor,
    radii: torch.Tensor,
    half_wh: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """(N,) bool: the frame box overlaps a live obstacle of a mixed field.

    A circle (half_wh == 0) takes the narrow phase of `any_collision`.  A
    box takes a separating-axis test over 4 axes (the 2 world axes of the
    box, the 2 body axes of the frame): exact for sharp boxes (r == 0); a
    radius widens the box's extents, exact on faces and slightly
    conservative at corners.  The projections are written as elementwise
    sums, not matrix products, so that they round alike on every device.
    """
    is_box = (half_wh > 0.0).any(dim=-1)                            # (N, K)
    circle_hit = box_circle_sdf(pos, angle, half_w, half_h, centers) < radii

    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    ax = torch.stack([one, zero, c, -s], dim=-1)                    # (N, 4)
    ay = torch.stack([zero, one, s, c], dim=-1)
    delta = centers - pos[:, None, :]                               # (N, K, 2)
    proj_d = (delta[..., 0:1] * ax[:, None, :] + delta[..., 1:2] * ay[:, None, :]).abs()
    # the frame's extent on each axis: |u.a| half_w + |v.a| half_h
    ext_drone = ((ax * c[:, None] + ay * s[:, None]).abs() * half_w
                 + (ax * -s[:, None] + ay * c[:, None]).abs() * half_h)  # (N, 4)
    # the box's: hw |a_x| + hh |a_y| + r
    ext_box = (half_wh[..., 0:1] * ax[:, None, :].abs()
               + half_wh[..., 1:2] * ay[:, None, :].abs()
               + radii[..., None])                                  # (N, K, 4)
    box_hit = (proj_d < ext_drone[:, None, :] + ext_box).all(dim=-1)
    hit = torch.where(is_box, box_hit, circle_hit) & mask
    return hit.any(dim=-1)
