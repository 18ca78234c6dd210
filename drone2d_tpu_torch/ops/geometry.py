"""Drone-obstacle geometry for circle obstacles, batch-first.

Counterpart of the circles-only path of `drone2d_tpu/ops/geometry.py`: the
frame box's world corners, and the frame-box vs circle collision test
(Chipmunk's poly-circle narrow phase: contact iff the box SDF at the circle
center is below the radius).
"""

from __future__ import annotations

import torch

from drone2d_tpu_torch.ops.transforms import rotate


def frame_vertices(
    pos: torch.Tensor, angle: torch.Tensor, half_w: float, half_h: float
) -> torch.Tensor:
    """World corners of the frame box: pos (N, 2), angle (N,) -> (N, 4, 2)."""
    corners = pos.new_tensor(
        [[-half_w, -half_h], [-half_w, half_h], [half_w, half_h], [half_w, -half_h]]
    )
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
    q = local.abs() - pos.new_tensor([half_w, half_h])
    outside = torch.sqrt(torch.sum(torch.clamp(q, min=0.0) ** 2, dim=-1))
    inside = torch.clamp(torch.maximum(q[..., 0], q[..., 1]), max=0.0)
    hit = (outside + inside < radii) & mask
    return hit.any(dim=-1)
