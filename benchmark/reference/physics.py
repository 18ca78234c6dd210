# Frozen copy of `drone2d_tpu_torch/ops/physics.py` at commit 012002a (the port's plain math);
# imports rewritten to this package, nothing of the port imported.
"""Rigid-body physics of the drone as one composite body, batch-first.

Counterpart of `drone2d_tpu/ops/physics.py`.  Chipmunk's position-first
symplectic Euler order is kept: the position moves with the PREVIOUS
velocity, then the velocity takes gravity and thrust; the thrust is turned
into the world frame with the pre-step angle.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.device import constant


@dataclasses.dataclass
class BodyState:
    pos: torch.Tensor    # (N, 2)
    vel: torch.Tensor    # (N, 2)
    angle: torch.Tensor  # (N,)
    omega: torch.Tensor  # (N,)


def thrust_forces(action: torch.Tensor, force_scale: float) -> torch.Tensor:
    """Action in [-1, 1]^2 -> rotor forces (drone_2d_env.py:400-401)."""
    return (action / 2.0 + 0.5) * force_scale


def step_body(
    body: BodyState,
    left_force: torch.Tensor,
    right_force: torch.Tensor,
    *,
    dt: float,
    gravity_y: float,
    mass: float,
    inertia: float,
    arm: float,
) -> BodyState:
    """One Chipmunk-order integration step; forces are (N,)."""
    total_thrust = left_force + right_force
    c, s = torch.cos(body.angle), torch.sin(body.angle)
    f_world = torch.stack([-s * total_thrust, c * total_thrust], dim=-1)
    torque = arm * (right_force - left_force)

    pos = body.pos + body.vel * dt
    angle = body.angle + body.omega * dt

    g = constant((0.0, gravity_y), body.vel)
    vel = body.vel + (g + f_world / mass) * dt
    omega = body.omega + (torque / inertia) * dt
    return BodyState(pos=pos, vel=vel, angle=angle, omega=omega)


def free_step_body(body: BodyState, *, dt: float, gravity_y: float) -> BodyState:
    """A force-free settle step (drone_2d_env.py:937-943)."""
    pos = body.pos + body.vel * dt
    angle = body.angle + body.omega * dt
    g = constant((0.0, gravity_y), body.vel)
    vel = body.vel + g * dt
    return BodyState(pos=pos, vel=vel, angle=angle, omega=body.omega)
