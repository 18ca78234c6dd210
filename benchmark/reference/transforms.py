# Frozen copy of `drone2d_tpu_torch/ops/transforms.py` at commit 012002a (the port's plain math);
# imports rewritten to this package, nothing of the port imported.
"""SO(2) frame math (counterpart of `drone2d_tpu/ops/transforms.py`)."""

from __future__ import annotations

import math

import torch


def ssa(angle: torch.Tensor) -> torch.Tensor:
    """Smallest signed angle, wrapped to [-pi, pi).

    `%` on tensors is `torch.remainder` (sign of the divisor), the semantics
    of `jnp`'s `%`; `torch.fmod` would differ for negative angles.
    """
    return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


def rotate(theta: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 2-vectors `v[..., 2]` by `theta` (broadcast against v[..., 0])."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def m1to1(value, lo, hi):
    """Normalize [lo, hi] -> [-1, 1] (drone_2d_env.py:972-974)."""
    return 2.0 * (value - lo) / (hi - lo) - 1.0


def invm1to1(value, lo, hi):
    """Inverse of m1to1 (drone_2d_env.py:976-978)."""
    return (value + 1.0) * (hi - lo) / 2.0 + lo
