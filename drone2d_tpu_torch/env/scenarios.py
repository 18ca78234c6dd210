"""Curriculum geometry drawn per episode, batched over envs.

Counterpart of the device half of `drone2d_tpu/env/scenarios.py`: the
random-corner waypoint chain (predef_path.py:307-363), the near-/on-path
obstacle sampler (obstacles.py:58-89) and the global_step -> stage schedule
(drone_2d_env.py:324-373).  Draws come from a `torch.Generator`, so they
follow the JAX package's distributions but not its bits.
"""

from __future__ import annotations

import math

import torch

from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.ops import path as tpath

# stage schedule (drone_2d_env.py:326-362), half-open intervals
STAGE_BOUNDS = (700_000, 1_000_000, 1_600_000, 2_000_000)


def stage_from_step(global_step: torch.Tensor) -> torch.Tensor:
    """Curriculum stage 1..5 from the float32 global env-step count."""
    s = torch.as_tensor(global_step, dtype=torch.float32)
    bounds = torch.tensor(STAGE_BOUNDS, dtype=torch.float32, device=s.device)
    return (1 + (s[..., None] >= bounds).sum(dim=-1)).to(torch.int32)


def stage3_spawn_chance(global_step: torch.Tensor) -> torch.Tensor:
    """Linear 0.2 -> 0.6 over [1.0M, 1.6M] (drone_2d_env.py:336-343)."""
    s = torch.as_tensor(global_step, dtype=torch.float32)
    return torch.clamp((s - 1.0e6) * (0.6 - 0.2) / 0.6e6 + 0.2, 0.2, 0.6)


def stage4_spawn_chance(global_step: torch.Tensor) -> torch.Tensor:
    """Linear 0.6 -> 1.0 over [1.6M, 2.0M] (drone_2d_env.py:348-357)."""
    s = torch.as_tensor(global_step, dtype=torch.float32)
    return torch.clamp((s - 1.6e6) * (1.0 - 0.6) / 0.4e6 + 0.6, 0.6, 1.0)


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def random_corner_waypoints(
    gen: torch.Generator, cfg: EnvConfig, num_envs: int, device
) -> torch.Tensor:
    """Random waypoint chains from random screen corners -> (N, max_wps, 2).

    Corner indices: 1=DL, 2=DR, 3=UL, 4=UR; live count is cfg.n_wps and the
    padding repeats the last live waypoint.
    """
    w, h, W = cfg.screensize_x, cfg.screensize_y, cfg.max_wps
    if cfg.random_path_spawn:
        lo, hi = cfg.spawn_corners
        corner = torch.randint(lo, hi + 1, (num_envs,), generator=gen, device=device)
    else:
        corner = torch.full((num_envs,), 2, device=device)  # 'DR'
    right = (corner == 2) | (corner == 4)
    up = (corner == 3) | (corner == 4)
    x1 = torch.where(right, w - 180.0, 100.0) + torch.rand(
        num_envs, generator=gen, device=device) * 80.0
    y1 = torch.where(up, h - 180.0, 100.0) + torch.rand(
        num_envs, generator=gen, device=device) * 80.0
    az_lo = torch.tensor([0.0, math.pi / 2, -math.pi / 2, -math.pi],
                         device=device)[corner - 1]
    az = az_lo[:, None] + torch.rand(
        (num_envs, W - 1), generator=gen, device=device) * (math.pi / 2)
    live = torch.arange(W - 1, device=device) < (cfg.n_wps - 1)
    steps = cfg.path_segment_length * torch.stack([torch.cos(az), torch.sin(az)], -1)
    steps = torch.where(live[None, :, None], steps, torch.zeros_like(steps))
    first = torch.stack([x1, y1], dim=-1)[:, None]
    return torch.cat([first, first + tpath.cumsum(steps, dim=1)], dim=1)


def _sample_near_path_obstacle(
    gen, pd: tpath.PathData, count: int, std: float, attempts: int,
    r_min: float, r_max: float,
):
    """`count` near-path obstacles per env by rejection sampling
    (obstacles.py:63-81): u ~ U(0.2L, 0.9L), lateral offset ~ N(0, std),
    radius ~ U(r_min, r_max); accept when |offset| > radius + 10.  Of a fixed
    number of attempts the first accepted one wins; if none is accepted the
    last draw's offset is pushed just outside the margin.

    Returns xy (N, count, 2), r (N, count).
    """
    N, dev = pd.length.shape[0], pd.length.device
    shape = (N, count, attempts)
    L = pd.length[:, None, None]
    u = _uniform(gen, shape, 0.2 * L, 0.9 * L, dev)
    dist = std * torch.randn(shape, generator=gen, device=dev)
    size = _uniform(gen, shape, r_min, r_max, dev)

    flat_u = u.reshape(N, count * attempts)
    base = tpath.path_point(pd, flat_u).reshape(N, count, attempts, 2)
    pa = tpath.direction_angle(pd, flat_u).reshape(shape) - math.pi / 2
    normal = torch.stack([torch.cos(pa), torch.sin(pa)], dim=-1)

    accept = dist.abs() > size + 10.0
    first = torch.argmax(accept.to(torch.uint8), dim=-1, keepdim=True)
    got_one = accept.any(dim=-1, keepdim=True)
    i = torch.where(got_one, first, torch.full_like(first, attempts - 1))
    d_sel = torch.gather(dist, 2, i)
    s_sel = torch.gather(size, 2, i)
    sign = torch.where(d_sel < 0, -1.0, 1.0)
    d_final = torch.where(got_one, d_sel, sign * (s_sel + 11.0))
    i2 = i[..., None].expand(-1, -1, -1, 2)
    pos = torch.gather(base, 2, i2) + d_final[..., None] * torch.gather(normal, 2, i2)
    return pos[:, :, 0], s_sel[:, :, 0]


def _sample_on_path_obstacle(gen, pd: tpath.PathData, r_min: float, r_max: float):
    """One obstacle per env placed on the path (obstacles.py:82-85)."""
    N, dev = pd.length.shape[0], pd.length.device
    u = _uniform(gen, (N,), 0.2 * pd.length, 0.9 * pd.length, dev)
    size = _uniform(gen, (N,), r_min, r_max, dev)
    return tpath.path_point(pd, u), size


def curriculum_obstacles(
    gen: torch.Generator,
    cfg: EnvConfig,
    pd: tpath.PathData,
    stage: torch.Tensor,
    global_step: torch.Tensor,
):
    """Stage-dependent obstacle field (drone_2d_env.py:326-372).

    stage (N,) int; global_step float32 (N,), -1 for a forced stage.  Layout:
    slots [0, max_curriculum_obs) near-path candidates, the next slot
    on-path, the rest padding.  Returns xy (N, max_obs, 2), r and mask
    (N, max_obs).
    """
    m = cfg.max_curriculum_obs
    N, dev = pd.length.shape[0], pd.length.device
    near_xy, near_r = _sample_near_path_obstacle(
        gen, pd, m, 100.0, cfg.obstacle_attempts,
        cfg.obstacle_radius_min, cfg.obstacle_radius_max,
    )
    on_xy, on_r = _sample_on_path_obstacle(
        gen, pd, cfg.obstacle_radius_min, cfg.obstacle_radius_max
    )

    forced = global_step < 0
    chance3 = torch.where(forced, 0.6, stage3_spawn_chance(global_step))
    chance4 = torch.where(forced, 1.0, stage4_spawn_chance(global_step))
    b3 = torch.rand(N, generator=gen, device=dev) < chance3
    b4 = torch.rand(N, generator=gen, device=dev) < chance4

    # stage 5: n ~ N(1, 4); -3<n<0 -> 1; n<-3 -> 0; else ceil(n)
    n5 = 1.0 + 4.0 * torch.randn(N, generator=gen, device=dev)
    count5 = torch.where(
        n5 < -3.0, 0, torch.where(n5 < 0.0, 1, torch.ceil(n5).to(torch.int64))
    ).clamp(0, m)

    near_count = torch.where(
        stage == 3, b3.to(torch.int64), torch.where(stage == 5, count5, 0)
    )
    near_mask = torch.arange(m, device=dev) < near_count[:, None]
    on_mask = ((stage == 4) & b4) | ((stage == 5) & (count5 > 0))

    pad = cfg.max_obs - m - 1
    xy = torch.cat([near_xy, on_xy[:, None], torch.full((N, pad, 2), 1e6, device=dev)], 1)
    r = torch.cat([near_r, on_r[:, None], torch.zeros((N, pad), device=dev)], 1)
    mask = torch.cat(
        [near_mask, on_mask[:, None], torch.zeros((N, pad), dtype=torch.bool, device=dev)], 1
    )
    xy = torch.where(mask[..., None], xy, torch.full_like(xy, 1e6))
    return xy, r, mask
