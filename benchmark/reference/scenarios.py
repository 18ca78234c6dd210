# Frozen copy of `drone2d_tpu_torch/env/scenarios.py` at commit 012002a (the port's plain math);
# imports rewritten to this package, nothing of the port imported.
"""Scenario and curriculum geometry.

Counterpart of `drone2d_tpu/env/scenarios.py`, in two halves:

1. Host side (numpy, deterministic): the 7 spatial benchmark scenarios of
   reference `test_scenarios.py` (create_test_scenario :169-246,
   generate_scen_waypoints_2d :87-167, generate_scen_obstacles :4-84), the
   extra `parallel_boxes` (the parallel layout with square obstacles) and
   the per-scenario spawn rectangles of `drone_2d_env.py:218-311`, padded to
   fixed `max_wps` / `max_obs` arrays once when a test-mode env is built.

2. Device side, batched over envs: the random-corner waypoint chain
   (predef_path.py:307-363), the near-/on-path obstacle sampler
   (obstacles.py:58-89), the global_step -> stage schedule
   (drone_2d_env.py:324-373), the rehearsal families' family draw and their
   corridor and crossing walls.  Draws come from a `torch.Generator`, so they
   follow the JAX package's distributions but not its bits; each rehearsal
   wall is a deterministic function of the path and its drawn values, so
   that a test can feed it the JAX package's draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.config import EXTRA_SCENARIOS, TEST_SCENARIOS, EnvConfig
from benchmark.reference.device import constant
from benchmark.reference import path as tpath
from benchmark.reference.host_path import HostQPMI

# ---------------------------------------------------------------------------
# Host side: deterministic test scenarios
# ---------------------------------------------------------------------------


class ScenarioGeometry(NamedTuple):
    """Static numpy geometry for one test scenario."""

    wps: np.ndarray         # (max_wps, 2) padded waypoints
    n_wps: int
    obs_xy: np.ndarray      # (max_obs, 2)
    obs_r: np.ndarray       # (max_obs,)
    obs_mask: np.ndarray    # (max_obs,) bool
    spawn_rect: np.ndarray  # (4,) xmin, ymin, xmax, ymax
    obs_half_wh: "np.ndarray | None" = None  # (max_obs, 2) box half-extents


def _chain(x1, y1, azimuths, distance):
    az = np.asarray(azimuths, dtype=np.float64)
    steps = distance * np.stack([np.cos(az), np.sin(az)], axis=-1)
    pts = np.concatenate([[[x1, y1]], steps], axis=0)
    return np.cumsum(pts, axis=0)


def scenario_waypoints(scen: str, w: float, h: float, *, n_wps: int = 10,
                       distance: float = 100.0, offset: float = 0.0) -> np.ndarray:
    """Deterministic scenario waypoint layouts (generate_scen_waypoints_2d)."""
    if scen in ("perpendicular", "parallel", "parallel_boxes", "impossible", "straight"):
        x1 = w / 2 - distance * (n_wps - 1) / 2
        return _chain(x1, h / 2, np.zeros(n_wps - 1), distance)
    if scen == "S_parallel":
        az = [(-1 if i % 2 == 0 else 1) * math.pi / 4 for i in range(n_wps - 1)]
        return _chain(w / 10, h / 2, az, distance)
    if scen == "corridor":
        x1 = w / 2 - distance * (n_wps - 1) / 2
        return _chain(x1, h / 2 + offset, np.zeros(n_wps - 1), distance)
    if scen == "S_corridor":
        az = [(-1 if i % 2 == 0 else 1) * math.pi / 4 for i in range(n_wps - 1)]
        return _chain(w / 7, h / 2 + offset, az, distance)
    if scen == "large":
        # a path that circumnavigates one huge central obstacle
        # (test_scenarios.py:137-164)
        n = int(w / 100)
        obs_rad = w / 5
        margin = 80.0
        circ_seg = math.pi * (obs_rad + margin) / (n - 3)
        distance = w / 10
        x1 = w / 2 - obs_rad - margin - distance
        y1 = h / 2 - margin
        wps = [np.array([x1, y1]), np.array([x1 + distance, y1])]
        for i in range(1, n - 1):
            az = math.pi / 2 - (i - 1) * math.pi / (n - 3)
            wps.append(wps[-1] + circ_seg * np.array([math.cos(az), math.sin(az)]))
        wps.append(wps[-1] + np.array([distance, 0.0]))
        return np.stack(wps)
    raise ValueError(f"unknown scenario waypoint layout: {scen}")


def _scenario_obstacles(scen: str, w: float, h: float) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic obstacle fields (generate_scen_obstacles + the
    per-scenario parameter overrides of create_test_scenario)."""
    xy, r = [], []

    def on_path_row(host: HostQPMI, us, size):
        for u in us:
            xy.append(host.point(u))
            r.append(size)

    if scen == "perpendicular":
        n, size = 6, 20.0
        host = HostQPMI(scenario_waypoints(scen, w, h))
        half = host.length / 2
        base = host.point(half)
        ang = host.direction_angle(half) - math.pi / 2
        start = n * size - size
        for i in range(n):
            off = start - i * size * 2
            xy.append(base + off * np.array([math.cos(ang), math.sin(ang)]))
            r.append(size)
    elif scen == "parallel":
        n, size = 6, 30.0
        host = HostQPMI(scenario_waypoints(scen, w, h))
        off = (host.length - n * size * 2) / 2 - size
        on_path_row(host, [off + i * size * 2 for i in range(1, n + 1)], size)
    elif scen == "S_parallel":
        n, size = 20, 15.0
        host = HostQPMI(scenario_waypoints(scen, w, h, n_wps=6, distance=300))
        off = (host.length - n * size * 2) / 2
        on_path_row(host, [off + i * size * 2 for i in range(1, n + 1)], size)
    elif scen == "corridor":
        for side in (+100.0, -100.0):
            host = HostQPMI(scenario_waypoints(scen, w, h, offset=side))
            n, free = 10, 100.0
            size = (host.length - 2 * free) / (n * 2)
            on_path_row(host, [i * size * 2 + free for i in range(1, n)], size)
    elif scen == "S_corridor":
        for side in (+150.0, -150.0):
            host = HostQPMI(
                scenario_waypoints(scen, w, h, n_wps=7, distance=200, offset=side)
            )
            n, free = 30, 100.0
            size = (host.length - 2 * free) / (n * 2)
            on_path_row(host, [i * size * 2 + free for i in range(1, n)], size)
    elif scen == "impossible":
        n, ring = 20, 100.0
        host = HostQPMI(scenario_waypoints(scen, w, h))
        size = 2 * math.pi * ring / (n * 2)
        base = host.point(host.length)
        pa = host.direction_angle(host.length)
        for i in range(1, n + 1):
            a = pa - i * 2 * math.pi / n
            xy.append(base + ring * np.array([math.cos(a), math.sin(a)]))
            r.append(size)
    elif scen == "large":
        xy.append(np.array([w / 2, h / 2]))
        r.append(w / 5)
    elif scen == "parallel_boxes":
        # the 'parallel' layout with Square obstacles (obstacles.py:20-31):
        # squares of side 2 size centered on the path in place of circles
        # of radius size
        n, size = 6, 30.0
        host = HostQPMI(scenario_waypoints("parallel", w, h))
        off = (host.length - n * size * 2) / 2 - size
        on_path_row(host, [off + i * size * 2 for i in range(1, n + 1)], size)
    else:
        raise ValueError(f"unknown scenario: {scen}")
    return np.stack(xy), np.asarray(r, dtype=np.float64)


_SPAWN_RECTS = {
    # (xmin, ymin, xmax, ymax) — drone_2d_env.py:221-311
    "perpendicular": lambda w, h: (50.0, 50.0, w / 2 - 100, h - 100),
    "parallel": lambda w, h: (50.0, 150.0, w / 2 - 300, h - 300),
    "S_parallel": lambda w, h: (50.0, 150.0, w / 2 - 300, h - 300),
    "corridor": lambda w, h: (50.0, 150.0, w / 2 - 400, h - 300),
    "S_corridor": lambda w, h: (50.0, 150.0, w / 2 - 450, h - 300),
    "large": lambda w, h: (50.0, 150.0, w / 2 - w / 4 - 50, h - 300),
    "impossible": lambda w, h: (50.0, 150.0, w / 2, h - 300),
    "parallel_boxes": lambda w, h: (50.0, 150.0, w / 2 - 300, h - 300),
}


def build_test_scenario(cfg: EnvConfig) -> ScenarioGeometry:
    """Assemble padded fixed-shape geometry for cfg.scenario.

    `parallel_boxes` also gets `obs_half_wh`, its squares' half-extents,
    with `obs_r` zeroed (sharp boxes); every other scenario is circles only
    (`obs_half_wh` None).
    """
    scen = cfg.scenario
    if scen not in TEST_SCENARIOS + EXTRA_SCENARIOS:
        raise ValueError(f"{scen!r} is not a spatial test scenario")
    w, h = cfg.screensize_x, cfg.screensize_y

    if scen == "S_parallel":
        wps = scenario_waypoints(scen, w, h, n_wps=6, distance=300)
    elif scen == "S_corridor":
        wps = scenario_waypoints(scen, w, h, n_wps=7, distance=200)
    else:
        wps = scenario_waypoints(scen, w, h)

    n_wps = len(wps)
    if n_wps > cfg.max_wps:
        raise ValueError(f"{scen}: {n_wps} waypoints > max_wps={cfg.max_wps}")
    wps_pad = np.concatenate([wps, np.repeat(wps[-1:], cfg.max_wps - n_wps, 0)])

    xy, r = _scenario_obstacles(scen, w, h)
    k = len(xy)
    if k > cfg.max_obs:
        raise ValueError(f"{scen}: {k} obstacles > max_obs={cfg.max_obs}")
    obs_xy = np.full((cfg.max_obs, 2), 1e6)
    obs_r = np.zeros(cfg.max_obs)
    obs_mask = np.zeros(cfg.max_obs, bool)
    obs_xy[:k] = xy
    obs_r[:k] = r
    obs_mask[:k] = True

    obs_half_wh = None
    if scen == "parallel_boxes":
        # the sizes in r are the squares' half-sides: box half-extents, radius 0
        obs_half_wh = np.zeros((cfg.max_obs, 2), np.float32)
        obs_half_wh[:k] = np.stack([r, r], axis=-1)
        obs_r[:] = 0.0

    return ScenarioGeometry(
        wps=wps_pad.astype(np.float32),
        n_wps=n_wps,
        obs_xy=obs_xy.astype(np.float32),
        obs_r=obs_r.astype(np.float32),
        obs_mask=obs_mask,
        spawn_rect=np.asarray(_SPAWN_RECTS[scen](w, h), np.float32),
        obs_half_wh=obs_half_wh,
    )


# ---------------------------------------------------------------------------
# Device side: curriculum randomization
# ---------------------------------------------------------------------------

# stage schedule (drone_2d_env.py:326-362), half-open intervals
STAGE_BOUNDS = (700_000, 1_000_000, 1_600_000, 2_000_000)


def stage_from_step(global_step: torch.Tensor) -> torch.Tensor:
    """Curriculum stage 1..5 from the float32 global env-step count."""
    s = torch.as_tensor(global_step, dtype=torch.float32)
    bounds = constant(STAGE_BOUNDS, s)
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
    az_lo = constant((0.0, math.pi / 2, -math.pi / 2, -math.pi), x1)[corner - 1]
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


# -- rehearsal families ------------------------------------------------------


def family_from_uniform(u: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The adaptive family index 0..7 of each env from u ~ U(0, 1) (N,) and
    the 7 rehearsal probabilities: the number of cumulative bounds at or
    below u (`drone2d_tpu/env/env.py:356-358`).  0..4 are stage_1..stage_5,
    5 corridor, 6 cross, 7 a scheduled-curriculum episode.  The cumulative
    sum adds left to right in float32, as `jnp.cumsum` does, so an env drawn
    on a bound lands in the same family."""
    cum = tpath.cumsum(probs.to(torch.float32)[None], dim=1)
    return (u[:, None] >= cum).sum(dim=1).to(torch.int32)


def _pad_walls(cfg: EnvConfig, xy: torch.Tensor, r: torch.Tensor):
    """(N, k, 2) centers and (N, k) radii -> the max_obs-padded layout of
    the JAX walls: live slots first, padding at 1e6 with radius 0."""
    N, k = r.shape
    pad = cfg.max_obs - k
    dev = xy.device
    xy = torch.cat([xy, torch.full((N, pad, 2), 1e6, device=dev)], 1)
    r = torch.cat([r, torch.zeros((N, pad), device=dev)], 1)
    mask = (torch.arange(cfg.max_obs, device=dev) < k).expand(N, -1)
    return xy, r, mask


def corridor_offsets(gen: torch.Generator, num_envs: int, device) -> torch.Tensor:
    """The corridor's lateral wall offset of each env, U(90, 180) px."""
    return _uniform(gen, (num_envs,), 90.0, 180.0, device)


def corridor_walls(cfg: EnvConfig, pd: tpath.PathData, off: torch.Tensor):
    """Corridor walls along each env's path (`drone2d_tpu/env/scenarios.py:326-357`):
    n = (max_obs - 1)//2 touching circles a side, of radius (L - 2*free)/(2n),
    tiling [free, L - free] of the path at `off` (N,) px to either side along
    the path's normal, as the eval's corridor scenarios tile theirs.

    Returns xy (N, max_obs, 2), r (N, max_obs), mask (N, max_obs)."""
    n = (cfg.max_obs - 1) // 2
    free = 100.0
    size = (pd.length - 2.0 * free) / (2.0 * n)                       # (N,)
    k = 2.0 * torch.arange(1, n + 1, device=size.device) - 1.0
    us = free + size[:, None] * k                                      # (N, n)
    base = tpath.path_point(pd, us)
    pa = tpath.direction_angle(pd, us) - math.pi / 2
    normal = torch.stack([torch.cos(pa), torch.sin(pa)], -1)
    shift = off[:, None, None] * normal
    xy = torch.cat([base + shift, base - shift], 1)
    return _pad_walls(cfg, xy, size[:, None].expand(-1, 2 * n))


def cross_draws(gen: torch.Generator, num_envs: int, device):
    """A crossing wall's draws per env: its place along the path as a
    fraction of the length U(0.3, 0.7), its circles' radius U(15, 40) and
    its lateral centering offset U(-60, 60) px."""
    u_frac = _uniform(gen, (num_envs,), 0.3, 0.7, device)
    size = _uniform(gen, (num_envs,), 15.0, 40.0, device)
    center = _uniform(gen, (num_envs,), -60.0, 60.0, device)
    return u_frac, size, center


def cross_walls(cfg: EnvConfig, pd: tpath.PathData, u_frac: torch.Tensor,
                size: torch.Tensor, center: torch.Tensor):
    """A wall of 6 touching circles across each env's path
    (`drone2d_tpu/env/scenarios.py:360-390`), the eval's perpendicular wall
    moved to u = u_frac * L and off-centered by `center`.

    Returns xy (N, max_obs, 2), r (N, max_obs), mask (N, max_obs)."""
    n = 6
    u = pd.length * u_frac
    base = tpath.path_point(pd, u)
    ang = tpath.direction_angle(pd, u) - math.pi / 2
    normal = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    i = torch.arange(n, device=size.device)
    offs = (n * size[:, None] - size[:, None]) - i * size[:, None] * 2.0 + center[:, None]
    xy = base[:, None, :] + offs[..., None] * normal[:, None, :]
    return _pad_walls(cfg, xy, size[:, None].expand(-1, n))
