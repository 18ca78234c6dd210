# Frozen copy of `drone2d_tpu_torch/env/env.py` at commit 012002a (the port's plain math);
# imports rewritten to this package, nothing of the port imported.
"""The drone environment as functions of batch-first tensors.

Counterpart of `drone2d_tpu/env/env.py` (reference `drone_2d_env.py`,
class Drone2dEnv).  Every function takes and returns the whole env batch:
what the JAX package writes per env under `vmap` is written here with the
env dimension N in front.  Auto-reset is a masked select to a reset template
that the learner builds once per rollout (`step_batch_template`), or a
fresh draw of the whole reset batch every step (`step_batch`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.config import EnvConfig
from benchmark.reference.device import constant
from benchmark.reference import scenarios
from benchmark.reference.types import (
    EnvState,
    EpisodeDyn,
    EpisodeStatic,
    ObstacleSet,
    StepOutput,
    merge_state,
    select_state,
    split_state,
)
from benchmark.reference import geometry, path as tpath, physics
from benchmark.reference.transforms import invm1to1, m1to1, ssa

OBS_DIM = 27
ACT_DIM = 2


def _observe(
    cfg: EnvConfig,
    pd: tpath.PathData,
    obstacles: ObstacleSet,
    body: physics.BodyState,
    target: torch.Tensor,
    la_locked: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """27-D observation (get_observation, drone_2d_env.py:631-773).

    Returns (obs (N, 27), new_la_locked (N,))."""
    w, h, diag = cfg.screensize_x, cfg.screensize_y, cfg.screen_diag
    x, y = body.pos[:, 0], body.pos[:, 1]
    alpha = body.angle

    vel_x = m1to1(body.vel[:, 0], -cfg.vel_norm, cfg.vel_norm)
    vel_y = m1to1(body.vel[:, 1], -cfg.vel_norm, cfg.vel_norm)
    omega = torch.clamp(body.omega / cfg.omega_norm, -1.0, 1.0)
    alpha_n = alpha / math.pi

    target_dx = m1to1(target[:, 0] - x, 0.0, w)
    target_dy = m1to1(target[:, 1] - y, 0.0, h)
    pos_x = m1to1(x, 0.0, w)
    pos_y = m1to1(y, 0.0, h)

    # --- k nearest obstacles by the vertex-sampled distance (:617-720) ------
    verts = geometry.frame_vertices(
        body.pos, alpha, cfg.drone_width / 2, cfg.drone_height / 4
    )
    obs_x, obs_y = obstacles.xy[..., 0], obstacles.xy[..., 1]
    if obstacles.half_wh is None:  # circles only
        ddx = verts[:, :, 0:1] - obs_x[:, None, :]
        ddy = verts[:, :, 1:2] - obs_y[:, None, :]
        vdist = torch.sqrt(ddx * ddx + ddy * ddy) - obstacles.r[:, None, :]
        d_all = vdist.min(dim=1).values
    else:
        d_all = geometry.vertex_rounded_box_distances(
            verts, obstacles.xy, obstacles.half_wh, obstacles.r)
    inf = torch.full_like(d_all, math.inf)
    remaining = torch.where(obstacles.mask, d_all, inf)
    n_obs = obstacles.mask.sum(dim=1)
    k_obs = torch.clamp(n_obs, max=cfg.k_obs)

    # k argmin passes; torch.argmin keeps the first index on ties and gives
    # index 0 on an all-inf row, as jnp.argmin does
    top_d, ox, oy = [], [], []
    for _ in range(cfg.k_obs):
        i = torch.argmin(remaining, dim=1, keepdim=True)
        top_d.append(torch.gather(remaining, 1, i))
        ox.append(torch.gather(obs_x, 1, i))
        oy.append(torch.gather(obs_y, 1, i))
        remaining = remaining.scatter(1, i, math.inf)
    top_d, ox, oy = torch.cat(top_d, 1), torch.cat(ox, 1), torch.cat(oy, 1)
    ang = ssa(torch.atan2(y[:, None] - oy, x[:, None] - ox) - alpha[:, None] - math.pi)
    slot_valid = torch.arange(cfg.k_obs, device=k_obs.device) < k_obs[:, None]
    obs_dist = torch.where(slot_valid, m1to1(top_d, 0.0, diag), 1.0)
    obs_sin = torch.where(slot_valid, torch.sin(ang), 0.0)
    obs_cos = torch.where(slot_valid, torch.cos(ang), 0.0)

    # --- velocity angle in the body frame (:722-727) ------------------------
    vel_angle_b = ssa(torch.atan2(body.vel[:, 1], body.vel[:, 0]) - alpha)
    s_vel, c_vel = torch.sin(vel_angle_b), torch.cos(vel_angle_b)

    # --- path queries (:729-749): one closest-u search for both points ------
    u_star = tpath.closest_u(
        pd, body.pos, golden_iters=cfg.golden_iters, fine_points=cfg.fine_refine_points
    )
    u_la = tpath.lookahead_u(pd, u_star, cfg.lookahead)
    pts = tpath.path_point(pd, torch.stack([u_star, u_la], dim=1))
    cp, la = pts[:, 0], pts[:, 1]

    # lock the lookahead to the goal once within 10 px of it (:738-747)
    near_goal = ((la[:, 0] - target[:, 0]).abs() < 10.0) & (
        (la[:, 1] - target[:, 1]).abs() < 10.0)
    la_locked_new = la_locked | near_goal
    la = torch.where(la_locked_new[:, None], target, la)

    # --- body-frame angles to lookahead / closest point (:751-763): the
    # reference's R_w_b(alpha) @ (p - pos) followed by an extra "- alpha"
    c, s = torch.cos(alpha), torch.sin(alpha)

    def body_angle_to(p):
        rel = p - body.pos
        bx = c * rel[:, 0] - s * rel[:, 1]
        by = s * rel[:, 0] + c * rel[:, 1]
        return ssa(torch.atan2(by, bx) - alpha)

    la_ang = body_angle_to(la)
    cp_ang = body_angle_to(cp)

    obs = torch.stack(
        [
            vel_x, vel_y,
            omega, alpha_n,
            target_dx, target_dy,
            pos_x, pos_y,
            obs_dist[:, 0], obs_sin[:, 0], obs_cos[:, 0],
            obs_dist[:, 1], obs_sin[:, 1], obs_cos[:, 1],
            obs_dist[:, 2], obs_sin[:, 2], obs_cos[:, 2],
            s_vel, c_vel,
            m1to1(cp[:, 0], 0.0, w), m1to1(cp[:, 1], 0.0, h),
            m1to1(la[:, 0], 0.0, w), m1to1(la[:, 1], 0.0, h),
            torch.sin(la_ang), torch.cos(la_ang),
            torch.sin(cp_ang), torch.cos(cp_ang),
        ],
        dim=1,
    ).to(torch.float32)
    return obs, la_locked_new


def _rewards_and_done(
    cfg: EnvConfig,
    obs: torch.Tensor,
    has_obstacles: torch.Tensor,
    collided: torch.Tensor,
    t_new: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """Reward terms and terminations from the normalized observation
    round-trip (drone_2d_env.py:422-572), each (N,)."""
    w, h, diag = cfg.screensize_x, cfg.screensize_y, cfg.screen_diag
    two_pi = 2 * math.pi

    def wrap2pi(a):  # `%` is torch.remainder: the sign of jnp's `%`
        return torch.remainder(a + two_pi, two_pi)

    vel_x = invm1to1(obs[:, 0], -cfg.vel_norm, cfg.vel_norm)
    vel_y = invm1to1(obs[:, 1], -cfg.vel_norm, cfg.vel_norm)
    alpha = obs[:, 3] * math.pi
    target_dx = invm1to1(obs[:, 4], 0.0, w)
    target_dy = invm1to1(obs[:, 5], 0.0, h)
    pos_x, pos_y = invm1to1(obs[:, 6], 0.0, w), invm1to1(obs[:, 7], 0.0, h)
    vel_angle = wrap2pi(torch.atan2(obs[:, 17], obs[:, 18]))
    cp_x, cp_y = invm1to1(obs[:, 19], 0.0, w), invm1to1(obs[:, 20], 0.0, h)
    la_angle = wrap2pi(torch.atan2(obs[:, 23], obs[:, 24]))

    # --- collision avoidance + lambda blending (:457-523) ------------------
    d_obs = invm1to1(obs[:, 8], 0.0, diag)
    obs_angle = wrap2pi(torch.atan2(obs[:, 9], obs[:, 10]))
    angle_diff = torch.rad2deg(
        torch.remainder(obs_angle - vel_angle + math.pi, two_pi) - math.pi
    ).abs()
    R, A = cfg.danger_range, cfg.danger_angle
    c = cfg.abs_inv_CA_min_rew
    in_range = d_obs < R
    lam_pa_raw = torch.clamp((d_obs / R) / 2.0, min=0.10)
    use_lam = has_obstacles & in_range & bool(cfg.use_Lambda)
    lambda_pa = torch.where(use_lam, lam_pa_raw, 1.0)
    lambda_ca = torch.where(use_lam, 1.0 - lam_pa_raw, 1.0)

    range_rew = torch.clamp(-((R + c * R) / (d_obs + c * R) - 1.0), max=0.0)
    angle_rew = torch.clamp(-((A + c * A) / (angle_diff + c * A) - 1.0), max=0.0)
    rew_ca = torch.where(has_obstacles & in_range, range_rew + angle_rew, 0.0)

    # --- path adherence (:527-530) ------------------------------------------
    dist_from_path = torch.sqrt((cp_x - pos_x) ** 2 + (cp_y - pos_y) ** 2)
    rew_pa = -(
        2.0 * torch.clamp(dist_from_path, 0.0, cfg.PA_band_edge) / cfg.PA_band_edge - 1.0
    ) * cfg.PA_scale

    # --- path progression (:534-539) ----------------------------------------
    speed = torch.sqrt(vel_x**2 + vel_y**2)
    vel_la_diff = (torch.remainder(la_angle - vel_angle + math.pi, two_pi) - math.pi).abs()
    rew_pp = torch.clamp(
        torch.cos(vel_la_diff) * speed * cfg.PP_vel_scale, cfg.PP_rew_min, cfg.PP_rew_max
    )

    # --- terminations and their rewards (:543-570) --------------------------
    end1 = collided
    rew_coll = torch.where(end1, cfg.rew_collision, 0.0)
    end2 = (target_dx.abs() < cfg.reach_end_radius) & (
        target_dy.abs() < cfg.reach_end_radius)
    rew_reach = torch.where(end2, cfg.rew_reach_end, 0.0)
    rew_aa = torch.where(alpha > cfg.AA_band, -torch.sin(alpha), 0.0)
    rew_aa = torch.where(alpha < -cfg.AA_band, torch.sin(alpha), rew_aa)
    end5 = alpha.abs() >= cfg.AA_angle
    rew_aa = torch.where(end5, cfg.rew_AA, rew_aa)
    end4 = t_new == cfg.n_steps

    reward = (
        rew_aa
        + rew_pa * lambda_pa
        + rew_pp
        + rew_coll
        + rew_ca * lambda_ca
        + rew_reach
    )
    return dict(
        reward=reward,
        rew_ca=rew_ca * lambda_ca,
        rew_pa=rew_pa * lambda_pa,
        rew_pp=rew_pp,
        rew_coll=rew_coll,
        rew_reach=rew_reach,
        rew_aa=rew_aa,
        dist_from_path=dist_from_path,
        d_obs=d_obs,
        done=end1 | end2 | end4 | end5,
        end1=end1,
        end2=end2,
        end4=end4,
        end5=end5,
    )


def _where_env(pick: torch.Tensor, a: Tuple[torch.Tensor, ...], b: Tuple[torch.Tensor, ...]):
    """Leaf by leaf, env n's entry of `a` where pick[n] (N,), else of `b`."""
    return tuple(torch.where(pick.reshape(pick.shape + (1,) * (x.dim() - 1)), x, y)
                 for x, y in zip(a, b))


class Drone2DEnv:
    """Binds an EnvConfig and a device; every method works on the batch.

    Both modes of the JAX package: `curriculum` (random paths and the
    stage schedule, with the static stage, corridor and crossing-wall
    rehearsal mixes and the adaptive family draw) and `test` (one of the
    spatial benchmark scenarios, its path and obstacles built once here,
    the box obstacles of `parallel_boxes` included).  With
    `initial_motion_enabled` a reset ends with the initial throw and the
    settle steps.
    """

    def __init__(self, cfg: EnvConfig, device=None):
        if cfg.mode not in ("curriculum", "test"):
            raise ValueError(f"mode must be 'curriculum' or 'test', got {cfg.mode!r}")
        if cfg.mode == "test" and cfg.scenario not in scenarios._SPAWN_RECTS:
            raise ValueError(
                f"test mode needs a spatial scenario, got {cfg.scenario!r} "
                "(stage_k scenarios run under mode='curriculum', as in the "
                "reference: drone_2d_env.py:76-77, 326-372)"
            )
        if len(set(cfg.stage_mix_weights)) > 1 and not cfg.adaptive_rehearsal:
            # as the JAX learner checks (learn/ppo.py initial_rehearsal_probs):
            # the static mix draws its stage uniformly
            raise ValueError(
                "non-uniform stage_mix_weights only take effect through the "
                "adaptive reset path (probabilities as data); set "
                f"adaptive_rehearsal=True; got {cfg.stage_mix_weights}"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        self.obs_dim = OBS_DIM
        self.act_dim = ACT_DIM
        self._stage_override = None
        if cfg.scenario.startswith("stage_"):
            self._stage_override = int(cfg.scenario.split("_")[1])

        if cfg.mode == "test":
            geo = scenarios.build_test_scenario(cfg)
            dev = self.device
            self._test_path = tpath.make_path(
                torch.tensor(geo.wps, device=dev)[None],
                torch.tensor([geo.n_wps], dtype=torch.int32, device=dev),
                table_n=cfg.path_table_n, margin=cfg.closest_u_margin,
            )
            self._test_obstacles = ObstacleSet(
                xy=torch.tensor(geo.obs_xy, device=dev)[None],
                r=torch.tensor(geo.obs_r, device=dev)[None],
                mask=torch.tensor(geo.obs_mask, device=dev)[None],
                half_wh=None if geo.obs_half_wh is None
                else torch.tensor(geo.obs_half_wh, device=dev)[None],
            )
            self._spawn_rect = tuple(float(v) for v in geo.spawn_rect)

    # -- reset ---------------------------------------------------------------

    def reset_batch(
        self, gen: torch.Generator, num_envs: int, global_step=0.0,
        rehearsal_probs: torch.Tensor | None = None,
    ) -> Tuple[EnvState, torch.Tensor]:
        """`num_envs` fresh episodes -> (state, obs (N, 27)).

        In test mode every env flies the scenario's path and obstacles from
        a spawn drawn uniformly in its rectangle.  In curriculum mode
        (`drone2d_tpu/env/env.py:309-454`) each env draws a random path and
        the stage the schedule gives `global_step`, and then, unless the
        scenario forces a stage, the rehearsal mixes:
        - `adaptive_rehearsal`: one family per env from `rehearsal_probs`
          (7,) (stage_1..stage_5, corridor, cross; the rest of the mass is a
          scheduled episode), by `scenarios.family_from_uniform`.  A stage
          family is drawn as a forced stage (gs -1).
        - else `stage_mix_prob`: a uniform forced stage 1..5 with that
          probability; `corridor_mix_prob` and `cross_mix_prob`: that wall
          with that probability (the crossing wall wins when both fire).
        Corridor and crossing-wall episodes start at the path start.  The
        env's `family` records what it drew (0 = scheduled, 1..5 a stage,
        6 corridor, 7 cross).  With `initial_motion_enabled` the body then
        takes the initial throw (`throw_draws`, `_initial_motion`) before
        the first observation.  Every mix and the throw draw only when they
        are on, so the generator's stream with all of them off is unchanged.
        """
        cfg, dev, N = self.cfg, self.device, num_envs
        if cfg.adaptive_rehearsal and rehearsal_probs is None and cfg.mode != "test":
            raise ValueError("cfg.adaptive_rehearsal=True requires rehearsal_probs")
        angle = scenarios._uniform(gen, (N,), -math.pi / 4, math.pi / 4, dev)
        family = torch.zeros(N, dtype=torch.int32, device=dev)
        if cfg.mode == "test":
            pd = tpath.PathData(**{k: v.expand(N, *v.shape[1:])
                                   for k, v in vars(self._test_path).items()})
            obstacles = ObstacleSet(**{k: None if v is None else v.expand(N, *v.shape[1:])
                                       for k, v in vars(self._test_obstacles).items()})
            xmin, ymin, xmax, ymax = self._spawn_rect
            x = scenarios._uniform(gen, (N,), xmin, xmax, dev)
            y = scenarios._uniform(gen, (N,), ymin, ymax, dev)
            pos = torch.stack([x, y], 1)
        else:
            pd, obstacles, pos, family = self._curriculum_reset(
                gen, N, global_step, rehearsal_probs)

        target = pd.wps[torch.arange(N, device=dev), pd.n_wps.long() - 1]
        zeros = torch.zeros(N, device=dev)
        body = physics.BodyState(pos=pos, vel=torch.zeros((N, 2), device=dev),
                                 angle=angle, omega=zeros)
        if cfg.initial_motion_enabled:
            body = self._initial_motion(
                body, self.throw_draws(gen, N) if cfg.initial_throw else None)
        la_locked = torch.zeros(N, dtype=torch.bool, device=dev)
        obs, la_locked = _observe(cfg, pd, obstacles, body, target, la_locked)
        state = EnvState(
            path=pd, obstacles=obstacles, body=body, target=target,
            t=torch.zeros(N, dtype=torch.int32, device=dev),
            path_error=zeros, total_reward=zeros, la_locked=la_locked,
            left_force=zeros, right_force=zeros, family=family,
        )
        return state, obs

    def _curriculum_reset(self, gen, N, global_step, rehearsal_probs):
        """Curriculum paths, obstacle fields and spawns -> (path, obstacles,
        pos (N, 2), family (N,)); see `reset_batch`."""
        cfg, dev = self.cfg, self.device
        wps = scenarios.random_corner_waypoints(gen, cfg, N, dev)
        n_wps = torch.full((N,), cfg.n_wps, dtype=torch.int32, device=dev)
        pd = tpath.make_path(wps, n_wps, table_n=cfg.path_table_n,
                             margin=cfg.closest_u_margin)
        family = torch.zeros(N, dtype=torch.int32, device=dev)
        forced = self._stage_override is not None
        adaptive = cfg.adaptive_rehearsal and not forced
        if forced:
            stage = torch.full((N,), self._stage_override, dtype=torch.int32, device=dev)
            gs = torch.full((N,), -1.0, device=dev)  # sim_num = -1 when forced
        else:
            # a host number is filled in on the device: a copy from the host
            # would refuse to be captured
            scaled = (global_step.to(device=dev, dtype=torch.float32)
                      if torch.is_tensor(global_step)
                      else torch.full((), float(global_step), dtype=torch.float32, device=dev))
            gs = (scaled / cfg.curriculum_scale).expand(N)
            stage = scenarios.stage_from_step(gs)
            if adaptive:
                fam_idx = scenarios.family_from_uniform(
                    torch.rand(N, generator=gen, device=dev), rehearsal_probs.to(dev))
                is_stage = fam_idx <= 4
                stage = torch.where(is_stage, fam_idx + 1, stage)
                gs = torch.where(is_stage, -1.0, gs)
                family = torch.where(is_stage, fam_idx + 1, family)
            elif cfg.stage_mix_prob > 0.0:
                mix = torch.rand(N, generator=gen, device=dev) < cfg.stage_mix_prob
                rand_stage = torch.randint(1, 6, (N,), generator=gen, device=dev,
                                           dtype=torch.int32)
                stage = torch.where(mix, rand_stage, stage)
                gs = torch.where(mix, -1.0, gs)
                family = torch.where(mix, rand_stage, family)
        xy, r, mask = scenarios.curriculum_obstacles(gen, cfg, pd, stage, gs)

        # the rehearsal walls (training-time augmentation: never under a
        # forced stage); both are built under adaptive rehearsal, where at
        # most one of them fires per env
        field = (xy, r, mask)
        walls = torch.zeros(N, dtype=torch.bool, device=dev)
        if adaptive or (cfg.corridor_mix_prob > 0.0 and not forced):
            fires = (fam_idx == 5) if adaptive else (
                torch.rand(N, generator=gen, device=dev) < cfg.corridor_mix_prob)
            off = scenarios.corridor_offsets(gen, N, dev)
            field = _where_env(fires, scenarios.corridor_walls(cfg, pd, off), field)
            family = torch.where(fires, 6, family)
            walls = walls | fires
        if adaptive or (cfg.cross_mix_prob > 0.0 and not forced):
            fires = (fam_idx == 6) if adaptive else (
                torch.rand(N, generator=gen, device=dev) < cfg.cross_mix_prob)
            drawn = scenarios.cross_draws(gen, N, dev)
            field = _where_env(fires, scenarios.cross_walls(cfg, pd, *drawn), field)
            family = torch.where(fires, 7, family)
            walls = walls | fires
        xy, r, mask = field
        obstacles = ObstacleSet(xy=xy, r=r, mask=mask)

        # stage 2 spawns anywhere on screen (:329-333); others at path start,
        # and so do the wall episodes (inside the corridor, the wall ahead)
        rx = scenarios._uniform(gen, (N,), 100.0, cfg.screensize_x - 100.0, dev)
        ry = scenarios._uniform(gen, (N,), 100.0, cfg.screensize_y - 100.0, dev)
        at_random = (stage == 2) & ~walls
        pos = torch.where(at_random[:, None], torch.stack([rx, ry], 1), wps[:, 0])
        return pd, obstacles, pos, family

    def throw_draws(self, gen: torch.Generator, num_envs: int) -> Tuple[torch.Tensor, ...]:
        """The initial throw's draws, each (N,): its direction in [0, 2 pi),
        its force in [0, 1500) and the rotor couple in [-3000, 3000)."""
        dev, N = self.device, num_envs
        angle = torch.rand(N, generator=gen, device=dev) * 2 * math.pi
        force = scenarios._uniform(gen, (N,), 0.0, 1500.0, dev)
        rot = scenarios._uniform(gen, (N,), -3000.0, 3000.0, dev)
        return angle, force, rot

    def _initial_motion(self, body: physics.BodyState, draws=None) -> physics.BodyState:
        """The optional throw and settle (initial_movement,
        drone_2d_env.py:917-946, defined but never called in the reference;
        `drone2d_tpu/env/env.py:456-480`): with `initial_throw`, one step
        under the thrown force and the rotor couple (net torque -2 arm rot)
        from `draws` (`throw_draws`), then `n_fall_steps` force-free steps."""
        cfg = self.cfg
        if cfg.initial_throw:
            throw_angle, throw_force, rot = draws
            f_world = throw_force[:, None] * torch.stack(
                [torch.cos(throw_angle), torch.sin(throw_angle)], dim=1)
            g = constant((0.0, cfg.gravity_y), body.vel)
            body = physics.BodyState(
                pos=body.pos + body.vel * cfg.physics_dt,
                vel=body.vel + (g + f_world / cfg.total_mass) * cfg.physics_dt,
                angle=body.angle + body.omega * cfg.physics_dt,
                omega=body.omega + (-2.0 * cfg.drone_radius * rot) / cfg.moment_of_inertia
                * cfg.physics_dt,
            )
        for _ in range(cfg.n_fall_steps):
            body = physics.free_step_body(body, dt=cfg.physics_dt, gravity_y=cfg.gravity_y)
        return body

    def reset(self, gen: torch.Generator, global_step=0.0, rehearsal_probs=None):
        """One fresh episode, as a batch of one."""
        return self.reset_batch(gen, 1, global_step, rehearsal_probs)

    # -- step ----------------------------------------------------------------

    def step(self, state: EnvState, action: torch.Tensor) -> StepOutput:
        """One env step WITHOUT auto-reset (drone_2d_env.py:394-615)."""
        cfg = self.cfg
        forces = physics.thrust_forces(action.to(torch.float32), cfg.force_scale)
        body = physics.step_body(
            state.body, forces[:, 0], forces[:, 1],
            dt=cfg.physics_dt, gravity_y=cfg.gravity_y, mass=cfg.total_mass,
            inertia=cfg.moment_of_inertia, arm=cfg.drone_radius,
        )
        obst = state.obstacles
        if obst.half_wh is None:  # circles only
            collided = geometry.any_collision(
                body.pos, body.angle, cfg.drone_width / 2, cfg.drone_height / 4,
                obst.xy, obst.r, obst.mask,
            )
        else:
            collided = geometry.any_collision_mixed(
                body.pos, body.angle, cfg.drone_width / 2, cfg.drone_height / 4,
                obst.xy, obst.r, obst.half_wh, obst.mask,
            )
        t_new = state.t + 1
        obs, la_locked = _observe(cfg, state.path, obst, body, state.target,
                                  state.la_locked)
        has_obstacles = obst.mask.any(dim=1)
        r = _rewards_and_done(cfg, obs, has_obstacles, collided, t_new)

        path_error = state.path_error + r["dist_from_path"]
        total_reward = state.total_reward + r["reward"]
        done = r["done"]
        new_state = EnvState(
            path=state.path, obstacles=obst, body=body, target=state.target,
            t=t_new, path_error=path_error, total_reward=total_reward,
            la_locked=la_locked, left_force=forces[:, 0], right_force=forces[:, 1],
            family=state.family,
        )

        # info bus (drone_2d_env.py:575-613); episode-end fields are zero
        # until done, as in the reference
        ape = path_error / torch.clamp(t_new.to(torch.float32), min=1.0)
        one = torch.ones_like(t_new)
        zero = torch.zeros_like(t_new)
        info = {
            "reward": r["reward"],
            "collision_avoidance_reward": r["rew_ca"],
            "path_adherence": r["rew_pa"],
            "path_progression": r["rew_pp"],
            "collision_reward": r["rew_coll"],
            "reach_end_reward": r["rew_reach"],
            "agressive_alpha_reward": r["rew_aa"],
            "dist_closest_obs": torch.where(has_obstacles, r["d_obs"], math.inf),
            "env_steps": t_new,
            "APE": torch.where(done, ape, 0.0),
            "n_collisions": torch.where(
                r["end1"] & ~(r["end2"] | r["end4"] | r["end5"]), one, zero),
            "n_successful_runs": torch.where(r["end2"], one, zero),
            "n_failed_runs": torch.where(r["end1"] | r["end4"] | r["end5"], one, zero),
            "total_reward": torch.where(done, total_reward, 0.0),
            # MDP-terminal end (collision / reach-end / AA-angle) as opposed
            # to the step-cap truncation end4
            "terminal": torch.where(r["end1"] | r["end2"] | r["end5"], one, zero),
        }
        return StepOutput(state=new_state, obs=obs, reward=r["reward"], done=done,
                          info=info)

    def step_batch_template(
        self, state: EnvState, action: torch.Tensor, reset_state: EnvState,
        reset_obs: torch.Tensor,
    ) -> StepOutput:
        """Auto-resetting step against a precomputed reset batch: an env
        that is done takes the template's state and observation (its info
        still reports the finished episode)."""
        out = self.step(state, action)
        out.state = select_state(out.done, out.state, reset_state)
        out.obs = torch.where(out.done[:, None], reset_obs, out.obs)
        return out

    # the single-env and the batched name of the JAX package are one function
    step_autoreset_template = step_batch_template

    def step_autoreset_split(
        self, dyn: EpisodeDyn, fresh: torch.Tensor, action: torch.Tensor,
        init_static: EpisodeStatic, tmpl_static: EpisodeStatic, tmpl_dyn: EpisodeDyn,
        tmpl_obs: torch.Tensor,
    ):
        """The split-carry auto-resetting step (`drone2d_tpu/env/env.py:612-659`):
        `step_batch_template`'s semantics with the state split in two.  The
        carry is the leaves `step` writes (`dyn`) and one `fresh` bit an env,
        set once the env has auto-reset in this chunk; an env's per-episode
        constants are `where(fresh, template, initial)`, blended at read time
        from two operands the chunk never writes.  By induction the blend
        equals the template variant's carried state, so the two loops agree
        bit for bit.  At the end of a chunk `types.finalize_split(init_static,
        tmpl_static, fresh, dyn)` gives back the whole state, and the next
        chunk starts with `fresh` False.

        Returns (dyn', fresh', obs, reward, done, info)."""
        static = select_state(fresh, init_static, tmpl_static)
        out = self.step(merge_state(static, dyn), action)
        new_dyn = select_state(out.done, split_state(out.state)[1], tmpl_dyn)
        new_obs = torch.where(out.done[:, None], tmpl_obs, out.obs)
        return new_dyn, fresh | out.done, new_obs, out.reward, out.done, out.info

    step_batch_split = step_autoreset_split

    def step_autoreset(
        self, state: EnvState, action: torch.Tensor, gen: torch.Generator, global_step=0.0,
    ) -> StepOutput:
        """Auto-resetting step with a fresh draw per reset, as the reference
        rebuilds its world on every reset (drone_2d_env.py:908-912): an env
        that is done takes an episode of its own, drawn from `gen` at
        `global_step`, not a template shared over a rollout.  As the JAX
        package does, it draws a whole reset batch of N every step and
        selects it on done, so no step waits for the host; that draw costs
        many physics steps (`step_batch_template` is the rollout's cheap
        variant)."""
        reset_state, reset_obs = self.reset_batch(gen, action.shape[0], global_step)
        return self.step_batch_template(state, action, reset_state, reset_obs)

    step_batch = step_autoreset
