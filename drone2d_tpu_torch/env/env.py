"""The drone environment as functions of batch-first tensors.

Counterpart of `drone2d_tpu/env/env.py` (reference `drone_2d_env.py`,
class Drone2dEnv).  Every function takes and returns the whole env batch:
what the JAX package writes per env under `vmap` is written here with the
env dimension N in front.  Auto-reset is a masked select to a reset template
that the learner builds once per rollout.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.env import scenarios
from drone2d_tpu_torch.env.types import EnvState, ObstacleSet, StepOutput, select_state
from drone2d_tpu_torch.ops import geometry, path as tpath, physics
from drone2d_tpu_torch.ops.transforms import invm1to1, m1to1, ssa

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
    ddx = verts[:, :, 0:1] - obs_x[:, None, :]
    ddy = verts[:, :, 1:2] - obs_y[:, None, :]
    vdist = torch.sqrt(ddx * ddx + ddy * ddy) - obstacles.r[:, None, :]
    d_all = vdist.min(dim=1).values
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


class Drone2DEnv:
    """Binds an EnvConfig and a device; every method works on the batch.

    Only the curriculum mode is ported, with the static stage-rehearsal mix
    (`stage_mix_prob`); the corridor, cross and adaptive mixes and the
    initial throw raise.
    """

    def __init__(self, cfg: EnvConfig, device=None):
        if cfg.mode != "curriculum":
            raise NotImplementedError("only mode='curriculum' is ported")
        if (cfg.corridor_mix_prob or cfg.cross_mix_prob or cfg.adaptive_rehearsal
                or cfg.initial_motion_enabled):
            raise NotImplementedError(
                "the corridor, cross and adaptive rehearsal mixes and the initial "
                "throw are not ported"
            )
        if len(set(cfg.stage_mix_weights)) > 1:
            # as the JAX learner checks (learn/ppo.py initial_rehearsal_probs):
            # the static mix draws its stage uniformly
            raise ValueError(
                "non-uniform stage_mix_weights only take effect through the "
                f"adaptive reset path, which is not ported; got {cfg.stage_mix_weights}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.obs_dim = OBS_DIM
        self.act_dim = ACT_DIM
        self._stage_override = None
        if cfg.scenario.startswith("stage_"):
            self._stage_override = int(cfg.scenario.split("_")[1])

    # -- reset ---------------------------------------------------------------

    def reset_batch(
        self, gen: torch.Generator, num_envs: int, global_step=0.0
    ) -> Tuple[EnvState, torch.Tensor]:
        """`num_envs` fresh curriculum episodes -> (state, obs (N, 27)).

        With `stage_mix_prob` > 0 each env draws its own stage rehearsal
        (`drone2d_tpu/env/env.py:363-370`): with that probability a uniform
        stage in 1..5 replaces the scheduled one, is treated as forced (gs
        -1) and is recorded as the env's `family`.  The mix never fires
        under a forced `scenario="stage_k"`.  Its draws are made only when
        the mix is on, so the generator's stream at 0 is unchanged.
        """
        cfg, dev, N = self.cfg, self.device, num_envs
        angle = scenarios._uniform(gen, (N,), -math.pi / 4, math.pi / 4, dev)
        wps = scenarios.random_corner_waypoints(gen, cfg, N, dev)
        n_wps = torch.full((N,), cfg.n_wps, dtype=torch.int32, device=dev)
        pd = tpath.make_path(wps, n_wps, table_n=cfg.path_table_n,
                             margin=cfg.closest_u_margin)
        family = torch.zeros(N, dtype=torch.int32, device=dev)
        if self._stage_override is not None:
            stage = torch.full((N,), self._stage_override, dtype=torch.int32, device=dev)
            gs = torch.full((N,), -1.0, device=dev)  # sim_num = -1 when forced
        else:
            scaled = torch.as_tensor(global_step, dtype=torch.float32, device=dev)
            gs = (scaled / cfg.curriculum_scale).expand(N)
            stage = scenarios.stage_from_step(gs)
            if cfg.stage_mix_prob > 0.0:
                mix = torch.rand(N, generator=gen, device=dev) < cfg.stage_mix_prob
                rand_stage = torch.randint(1, 6, (N,), generator=gen, device=dev,
                                           dtype=torch.int32)
                stage = torch.where(mix, rand_stage, stage)
                gs = torch.where(mix, -1.0, gs)
                family = torch.where(mix, rand_stage, family)
        xy, r, mask = scenarios.curriculum_obstacles(gen, cfg, pd, stage, gs)
        obstacles = ObstacleSet(xy=xy, r=r, mask=mask)
        # stage 2 spawns anywhere on screen (:329-333); others at path start
        rx = scenarios._uniform(gen, (N,), 100.0, cfg.screensize_x - 100.0, dev)
        ry = scenarios._uniform(gen, (N,), 100.0, cfg.screensize_y - 100.0, dev)
        pos = torch.where((stage == 2)[:, None], torch.stack([rx, ry], 1), wps[:, 0])

        target = wps[torch.arange(N, device=dev), n_wps.long() - 1]
        zeros = torch.zeros(N, device=dev)
        body = physics.BodyState(pos=pos, vel=torch.zeros((N, 2), device=dev),
                                 angle=angle, omega=zeros)
        la_locked = torch.zeros(N, dtype=torch.bool, device=dev)
        obs, la_locked = _observe(cfg, pd, obstacles, body, target, la_locked)
        state = EnvState(
            path=pd, obstacles=obstacles, body=body, target=target,
            t=torch.zeros(N, dtype=torch.int32, device=dev),
            path_error=zeros, total_reward=zeros, la_locked=la_locked,
            left_force=zeros, right_force=zeros, family=family,
        )
        return state, obs

    def reset(self, gen: torch.Generator, global_step=0.0):
        """One fresh episode, as a batch of one."""
        return self.reset_batch(gen, 1, global_step)

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
        collided = geometry.any_collision(
            body.pos, body.angle, cfg.drone_width / 2, cfg.drone_height / 4,
            obst.xy, obst.r, obst.mask,
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
