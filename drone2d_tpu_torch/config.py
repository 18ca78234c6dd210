"""Environment, learner and training-run configuration.

The port's own copy of the scenario names, the `EnvConfig`, `PPOConfig`
and `TrainConfig` dataclasses, the published `PRESETS` and `apply_preset`
of the JAX package (`drone2d_tpu/config.py`), field for field with the
same defaults, so that
one set of values configures both packages.  Defaults are the reference's
committed values (`rl_config.py`, `drone_2d_env.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Scenario name registry (reference `rl_config.py:45-58`).
TEST_SCENARIOS: Tuple[str, ...] = (
    "perpendicular",
    "parallel",
    "S_parallel",
    "corridor",
    "S_corridor",
    "large",
    "impossible",
)
STAGE_SCENARIOS: Tuple[str, ...] = (
    "stage_1",
    "stage_2",
    "stage_3",
    "stage_4",
    "stage_5",
)
ALL_SCENARIOS: Tuple[str, ...] = TEST_SCENARIOS + STAGE_SCENARIOS
# Framework-only extras, NOT part of the published 12-scenario suite:
# 'parallel_boxes' exercises the box obstacles (reference obstacles.py:20-45),
# whose rounded-box geometry the port does not have.
EXTRA_SCENARIOS: Tuple[str, ...] = ("parallel_boxes",)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """All environment knobs (reference `rl_config.py:10-44`)."""

    # --- host-side render flags (API parity; the device path ignores them) ---
    render_sim: bool = False
    render_path: bool = False
    render_shade: bool = False
    render_text: bool = False
    shade_distance: float = 75.0

    # --- episode / physics ---
    n_steps: int = 1100            # max episode steps (rl_config.py:16)
    n_fall_steps: int = 5
    change_target: bool = False
    initial_throw: bool = True
    initial_motion_enabled: bool = False

    # --- path generation ---
    random_path_spawn: bool = True
    path_segment_length: float = 100.0
    n_wps: int = 12
    screensize_x: float = 1300.0
    screensize_y: float = 1300.0
    lookahead: float = 220.0
    spawn_corners: Tuple[int, int] = (1, 4)  # (DL, DR, UL, UR) index range

    # --- reward shaping ---
    danger_range: float = 150.0
    danger_angle: float = 20.0            # degrees
    abs_inv_CA_min_rew: float = 1.0 / 8.0
    PA_band_edge: float = 40.0
    PA_scale: float = 2.0
    PP_vel_scale: float = 0.08
    PP_rew_max: float = 2.5
    PP_rew_min: float = -1.0
    rew_collision: float = -50.0
    reach_end_radius: float = 20.0
    rew_reach_end: float = 30.0
    AA_angle: float = math.pi / 2
    AA_band: float = math.pi / 4
    rew_AA: float = -1.0
    use_Lambda: bool = True

    # --- mode / scenario ---
    mode: str = "curriculum"       # 'curriculum' or 'test'
    scenario: str = "large"
    curriculum_scale: float = 1.0
    stage_mix_prob: float = 0.0
    corridor_mix_prob: float = 0.0
    cross_mix_prob: float = 0.0
    stage_mix_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    rehearsal_adapt: bool = True
    adaptive_rehearsal: bool = False

    # --- capacity knobs (fixed shapes; not in the reference) ---
    max_wps: int = 16
    max_obs: int = 64
    max_curriculum_obs: int = 18
    path_table_n: int = 512
    fine_refine_points: int = 17
    golden_iters: int = 0
    obstacle_attempts: int = 8
    obstacle_radius_min: float = 10.0
    obstacle_radius_max: float = 50.0

    # --- physics constants (drone_2d_env.py / Drone.py) ---
    gravity_y: float = -1000.0
    physics_dt: float = 1.0 / 60.0
    force_scale: float = 1000.0
    drone_height: float = 20.0
    drone_width: float = 100.0
    mass_frame: float = 0.2
    mass_motor: float = 0.4
    vel_norm: float = 1330.0
    omega_norm: float = 11.7
    k_obs: int = 3
    closest_u_margin: float = 10.0

    @property
    def drone_radius(self) -> float:
        """Motor-arm half-span: width/2 - height/2 = 40 (Drone.py:11)."""
        return self.drone_width / 2 - self.drone_height / 2

    @property
    def total_mass(self) -> float:
        return self.mass_frame + 2 * self.mass_motor

    @property
    def moment_of_inertia(self) -> float:
        """Moment of the rigid frame + two motor boxes about the COM."""
        w, h = self.drone_width, self.drone_height
        i_frame = self.mass_frame * (w * w + (h / 2) * (h / 2)) / 12.0
        i_motor_own = self.mass_motor * (h * h + h * h) / 12.0
        i_motor = i_motor_own + self.mass_motor * self.drone_radius**2
        return i_frame + 2 * i_motor

    @property
    def screen_diag(self) -> float:
        return math.hypot(self.screensize_x, self.screensize_y)

    def replace(self, **kw) -> "EnvConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters (SB3 `PPO("MlpPolicy")` defaults, ent_coef 0.01)."""

    learning_rate: float = 3e-4
    n_steps: int = 128
    num_minibatches: int = 8
    n_epochs: int = 10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    hidden_sizes: Tuple[int, ...] = (64, 64)
    shuffle: str = "exact"

    def replace(self, **kw) -> "PPOConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-run configuration (reference `rl_config.py:5-8` + main.py)."""

    total_timesteps: int = 9_000_000   # rl_config.py:6
    num_envs: int = 4096
    seed: int = 0
    checkpoint_every_steps: int = 100_000  # main.py:161 save_freq semantics
    log_every_updates: int = 1
    checkpoint_dir: str = "logs"
    metrics_path: str = "logs/metrics.jsonl"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


# --- Published training recipes as first-class presets (VERDICT r4 #3) ----
#
# The reference ships its best configs verbatim
# (best_models_config_and_res/run17see3/{rl_config,env_train_config}.txt);
# these presets are the rebuild's equivalent: the exact recipes behind the
# shipped strict-dominance agents (docs/RESULTS.md rounds 3-4), selectable
# as `--preset NAME` on the train CLIs of both packages.  Explicit
# CLI flags override preset values.  The committed per-knob defaults above
# deliberately stay at REFERENCE values (conformance first); the presets
# carry the quality deltas.
PRESETS: dict = {
    # Hunt-7 from-scratch recipe: 24 seeds x 150M of this + selection
    # produced three strict n=1000-dominance finalists (stage_1 3000/3000,
    # means 0.849-0.856) with no warm start (docs/RESULTS.md round 4).
    # Train a pool of seeds (sweep.py --vmap 8), then pick with
    # scripts/select_agents.py: expect large seed variance (the reference
    # hand-picked from ~20 runs the same way).
    "flagship-scratch": dict(
        doc="published-quality from-scratch recipe (hunt 7, round 4)",
        env=dict(
            PP_rew_max=8.0,               # the r4 pace lever (3.5 saturates)
            rew_collision=-70.0,
            abs_inv_CA_min_rew=1.0 / 6.0,
            curriculum_scale=4.0,
            obstacle_radius_max=160.0,
            stage_mix_prob=0.25,
        ),
        ppo=dict(
            hidden_sizes=(128, 128),      # r3 capacity finding
            n_steps=128,
            num_minibatches=64,
            shuffle="timeperm",
        ),
        train=dict(total_timesteps=150_000_000, num_envs=1024),
    ),
    # Hunt-8 pace fine-tune (adaptive rehearsal): 8 seeds x 30M from a
    # trained winner (--init-params required) lifted every candidate to true stage_1
    # 1000/1000 and produced the shipped flagship agent_s8004 (0.8822 true
    # mean, gen-2 of the s250 -> s6006 -> s8004 chain).
    "flagship-finetune": dict(
        doc="pace fine-tune recipe (hunt 8, round 4); needs --init-params",
        env=dict(
            PP_rew_max=8.0,
            rew_collision=-70.0,
            abs_inv_CA_min_rew=1.0 / 6.0,
            curriculum_scale=0.05,
            obstacle_radius_max=160.0,
            stage_mix_prob=0.3,
            stage_mix_weights=(3.0, 1.0, 1.0, 1.0, 1.0),
            adaptive_rehearsal=True,
            rehearsal_adapt=False,
        ),
        ppo=dict(
            hidden_sizes=(128, 128),
            n_steps=128,
            num_minibatches=64,
            shuffle="timeperm",
        ),
        train=dict(total_timesteps=30_000_000, num_envs=1024),
    ),
}


def apply_preset(
    name: str,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    train_cfg: TrainConfig,
    provided: set = frozenset(),
) -> Tuple[EnvConfig, PPOConfig, TrainConfig]:
    """Overlay preset `name` on the three configs.

    `provided` holds the keys the user set explicitly on the CLI, namespaced
    like the train-CLI argparse attributes ('env_PP_rew_max',
    'ppo_hidden_sizes', 'total_timesteps'); those keep their user value —
    preset fills everything else it defines.
    """
    preset = PRESETS[name]
    for section, cfg_name, cfg in (
        ("env", "env_", env_cfg), ("ppo", "ppo_", ppo_cfg),
        ("train", "", train_cfg),
    ):
        kw = {
            k: v for k, v in preset.get(section, {}).items()
            if f"{cfg_name}{k}" not in provided
        }
        if section == "env":
            env_cfg = cfg.replace(**kw)
        elif section == "ppo":
            ppo_cfg = cfg.replace(**kw)
        else:
            train_cfg = cfg.replace(**kw)
    return env_cfg, ppo_cfg, train_cfg
