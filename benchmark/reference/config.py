# Frozen copy of `drone2d_tpu_torch/config.py` at commit 012002a (the scenario
# names, EnvConfig and PPOConfig; the presets are in the configuration files).
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

