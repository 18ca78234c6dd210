"""PPO rollout: the acting half of the SB3 `PPO("MlpPolicy")` learner.

Counterpart of the rollout part of `drone2d_tpu/learn/ppo.py`.  A rollout
steps all envs in lockstep for `n_steps`: the policy sample (the fused
kernel on the card), a clip of the action to [-1, 1] for the env, and the
auto-resetting env step against a reset template built once per rollout.
The PPO update (loss, gradients, Adam) is not ported yet.

`rollout_from` is the deterministic core: it takes the reset template and
the (T, N, 2) standard-normal noise, so a test can feed it the JAX
package's draws.  `rollout` draws both from the state's generator.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM, Drone2DEnv
from drone2d_tpu_torch.env.types import EnvState
from drone2d_tpu_torch.models.policy import ActorCritic

# Final-step info components averaged over finished episodes
# (tensorboardlogger.py:101-108).
_COMPONENT_KEYS = (
    "reward",
    "collision_reward",
    "collision_avoidance_reward",
    "path_adherence",
    "path_progression",
    "reach_end_reward",
    "agressive_alpha_reward",
)
_STAT_KEYS = (
    "env_steps", "total_reward", "APE", "n_successful_runs", "n_failed_runs",
    "n_collisions",
)


@dataclasses.dataclass
class EpisodeStats:
    """Sums over the episodes that finished during one rollout."""

    n_episodes: torch.Tensor        # () finished episodes
    sum_length: torch.Tensor        # () sum of final env_steps
    sum_total_reward: torch.Tensor  # () sum of episode returns
    sum_ape: torch.Tensor           # () sum of episode APEs
    n_success: torch.Tensor
    n_fail: torch.Tensor
    n_collision: torch.Tensor
    sum_components: torch.Tensor    # (7,) final-step reward components

    def summary(self) -> Dict[str, float]:
        n = max(float(self.n_episodes), 1.0)
        out = {
            "episodes": float(self.n_episodes),
            "avg_length": float(self.sum_length) / n,
            "avg_total_reward": float(self.sum_total_reward) / n,
            "avg_APE": float(self.sum_ape) / n,
            "success_rate": float(self.n_success) / n,
            "failure_rate": float(self.n_fail) / n,
            "collision_rate": float(self.n_collision) / n,
        }
        for i, k in enumerate(_COMPONENT_KEYS):
            out[f"avg_{k}"] = float(self.sum_components[i]) / n
        return out


@dataclasses.dataclass
class TrainState:
    params: ActorCritic
    env_state: EnvState            # batched over num_envs
    obs: torch.Tensor              # (N, 27)
    generator: torch.Generator     # reset templates and action noise
    # float32 env-step counter, advanced once per rollout by n_steps*num_envs
    # (exact in float32 for power-of-two increments), as in the JAX package
    global_step: torch.Tensor      # () float32


@dataclasses.dataclass
class RolloutBatch:
    obs: torch.Tensor        # (T, N, 27)
    actions: torch.Tensor    # (T, N, 2) unclipped samples
    log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor     # (T, N)
    rewards: torch.Tensor    # (T, N)
    dones: torch.Tensor      # (T, N) bool


class PPOLearner:
    """Binds (EnvConfig, PPOConfig, num_envs) to a device (the card unless
    device="cpu")."""

    def __init__(self, env_cfg: EnvConfig, ppo_cfg: PPOConfig, num_envs: int,
                 *, device=None):
        self.device = resolve_device(device)
        self.env = Drone2DEnv(env_cfg, self.device)
        self.cfg = ppo_cfg
        self.num_envs = num_envs

    def init(self, seed: int, params: ActorCritic | None = None,
             global_step: float = 0.0) -> TrainState:
        """Fresh envs and, unless given, fresh weights.  The curriculum clock
        starts at `global_step` (0 for a run from scratch; a trained agent
        resumes where its curriculum has obstacles)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if params is None:
            params = ActorCritic(
                OBS_DIM, ACT_DIM, self.cfg.hidden_sizes,
                generator=torch.Generator().manual_seed(seed), device=self.device,
            )
        step = torch.tensor(global_step, dtype=torch.float32, device=self.device)
        env_state, obs = self.env.reset_batch(gen, self.num_envs, step)
        return TrainState(params=params, env_state=env_state, obs=obs, generator=gen,
                          global_step=step)

    def rollout(
        self, state: TrainState
    ) -> Tuple[TrainState, RolloutBatch, torch.Tensor, EpisodeStats]:
        """Collect n_steps across all envs under the current policy.

        Returns (state', batch, last_values, episode_stats)."""
        reset_state, reset_obs = self.env.reset_batch(
            state.generator, self.num_envs, state.global_step
        )
        noise = torch.randn(
            (self.cfg.n_steps, self.num_envs, ACT_DIM),
            generator=state.generator, device=self.device,
        )
        return self.rollout_from(state, reset_state, reset_obs, noise)

    @torch.no_grad()
    def rollout_from(
        self,
        state: TrainState,
        reset_state: EnvState,
        reset_obs: torch.Tensor,
        noise: torch.Tensor,
    ) -> Tuple[TrainState, RolloutBatch, torch.Tensor, EpisodeStats]:
        """The rollout with its reset template and noise (T, N, 2) given."""
        T, N, dev = self.cfg.n_steps, self.num_envs, self.device
        if tuple(noise.shape) != (T, N, ACT_DIM):
            raise ValueError(f"noise has shape {tuple(noise.shape)}, want {(T, N, ACT_DIM)}")
        f32 = dict(dtype=torch.float32, device=dev)
        batch = RolloutBatch(
            obs=torch.empty((T, N, OBS_DIM), **f32),
            actions=torch.empty((T, N, ACT_DIM), **f32),
            log_probs=torch.empty((T, N), **f32),
            values=torch.empty((T, N), **f32),
            rewards=torch.empty((T, N), **f32),
            dones=torch.empty((T, N), dtype=torch.bool, device=dev),
        )
        infos = {k: torch.empty((T, N), **f32) for k in _STAT_KEYS + _COMPONENT_KEYS}

        env_state, obs = state.env_state, state.obs
        for t in range(T):
            action, log_prob, value = state.params.sample_action(obs, noise=noise[t])
            out = self.env.step_batch_template(
                env_state, torch.clamp(action, -1.0, 1.0), reset_state, reset_obs
            )
            batch.obs[t] = obs
            batch.actions[t] = action
            batch.log_probs[t] = log_prob
            batch.values[t] = value
            batch.rewards[t] = out.reward
            batch.dones[t] = out.done
            for k in infos:
                infos[k][t] = out.info[k]
            env_state, obs = out.state, out.obs

        d = batch.dones.to(torch.float32)
        stats = EpisodeStats(
            n_episodes=d.sum(),
            sum_length=(infos["env_steps"] * d).sum(),
            sum_total_reward=(infos["total_reward"] * d).sum(),
            sum_ape=(infos["APE"] * d).sum(),
            n_success=(infos["n_successful_runs"] * d).sum(),
            n_fail=(infos["n_failed_runs"] * d).sum(),
            n_collision=(infos["n_collisions"] * d).sum(),
            sum_components=torch.stack([(infos[k] * d).sum() for k in _COMPONENT_KEYS]),
        )
        # the kernel's value output with zero noise, so that nothing plain
        # runs on the card's path
        _, _, last_values = state.params.sample_action(
            obs, noise=torch.zeros((N, ACT_DIM), **f32)
        )
        global_step = state.global_step + torch.tensor(float(T * N), **f32)
        new_state = dataclasses.replace(
            state, env_state=env_state, obs=obs, global_step=global_step
        )
        return new_state, batch, last_values, stats
