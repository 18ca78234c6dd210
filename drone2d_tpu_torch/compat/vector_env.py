"""Vector env: the reference's SubprocVecEnv surface as one batch on the card.

Counterpart of `drone2d_tpu/compat/vector_env.py`.  The reference's only
parallelism is SB3's `SubprocVecEnv`, one OS process per env (reference
main.py:183-190).  Here N envs step as one batch of the port's env on the
card (unless `device="cpu"`), behind numpy, so that an outside RL loop
drives thousands of envs through the standard vector API.

Autoreset follows gymnasium >= 1.0's NEXT_STEP rule: an env that ends
returns its last observation on that step, and resets on the NEXT step
(its action ignored, reward 0, neither terminated nor truncated, its info
masked out).  A reset takes the env of a template batch, as the rollout
does (`Drone2DEnv.step_batch_template`); the templates are drawn anew every
`template_refresh_steps` steps (128 by default), or, with 0, on every step
that has an env to reset (a fresh draw per reset, at the cost of drawing a
whole batch).

The device part of a step (the env step and the NEXT_STEP select) runs as a
CUDA graph over static buffers, as the JAX adapter jits it: made at the
first step after a reset that brings new shapes, reused by every other step
and reset.  The action is copied in every step and the templates whenever
they are drawn anew.  The draws (the reset, the templates) are a small graph
of their own, bound to the env's one generator (re-seeded on the host by
`reset(seed=...)`, never replaced), at the curriculum step held on the
device; it is replayed when the host decides a refresh, and the reset
clones what it drew.  The one copy of a step's results to the host stays.
On the CPU the graphs' bodies run directly (`utils/graphs.py`);
`device_step` is the same step run eagerly.

Two layers, so that the card's work needs no gymnasium:
- `VectorEnvCore` holds the state and the templates, steps them and returns
  numpy; it imports no gym;
- `Drone2dVectorEnv` adds gymnasium's spaces and metadata on top (it
  imports gymnasium when built) and is what `gymnasium.make_vec` returns
  for a `drone2d_tpu_torch/<scenario>-v0` id (`compat/gym_env.py`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from drone2d_tpu_torch.compat.gym_env import scenario_overrides
from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM, Drone2DEnv
from drone2d_tpu_torch.env.types import EnvState, select_state
from drone2d_tpu_torch.utils import graphs


class VectorEnvCore:
    """N envs on `device` with NEXT_STEP autoreset, numpy in and out.

    `global_step` drives the curriculum clock (the reference reads it from
    checkpoint file names, drone_2d_env.py:79-86); an outside training loop
    advances it: `env.global_step = n`.
    """

    closed = False

    def __init__(
        self,
        num_envs: int = 1024,
        seed: int = 0,
        global_step: int = 0,
        scenario: Optional[str] = None,
        template_refresh_steps: int = 128,
        device=None,
        **config_overrides,
    ):
        self.cfg = EnvConfig(**scenario_overrides(scenario, config_overrides))
        self._env = Drone2DEnv(self.cfg, device)
        self.device = self._env.device
        self.num_envs = int(num_envs)
        self.global_step = int(global_step)
        self._refresh = int(template_refresh_steps)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._state = None
        self._prev_done = None
        self._templates = None
        self._steps_since_refresh = 0
        # the device step over static (state, prev_done, action, templates)
        self._step = graphs.ShapeGraph(self._step_body, lambda inputs: inputs[:2], self.device)
        # a batch of N fresh episodes at the curriculum step, drawn from the
        # generator: the reset's and every template refresh's
        self._draw = graphs.ShapeGraph(
            lambda inputs: lambda: self._env.reset_batch(self._gen, self.num_envs, inputs[0]),
            lambda inputs: (), self.device, generators=[self._gen])

    def _draw_batch(self):
        """N fresh episodes at `global_step` -> (state, obs), the draw
        graph's static outputs (the next draw overwrites them)."""
        step = torch.full((), float(self.global_step), dtype=torch.float32, device=self.device)
        return self._draw((step,))[0]

    def device_step(self, state: EnvState, prev_done: torch.Tensor, action: torch.Tensor,
                    reset_state: EnvState, reset_obs: torch.Tensor):
        """One step of the batch: the env step, then NEXT_STEP autoreset (an
        env done on the previous step takes its template, its transition
        discarded) -> (state, obs, reward, terminated, truncated, info)."""
        out = self._env.step(state, action.clamp(-1.0, 1.0))
        state = select_state(prev_done, out.state, reset_state)
        obs = torch.where(prev_done[:, None], reset_obs, out.obs)
        reward = torch.where(prev_done, 0.0, out.reward)
        done = out.done & ~prev_done
        # terminated: a real MDP end (the env's `terminal` flag); truncated:
        # only the step cap fired (cf. Drone2dGymEnv.step_gymnasium)
        terminated = done & out.info["terminal"].bool()
        truncated = done & ~terminated
        return state, obs, reward, terminated, truncated, out.info

    def _step_body(self, inputs):
        """The captured step over the static `inputs` (state, prev_done,
        action, (reset_state, reset_obs)): `device_step`, the new state and
        done flags written back into the inputs -> (obs, reward, terminated,
        truncated, the rows reset by this step, info)."""
        state, prev_done, action, templates = inputs

        def body():
            new, obs, reward, terminated, truncated, info = self.device_step(
                state, prev_done, action, *templates)
            was_reset = prev_done.clone()
            graphs.copy_(state, new)
            prev_done.copy_(terminated | truncated)
            return obs, reward, terminated, truncated, was_reset, info
        return body

    # -- the gymnasium.vector.VectorEnv surface --------------------------------

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._gen.manual_seed(int(seed))
        state, obs = graphs.clone(self._draw_batch())
        self.start_from(state)
        return obs.cpu().numpy(), {}

    def start_from(self, state: EnvState, templates=None) -> None:
        """Continue from the batch `state` on `device`, none of it done, with
        the template batch `templates` ((state, obs), or None to draw one on
        the next step)."""
        self._state = state
        self._prev_done = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        self._templates = templates
        self._steps_since_refresh = 0

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        stale = (
            self._templates is None
            or (self._refresh > 0 and self._steps_since_refresh >= self._refresh)
            or (self._refresh == 0 and bool(self._prev_done.any()))
        )
        if stale:
            self._templates = self._draw_batch()
            self._steps_since_refresh = 0
        self._steps_since_refresh += 1

        a = torch.as_tensor(actions, dtype=torch.float32,
                            device=self.device).reshape(self.num_envs, ACT_DIM)
        (obs, reward, terminated, truncated, was_reset, info), inputs = self._step(
            (self._state, self._prev_done, a, self._templates))
        # the graph wrote the next state and done flags into its inputs; the
        # static templates, which hold this step's, are copied anew only
        # when drawn anew
        self._state, self._prev_done, _, self._templates = inputs

        # one copy to the host for the whole step (float64 holds every
        # float32 and int32 value exactly); the gymnasium vector info
        # convention: arrays plus a `_<key>` mask, which a reset step clears
        # (its transition was discarded)
        keys = list(info)
        cols = [obs, reward[:, None], terminated[:, None], truncated[:, None],
                ~was_reset[:, None], *(info[k][:, None] for k in keys)]
        host = torch.cat([c.double() for c in cols], 1).cpu().numpy()
        live = host[:, OBS_DIM + 3] > 0
        infos = {k: host[:, OBS_DIM + 4 + i].astype(str(info[k].dtype).split(".")[1])
                 for i, k in enumerate(keys)}
        infos.update({f"_{k}": live for k in keys})
        return (host[:, :OBS_DIM].astype(np.float32), host[:, OBS_DIM].astype(np.float32),
                host[:, OBS_DIM + 1] > 0, host[:, OBS_DIM + 2] > 0, infos)

    def close(self, **kwargs) -> None:
        self.closed = True

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(num_envs={self.num_envs}, "
                f"scenario={self.cfg.scenario!r})")


class Drone2dVectorEnv(VectorEnvCore):
    """`gymnasium.vector.VectorEnv`-conformant: `VectorEnvCore` with the
    spaces and metadata of gymnasium, which it imports.  Built directly or
    by `gymnasium.make_vec("drone2d_tpu_torch/<scenario>-v0", num_envs=N)`
    after `register_gym_envs()`."""

    render_mode = None
    spec = None  # set by gymnasium.make_vec

    @property
    def unwrapped(self):
        return self

    def __init__(self, num_envs: int = 1024, **kwargs):
        import gymnasium
        from gymnasium.vector.utils import batch_space

        super().__init__(num_envs, **kwargs)
        self.metadata = {
            "render_modes": [],
            "autoreset_mode": gymnasium.vector.AutoresetMode.NEXT_STEP,
        }
        # unbounded: several observation entries are normalized, not clipped
        self.single_observation_space = gymnasium.spaces.Box(
            -np.inf, np.inf, (OBS_DIM,), np.float32)
        self.single_action_space = gymnasium.spaces.Box(-1.0, 1.0, (ACT_DIM,), np.float32)
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)
        self.action_space = batch_space(self.single_action_space, self.num_envs)
