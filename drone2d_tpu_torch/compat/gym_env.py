"""Single-env adapter with the reference's gym 0.21 surface.

Counterpart of `drone2d_tpu/compat/gym_env.py`.  The reference publishes
`Drone2dEnv(gym.Env)` with the old gym API (`drone_2d_env.py:394, 775, 908,
914`): `reset() -> obs`, `step(a) -> (obs, reward, done, info)`, `render()`,
`close()`, and `observation_space` / `action_space` Box[-1, 1] (:155-162).
Here the env is the port's batch of one on the card (unless the caller
passes `device="cpu"`), with numpy in and out and the pygame renderer drawn
on the host on demand.  `step_gymnasium` and `reset_seeded` give the
gymnasium 5-tuple; `register_gym_envs` registers `drone2d_tpu_torch/<scenario>-v0`
ids with gymnasium, the single env and the vector env (`compat/vector_env.py`)
behind `gymnasium.make_vec`.

The device step (`Drone2DEnv.step` of the batch of one) runs as a CUDA
graph over a static state and action, as the JAX adapter jits it, behind
`step`, `step_gymnasium` and the gymnasium wrapper alike; made at the first
step after a reset that brings new shapes, reused after every other reset.
The reset's draw is a small graph of its own, bound to the env's one
generator (`seed` re-seeds it on the host); the copy of a step's results to
the host stays eager.  On the CPU the graphs' bodies run directly
(`utils/graphs.py`).

For throughput use the batched API (`Drone2DEnv`, `Drone2dVectorEnv` or
the learner): every step here copies its results to the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM, Drone2DEnv
from drone2d_tpu_torch.utils import graphs


class _Box:
    """Minimal Box space, so that the adapter needs no gym: low, high,
    shape, dtype, sample and contains, as gym's and gymnasium's Box."""

    def __init__(self, low: float, high: float, shape: Tuple[int, ...]):
        self.low = np.full(shape, low, np.float32)
        self.high = np.full(shape, high, np.float32)
        self.shape = shape
        self.dtype = np.float32

    def sample(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        return rng.uniform(self.low, self.high).astype(np.float32)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            np.all(x >= self.low - 1e-6) and np.all(x <= self.high + 1e-6)
        )


def scenario_overrides(scenario: Optional[str], overrides: dict) -> dict:
    """`overrides` with the mode and scenario of a scenario name, the rule
    of `eval.run.scenario_config` (None: the curriculum's defaults)."""
    if scenario is None:
        return dict(overrides)
    from drone2d_tpu_torch.eval.run import scenario_config

    cfg = scenario_config(scenario)
    return {"mode": cfg.mode, "scenario": cfg.scenario, **overrides}


class Drone2dGymEnv:
    """One env, held as a batch of one on `device`, behind numpy."""

    metadata = {"render.modes": ["human", "rgb_array"]}

    def __init__(self, seed: int = 0, global_step: int = 0, device=None, **config_overrides):
        self.cfg = EnvConfig(**config_overrides)
        self._env = Drone2DEnv(self.cfg, device)
        self.device = self._env.device
        self.global_step = float(global_step)
        self._gen = torch.Generator(device=self.device)
        self.seed(seed)
        self._state = None
        # the device step over a static (state, action)
        self._step = graphs.ShapeGraph(self._step_body, lambda inputs: inputs[0], self.device)
        # the reset's draw of one episode at the curriculum step, a graph of
        # its own bound to the generator
        self._draw = graphs.ShapeGraph(
            lambda inputs: lambda: self._env.reset(self._gen, inputs[0]), lambda inputs: (),
            self.device, generators=[self._gen])
        self._renderer = None
        self._screen = None
        self._trail: list = []

        self.observation_space = _Box(-1.0, 1.0, (OBS_DIM,))
        self.action_space = _Box(-1.0, 1.0, (ACT_DIM,))

    # -- gym 0.21 surface ----------------------------------------------------

    def seed(self, seed: int) -> None:
        """Re-seed the env's one generator (the reset's draw graph is bound
        to it)."""
        self._gen.manual_seed(int(seed))

    def reset(self) -> np.ndarray:
        step = torch.full((), self.global_step, dtype=torch.float32, device=self.device)
        self._state, obs = graphs.clone(self._draw((step,))[0])
        self._trail = []
        return obs[0].cpu().numpy()

    def _step_body(self, inputs):
        """The captured step over the static `inputs` (state, action): the
        env step of the batch of one, the new state written back into the
        inputs -> (obs, done, info)."""
        state, action = inputs

        def body():
            out = self._env.step(state, action.clamp(-1.0, 1.0))
            graphs.copy_(state, out.state)
            return out.obs, out.done, out.info
        return body

    def step(self, action) -> Tuple[np.ndarray, float, bool, dict]:
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        a = torch.as_tensor(np.asarray(action, np.float32).reshape(1, ACT_DIM),
                            device=self.device)
        # the graph writes the next state into its static state, kept here
        (obs, done, out_info), (self._state, _) = self._step((self._state, a))
        # one copy to the host for the whole step (float64 holds every
        # float32 and int32 value exactly)
        keys = list(out_info)
        host = torch.cat([obs[0].double(), done.double(),
                          *(out_info[k].double() for k in keys)]).cpu().numpy()
        info = {k: float(x) if out_info[k].is_floating_point() else int(x)
                for k, x in zip(keys, host[OBS_DIM + 1:])}
        return (host[:OBS_DIM].astype(np.float32), info["reward"], bool(host[OBS_DIM]),
                info)

    def render(self, mode: str = "human"):
        import os

        from drone2d_tpu_torch.eval.render import SceneRenderer, _flip

        if self._renderer is None:
            self._renderer = SceneRenderer(self.cfg)
        r, state = self._renderer, self._state

        def host(x):
            return x[0].cpu().numpy()

        path_coords = obstacles = None
        if self.cfg.mode != "test":
            from drone2d_tpu_torch.utils.host_path import HostQPMI

            n = int(state.path.n_wps[0])
            path_coords = HostQPMI(host(state.path.wps)[:n]).coords(100)
            obstacles = (host(state.obstacles.xy), host(state.obstacles.r),
                         host(state.obstacles.mask))
        pos = host(state.body.pos)
        self._trail.append((float(pos[0]), _flip(float(pos[1]), self.cfg.screensize_y)))
        r.draw_scene(path_coords, obstacles)
        if len(self._trail) > 2:
            r.draw_flight_path(self._trail, (16, 19, 97))
        r.draw_drone(pos, float(state.body.angle[0]))

        if mode == "rgb_array":
            return r.frame()
        import pygame

        if self._screen is None:
            os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
            pygame.display.init()
            self._screen = pygame.display.set_mode(
                (int(self.cfg.screensize_x), int(self.cfg.screensize_y))
            )
        self._screen.blit(r.surface, (0, 0))
        pygame.display.flip()
        return None

    def close(self) -> None:
        if self._screen is not None:
            import pygame

            pygame.display.quit()
            self._screen = None

    # -- gymnasium-style variants -------------------------------------------

    def reset_seeded(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed(seed)
        return self.reset(), {}

    def step_gymnasium(self, action):
        obs, reward, done, info = self.step(action)
        # terminated: a real MDP end (collision, reach-end, aggressive
        # angle); truncated: only the step cap.  From the env's `terminal`
        # flag, so a collision on the cap step still counts as terminated.
        terminated = done and bool(info["terminal"])
        truncated = done and not terminated
        return obs, reward, terminated, truncated, info


def make(scenario: Optional[str] = None, **overrides) -> Drone2dGymEnv:
    """gym.make-style constructor: make('corridor'), or make() for the
    curriculum (the reference registers its ids in main.py:138-154).
    `overrides` are EnvConfig fields, `seed`, `global_step` and `device`."""
    return Drone2dGymEnv(**scenario_overrides(scenario, overrides))


def register_gym_envs() -> list:
    """Register `drone2d_tpu_torch/<scenario>-v0` ids with gymnasium (or
    classic gym >= 0.26) when one is installed, for the curriculum and every
    scenario: the reference's `register('drone-2d-custom-...')` calls
    (main.py:138-154).  Under gymnasium each id also takes the vector env
    as its `vector_entry_point`, so that
    `gymnasium.make_vec("drone2d_tpu_torch/corridor-v0", num_envs=N)` steps
    N envs as one batch.  The ids differ from the JAX package's
    `drone2d_tpu/...`, so both register in one process.  Returns the ids
    registered by this call ([] when no gym imports, or all were there).
    """
    try:
        import gymnasium as g
    except ImportError:
        try:
            import gym as g  # classic gym, the >= 0.26 API
        except ImportError:
            return []

    class _Adapter(g.Env):
        """gym(nasium).Env over Drone2dGymEnv (the 5-tuple step)."""

        metadata = {"render_modes": ["rgb_array"], "render_fps": 60}

        def __init__(self, scenario=None, render_mode=None, **overrides):
            super().__init__()
            self._e = make(scenario, **overrides)
            self.render_mode = render_mode
            # several observation entries are normalized, not clipped (the
            # velocity and target-delta terms), so the space is unbounded
            # here; make() keeps the reference's Box[-1, 1]
            self.observation_space = g.spaces.Box(-np.inf, np.inf, (OBS_DIM,), np.float32)
            self.action_space = g.spaces.Box(-1.0, 1.0, (ACT_DIM,), np.float32)

        def reset(self, *, seed=None, options=None):
            return self._e.reset_seeded(seed=seed)

        def step(self, action):
            return self._e.step_gymnasium(action)

        def render(self):
            return self._e.render("rgb_array")

        def close(self):
            self._e.close()

    from drone2d_tpu_torch.config import ALL_SCENARIOS

    vector_kwargs = {}
    if hasattr(g, "make_vec"):
        from drone2d_tpu_torch.compat.vector_env import Drone2dVectorEnv

        vector_kwargs = {"vector_entry_point": Drone2dVectorEnv}

    registered = []
    for name, scenario in [("curriculum", None)] + [(s, s) for s in ALL_SCENARIOS]:
        env_id = f"drone2d_tpu_torch/{name}-v0"
        if env_id in getattr(g.envs, "registry", {}):
            continue
        g.register(id=env_id, entry_point=_Adapter, kwargs={"scenario": scenario},
                   max_episode_steps=None,  # the env truncates itself at n_steps
                   **vector_kwargs)
        registered.append(env_id)
    return registered
