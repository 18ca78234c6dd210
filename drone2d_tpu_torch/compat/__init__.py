"""Bridges: the JAX package's agents and state (`from_jax`), SB3 agents
(`sb3_import`), and the reference's gym surface: the single env
(`gym_env`) and the vector env (`vector_env`).  Importing this package
imports no gym; `register_gym_envs` and `Drone2dVectorEnv` import
gymnasium when they are called."""

from drone2d_tpu_torch.compat.gym_env import Drone2dGymEnv, make, register_gym_envs
from drone2d_tpu_torch.compat.vector_env import Drone2dVectorEnv

__all__ = ["Drone2dGymEnv", "Drone2dVectorEnv", "make", "register_gym_envs"]
