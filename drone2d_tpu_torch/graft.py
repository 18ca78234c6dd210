"""The graft entry's step: the port's counterpart of `__graft_entry__.entry`.

The JAX entry jits one forward step of the flagship model over its env
batch: the policy sample (`sample_action`), the clip to [-1, 1] and the
auto-resetting `step_batch`, which draws a whole fresh reset batch every
step and selects it where an env is done (`drone2d_tpu/env/env.py:671-682`).
`graft_step` is that step eagerly; `GraftStep` the same step as one CUDA
graph on the card, the noise and the reset batch drawn inside it from the
generator it is bound to, so that it draws, step for step, what
`graft_step` draws from the same generator state.  On the CPU its body runs
directly (`utils/graphs.py`).
"""

from __future__ import annotations

import torch

from drone2d_tpu_torch.utils import graphs

# the JAX entry's shapes: 256 envs, the flagship's 128-128 actor-critic
NUM_ENVS = 256
HIDDEN = (128, 128)


@torch.no_grad()
def graft_step(params, env, state, obs, gen: torch.Generator, global_step=0.0):
    """One step: the policy's sample with noise from `gen`, the clipped
    action into `env.step_batch` with a reset batch drawn from `gen` at
    `global_step` -> (state', obs', reward, done, value)."""
    action, _, value = params.sample_action(obs, gen)
    out = env.step_batch(state, torch.clamp(action, -1.0, 1.0), gen, global_step)
    return out.state, out.obs, out.reward, out.done, value


class GraftStep:
    """`graft_step` as a graph over static buffers (`graphs.ShapeGraph`),
    bound to `gen`, its curriculum step a device scalar made once.  A call
    on (state, obs) copies in whatever is not already the static state (the
    last call's outputs are) and replays -> (state', obs', reward, done,
    value), static: the next call overwrites them, so clone what is kept."""

    def __init__(self, params, env, gen: torch.Generator, global_step: float = 0.0):
        step = torch.full((), float(global_step), dtype=torch.float32, device=env.device)

        def make_body(inputs):
            state, obs = inputs

            def body():
                new, new_obs, reward, done, value = graft_step(params, env, state, obs, gen,
                                                               step)
                graphs.copy_((state, obs), (new, new_obs))
                return reward, done, value
            return body

        self.graph = graphs.ShapeGraph(make_body, lambda inputs: inputs, env.device,
                                       generators=[gen])

    def __call__(self, state, obs):
        (reward, done, value), (state, obs) = self.graph((state, obs))
        return state, obs, reward, done, value
