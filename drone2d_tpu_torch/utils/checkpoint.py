"""Checkpoint / resume with `torch.save` (counterpart of
`drone2d_tpu/utils/checkpoint.py`, which uses orbax).

A checkpoint is one file, `ckpt_<global_step>.pt`, holding the params'
state_dict, the optimizer's state_dict, the generator's state with its
device type and a 64-bit seed drawn from it, `global_step`,
`episodes_total` and the PLR fields (`rehearsal_probs`, `family_counts`,
`family_wins`).  The curriculum clock IS `global_step`, so resume is exact.
Env state is not saved, as in the JAX package: restore resets the envs at
the restored step from the restored generator.  The last KEEP checkpoints
are kept (orbax's `max_to_keep=5`).

A generator's state has one format a device type (the CPU's is 5056 bytes,
CUDA's 16), and neither takes the other's.  A resume on the device type
that saved restores the state, so it continues the saved stream exactly.
On the other type it seeds a fresh generator from the stored seed: a
resumed run, but on another stream (the JAX package's raw key data restores
on any backend, `drone2d_tpu/utils/checkpoint.py:43-45`).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, List, Tuple

import torch

from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner, TrainState
from drone2d_tpu_torch.models.policy import ActorCritic

_NAME = re.compile(r"ckpt_(\d+)\.pt")
KEEP = 5
_PLR_FIELDS = ("rehearsal_probs", "family_counts", "family_wins")


def checkpoint_steps(directory: str) -> List[int]:
    """The steps of the checkpoints under `directory`, oldest first."""
    if not os.path.isdir(directory):
        return []
    found = (_NAME.fullmatch(name) for name in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def save_checkpoint(directory: str, state: TrainState) -> int:
    """Write the learner state at its global_step (written to a temporary
    file, then renamed) and drop all but the newest KEEP.  Returns the
    step."""
    step = int(float(state.global_step))
    gen = state.generator
    # the seed comes from a copy: saving leaves the run's stream as it is
    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    seed = int(torch.randint(0, 2**63 - 1, (), generator=twin, device=gen.device))
    payload = dict(
        params=state.params.state_dict(),
        optimizer=state.optimizer.state_dict(),
        generator=gen.get_state(),
        generator_device=gen.device.type,
        generator_seed=seed,
        global_step=step,
        episodes_total=int(float(state.episodes_total)),
        **{k: getattr(state, k).detach().cpu() for k in _PLR_FIELDS},
    )
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    torch.save(payload, f"{path}.tmp")
    os.replace(f"{path}.tmp", path)
    for old in checkpoint_steps(directory)[:-KEEP]:
        os.remove(_path(directory, old))
    return step


def restore_checkpoint(directory: str, learner: PPOLearner, streams: Callable[
        [int], Tuple[torch.Generator, torch.Generator]] | None = None
        ) -> Tuple[TrainState, int]:
    """A runnable TrainState from the latest checkpoint, with its envs reset
    at the restored global_step (from the restored rehearsal probabilities
    under adaptive rehearsal), drawing from the restored generator.  Given
    `streams`, a function of the stored seed to (the state's generator, the
    envs' generator), those two instead (a rank's own streams,
    `parallel.mesh.shard_restore`).  A checkpoint without the PLR fields
    restores the initial probabilities and zero counts.  On another device
    type than the one that saved it, the generator is seeded from the
    stored seed; a checkpoint without one (written before the seed was
    stored) raises.  Adam's state loads onto either device type
    (`optim.load_state_dict`)."""
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory!r}")
    path = _path(directory, steps[-1])
    payload = torch.load(path, map_location="cpu", weights_only=True)
    params = ActorCritic(OBS_DIM, ACT_DIM, learner.cfg.hidden_sizes, device=learner.device)
    params.load_state_dict(payload["params"])
    gen = env_gen = torch.Generator(device=learner.device)
    # checkpoints from before the device type was stored: a CUDA generator's
    # state is its 8-byte seed and 8-byte offset
    saved_on = payload.get("generator_device",
                           "cuda" if payload["generator"].numel() == 16 else "cpu")
    if streams is not None:
        if "generator_seed" not in payload:
            raise ValueError(f"{path} stores no seed to derive a rank's streams from")
        gen, env_gen = streams(int(payload["generator_seed"]))
    elif saved_on == gen.device.type:
        gen.set_state(payload["generator"])
    elif "generator_seed" in payload:
        gen.manual_seed(payload["generator_seed"])
        print(f"resume on {gen.device.type} from a {saved_on} checkpoint: the generator is "
              f"seeded from the stored seed, so the draws leave the saved stream")
    else:
        raise ValueError(
            f"{path} holds a {saved_on} generator state and no seed (it predates "
            f"cross-device resume): resume it on a {saved_on} device")
    state = learner.start(gen, params, float(payload["global_step"]),
                          float(payload["episodes_total"]), payload.get("rehearsal_probs"),
                          env_gen)
    if "family_counts" in payload:
        state = dataclasses.replace(state, **{
            k: payload[k].to(learner.device) for k in ("family_counts", "family_wins")})
    optim.load_state_dict(state.optimizer, payload["optimizer"])
    return state, int(payload["global_step"])
