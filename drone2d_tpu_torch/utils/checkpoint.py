"""Checkpoint / resume with `torch.save` (counterpart of
`drone2d_tpu/utils/checkpoint.py`, which uses orbax).

A checkpoint is one file, `ckpt_<global_step>.pt`, holding the params'
state_dict, the optimizer's state_dict, the generator's state,
`global_step`, `episodes_total` and the PLR fields (`rehearsal_probs`,
`family_counts`, `family_wins`).  The curriculum clock IS `global_step`,
so resume is exact.  Env state is not saved, as in the JAX package: restore
resets the envs at the restored step from the restored generator.  The
last KEEP checkpoints are kept (orbax's `max_to_keep=5`).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Tuple

import torch

from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM
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
    payload = dict(
        params=state.params.state_dict(),
        optimizer=state.optimizer.state_dict(),
        generator=state.generator.get_state(),
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


def restore_checkpoint(directory: str, learner: PPOLearner) -> Tuple[TrainState, int]:
    """A runnable TrainState from the latest checkpoint, with its envs reset
    at the restored global_step (from the restored rehearsal probabilities
    under adaptive rehearsal).  A checkpoint without the PLR fields restores
    the initial probabilities and zero counts."""
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory!r}")
    payload = torch.load(_path(directory, steps[-1]), map_location="cpu", weights_only=True)
    params = ActorCritic(OBS_DIM, ACT_DIM, learner.cfg.hidden_sizes, device=learner.device)
    params.load_state_dict(payload["params"])
    gen = torch.Generator(device=learner.device)
    gen.set_state(payload["generator"])
    state = learner.start(gen, params, float(payload["global_step"]),
                          float(payload["episodes_total"]), payload.get("rehearsal_probs"))
    if "family_counts" in payload:
        state = dataclasses.replace(state, **{
            k: payload[k].to(learner.device) for k in ("family_counts", "family_wins")})
    state.optimizer.load_state_dict(payload["optimizer"])
    return state, int(payload["global_step"])
