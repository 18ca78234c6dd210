# Frozen copy of `drone2d_tpu_torch/env/types.py` at commit 012002a (the port's plain math);
# imports rewritten to this package, nothing of the port imported.
"""Environment state as dataclasses of batch-first tensors.

Counterpart of `drone2d_tpu/env/types.py`: the same leaves, with the env
batch dimension N written out in front of each.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from benchmark.reference.path import PathData
from benchmark.reference.physics import BodyState


@dataclasses.dataclass
class ObstacleSet:
    """Padded obstacles; padding sits at 1e6 with radius 0.

    `half_wh` None means circles only, the default path.  Set, every
    obstacle is a rounded axis-aligned box (`half_wh` half-extents plus
    radius `r`), as the `parallel_boxes` squares are: a Square(size) is
    half_wh (size/2, size/2) with r 0.
    """

    xy: torch.Tensor    # (N, MAX_OBS, 2) centers
    r: torch.Tensor     # (N, MAX_OBS) radii
    mask: torch.Tensor  # (N, MAX_OBS) bool, True = live obstacle
    half_wh: Optional[torch.Tensor] = None  # (N, MAX_OBS, 2) box half-extents


@dataclasses.dataclass
class EnvState:
    """Full per-env episode state."""

    path: PathData
    obstacles: ObstacleSet
    body: BodyState
    target: torch.Tensor        # (N, 2) last waypoint
    t: torch.Tensor             # (N,) int32 current time step
    path_error: torch.Tensor    # (N,) running sum of distance from path
    total_reward: torch.Tensor  # (N,) episode return
    la_locked: torch.Tensor     # (N,) bool lookahead locked to the goal
    left_force: torch.Tensor    # (N,) last applied rotor forces
    right_force: torch.Tensor   # (N,)
    family: torch.Tensor        # (N,) int32 rehearsal family (0 = schedule)


@dataclasses.dataclass
class EpisodeStatic:
    """The leaves of EnvState that are constant within an episode.

    `Drone2DEnv.step` never writes them; they change only when an
    auto-reset swaps in a template episode.  The split-carry step
    (`Drone2DEnv.step_autoreset_split`) carries only the mutated leaves and
    one `fresh` bit an env, and blends these at read time (`finalize_split`
    gives back the whole state)."""

    path: PathData
    obstacles: ObstacleSet
    target: torch.Tensor        # (N, 2)
    family: torch.Tensor        # (N,) int32


@dataclasses.dataclass
class EpisodeDyn:
    """The leaves of EnvState that `step` writes."""

    body: BodyState
    t: torch.Tensor
    path_error: torch.Tensor
    total_reward: torch.Tensor
    la_locked: torch.Tensor
    left_force: torch.Tensor
    right_force: torch.Tensor


def split_state(state: "EnvState") -> "tuple[EpisodeStatic, EpisodeDyn]":
    """EnvState -> (per-episode constants, the leaves step writes)."""
    return (
        EpisodeStatic(state.path, state.obstacles, state.target, state.family),
        EpisodeDyn(state.body, state.t, state.path_error, state.total_reward,
                   state.la_locked, state.left_force, state.right_force),
    )


def merge_state(static: EpisodeStatic, dyn: EpisodeDyn) -> "EnvState":
    """Inverse of split_state."""
    return EnvState(
        path=static.path, obstacles=static.obstacles, body=dyn.body, target=static.target,
        t=dyn.t, path_error=dyn.path_error, total_reward=dyn.total_reward,
        la_locked=dyn.la_locked, left_force=dyn.left_force, right_force=dyn.right_force,
        family=static.family,
    )


def finalize_split(init_static: EpisodeStatic, tmpl_static: EpisodeStatic,
                   fresh: torch.Tensor, dyn: EpisodeDyn) -> "EnvState":
    """The whole EnvState at the end of a split-carry chunk
    (`drone2d_tpu/env/types.py:113-139`).

    The split loop never writes the per-episode constants: an env's true
    statics are the template's where it has auto-reset in the chunk
    (`fresh` (N,) bool), else its initial ones.  A caller that stops the
    loop (to start the next chunk against a new template, to checkpoint, to
    inspect) applies this blend once; carrying `init_static` on unblended
    would bring back the finished episode's geometry for every env that
    reset in the chunk."""
    return merge_state(select_state(fresh, init_static, tmpl_static), dyn)


def _none_leaf(leaves) -> bool:
    """True when every leaf is None; raises on a mix of None and tensors."""
    nones = [x is None for x in leaves]
    if any(nones) and not all(nones):
        raise ValueError("states disagree on an optional leaf (e.g. box obstacles' half_wh)")
    return nones[0]


def _select(mask: torch.Tensor, a, b):
    """Leaf-wise `where(mask, b, a)` over matching dataclass trees; a None
    leaf (in both) stays None."""
    if dataclasses.is_dataclass(a):
        return type(a)(**{
            f.name: _select(mask, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
        })
    if _none_leaf((a, b)):
        return None
    m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return torch.where(m, b, a)


def select_state(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per env, the state `b` where mask (N,) is True, else `a` (also for
    any other tree of dataclasses over (N, ...) leaves, such as
    `EpisodeStatic` and `EpisodeDyn`)."""
    return _select(mask, a, b)


def cat_states(states: Sequence[EnvState]) -> EnvState:
    """The envs of `states`, in order, as one batch (a copy of each leaf)."""
    first = states[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: cat_states([getattr(s, f.name) for s in states])
                              for f in dataclasses.fields(first)})
    if _none_leaf(states):
        return None
    return torch.cat(list(states))


@dataclasses.dataclass
class StepOutput:
    state: EnvState
    obs: torch.Tensor                # (N, 27)
    reward: torch.Tensor             # (N,)
    done: torch.Tensor               # (N,) bool
    info: Dict[str, torch.Tensor]    # each (N,)


# family-axis layout for rehearsal accounting (EnvState.family values)
N_FAMILIES = 8
FAMILY_NAMES = (
    "schedule", "stage_1", "stage_2", "stage_3", "stage_4", "stage_5",
    "corridor", "cross",
)

# Names of the info-dict metric bus (drone_2d_env.py:114-137, 575-613).
INFO_FIELDS = (
    "reward",
    "collision_avoidance_reward",
    "path_adherence",
    "path_progression",
    "collision_reward",
    "reach_end_reward",
    "agressive_alpha_reward",
    "dist_closest_obs",
    "env_steps",
    "APE",
    "n_collisions",
    "n_successful_runs",
    "n_failed_runs",
    "total_reward",
)
