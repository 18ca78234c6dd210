"""Carry weights, optimizer state and env state across from the JAX
package, as numpy.

Agents load from the `.npz` naming of `drone2d_tpu/models/policy.py`
(`params_to_flat_dict`), and an `EnvState` maps leaf for leaf: the JAX
package's batched state, with each leaf turned into a numpy array, becomes
the port's state with the same padded shapes (`max_wps`, `max_obs`, the
path table) and int32 `t` and `family`; the box obstacles' `half_wh` comes
across where it is set and stays None where it is not.  optax's Adam state
maps into the port's `torch.optim.Adam` (`opt_state_from_numpy`), and a
whole learner state, PLR fields included, into the port's `TrainState`
(`train_state_from_numpy`), and a whole population of the JAX package's
zoo into the port's `ZooState` (`zoo_state_from_numpy`).  Nothing here
imports JAX: every direction goes through numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.env.types import EnvState, ObstacleSet
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import TrainState
from drone2d_tpu_torch.learn.zoo import ZooState
from drone2d_tpu_torch.models.policy import (
    ActorCritic,
    flat_dict_to_params,
    params_to_flat_dict,
    stack_params,
    state_dict_key,
)
from drone2d_tpu_torch.ops.path import PathData
from drone2d_tpu_torch.ops.physics import BodyState

# an agent's flat dict <-> ActorCritic
params_from_flat = flat_dict_to_params
params_to_flat = params_to_flat_dict

_INT_LEAVES = ("path.n_wps", "t", "family")


def flatten_fields(tree, prefix: str = "") -> dict:
    """Nested NamedTuples or dataclasses -> {"path.wps": ndarray, ...};
    None leaves are dropped."""
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
    elif hasattr(tree, "_fields"):
        names = list(tree._fields)
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu()
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for name in names:
        leaf = getattr(tree, name)
        if leaf is not None:
            out.update(flatten_fields(leaf, f"{prefix}{name}."))
    return out


def env_state_from_numpy(tree, device=None) -> EnvState:
    """The JAX package's batched EnvState (leaves as numpy arrays, or the
    flat dict `flatten_fields` makes of it) -> the port's EnvState."""
    flat = dict(tree) if isinstance(tree, Mapping) else flatten_fields(tree)
    dev = resolve_device(device)

    def leaf(name):
        if name == "obstacles.half_wh" and name not in flat:
            return None  # circles only
        a = np.asarray(flat[name])
        dtype = torch.int32 if name in _INT_LEAVES else (
            torch.bool if a.dtype == bool else torch.float32)
        return torch.tensor(a, dtype=dtype, device=dev)

    def group(cls, prefix):
        return cls(**{f.name: leaf(f"{prefix}{f.name}") for f in dataclasses.fields(cls)})

    top = {f.name: leaf(f.name) for f in dataclasses.fields(EnvState)
           if f.name not in ("path", "obstacles", "body")}
    return EnvState(
        path=group(PathData, "path."), obstacles=group(ObstacleSet, "obstacles."),
        body=group(BodyState, "body."), **top,
    )


def env_state_to_numpy(state: EnvState) -> dict:
    """The port's EnvState -> {"path.wps": ndarray, ...} (JAX leaf names)."""
    return flatten_fields(state)


def opt_state_from_numpy(optimizer: torch.optim.Adam, params: ActorCritic, adam_state) -> None:
    """Load optax's `ScaleByAdamState` into `optimizer`, the port's Adam over
    `params` (`learn/optim.py`).

    `adam_state` has `count` (the steps taken), `mu` and `nu` (the first and
    second moments), with numpy leaves; `mu` and `nu` are trees of the
    `ActorCriticParams` layout or flat dicts in the agent-file naming.  The
    next step then applies the bias correction of step `count + 1`, as
    optax does.  For a population (stacked `params`) the moments are
    stacked alike and `count` has one entry a member, all equal.
    """
    counts = np.unique(np.asarray(adam_state.count))
    if counts.size != 1:
        raise ValueError(f"members at different Adam steps {counts}: one Adam steps them all")
    moments = {k: v if isinstance(v, Mapping) else params_to_flat_dict(v)
               for k, v in (("exp_avg", adam_state.mu), ("exp_avg_sq", adam_state.nu))}
    by_key = dict(params.named_parameters())
    index = {id(p): i for i, p in enumerate(optimizer.param_groups[0]["params"])}
    state = {}
    for name in moments["exp_avg"]:
        p = by_key[state_dict_key(name)]
        state[index[id(p)]] = {
            "step": torch.tensor(float(counts[0]), dtype=torch.float32),
            **{k: torch.tensor(np.asarray(m[name], np.float32)).reshape(p.shape)
               for k, m in moments.items()},
        }
    if len(state) != len(index):
        raise ValueError(f"Adam state for {len(state)} of {len(index)} parameters")
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)


def train_state_from_numpy(tree, learning_rate: float, device=None) -> TrainState:
    """The JAX package's `TrainState`, with numpy leaves, -> the port's:
    params, Adam state (optax's clip + Adam chain; a fresh Adam when
    `opt_state` is None), envs, obs, the counters and the PLR fields
    (`rehearsal_probs`, `family_counts`, `family_wins`).  The JAX key has no
    counterpart: the state gets a fresh generator on `device`."""
    dev = resolve_device(device)
    params = flat_dict_to_params(params_to_flat_dict(tree.params), device=dev)
    opt = optim.adam(params.parameters(), learning_rate)
    if tree.opt_state is not None:
        opt_state_from_numpy(opt, params, tree.opt_state[1][0])

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return TrainState(
        params=params, optimizer=opt, env_state=env_state_from_numpy(tree.env_state, dev),
        obs=f32(tree.obs), generator=torch.Generator(device=dev),
        global_step=f32(tree.global_step), episodes_total=f32(tree.episodes_total),
        rehearsal_probs=f32(tree.rehearsal_probs), family_counts=f32(tree.family_counts),
        family_wins=f32(tree.family_wins),
    )


def zoo_state_from_numpy(tree, learning_rate: float, device=None) -> ZooState:
    """The JAX package's zoo state (its `TrainState` stacked over S members
    by `ZooTrainer.init`, numpy leaves) -> the port's ZooState: the params
    stacked, the Adam state, member m's N envs as rows [m N, (m + 1) N) of
    one batch, the counters and PLR fields (S, ...).  The members get fresh
    generators on `device`."""
    dev = resolve_device(device)
    flat = params_to_flat_dict(tree.params)
    S = np.shape(flat["log_std"])[0]
    params = stack_params([flat_dict_to_params({k: v[m] for k, v in flat.items()}, device=dev)
                           for m in range(S)])
    opt = optim.adam(params.parameters(), learning_rate)
    opt_state_from_numpy(opt, params, tree.opt_state[1][0])
    env = {k: v.reshape((-1,) + v.shape[2:]) for k, v in flatten_fields(tree.env_state).items()}

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return ZooState(
        params=params, optimizer=opt, env_state=env_state_from_numpy(env, dev),
        obs=f32(np.asarray(tree.obs).reshape(-1, np.shape(tree.obs)[-1])),
        generators=[torch.Generator(device=dev) for _ in range(S)],
        **{k: f32(getattr(tree, k)) for k in ("global_step", "episodes_total",
                                               "rehearsal_probs", "family_counts",
                                               "family_wins")},
    )
