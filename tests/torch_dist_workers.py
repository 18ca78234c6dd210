"""The rank processes of tests/test_torch_parallel.py.

Each is started as `python -m tests.torch_dist_workers RANK WORLD DIR`,
joins a gloo group on the CPU through a rendezvous file in DIR, runs the
jobs listed in DIR/jobs.json in order and writes DIR/<job>_<rank>.pt.
Imports no JAX: the inputs the JAX package drew arrive as .npz files.
"""

from __future__ import annotations

import functools
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy, params_from_flat
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner, TrainState
from drone2d_tpu_torch.learn.zoo import ZooTrainer, shard_population, train_zoo
from drone2d_tpu_torch.models.policy import params_to_flat_dict
from drone2d_tpu_torch.parallel.mesh import (
    local_learner, make_group, shard_init, shard_restore, shard_update)
from drone2d_tpu_torch.utils.checkpoint import save_checkpoint

ENV_KW = dict(path_table_n=128)
PPO_KW = dict(n_steps=8, num_minibatches=2, n_epochs=2, shuffle="timeperm",
              hidden_sizes=(32, 32))
GLOBAL_ENVS, SEED, UPDATES = 16, 7, 2
POP_SEEDS, POP_ENVS = (3, 4, 5, 6), 8


def _learner(num_envs, **kw):
    return PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**PPO_KW), num_envs, device="cpu", **kw)


def job_shard(group, rank, directory):
    """UPDATES sharded updates from shard_init(SEED) (the captured update,
    `update_jit` with the group); then rank 0 saves a checkpoint and every
    rank restores it (`shard_restore`)."""
    learner = _learner(GLOBAL_ENVS)
    state = shard_init(group, learner, SEED)
    update = shard_update(group, learner)
    metrics = []
    for _ in range(UPDATES):
        state, m = update(state)
        metrics.append({k: float(v) for k, v in m.items()})
    ckpt = os.path.join(directory, "ckpt")
    if rank == 0:
        save_checkpoint(ckpt, state)
    dist.barrier(group)
    restored, step = shard_restore(group, learner, ckpt)
    return dict(params=params_to_flat_dict(state.params), metrics=metrics,
                adam=[{k: v.clone() for k, v in s.items()}
                      for s in state.optimizer.state.values()],
                generator=state.generator.get_state(), obs=state.obs,
                global_step=float(state.global_step),
                episodes_total=float(state.episodes_total),
                restored=dict(step=step, params=params_to_flat_dict(restored.params),
                              obs=restored.obs, global_step=float(restored.global_step),
                              generator=restored.generator.get_state()))


def job_shard_eager(group, rank, directory):
    """`job_shard`'s updates through the eager update, `update(...,
    group=group)` drawing from the rank's generator: the update that gloo
    runs on the card."""
    learner = _learner(GLOBAL_ENVS)
    state = shard_init(group, learner, SEED)
    local = local_learner(learner, dist.get_world_size(group))
    update = functools.partial(local.update, group=group)
    metrics = []
    for _ in range(UPDATES):
        state, m = update(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(params=params_to_flat_dict(state.params), metrics=metrics,
                global_step=float(state.global_step))


def _jax_update(group, rank, directory, captured: bool):
    """One update of this rank's slice with the JAX package's state and
    per-shard draws injected: `update_from` with the group, or
    `update_jit(..., group=group)` with the same draws (`captured`)."""
    z = dict(np.load(os.path.join(directory, f"jax_in_{rank}.npz")))
    sub = lambda p: {k[len(p):]: v for k, v in z.items() if k.startswith(p)}  # noqa: E731
    n_loc = z["obs"].shape[0]
    local = _learner(n_loc, step_increment=n_loc * dist.get_world_size(group))
    params = params_from_flat(sub("params/"), device="cpu")
    state = TrainState(
        params=params, optimizer=optim.adam(params.parameters(), local.cfg.learning_rate),
        env_state=env_state_from_numpy(sub("env/"), device="cpu"),
        obs=torch.tensor(z["obs"]), generator=torch.Generator(),
        global_step=torch.tensor(float(z["global_step"])), episodes_total=torch.tensor(0.0))
    draws = (env_state_from_numpy(sub("reset/"), device="cpu"), torch.tensor(z["reset_obs"]),
             torch.tensor(z["noise"]), torch.tensor(z["perms"]))
    if captured:
        state, metrics = local.update_jit(state, draws, group=group)
    else:
        state, metrics = local.update_from(state, *draws, group=group)
    return dict(params=params_to_flat_dict(state.params),
                metrics={k: float(v) for k, v in metrics.items()},
                global_step=float(state.global_step),
                episodes_total=float(state.episodes_total))


def job_jax(group, rank, directory):
    """One update of this rank's slice with the JAX package's state and
    per-shard draws injected (`update_from` with the group)."""
    return _jax_update(group, rank, directory, captured=False)


def job_jax_jit(group, rank, directory):
    """`job_jax` through the captured update, `update_jit(..., group=group)`
    (its bodies run directly on the CPU, collectives included)."""
    return _jax_update(group, rank, directory, captured=True)


def job_population(group, rank, directory):
    """One update of this rank's block of POP_SEEDS."""
    seeds = shard_population(group, POP_SEEDS)
    trainer = ZooTrainer(EnvConfig(**ENV_KW), PPOConfig(**PPO_KW), POP_ENVS, device="cpu")
    state, metrics = trainer.update(trainer.init(seeds))
    return dict(seeds=seeds, members={s: params_to_flat_dict(state.params.member(i))
                                      for i, s in enumerate(seeds)},
                loss=metrics["loss"].clone())


def job_train_zoo(group, rank, directory):
    """`train_zoo` over the group: one update of this rank's block of
    POP_SEEDS, each seed's files written under DIR/zoo by its rank."""
    train_zoo(EnvConfig(**ENV_KW), PPOConfig(**PPO_KW), POP_ENVS, POP_SEEDS,
              PPO_KW["n_steps"] * POP_ENVS, os.path.join(directory, "zoo"), device="cpu",
              group=group)
    return {}


def job_raises(group, rank, directory):
    """The messages of shard_init over 3 envs and shard_population of 3
    seeds, each of which must raise ValueError."""
    out = {}
    for name, fn in (("num_envs", lambda: shard_init(group, _learner(3), SEED)),
                     ("population", lambda: shard_population(group, (1, 2, 3)))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def main(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    group, _ = make_group("cpu", backend="gloo",
                          init_method=f"file://{os.path.join(directory, 'rendezvous')}",
                          world_size=world, rank=rank)
    try:
        with open(os.path.join(directory, "jobs.json")) as f:
            jobs = json.load(f)
        for job in jobs:
            result = globals()[f"job_{job}"](group, rank, directory)
            torch.save(result, os.path.join(directory, f"{job}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
