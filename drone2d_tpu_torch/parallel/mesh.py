"""Scale-out: env-batch data parallelism over a `torch.distributed` group.

Counterpart of `drone2d_tpu/parallel/mesh.py`, which shards the env batch
over a 1-D device mesh with `shard_map`.  Here each rank is one process
driving one device.  Every rank runs the whole PPO update (rollout, GAE,
minibatch SGD) on its own slice of `num_envs / world` envs; the advantage
moments, the gradients, the loss and aux of each minibatch, and the
rollout's episode stats are reduced over the group inside
`PPOLearner.update_jit` (`group=`; CUDA graphs that hold NCCL's
collectives on the card), so the weights and the optimizer stay
replicated and the math is large-batch PPO whose k-th minibatch is the
union of the ranks' k-th local minibatches.  `union_update` replays that in
one process, and the tests hold `shard_update` against it.

Each rank's state carries a generator of its own, seeded once from the
run's seed folded with the rank (`rank_generator`), as the JAX package
folds `axis_index` into its key (`drone2d_tpu/parallel/mesh.py:128-131`),
and advanced by the rank's draws from update to update.  The update draws
from it inside its CUDA graph, which is bound to that one generator object:
no seed is read back from the card, and the ranks' streams differ because
their seeds do.  A restore seeds each rank's generators anew from the seed
the checkpoint stores, folded with the rank the same way.

Unlike the JAX package's one-device shortcut (`:117-124`), the collectives
run at world size 1 too: a sum over one rank and a division by 1.0 are
exact, so a world-1 update equals `PPOLearner.update` bit for bit.
"""

from __future__ import annotations

import functools
import os
import socket
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.learn.ppo import PPOLearner, TrainState
from drone2d_tpu_torch.models.policy import ActorCritic
from drone2d_tpu_torch.parallel.multihost import default_backend, init_distributed, launched


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_group(device=None, *, backend=None, init_method=None, world_size=None, rank=None):
    """The world's process group and this rank's device -> (group, device).

    The device is `cuda:LOCAL_RANK` unless given (two ranks may be given the
    same card).  The backend is NCCL for a CUDA device and gloo for the
    CPU unless given; nothing falls back to another.  Under torchrun the
    group comes from its variables (`init_distributed`); a lone process
    with no arguments gets a group of one over a free localhost port."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized() and init_method is None and world_size is None \
            and not launched():
        init_method, world_size, rank = f"tcp://localhost:{free_port()}", 1, 0
    init_distributed(backend or default_backend(device), init_method, world_size, rank)
    return dist.group.WORLD, device


def fold_in(seed: int, data: int) -> int:
    """A seed for stream `data` of `seed` (the JAX package's
    `random.fold_in`): two different pairs give unrelated seeds."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1, np.uint64)[0] >> 1)


def seeded(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """The generator of rank `rank`'s draws (reset templates, action noise,
    shuffles) in a run from `seed`: seeded with `fold_in(fold_in(seed, 0),
    rank)`, a stream apart from every rank's envs (`fold_in(seed, 1 +
    rank)`), computed on the host."""
    return seeded(fold_in(fold_in(seed, 0), rank), device)


def env_generator(seed: int, rank: int, device) -> torch.Generator:
    """The generator of rank `rank`'s initial envs in a run from `seed`."""
    return seeded(fold_in(seed, 1 + rank), device)


def local_learner(learner: PPOLearner, world: int) -> PPOLearner:
    """The learner of one rank's `num_envs / world` envs, whose global_step
    advances by the global env count (`drone2d_tpu/parallel/mesh.py:54-63`)."""
    if learner.num_envs % world:
        raise ValueError(f"num_envs={learner.num_envs} % {world} ranks != 0")
    return PPOLearner(learner.env.cfg, learner.cfg, learner.num_envs // world,
                      device=learner.device, step_increment=learner.num_envs)


def rank_state(local: PPOLearner, seed: int, rank: int, params: ActorCritic | None = None,
               global_step: float = 0.0) -> TrainState:
    """Rank `rank`'s initial state: the weights of `seed` (or `params`, a
    warm start), a fresh optimizer, its own envs reset from
    `env_generator(seed, rank)` and its own `rank_generator(seed, rank)`."""
    dev = local.device
    if params is None:
        params = ActorCritic(OBS_DIM, ACT_DIM, local.cfg.hidden_sizes,
                             generator=torch.Generator().manual_seed(seed), device=dev)
    return local.start(rank_generator(seed, rank, dev), params, global_step,
                       env_generator=env_generator(seed, rank, dev))


def _flat_params(params: ActorCritic) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in params.parameters()])


def check_replicated(group, params: ActorCritic) -> None:
    """Broadcast rank 0's weights and raise unless they equal this rank's."""
    mine = _flat_params(params)
    ref = mine.clone()
    dist.broadcast(ref, src=0, group=group)
    if not torch.equal(ref, mine):
        raise RuntimeError(f"rank {dist.get_rank(group)}'s weights differ from rank 0's")


def shard_init(group, learner: PPOLearner, seed: int,
               params: ActorCritic | None = None) -> TrainState:
    """This rank's TrainState for `shard_update`.

    `learner.num_envs` is the GLOBAL env count; `num_envs % world` must be 0.
    Every rank builds the same weights from `seed` (or copies `params`, a
    warm start) and checks them against rank 0's by a broadcast; each resets
    its own `num_envs / world` envs from a per-rank seed."""
    local = local_learner(learner, dist.get_world_size(group))
    state = rank_state(local, seed, dist.get_rank(group), params)
    check_replicated(group, state.params)
    return state


def shard_restore(group, learner: PPOLearner, directory: str) -> Tuple[TrainState, int]:
    """The latest checkpoint under `directory` restored on this rank: the
    weights, Adam, counters and PLR fields as saved, and this rank's
    generators seeded from the seed the checkpoint stores as `shard_init`
    seeds them from the run's (`rank_generator`, `env_generator`), its env
    slice reset at the restored step, as the JAX package's restore resets
    the envs (`drone2d_tpu/utils/checkpoint.py:111-114`).  Nothing is read
    from the card.  Returns (state, step)."""
    from drone2d_tpu_torch.utils.checkpoint import restore_checkpoint

    local = local_learner(learner, dist.get_world_size(group))
    rank, dev = dist.get_rank(group), local.device
    state, step = restore_checkpoint(
        directory, local,
        streams=lambda seed: (rank_generator(seed, rank, dev), env_generator(seed, rank, dev)))
    check_replicated(group, state.params)
    return state, step


def captures(group, device) -> bool:
    """Whether `shard_update` runs the captured update for `group` on
    `device`: always on the CPU, where the graphs' bodies run directly, and
    on the card with NCCL, whose collectives a CUDA graph can record.  gloo
    on the card cannot be recorded, so it takes the eager update: a choice
    by the backend, not a fallback."""
    return resolve_device(device).type == "cpu" or dist.get_backend(group) == "nccl"


def shard_update(group, learner: PPOLearner
                 ) -> Callable[[TrainState], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The data-parallel PPO update: TrainState -> (TrainState, metrics).

    Each rank draws from its state's own generator (`rank_generator`) and
    rolls out its own envs; the reductions run inside the update.  That
    update is `PPOLearner.update_jit(..., group=group)`, the draws and the
    collectives recorded into its CUDA graphs with NCCL on the card, as the
    JAX package jits its `shard_update`; a failed capture raises.  gloo on
    the card runs `PPOLearner.update(..., group=group)` instead
    (`captures`), with the same draws."""
    local = local_learner(learner, dist.get_world_size(group))
    run = local.update_jit if captures(group, local.device) else local.update
    return functools.partial(run, group=group)


def union_update(learner: PPOLearner, states: Sequence[TrainState]) -> List[TrainState]:
    """One `shard_update` of `len(states)` ranks replayed in one process,
    the reference the tests hold it against (`tests/test_parallel.py`'s
    union-batch replay).  `states` are the ranks' states, sharing one
    weights object and one optimizer, each with its own generator; each
    rank's rollout is replayed with its own draws, then every SGD step
    takes the union of the ranks' k-th local minibatches through the plain
    loss, clip and Adam.  Returns the ranks' new states, the weights and
    the optimizer updated in place."""
    world = len(states)
    local = local_learner(learner, world)
    cfg = local.cfg
    out, streams = [], []
    for state in states:
        reset_state, reset_obs, noise, perms = local.draws(state)
        new_state, batch, last_values, _ = local.rollout_from(state, reset_state, reset_obs,
                                                              noise)
        adv, ret = compute_gae(batch.rewards, batch.values, batch.dones, last_values,
                               gamma=cfg.gamma, gae_lambda=cfg.gae_lambda)
        data = (batch.obs, batch.actions, batch.log_probs, adv, ret)
        streams.append(local._minibatches(data, perms.to(local.device), None))
        out.append(new_state)
    params, opt = states[0].params, states[0].optimizer
    leaves = list(params.parameters())
    for mbs in zip(*streams):
        union = [torch.cat(parts) for parts in zip(*mbs)]
        loss, _ = local.loss_fn(params, *union)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        optim.clip_by_global_norm_([p.grad for p in leaves], cfg.max_grad_norm)
        opt.step()
    return out
