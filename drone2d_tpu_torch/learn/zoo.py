"""Population (zoo) training: S seeds trained as one batch.

Counterpart of `drone2d_tpu/learn/zoo.py`, which runs `jax.vmap(learner.update)`
over a stacked state.  Here the vmap is written out, in `learn/ppo.py`'s
update, which takes a member axis.  The S members' weights are one
`ActorCritic` with a leading member axis (`models/policy.stack_params`), and
their envs are one env batch of S * N: member m owns rows [m N, (m + 1) N).
A rollout step is then one env step over S * N envs and one launch of the
fused policy kernel for every member (`ops/fused_policy.py`, the agent on
the grid's y axis).  GAE runs over (T, S * N).  Each SGD step gathers every
member's minibatch with that member's own permutation and sums the members'
losses.  The gradient of the sum is each member's own gradient, since
members share no weight.  The clip is taken per member, and one Adam over
the stacked leaves is S independent Adams (`learn/optim.py`).

Every member draws from its own `torch.Generator`, seeded as
`PPOLearner.init(seed)` seeds one, and in the same order: its reset
template, its (T, N, 2) action noise, its shuffles.  A member of a population
therefore trains as the single-seed learner would from the same seed, up to
float32 rounding (the stacked products and per-member sums run in another
order).  `update_from` takes the draws, so tests can feed it the JAX
package's.

`shard_population` splits the member axis over the ranks of a
`torch.distributed` group with no collective, as the JAX package shards it
over a device mesh: each rank trains its own block of S / world seeds, and
`train_zoo(group=...)` writes each seed's files from the rank that owns it.

Seed-selection campaigns pair this with
`drone2d_tpu_torch.scripts.select_agents` (batched multi-agent eval).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM
from drone2d_tpu_torch.env.types import FAMILY_NAMES, EnvState, cat_states
from drone2d_tpu_torch.eval.run import load_params
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.plr import reweight_rehearsal
from drone2d_tpu_torch.learn.ppo import PPOLearner, TrainState
from drone2d_tpu_torch.models.policy import ActorCritic, params_to_flat_dict, stack_params
from drone2d_tpu_torch.utils import profiling


@dataclasses.dataclass
class ZooState:
    """A population's state: `TrainState` with a member axis S on each field."""

    params: ActorCritic                # every leaf (S, ...)
    optimizer: torch.optim.Adam        # over the stacked leaves
    env_state: EnvState                # S * N envs, member-major
    obs: torch.Tensor                  # (S * N, 27)
    generators: List[torch.Generator]  # one a member
    global_step: torch.Tensor          # (S,) float32
    episodes_total: torch.Tensor       # (S,) float32
    rehearsal_probs: torch.Tensor      # (S, 7)
    family_counts: torch.Tensor        # (S, 8)
    family_wins: torch.Tensor          # (S, 8)


class ZooTrainer(PPOLearner):
    """Binds (EnvConfig, PPOConfig, num_envs per member) to a device (the
    card unless device="cpu").  `init(seeds)` -> ZooState; `update(state)`
    -> (state', metrics), every metric shaped (S,) under the JAX package's
    keys; `update_jit(state)` the same as CUDA graphs on the card, one
    program for all S members (one kernel launch a step through the agent
    axis), the counterpart of `jax.jit(jax.vmap(update))`.  The rollout,
    GAE and SGD are `PPOLearner`'s, which take the member axis; this class
    draws for each member from its own generator."""

    def init(self, seeds: Sequence[int], params: ActorCritic | None = None) -> ZooState:
        """One member per seed, each started as `PPOLearner.init(seed)` starts
        it (its own generator, envs and initial weights), or, given `params`,
        every member from its own copy of `params` (a warm start)."""
        return assemble([PPOLearner.init(self, int(s), params=params) for s in seeds],
                        self.cfg.learning_rate)

    def draws(self, state: ZooState):
        """Each member's draws from its own generator, in the order of
        `PPOLearner.draws`: the reset template, the (T, N, 2) action noise,
        then the shuffles.  Returns them as `update_from` takes them: the
        members' templates as one of S * N envs, member-major, the noise
        (T, S, N, 2) and the shuffles (S, n_epochs, ...)."""
        T, N = self.cfg.n_steps, self.num_envs
        templates, noise, perms = [], [], []
        for m, gen in enumerate(state.generators):
            templates.append(self.env.reset_batch(
                gen, N, state.global_step[m], self._reset_probs(state.rehearsal_probs[m])))
            noise.append(torch.randn((T, N, ACT_DIM), generator=gen, device=self.device))
            perms.append(self.draw_perms(gen))
        return (cat_states([t for t, _ in templates]), torch.cat([o for _, o in templates]),
                torch.stack(noise, dim=1), torch.stack(perms))


    def generators(self, state: ZooState):
        """The members' generators, which `draws(state)` draws from."""
        return list(state.generators)


def assemble(members: Sequence[TrainState], learning_rate: float) -> ZooState:
    """A ZooState of single-seed TrainStates, in order: their weights
    stacked (copies), their envs as one batch, a fresh Adam over the stack
    and their generators as they are."""
    params = stack_params([m.params for m in members])
    return ZooState(
        params=params, optimizer=optim.adam(params.parameters(), learning_rate),
        env_state=cat_states([m.env_state for m in members]),
        obs=torch.cat([m.obs for m in members]),
        generators=[m.generator for m in members],
        **{k: torch.stack([getattr(m, k) for m in members])
           for k in ("global_step", "episodes_total", "rehearsal_probs", "family_counts",
                     "family_wins")},
    )


def warm_start(trainer: ZooTrainer, seeds: Sequence[int], init_params: str) -> ZooState:
    """A population of `seeds` with every member from its own copy of one
    agent (an agent .npz or the port's checkpoint directory): the policy
    only, so that the optimizer, envs and generators stay per seed and the
    members diverge through their data and draws.  Raises unless the
    agent's shapes are the population's.  Recorded as the span
    `zoo.warm_start` (the file, the members, the seconds on the host)."""
    with profiling.span("zoo.warm_start", file=str(init_params), members=len(seeds)) as span:
        t = time.perf_counter()
        params = load_params(init_params, device=trainer.device)
        got = {k: v.shape for k, v in params_to_flat_dict(params).items()}
        want = {k: v.shape for k, v in params_to_flat_dict(
            ActorCritic(OBS_DIM, ACT_DIM, trainer.cfg.hidden_sizes, device="cpu")).items()}
        if got != want:
            raise ValueError(f"init_params {init_params} has shapes {got}, but the "
                             f"population expects {want} (check hidden_sizes)")
        state = trainer.init(seeds, params=params)
        span.set(seconds=time.perf_counter() - t)
    return state


def count_rehearsal(state: ZooState, since=None):
    """Add to the counters `rehearsal.episodes[<family>]` and
    `rehearsal.wins[<family>]` (`env.types.FAMILY_NAMES`) the growth of the
    population's finished episodes and wins per family since `since`, the
    sums this returned at its last call (None: since zero).  It copies the
    sums to the host, so call it only where the host waits anyway.  Returns
    the sums, (S, 8) host arrays each."""
    sums = (state.family_counts.cpu().numpy(), state.family_wins.cpu().numpy())
    for kind, now, before in zip(("episodes", "wins"), sums, since or (0.0, 0.0)):
        grown = (now - before).sum(axis=0)
        for name, n in zip(FAMILY_NAMES, grown.tolist()):
            profiling.count(f"rehearsal.{kind}[{name}]", n)
    return sums


def shard_population(group, seeds: Sequence[int]) -> List[int]:
    """This rank's block of the population `seeds`: the member axis split
    over the ranks of `group`, rank r taking seeds [r S / world, (r + 1) S /
    world).  Members share nothing, so the block trains alone, with no
    collective (`drone2d_tpu/learn/zoo.py:62-92`).  Raises unless the
    world size divides S."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if len(seeds) % world:
        raise ValueError(f"population size {len(seeds)} not divisible by {world} ranks")
    n = len(seeds) // world
    return list(seeds[rank * n:(rank + 1) * n])


def save_zoo(state: ZooState, seeds: Sequence[int], out_root: str,
             step: Optional[int] = None) -> List[str]:
    """Write each member's weights as seed_<s>/new_agent.npz (final) or
    seed_<s>/ckpt_<step>.npz (a snapshot), the agent-file naming that both
    packages' `load_params` read and `scripts/select_agents.py` finds."""
    paths = []
    for i, s in enumerate(seeds):
        d = os.path.join(out_root, f"seed_{s}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "new_agent.npz" if step is None else f"ckpt_{step}.npz")
        np.savez(path, **params_to_flat_dict(state.params.member(i)))
        paths.append(path)
    return paths


def snapshot_schedule(
    total_timesteps: int,
    spu: int,
    snapshots: int = 3,
    snapshot_steps: Optional[Sequence[int]] = None,
) -> tuple[int, set[int]]:
    """`train_zoo`'s schedule: the number of updates that reach
    `total_timesteps` at `spu` env steps a member an update, and the updates
    after which it writes a `ckpt_<update * spu>.npz` snapshot: `snapshots`
    evenly spaced ones (Python's round, half to even), or, given
    `snapshot_steps`, the first update whose env steps reach each."""
    n_updates = max((total_timesteps + spu - 1) // spu, 1)
    if snapshot_steps is not None:
        # a requested step at or after the end still writes its
        # ckpt_<step>.npz at the last update
        snap_at = {min(max(-(-int(s) // spu), 1), n_updates) for s in snapshot_steps}
    else:
        # within [1, n_updates - 1]: update n_updates is the final save; a
        # short run gets fewer (distinct) snapshots than asked
        snap_at = {
            min(max(round(n_updates * (i + 1) / (snapshots + 1)), 1), n_updates - 1)
            for i in range(snapshots)
        } if n_updates > 1 else set()
    return n_updates, snap_at


def train_zoo(
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    num_envs: int,
    seeds: Sequence[int],
    total_timesteps: int,
    out_root: str,
    *,
    snapshots: int = 3,
    snapshot_steps: Optional[Sequence[int]] = None,
    log_every: int = 20,
    init_params: Optional[str] = None,
    device=None,
    group=None,
) -> ZooState:
    """Train the population to `total_timesteps` each, writing snapshots on
    the way: `snapshots` evenly spaced ones, or, given `snapshot_steps`, one
    at the first update whose env steps reach each (a step past the end
    snapshots at the last update), then every member's new_agent.npz.  Under
    adaptive rehearsal with the controller on, each member reweights its own
    families every `log_every` updates.  `init_params` (an agent .npz or the
    port's checkpoint directory) warm-starts every member from its own copy
    of one agent.  Prints the population's mean and best success rate.
    With `group`, this rank trains its block of the seeds
    (`shard_population`) and writes their files; rank 0 prints its own
    block's rates."""
    if group is not None:
        seeds = shard_population(group, seeds)
    lead = group is None or dist.get_rank(group) == 0
    trainer = ZooTrainer(env_cfg, ppo_cfg, num_envs, device=device)
    if env_cfg.adaptive_rehearsal and float(trainer.initial_rehearsal_probs().sum()) <= 0.0:
        raise ValueError(
            "adaptive_rehearsal=True with a zero rehearsal budget is a "
            "silent no-op: set stage_mix_prob (and/or corridor_mix_prob, "
            "cross_mix_prob) > 0 to define the budget the controller "
            "redistributes"
        )
    if init_params:
        state = warm_start(trainer, seeds, init_params)
        if lead:
            print(f"warm-started {len(seeds)} members from {init_params}")
    else:
        state = trainer.init(seeds)
    spu = trainer.batch_size  # env steps a member an update
    n_updates, snap_at = snapshot_schedule(total_timesteps, spu, snapshots, snapshot_steps)

    adaptive = env_cfg.adaptive_rehearsal and env_cfg.rehearsal_adapt
    # the family sums at the last tick, which the counters and the
    # controller both take their growth from
    last = count_rehearsal(state) if env_cfg.adaptive_rehearsal else None
    t0 = time.perf_counter()
    for u in range(1, n_updates + 1):
        # the captured update (CUDA graphs on the card), the counterpart of
        # jit(vmap(update)); a rank's block trains alone, with no collective
        state, metrics = trainer.update_jit(state)
        if env_cfg.adaptive_rehearsal and (u % log_every == 0 or u == n_updates):
            sums = count_rehearsal(state, last)
            if adaptive and u % log_every == 0:
                # each member reweights its own families by its own failure
                # rates since the last tick (learn/plr.py broadcasts over
                # members)
                new_probs = reweight_rehearsal(state.rehearsal_probs.cpu().numpy(),
                                               sums[0] - last[0], sums[1] - last[1])
                state = dataclasses.replace(state, rehearsal_probs=torch.as_tensor(
                    new_probs, dtype=torch.float32, device=trainer.device))
            last = sums
        if u == 1:
            # the first update also builds the kernel: the rate starts after it
            float(metrics["loss"][0])
            t0 = time.perf_counter()
        if lead and (u % log_every == 0 or u == n_updates):
            sr = metrics["episodes/success_rate"].cpu().numpy()
            loss = metrics["loss"].cpu().numpy()
            rate = spu * len(seeds) * max(u - 1, 1) / max(time.perf_counter() - t0, 1e-9)
            print(
                f"update {u}/{n_updates}  step {u * spu:>9d}/seed  "
                f"loss {loss.mean():8.3f}  sr mean {sr.mean():.2f} "
                f"max {sr.max():.2f}  {rate:,.0f} steps/s ({len(seeds)} seeds)"
            )
        if u in snap_at:
            save_zoo(state, seeds, out_root, step=u * spu)
    save_zoo(state, seeds, out_root, step=None)
    return state
