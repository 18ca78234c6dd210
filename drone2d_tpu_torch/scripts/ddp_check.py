"""Check the data-parallel update across ranks against its one-process
replay.

Run under torchrun, one rank a card (NCCL):

    torchrun --standalone --nproc_per_node=K -m drone2d_tpu_torch.scripts.ddp_check \\
        --preset flagship-scratch

It takes the train CLI's flags (`drone2d_tpu_torch.train`); `--device cpu`
runs the ranks on the host over gloo.  Every rank builds the learner over
`--num-envs` envs in all, runs `shard_init` and one `shard_update` (the
captured update: `update_jit` with the group, NCCL's collectives inside
the CUDA graphs on the cards; its bodies run directly on the host), then
replays the same update of all K ranks in its own process
(`parallel.mesh.union_update`) and holds its weights against the replay at
rtol 2e-5, atol 2e-6 (the JAX package's tolerance for its shards against
the union batch), and its weights and Adam moments against rank 0's bit
for bit.  It also runs the eager update (`PPOLearner.update(...,
group=group)`, the draws made eagerly from the rank's generator) from a
twin state and reports whether the two agree bit for bit (`eager_equal`:
weights, Adam, metrics) and, in the units of `excess`, how far the eager
weights lie from the captured ones (`eager_excess`): NCCL may reduce in
another order under capture.  Then it times one update each
way in turn (ROUNDS; `seconds`), and counts the kernel launches of the
capturing update (`capture_launches`: 2 (n_steps + 1) on a card) and of a
replayed one (`launches`: n_steps + 1).  Rank 0 prints one JSON line of
the results, then DDP CHECK OK; a failed check exits non-zero.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.models.policy import params_to_flat_dict
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action
from drone2d_tpu_torch.parallel import mesh
from drone2d_tpu_torch.parallel.multihost import launched
from drone2d_tpu_torch.train import parse_args

RTOL, ATOL = 2e-5, 2e-6
# the timed updates after the checks, continuing each state, in turn
ROUNDS = ("captured", "eager", "eager", "captured")


def excess(got: dict, ref: dict) -> float:
    """max |got - ref| / (atol + rtol |ref|) over every leaf: at most 1 passes."""
    return max(float(np.max(np.abs(got[k].astype(np.float64) - ref[k])
                            / (ATOL + RTOL * np.abs(ref[k])))) for k in ref)


def _flat_adam(opt: torch.optim.Adam) -> torch.Tensor:
    return torch.cat([s[k].reshape(-1) for s in opt.state.values()
                      for k in ("exp_avg", "exp_avg_sq")])


def _equal_to_rank0(x: torch.Tensor, group) -> bool:
    ref = x.clone()
    dist.broadcast(ref, src=0, group=group)
    return bool(torch.equal(ref, x))


def _twin(state, device):
    """A copy of a rank's state with weights, Adam and a generator of its own
    at the same state (the envs are replaced by an update, never written)."""
    params = copy.deepcopy(state.params)
    opt = optim.adam(params.parameters(), state.optimizer.defaults["lr"])
    opt.load_state_dict(state.optimizer.state_dict())
    gen = torch.Generator(device=device)
    gen.set_state(state.generator.get_state())
    return dataclasses.replace(state, params=params, optimizer=opt, generator=gen)


def check(train_cfg, env_cfg, ppo_cfg, device) -> dict:
    """One captured sharded update on this rank against its union replay and
    against the eager sharded update from a twin state; then TIMED rounds
    of one update each way, in turn -> this rank's results."""
    group, dev = mesh.make_group(device)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    learner = PPOLearner(env_cfg, ppo_cfg, train_cfg.num_envs, device=dev)
    state = mesh.shard_init(group, learner, train_cfg.seed)
    eager_state = _twin(state, dev)
    local = mesh.local_learner(learner, world)
    updates = {"captured": mesh.shard_update(group, learner),
               "eager": functools.partial(local.update, group=group)}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    state, metrics = updates["captured"](state)
    sync()
    capture_seconds = time.perf_counter() - t0
    capture_launches = fused_sample_action.launches
    eager_state, eager_metrics = updates["eager"](eager_state)
    got = params_to_flat_dict(state.params)
    replicated = (_equal_to_rank0(mesh._flat_params(state.params), group)
                  and _equal_to_rank0(_flat_adam(state.optimizer), group))
    eager = params_to_flat_dict(eager_state.params)
    eager_equal = (all(np.array_equal(got[k], eager[k]) for k in got)
                   and torch.equal(_flat_adam(state.optimizer), _flat_adam(eager_state.optimizer))
                   and all(torch.equal(metrics[k], eager_metrics[k]) for k in metrics))
    union = [mesh.rank_state(local, train_cfg.seed, r) for r in range(world)]
    shared = dict(params=union[0].params, optimizer=union[0].optimizer)
    union = mesh.union_update(learner, [dataclasses.replace(s, **shared) for s in union])
    union_excess, eager_excess = excess(got, params_to_flat_dict(union[0].params)), excess(eager,
                                                                                          got)

    # one update each way in turn, continuing each state (the flat dicts
    # above may share the weights' memory: every check is made by now)
    states = {"captured": state, "eager": eager_state}
    seconds = {k: [] for k in states}
    launches = None
    for name in ROUNDS:
        sync()
        before = fused_sample_action.launches
        t0 = time.perf_counter()
        states[name], _ = updates[name](states[name])
        sync()
        seconds[name].append(time.perf_counter() - t0)
        if name == "captured" and launches is None:
            launches = fused_sample_action.launches - before

    return dict(rank=rank, device=str(dev), backend=dist.get_backend(group),
                captured=mesh.captures(group, dev), capture_seconds=capture_seconds,
                capture_launches=capture_launches, launches=launches, seconds=seconds,
                loss=float(metrics["loss"]), global_step=float(metrics["global_step"]),
                excess=union_excess, replicated=replicated, eager_equal=eager_equal,
                eager_excess=eager_excess)


def main(argv=None) -> None:
    args, train_cfg, env_cfg, ppo_cfg = parse_args(argv)
    if not launched():
        raise SystemExit("ddp_check: run it under torchrun (WORLD_SIZE and RANK unset)")
    mine = check(train_cfg, env_cfg, ppo_cfg, args.device)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, mine)
    dist.destroy_process_group()
    ok = (all(r["excess"] <= 1.0 and r["replicated"] for r in rows)
          # the kernel launches once a rollout step and once for the last
          # values on a card; the host runs its plain version
          and all(r["launches"] == (ppo_cfg.n_steps + 1 if r["device"].startswith("cuda")
                                    else 0) for r in rows)
          and all(r["capture_launches"] == (2 * (ppo_cfg.n_steps + 1) if r["captured"]
                                            and r["device"].startswith("cuda")
                                            else r["launches"]) for r in rows)
          and all(r["global_step"] == train_cfg.num_envs * ppo_cfg.n_steps for r in rows))
    if mine["rank"] == 0:
        print(json.dumps(dict(world=len(rows), num_envs=train_cfg.num_envs,
                              n_epochs=ppo_cfg.n_epochs, rtol=RTOL, atol=ATOL, ranks=rows)))
        print("DDP CHECK OK" if ok else "DDP CHECK FAILED", flush=True)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
