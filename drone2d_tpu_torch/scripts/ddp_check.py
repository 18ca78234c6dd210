"""Check the data-parallel update across ranks against its one-process
replay.

Run under torchrun, one rank a card (NCCL):

    torchrun --standalone --nproc_per_node=K -m drone2d_tpu_torch.scripts.ddp_check \\
        --preset flagship-scratch

It takes the train CLI's flags (`drone2d_tpu_torch.train`); `--device cpu`
runs the ranks on the host over gloo.  Every rank builds the learner over
`--num-envs` envs in all, runs `shard_init` and one `shard_update`, then
replays the same update of all K ranks in its own process
(`parallel.mesh.union_update`) and holds its weights against the replay at
rtol 2e-5, atol 2e-6 (the JAX package's tolerance for its shards against
the union batch), and its weights and Adam moments against rank 0's bit
for bit.  Rank 0 prints one JSON line of the results, then DDP CHECK OK;
a failed check exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.models.policy import params_to_flat_dict
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action
from drone2d_tpu_torch.parallel import mesh
from drone2d_tpu_torch.parallel.multihost import launched
from drone2d_tpu_torch.train import parse_args

RTOL, ATOL = 2e-5, 2e-6


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


def check(train_cfg, env_cfg, ppo_cfg, device) -> dict:
    """One sharded update on this rank and its union replay -> this
    rank's results."""
    group, dev = mesh.make_group(device)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    learner = PPOLearner(env_cfg, ppo_cfg, train_cfg.num_envs, device=dev)
    state = mesh.shard_init(group, learner, train_cfg.seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    state, metrics = mesh.shard_update(group, learner)(state)
    sync()
    seconds = time.perf_counter() - t0
    launches = fused_sample_action.launches
    got = params_to_flat_dict(state.params)
    replicated = (_equal_to_rank0(mesh._flat_params(state.params), group)
                  and _equal_to_rank0(_flat_adam(state.optimizer), group))

    local = mesh.local_learner(learner, world)
    states = [mesh.rank_state(local, train_cfg.seed, r) for r in range(world)]
    shared = dict(params=states[0].params, optimizer=states[0].optimizer,
                  generator=states[0].generator)
    states = mesh.union_update(learner, [dataclasses.replace(s, **shared) for s in states])
    return dict(rank=rank, device=str(dev), backend=dist.get_backend(group),
                seconds=seconds, launches=launches, loss=float(metrics["loss"]),
                global_step=float(metrics["global_step"]),
                excess=excess(got, params_to_flat_dict(states[0].params)),
                replicated=replicated)


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
          and all(r["global_step"] == train_cfg.num_envs * ppo_cfg.n_steps for r in rows))
    if mine["rank"] == 0:
        print(json.dumps(dict(world=len(rows), num_envs=train_cfg.num_envs,
                              n_epochs=ppo_cfg.n_epochs, rtol=RTOL, atol=ATOL, ranks=rows)))
        print("DDP CHECK OK" if ok else "DDP CHECK FAILED", flush=True)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
