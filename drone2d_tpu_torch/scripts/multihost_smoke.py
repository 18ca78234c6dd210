"""Multi-process smoke run of the data-parallel update (the port's
counterpart of `scripts/multihost_smoke.py`).

Spawns 2 local processes that form one `torch.distributed` group over
gloo; each builds the group through `parallel.make_group`, resets its half
of the envs (`shard_init`) and runs one sharded PPO update of a tiny
configuration (`shard_update`).  The parent checks that both ranks report
the same loss and global step, and prints MULTIHOST SMOKE OK.

The ranks run on the card unless `--device cpu` is given: rank K takes
`cuda:K` modulo the cards present (both share a lone card), or the card
`--device cuda:N` names.  The backend is gloo on either device, since
NCCL refuses two ranks on one card.

    python -m drone2d_tpu_torch.scripts.multihost_smoke [--device cpu]   # parent
    python -m drone2d_tpu_torch.scripts.multihost_smoke --rank K --port P   # rank K
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from drone2d_tpu_torch.device import resolve_device

NUM_PROCESSES = 2
GLOBAL_ENVS = 8


def rank_device(device: str, rank: int):
    """Rank `rank`'s device: `device` itself, or for a bare `cuda` the
    rank's own card modulo the cards present."""
    import torch

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def worker(rank: int, port: int, device: str) -> None:
    import torch

    from drone2d_tpu_torch.config import EnvConfig, PPOConfig
    from drone2d_tpu_torch.learn.ppo import PPOLearner
    from drone2d_tpu_torch.parallel import make_group, shard_init, shard_update
    from drone2d_tpu_torch.parallel.multihost import host_info

    torch.set_num_threads(1)
    group, device = make_group(rank_device(device, rank), backend="gloo",
                               init_method=f"tcp://localhost:{port}",
                               world_size=NUM_PROCESSES, rank=rank)
    info = host_info()
    if info.process_count != NUM_PROCESSES or info.process_index != rank:
        raise RuntimeError(f"rank {rank}: {info}")
    learner = PPOLearner(EnvConfig(n_steps=32, path_table_n=128),
                         PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2),
                         num_envs=GLOBAL_ENVS, device=device)
    state = shard_init(group, learner, seed=0)
    state, metrics = shard_update(group, learner)(state)
    loss, gs = float(metrics["loss"]), float(metrics["global_step"])
    if gs != GLOBAL_ENVS * learner.cfg.n_steps:
        raise RuntimeError(f"rank {rank}: global_step {gs}")
    print(f"RANK {info.process_index}/{info.process_count} loss={loss!r} OK", flush=True)
    torch.distributed.destroy_process_group()


def parent(timeout: float, device: str) -> int:
    from drone2d_tpu_torch.parallel.mesh import free_port

    resolve_device(device)  # no CUDA and no --device cpu: raise before spawning
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "drone2d_tpu_torch.scripts.multihost_smoke",
         "--rank", str(r), "--port", str(port), "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(NUM_PROCESSES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        print("TIMEOUT waiting for the ranks", file=sys.stderr)
        return 2
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out in outs:
        sys.stdout.write(out)
    if any(p.returncode for p in procs):
        return 1
    losses = [line.split("loss=")[1].split()[0] for o in outs for line in o.splitlines()
              if "loss=" in line]
    if len(losses) != NUM_PROCESSES or len(set(losses)) != 1:
        print(f"the ranks disagree: {losses}", file=sys.stderr)
        return 1
    print("MULTIHOST SMOKE OK")
    return 0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: rank K on card K modulo the cards), cuda:N or cpu")
    args = p.parse_args(argv)
    if args.rank is None:
        raise SystemExit(parent(args.timeout, args.device))
    worker(args.rank, args.port, args.device)


if __name__ == "__main__":
    main()
