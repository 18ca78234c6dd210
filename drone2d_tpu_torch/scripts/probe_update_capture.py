"""What `update_jit`'s capture costs at a training shape, and what its
replays take, on the card.  Default shape: the reference's own (SB3's
`PPO("MlpPolicy")` defaults, as the hunt of `README.md` trains it): a
population of 8 seeds x 14 envs x 2048-step rollouts, 448 minibatches of 64
x 10 epochs, the exact shuffle, the 64-64 policy, the hunt's env (`ENV`).

    python -m drone2d_tpu_torch.scripts.probe_update_capture [--vmap 8] \\
        [--num-envs 14] [--n-steps 2048] [--num-minibatches 448] \\
        [--chunk 2048] [--updates 2] [--check]

The rollout is recorded in graphs of `--chunk` steps (default
`learn.ppo.ROLLOUT_CHUNK`, what `update_jit` chooses; `--chunk` equal to
`--n-steps` records it unrolled, as one graph).  Prints one JSON line: the
chunks, the capture's warm-up, recording and instantiation seconds, each
graph's nodes, the pool's bytes, the process's peak resident set before and
after the capture, the capturing call's seconds and kernel launches, and
the seconds of each of `--updates` later replayed updates.  With `--check`,
first one captured update at one epoch (the epoch graph is the same for any
number of epochs) against the eager `update` from the same state: weights,
Adam's state, metrics, envs, counters and generators bit for bit.  Run each
`--chunk` in a process of its own: the peak resident set is the process's.
Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import resource
import time

import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.learn import ppo
from drone2d_tpu_torch.learn.zoo import ZooTrainer
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action
from drone2d_tpu_torch.utils import graphs

# the JAX package's SB3-shape hunt (`artifacts/campaigns/r3/r3_9m_sb3shape`):
# its seeds and its env, the published reward recipe
SEEDS = tuple(range(40, 48))
ENV = EnvConfig(PP_rew_max=3.5, rew_collision=-70.0, abs_inv_CA_min_rew=1.0 / 6.0)


def peak_rss_mib() -> float:
    """The process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def states_equal(a, b) -> dict:
    """Which parts of two states (a learner's or a population's) are
    bit-equal: the weights, Adam's whole state, the envs with obs and
    counters, and the generators' states."""
    def same(xs, ys):
        xs, ys = list(xs), list(ys)
        return len(xs) == len(ys) and all(
            (x is None and y is None) or torch.equal(x, y) for x, y in zip(xs, ys))

    def gens(s):
        return [g.get_state() for g in (s.generators if hasattr(s, "generators")
                                        else [s.generator])]

    return {
        "weights": same(a.params.parameters(), b.params.parameters()),
        "adam": same(graphs.optimizer_tensors(a.optimizer), graphs.optimizer_tensors(b.optimizer)),
        "envs": same(*(graphs.leaves((s.env_state, s.obs, s.global_step, s.episodes_total,
                                      s.family_counts, s.family_wins)) for s in (a, b))),
        "generators": same(gens(a), gens(b)),
    }


def trainer_for(ppo_cfg: PPOConfig, num_envs: int, device=None) -> ZooTrainer:
    return ZooTrainer(ENV, ppo_cfg, num_envs, device=device)


def check_eager(ppo_cfg: PPOConfig, num_envs: int, seeds=SEEDS, device=None) -> dict:
    """One captured update at one epoch against the eager `update` from twin
    states: {"equal": {part: bool}, and each one's seconds and kernel
    launches ("update_jit_s", "update_jit_launches", "update_s",
    "update_launches")}."""
    trainer = trainer_for(ppo_cfg.replace(n_epochs=1), num_envs, device)
    a, b = trainer.init(seeds), trainer.init(seeds)
    out = {}
    for name, fn in (("update_jit", trainer.update_jit), ("update", trainer.update)):
        _sync(trainer.device)
        before = fused_sample_action.launches
        t0 = time.perf_counter()
        if name == "update_jit":
            a, ma = fn(a)
        else:
            b, mb = fn(b)
        _sync(trainer.device)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_launches"] = fused_sample_action.launches - before
    equal = states_equal(a, b)
    equal["metrics"] = set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in mb)
    return {"equal": equal, **out}


def measure(ppo_cfg: PPOConfig, num_envs: int, seeds=SEEDS, updates: int = 2,
            device=None) -> dict:
    """Capture the population's update (its first `update_jit` call) and
    replay `updates` more: the capture's costs and the updates' seconds."""
    trainer = trainer_for(ppo_cfg, num_envs, device)
    state = trainer.init(seeds)
    _sync(trainer.device)
    rss_before = peak_rss_mib()
    before = fused_sample_action.launches
    t0 = time.perf_counter()
    state, metrics = trainer.update_jit(state)
    loss = float(metrics["loss"].mean())
    first_s = time.perf_counter() - t0
    first_launches = fused_sample_action.launches - before
    rss_after = peak_rss_mib()
    program = next(iter(trainer._graphs.entries.values()))
    st = program.capture_stats
    secs, launches = [], []
    for _ in range(updates):
        before = fused_sample_action.launches
        t0 = time.perf_counter()
        state, metrics = trainer.update_jit(state)
        loss = float(metrics["loss"].mean())
        secs.append(time.perf_counter() - t0)
        launches.append(fused_sample_action.launches - before)
    out = {
        "members": len(seeds), "num_envs": num_envs, "n_steps": ppo_cfg.n_steps,
        "num_minibatches": ppo_cfg.num_minibatches, "n_epochs": ppo_cfg.n_epochs,
        "shuffle": ppo_cfg.shuffle, "hidden_sizes": list(ppo_cfg.hidden_sizes),
        "chunks": program.chunks, "capturing_call_s": first_s,
        "capturing_call_launches": first_launches, "replay_s": secs,
        "replay_launches": launches, "loss": loss,
        "peak_rss_mib_before": rss_before, "peak_rss_mib_after": rss_after,
    }
    if st is not None:
        out.update(warmup_s=st.warmup_s, recording_s=st.capture_s,
                   instantiation_s=st.instantiate_s, pool_bytes=st.pool_bytes,
                   nodes=st.nodes)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--vmap", type=int, default=len(SEEDS), help="population size")
    p.add_argument("--num-envs", type=int, default=14)
    p.add_argument("--n-steps", type=int, default=2048)
    p.add_argument("--num-minibatches", type=int, default=448)
    p.add_argument("--n-epochs", type=int, default=10)
    p.add_argument("--shuffle", default="exact", choices=("exact", "affine", "timeperm"))
    p.add_argument("--chunk", type=int, default=None,
                   help="rollout steps a graph (default: learn.ppo.ROLLOUT_CHUNK)")
    p.add_argument("--updates", type=int, default=2, help="replayed updates timed")
    p.add_argument("--check", action="store_true",
                   help="first hold a captured update at one epoch bit-equal to the eager one")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.chunk is not None:
        ppo.ROLLOUT_CHUNK = args.chunk
    cfg = PPOConfig(n_steps=args.n_steps, num_minibatches=args.num_minibatches,
                    n_epochs=args.n_epochs, shuffle=args.shuffle)
    seeds = tuple(range(SEEDS[0], SEEDS[0] + args.vmap))
    out = {}
    if args.check:
        out["check"] = check_eager(cfg, args.num_envs, seeds, args.device)
    out.update(measure(cfg, args.num_envs, seeds, args.updates, args.device))
    print(json.dumps(out), flush=True)
    if args.check and not all(out["check"]["equal"].values()):
        raise SystemExit(f"captured update differs from the eager one: {out['check']['equal']}")


if __name__ == "__main__":
    main()
