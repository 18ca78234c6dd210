"""Split-time the quality-recipe PPO update on the card: rollout vs GAE+SGD;
the port's counterpart of `scripts/bench_update_split.py`.

    python -m drone2d_tpu_torch.scripts.bench_update_split \\
        [NUM_ENVS] [N_STEPS] [MINIBATCHES] [--device cpu]

Times eager updates of NUM_ENVS envs x N_STEPS steps with MINIBATCHES
minibatches x 10 epochs split into the reset templates' draws, the
rollout's steps, GAE and SGD (host clock, each part synchronized), and the
whole update through `PPOLearner.update_jit` (CUDA graphs on the card), as
the JAX script times its `update_jit`; prints the rollout's and the
update's env steps a second and the optimizer phase's share of the eager
update.  On the card it also counts the device ops a rollout step and the
device's busy share under the profiler.  Runs on the CUDA card unless
`--device cpu`.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.device import resolve_device, synchronize
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.learn.ppo import PPOLearner, collect_steps
from drone2d_tpu_torch.utils.profiling import device_window

# rollout steps under the profiler, for the device ops and busy share a step
PROFILE_STEPS = 16


def update_split(runs: dict, reps: int = 3, log=print) -> dict:
    """For each label -> (learner or population trainer, state): seconds per
    update split into the reset templates' draws, the rollout's steps, GAE
    and SGD (host clock, each part synchronized), the median of `reps`
    updates, the labels' updates taken in turn so that the host's drift
    falls on each alike; the env steps trained a second; then, on the card,
    one rollout's first PROFILE_STEPS steps under the profiler: the device
    ops a step and the device's busy share.  Returns label -> (state, batch,
    adv, ret, env steps a second, the median parts (draws, steps, gae, sgd,
    total) in seconds)."""
    parts, out = {k: [] for k in runs}, {}
    for _ in range(reps):
        for label, (learner, state) in runs.items():
            cfg, dev = learner.cfg, learner.device
            synchronize(dev)
            t0 = time.perf_counter()
            *draws, perms = learner.draws(state)
            synchronize(dev)
            t1 = time.perf_counter()
            state, batch, last_values, _ = learner.rollout_from(state, *draws)
            synchronize(dev)
            t2 = time.perf_counter()
            adv, ret = compute_gae(batch.rewards, batch.values, batch.dones, last_values,
                                   gamma=cfg.gamma, gae_lambda=cfg.gae_lambda)
            synchronize(dev)
            t3 = time.perf_counter()
            metrics = learner.sgd(state, batch, adv, ret, perms)
            synchronize(dev)
            t4 = time.perf_counter()
            parts[label].append((t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0))
            if not bool(torch.isfinite(metrics["loss"]).all()):
                raise AssertionError(f"{label}: non-finite loss")
            runs[label] = (learner, state)
            out[label] = (state, batch, adv, ret)
    for label, (learner, state) in runs.items():
        cfg, members = learner.cfg, state.params.members or 1
        med = tuple(statistics.median(p[i] for p in parts[label]) for i in range(5))
        draws_s, steps_s, gae_s, sgd_s, total_s = med
        sgd_steps = cfg.n_epochs * cfg.num_minibatches
        rate = members * cfg.n_steps * learner.num_envs / total_s
        log(f"{label} update (host clock, synchronized, median of {reps}): reset draws "
            f"{draws_s:.4f} s, rollout steps {steps_s:.4f} s ({1e3 * steps_s / cfg.n_steps:.3f} "
            f"ms a step), GAE {gae_s:.4f} s, SGD {sgd_s:.4f} s ({1e3 * sgd_s / sgd_steps:.3f} ms "
            f"a minibatch step), total {total_s:.4f} s; "
            f"all: {[tuple(round(x, 4) for x in p) for p in parts[label]]}")
        log(f"  train_steps_per_s {rate:.1f} ({members} x {learner.num_envs} envs x "
            f"{cfg.n_steps} steps / seconds per update)")
        if learner.device.type == "cuda":
            reset_state, reset_obs, noise, _ = learner.draws(state)
            steps = min(PROFILE_STEPS, cfg.n_steps)
            noise = noise[:steps]
            events, dev_us, wall_us = device_window(lambda: collect_steps(
                state.params, learner.env, state.env_state, state.obs, reset_state, reset_obs,
                noise))
            log(f"  profiler, {steps} rollout steps: " + (
                f"{len(events) / steps:.0f} device ops a step, device busy "
                f"{dev_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
                f"({100 * dev_us / wall_us:.1f}%)" if events
                else "device time not measured (no device events)"))
        out[label] = out[label] + (rate, med)
    return out


def update_jit_seconds(runs: dict, reps: int = 3, log=print) -> dict:
    """For each label -> (learner or population trainer, state): the
    seconds of a first `update_jit` call (it captures the graphs, unless
    the learner holds them for these weights already), then of `reps` more
    (host clock, synchronized), the labels taken in turn.  Returns label ->
    (state, first call's seconds, [seconds])."""
    first, seconds = {}, {label: [] for label in runs}
    for rep in range(1 + reps):
        for label, (learner, state) in runs.items():
            synchronize(learner.device)
            t0 = time.perf_counter()
            state, metrics = learner.update_jit(state)
            if not bool(torch.isfinite(metrics["loss"]).all()):
                raise AssertionError(f"{label}: non-finite loss")
            synchronize(learner.device)
            dt = time.perf_counter() - t0
            runs[label] = (learner, state)
            if rep:
                seconds[label].append(dt)
            else:
                first[label] = dt
    for label, (learner, state) in runs.items():
        members, med = state.params.members or 1, statistics.median(seconds[label])
        log(f"{label} update_jit (host clock, synchronized): the first call (with its "
            f"capture, if any) {first[label]:.4f} s, then min {min(seconds[label]):.4f} median {med:.4f} max "
            f"{max(seconds[label]):.4f} s of {reps}; train_steps_per_s "
            f"{members * learner.cfg.n_steps * learner.num_envs / med:.1f}")
    return {label: (runs[label][1], first[label], seconds[label]) for label in runs}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("num_envs", nargs="?", type=int, default=1024)
    p.add_argument("n_steps", nargs="?", type=int, default=128)
    p.add_argument("num_minibatches", nargs="?", type=int, default=64)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to run; the default is the CUDA card, and the run fails "
                   "without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    num_envs, n_steps, num_mb = args.num_envs, args.n_steps, args.num_minibatches
    learner = PPOLearner(EnvConfig(),
                         PPOConfig(n_steps=n_steps, num_minibatches=num_mb, n_epochs=10),
                         num_envs, device=dev)
    state = learner.init(0)
    out = update_split({"update": (learner, state)})["update"]
    draws_s, steps_s, _, _, eager_s = out[-1]
    seconds = update_jit_seconds({"update": (learner, out[0])})["update"][2]
    steps_per_update = num_envs * n_steps
    t_roll, t_upd = draws_s + steps_s, statistics.median(seconds)
    sgd = eager_s - t_roll
    print(f"config: {num_envs} envs x {n_steps} steps, {num_mb} mb x 10 epochs "
          f"({num_mb * 10} SGD steps/update)")
    print(f"rollout:      {t_roll*1e3:8.2f} ms/update "
          f"({steps_per_update / t_roll / 1e3:,.0f}k env-steps/s, eager)")
    print(f"full update:  {t_upd*1e3:8.2f} ms/update "
          f"({steps_per_update / t_upd / 1e3:,.0f}k env-steps/s, update_jit); eager "
          f"{eager_s*1e3:.2f} ms/update")
    print(f"gae+sgd share: {sgd*1e3:8.2f} ms/update ({100*sgd/eager_s:.0f}% of the eager "
          f"update)  ~{sgd / (num_mb * 10) * 1e6:.0f} us per SGD minibatch step")
    return dict(rollout_s=t_roll, update_s=t_upd, sgd_s=sgd, eager_update_s=eager_s)


if __name__ == "__main__":
    main()
