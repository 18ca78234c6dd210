"""Update-phase roofline on the card: the port's counterpart of
`scripts/roofline_update.py`.  It decomposes the SGD phase of the
quality-recipe PPO update and holds each piece against its analytic floor.

The quality recipe runs 64 minibatches x 10 epochs = 640 SGD steps per
131072-env-step update.  This tool answers where the time of the SGD phase
goes:

  - GAE (one pass over the rollout),
  - the per-epoch timeperm permutation + reshape (10x),
  - the clipped-surrogate loss and its gradient on one (B/64)-row
    minibatch (640x),
  - the global-norm clip (0.5) and the Adam step (eps 1e-5) (640x),

each timed on its own (host clock, synchronized, `iters` calls), then held
against the measured SGD phase of the eager update
(`bench_update_split.update_split`; the remainder is what the components
do not explain) and against analytic FLOP and byte floors for the MLP on
the H100's float32 peaks.  `full_update` is the whole update through
`PPOLearner.update_jit` (CUDA graphs on the card), as the JAX script times
its `update_jit`; the shares are of the eager update.

    python -m drone2d_tpu_torch.scripts.roofline_update [NUM_ENVS] [N_STEPS] \\
        [MINIBATCHES] [--out PATH] [--device cpu]

Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.device import resolve_device, synchronize
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.scripts.bench_update_split import update_jit_seconds, update_split

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): float32 on the CUDA
# cores (the SGD's products run in float32, TF32 off) and HBM3
PEAK_FLOPS = 67e12
PEAK_BW = 3.35e12
HIDDEN = (128, 128)  # the flagship capacity (presets)


def _timed(f, device, iters: int) -> float:
    """Seconds a call of f(), over `iters` calls after a warm-up one."""
    f()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        f()
    synchronize(device)
    return (time.perf_counter() - t0) / iters


def decompose(num_envs: int = 1024, n_steps: int = 128, num_mb: int = 64, *, reps: int = 5,
              iters: int = 20, device=None) -> dict:
    """The report: the update's split (median of `reps` updates), each
    component's time (`iters` calls each), the floors and the shares."""
    dev = resolve_device(device)
    cfg = PPOConfig(n_steps=n_steps, num_minibatches=num_mb, n_epochs=10, shuffle="timeperm",
                    hidden_sizes=HIDDEN)
    learner = PPOLearner(EnvConfig(), cfg, num_envs, device=dev)
    state = learner.init(0)
    B = num_envs * n_steps
    mbs = B // num_mb
    n_sgd = num_mb * cfg.n_epochs

    # --- end-to-end phase split: the eager update's parts, and the whole
    # update through update_jit, as the JAX script times its update_jit ---
    state, *_, (draws_s, steps_s, _, _, eager_s) = update_split(
        {"update": (learner, state)}, reps=reps)["update"]
    t_upd = statistics.median(update_jit_seconds({"update": (learner, state)}, reps=reps)[
        "update"][2])
    t_roll = draws_s + steps_s
    t_phase = eager_s - t_roll

    # --- components, on their own ---
    gen = torch.Generator(device=dev).manual_seed(1)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rewards, values = normal(n_steps, num_envs), normal(n_steps, num_envs)
    dones = torch.zeros((n_steps, num_envs), dtype=torch.bool, device=dev)
    last_vals = torch.zeros(num_envs, device=dev)
    t_gae = _timed(lambda: compute_gae(rewards, values, dones, last_vals, gamma=cfg.gamma,
                                       gae_lambda=cfg.gae_lambda), dev, iters)

    stacked = (normal(n_steps, num_envs, 27), normal(n_steps, num_envs, 2),
               normal(n_steps, num_envs), normal(n_steps, num_envs), normal(n_steps, num_envs))

    def perm_epoch():
        perm = torch.randperm(n_steps, generator=gen, device=dev)
        return [x.index_select(0, perm).reshape((num_mb, mbs) + x.shape[2:]) for x in stacked]

    t_perm = _timed(perm_epoch, dev, iters)

    mb = (normal(mbs, 27), normal(mbs, 2), normal(mbs), normal(mbs), normal(mbs))
    params, opt = state.params, state.optimizer
    leaves = list(params.parameters())

    def grad_step():
        loss, _ = learner.loss_fn(params, *mb)
        opt.zero_grad(set_to_none=True)
        loss.backward()

    t_grad = _timed(grad_step, dev, iters)

    def opt_step():
        optim.clip_by_global_norm_([p.grad for p in leaves], cfg.max_grad_norm)
        opt.step()

    t_opt = _timed(opt_step, dev, iters)

    # --- analytic floors for the grad step ---
    n_params = sum(int(np.prod(p.shape)) for p in leaves)
    dims = [27, *HIDDEN]
    mm_flops_fwd = 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    mm_flops_fwd += 2 * (HIDDEN[-1] * 3)  # pi(2)+vf(1) heads
    mm_flops_fwd *= 2  # separate pi and vf towers
    flops_step = 3 * mm_flops_fwd * mbs  # fwd + ~2x bwd
    # bytes: minibatch activations r/w (~3 layers) + params + adam moments
    bytes_step = mbs * 27 * 4 * 3 + n_params * 4 * 8
    floor_compute = flops_step / PEAK_FLOPS
    floor_bytes = bytes_step / PEAK_BW

    sum_components = t_gae + cfg.n_epochs * t_perm + n_sgd * (t_grad + t_opt)
    return dict(
        config=dict(num_envs=num_envs, n_steps=n_steps, num_minibatches=num_mb,
                    n_epochs=cfg.n_epochs, minibatch_rows=mbs,
                    hidden=list(HIDDEN), n_params=n_params),
        ms=dict(
            rollout=t_roll * 1e3, full_update=t_upd * 1e3,
            sgd_phase=t_phase * 1e3, gae=t_gae * 1e3,
            perm_per_epoch=t_perm * 1e3,
            grad_per_step=t_grad * 1e3, opt_per_step=t_opt * 1e3,
            components_sum=sum_components * 1e3,
        ),
        env_steps_per_s=dict(rollout=B / t_roll, full_update=B / t_upd),
        floors_us=dict(grad_compute=floor_compute * 1e6, grad_bytes=floor_bytes * 1e6),
        shares=dict(
            sgd_of_update=t_phase / eager_s,
            grad_of_sgd=n_sgd * t_grad / max(t_phase, 1e-12),
            opt_of_sgd=n_sgd * t_opt / max(t_phase, 1e-12),
            perm_of_sgd=cfg.n_epochs * t_perm / max(t_phase, 1e-12),
            gae_of_sgd=t_gae / max(t_phase, 1e-12),
            unexplained=(t_phase - sum_components) / max(t_phase, 1e-12),
        ),
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("num_envs", nargs="?", type=int, default=1024)
    p.add_argument("n_steps", nargs="?", type=int, default=128)
    p.add_argument("num_minibatches", nargs="?", type=int, default=64)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to run; the default is the CUDA card, and the run fails "
                   "without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    report = decompose(args.num_envs, args.n_steps, args.num_minibatches, device=args.device)
    print(json.dumps(report, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
