"""The hand-written policy kernel against the plain PyTorch version on the
card: the port's counterpart of `scripts/bench_fused_policy.py`.

Times `ops.fused_policy.fused_sample_action_ref` (the plain version, eager
PyTorch) against `fused_sample_action` (the CUDA kernel) at the bench shape
(4096 envs, hidden 128x128), each in an `--iters`-iteration loop with the
obs fed back through a cheap dependency, the noise drawn each iteration from
one seeded generator; best of `--reps`.  Before timing, the kernel's outputs
on the first iteration's inputs are held against the plain version's: the
scaled error max |kernel - plain| / max(1, max |plain|) of each output.

    python -m drone2d_tpu_torch.scripts.bench_fused_policy [--batch 4096] \\
        [--iters 256] [--reps 5] [--out PATH] [--device cpu]

Prints `bench_fused_policy.py`'s JSON with the plain version under "plain"
(the original's "xla") and the kernel under "kernel" (its "pallas"); the
original's `--block` (the Pallas block rows) has no counterpart: the kernel
fixes its rows a block.  On the CPU both loops run the plain version.  Runs
on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from drone2d_tpu_torch.device import resolve_device, synchronize
from drone2d_tpu_torch.models.policy import ActorCritic
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action, fused_sample_action_ref


def scaled_errors(got, want) -> dict:
    """max |got - want| / max(1, max |want|) of each output."""
    out = {}
    for k, g, w in zip(("action", "logp", "value"), got, want):
        g, w = g.double(), w.double()
        out[k] = float((g - w).abs().max() / max(1.0, float(w.abs().max())))
    return out


@torch.no_grad()
def run(batch: int = 4096, iters: int = 256, reps: int = 5, device=None) -> dict:
    dev = resolve_device(device)
    params = ActorCritic(27, 2, (128, 128), generator=torch.Generator().manual_seed(0),
                         device=dev)
    obs0 = torch.randn((batch, 27), generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)

    def loop(fn):
        gen = torch.Generator(device=dev).manual_seed(2)
        obs = obs0
        for _ in range(iters):
            noise = torch.randn((batch, 2), generator=gen, device=dev)
            a, logp, v = fn(params, obs, noise)
            # cheap dependency: nudge obs by the action stats
            obs = obs + 1e-6 * (logp[:, None] + v[:, None] + a.sum(-1, keepdim=True))
        return obs

    noise0 = torch.randn((batch, 2), generator=torch.Generator(device=dev).manual_seed(2),
                         device=dev)
    errors = scaled_errors(fused_sample_action(params, obs0, noise0),
                           fused_sample_action_ref(params, obs0, noise0))
    results = {}
    for name, fn in (("plain", fused_sample_action_ref), ("kernel", fused_sample_action)):
        loop(fn)  # warm-up
        times = []
        for _ in range(reps):
            synchronize(dev)
            t0 = time.perf_counter()
            out = loop(fn)
            float(out[0, 0])  # on the host: synchronizes
            times.append(time.perf_counter() - t0)
        best = min(times)
        ns = best / iters / batch * 1e9
        results[name] = dict(best_s=best, ns_per_env_sample=round(ns, 2))
        print(f"{name}: {best*1e3:.2f} ms for {iters} iters -> {ns:.2f} ns/env-sample",
              flush=True)
    results["speedup_plain_over_kernel"] = round(
        results["kernel"]["best_s"] / results["plain"]["best_s"], 3)
    results["scaled_errors"] = errors
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--iters", type=int, default=256)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to run; the default is the CUDA card, and the run fails "
                   "without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    results = run(args.batch, args.iters, args.reps, device=args.device)
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(batch=args.batch, iters=args.iters, **results), f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
