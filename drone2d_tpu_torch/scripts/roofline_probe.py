"""Roofline measurements for the env hot loop on the card: the port's
counterpart of `scripts/roofline_probe.py`.

Times the bench's env line chunk across a grid of (num_envs, path_table_n)
to attribute the cost of an env step to its candidate bottlenecks: the
captured chunk (`drone2d_tpu_torch.bench.CapturedChunk`: the policy sample,
the env step and the masked auto-reset as a CUDA graph of `bench.GRAPH_STEPS`
steps, replayed), each chunk's template and noise drawn by its draw graph
(`bench.draw_chunk` captured), as the bench's env line times it and as the
JAX probe jits its chunk, draws included:

* num_envs scaling separates launch-bound (flat time against batch) from
  throughput-bound (time ~ linear in batch);
* path_table_n scaling isolates the closest-point table stream — the
  biggest per-env byte stream in the step (table_u/x/y: 12 B per entry per
  pass) — from everything else;
* the auto-reset ablation drops the template select (the plain `env.step`)
  to measure how much of the cost is the whole-carry read and write it
  forces.

    python -m drone2d_tpu_torch.scripts.roofline_probe [--out results/roofline.json] \\
        [--chunk 256] [--repeats 6] [--device cpu]

Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from drone2d_tpu_torch.bench import CapturedChunk, graph_steps
from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM, Drone2DEnv
from drone2d_tpu_torch.models.policy import ActorCritic

ENVS_GRID = (512, 1024, 2048, 4096, 8192)
TABLE_GRID = (128, 256, 512, 1024, 2048)


def measure(num_envs: int, table_n: int, *, chunk_t: int, repeats: int, autoreset: bool = True,
            device=None) -> float:
    """ns per env step of the bench's captured chunk at this shape, its
    draws included: `repeats` chunks after a warm-up chunk (the capture
    before it), synchronized before each clock read."""
    dev = resolve_device(device)
    env = Drone2DEnv(EnvConfig(path_table_n=table_n), dev)
    params = ActorCritic(OBS_DIM, ACT_DIM, generator=torch.Generator().manual_seed(0),
                         device=dev)
    env_state, obs = env.reset_batch(torch.Generator(device=dev).manual_seed(1), num_envs, 0.0)
    gen = torch.Generator(device=dev).manual_seed(2)
    run = CapturedChunk(params, env, env_state, obs, steps=graph_steps(chunk_t), gen=gen,
                        chunk_t=chunk_t, autoreset=autoreset)
    env_state, obs, r = run(env_state, obs)
    float(r.sum())  # warm-up, synchronized
    t0 = time.perf_counter()
    for _ in range(repeats):
        env_state, obs, r = run(env_state, obs)
    float(r.sum())
    dt = time.perf_counter() - t0
    return dt / (repeats * chunk_t * num_envs) * 1e9


def probe(envs=ENVS_GRID, tables=TABLE_GRID, *, chunk_t: int = 256, repeats: int = 6,
          device=None) -> list:
    """The three probes' rows, printing a line each: num_envs scaling at
    table 512, table scaling at 4096 envs (or the largest of `envs`), and
    the auto-reset ablation there."""
    rows = []
    big = max(envs)
    print("== num_envs scaling (table_n=512) ==")
    for n in envs:
        ns = measure(n, 512, chunk_t=chunk_t, repeats=repeats, device=device)
        rows.append(dict(probe="envs", num_envs=n, table_n=512, ns_per_env_step=round(ns, 2)))
        print(f"  envs={n:5d}: {ns:7.2f} ns/env-step  ({1e9/ns/1e6:,.1f}M steps/s)", flush=True)
    n_table = 4096 if 4096 in envs else big
    print(f"== table_n scaling (num_envs={n_table}) ==")
    for t in tables:
        ns = measure(n_table, t, chunk_t=chunk_t, repeats=repeats, device=device)
        rows.append(dict(probe="table", num_envs=n_table, table_n=t,
                         ns_per_env_step=round(ns, 2)))
        print(f"  table={t:5d}: {ns:7.2f} ns/env-step", flush=True)
    print(f"== auto-reset select ablation ({n_table} envs, table 512) ==")
    for ar in (True, False):
        ns = measure(n_table, 512, chunk_t=chunk_t, repeats=repeats, autoreset=ar,
                     device=device)
        rows.append(dict(probe="autoreset", num_envs=n_table, table_n=512, autoreset=ar,
                         ns_per_env_step=round(ns, 2)))
        print(f"  autoreset={ar}: {ns:7.2f} ns/env-step", flush=True)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="results/roofline.json")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--repeats", type=int, default=6)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to run; the default is the CUDA card, and the run fails "
                   "without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    rows = probe(chunk_t=args.chunk, repeats=args.repeats, device=dev)
    doc = dict(chunk=args.chunk, repeats=args.repeats, rows=rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")
    return doc


if __name__ == "__main__":
    main()
