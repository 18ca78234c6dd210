"""Batched checkpoint/agent selection over the 12-scenario suite: the port's
counterpart of `scripts/select_agents.py`.

The reference picked its published agents by hand from ~80 checkpoints
(ppo_agents/, best 3 enshrined in best_models_config_and_res/).  This tool
loads EVERY candidate (each seed's final new_agent.npz, its
`ckpt_<step>.npz` zoo snapshots and the port's `ckpt_<step>.pt`
checkpoints), stacks their weights along an agent axis, and flies all
candidates on each scenario as one batch (`eval.episode.run_episodes_multi`:
one env step and one policy-kernel launch a step for all of them).

    python -m drone2d_tpu_torch.scripts.select_agents results/hunt/seed_* \\
        [--episodes 100] [--seed 0] [--scenarios corridor large ...] \\
        [--finals-only] [--out results/hunt/select.json] [--device cpu]

Prints a per-candidate table (success rate per scenario, mean SR, and how
many of the 12 published success rates the candidate matches or beats) and
writes the full summary JSON.  Runs on the CUDA card unless `--device cpu`.
The line after the flights says where their time went: policy-kernel
launches, the CUDA graphs captured and the seconds they took (by cause),
the campaign envs reused, made anew and released, the eval runners' hits
(and how many of them were on a runner made for another scenario), misses
and evictions, and the draw caches' hits, misses and evictions
(`utils/profiling.py`'s counters; no capture on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

from drone2d_tpu_torch.config import ALL_SCENARIOS
from drone2d_tpu_torch.eval.barplots import PUBLISHED_AAPE, PUBLISHED_SR
from drone2d_tpu_torch.eval.episode import run_episodes_multi
from drone2d_tpu_torch.eval.run import load_params, scenario_config
from drone2d_tpu_torch.models.policy import stack_params
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action
from drone2d_tpu_torch.utils import profiling
from drone2d_tpu_torch.utils.checkpoint import checkpoint_steps


def capture_line(before: dict, after: dict) -> str:
    """What the flights between two readings of the counters captured and
    released: graph captures and their seconds, by cause, the campaign
    envs reused, made anew and released, the eval runners' hits (those on
    a runner made for another scenario: shared), misses and evictions, and
    the other graph caches' hits, misses and evictions."""
    def d(name):
        return after.get(name, 0) - before.get(name, 0)

    causes = sorted(k[len("graphs.captures["):-1] for k in after
                    if k.startswith("graphs.captures[") and d(k))
    by = ", ".join(f"{c} {d(f'graphs.captures[{c}]'):g} "
                   f"({d(f'graphs.capture_s[{c}]'):.1f} s)" for c in causes)
    return (f"graph captures {d('graphs.captures'):g} in {d('graphs.capture_s'):.1f} s"
            f"{f' ({by})' if by else ''}; campaign envs: {d('campaign_env.hits'):g} reused, "
            f"{d('campaign_env.misses'):g} made, {d('campaign_env.evictions'):g} released; "
            f"eval runners: {d('eval_runner.hits'):g} hits ({d('eval_runner.shared'):g} shared "
            f"across scenarios), {d('eval_runner.misses'):g} misses, "
            f"{d('eval_runner.evictions'):g} evictions; "
            f"graph caches: {d('graph_cache.hits'):g} hits, {d('graph_cache.misses'):g} misses, "
            f"{d('graph_cache.evictions'):g} evictions")


def find_candidates(run_dirs, finals_only=False):
    """(label, agent_path, checkpoint_step) triplets for every candidate."""
    cands = []
    for d in run_dirs:
        d = os.path.normpath(d)
        name = os.path.basename(d)
        final = os.path.join(d, "new_agent.npz")
        if os.path.exists(final):
            cands.append((f"{name}/final", final, None))
        if finals_only:
            continue
        # the train CLI's checkpoints; the last one duplicates the final agent
        for s in checkpoint_steps(d)[:-1]:
            cands.append((f"{name}/{s}", d, s))
        # zoo snapshots (learn/zoo.py save_zoo)
        for e in sorted(os.listdir(d)):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", e)
            if m:
                cands.append((f"{name}/{m.group(1)}", os.path.join(d, e), None))
    return cands


def main(argv=None) -> None:
    from drone2d_tpu_torch.utils.runtime import wait_for_accelerator

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dirs", nargs="+", help="seed run dirs (from sweep)")
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scenarios", nargs="+", default=None,
                   help="subset of scenarios (default: all 12)")
    p.add_argument("--finals-only", action="store_true",
                   help="skip intermediate checkpoints")
    p.add_argument("--out", default=None, help="summary JSON path")
    p.add_argument(
        "--device", default=None, choices=("cuda", "cpu"),
        help="where to evaluate; the default is the CUDA card, and the run "
        "fails without one ('cpu' runs on the host)",
    )
    args = p.parse_args(argv)
    if args.device != "cpu":
        print(f"device: {wait_for_accelerator()}")

    scenarios = args.scenarios or list(ALL_SCENARIOS)
    cands = find_candidates(args.run_dirs, args.finals_only)
    if not cands:
        sys.exit("no candidates found")
    print(f"{len(cands)} candidates x {len(scenarios)} scenarios "
          f"x {args.episodes} episodes")

    stack = stack_params([load_params(path, step, device=args.device)
                          for _, path, step in cands])

    t0, launches = time.perf_counter(), fused_sample_action.launches
    before = profiling.counters()
    table = {label: {} for label, _, _ in cands}
    for scen in scenarios:
        cfg = scenario_config(scen)
        res = run_episodes_multi(cfg, stack, args.seed, args.episodes, device=args.device)
        n = np.maximum(res.success.sum(axis=1) + res.fail.sum(axis=1), 1)
        sr = res.success.sum(axis=1) / n
        cr = res.collision.sum(axis=1) / n
        for i, (label, _, _) in enumerate(cands):
            table[label][scen] = dict(
                success_rate=float(sr[i]), collision_rate=float(cr[i]),
                avg_ape=float(res.ape[i].mean()),
            )
        print(f"  {scen}: done (best SR {sr.max():.2f})")
    print(f"flew {len(cands)} candidates on {len(scenarios)} scenarios in "
          f"{time.perf_counter() - t0:.1f} s, {fused_sample_action.launches - launches} "
          "policy-kernel launches")
    print(capture_line(before, profiling.counters()))

    # ranking: published-SR coverage first, then published-AAPE coverage
    # (at or below the published "Reactive" AAPE), then mean SR
    rows = []
    for label, per in table.items():
        srs = {s: per[s]["success_rate"] for s in scenarios}
        mean_sr = sum(srs.values()) / len(srs)
        covered = sum(
            1 for s in scenarios
            if s in PUBLISHED_SR and srs[s] >= PUBLISHED_SR[s]
        )
        ape_covered = sum(
            1 for s in scenarios
            if s in PUBLISHED_AAPE and per[s]["avg_ape"] <= PUBLISHED_AAPE[s]
        )
        rows.append((covered, ape_covered, mean_sr, label, srs))
    rows.sort(reverse=True)

    width = max(len(r[3]) for r in rows)
    head = " ".join(f"{s[:6]:>6s}" for s in scenarios)
    print(f"\n{'candidate':>{width}s} cover aape meanSR {head}")
    for covered, ape_covered, mean_sr, label, srs in rows:
        vals = " ".join(f"{srs[s]:6.2f}" for s in scenarios)
        print(f"{label:>{width}s} {covered:5d} {ape_covered:4d} "
              f"{mean_sr:6.3f} {vals}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
        print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
