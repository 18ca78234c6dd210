"""Package a hunt candidate as a shipped flagship artifact: the port's
counterpart of `scripts/package_agent.py`.

Creates artifacts/agent_s<seed>/ in the shape of the shipped agents:
new_agent.npz + 100-episode 12-scenario campaign summaries under both
committed eval seeds (0 = in-selection, 777 = held-out) + optionally a
campaign_n1000_summary.json converted from a `precision_campaign` report.

    python -m drone2d_tpu_torch.scripts.package_agent \\
        results/r4_h5_pp8/seed_5004/ckpt_12058624.npz \\
        --seed 5004 --checkpoint-step 12058624 \\
        --note "hunt 5 (PP_rew_max=8 pace fine-tune from agent_s147)" \\
        --n1000 artifacts/campaigns/r4/h5_finalists_n1000.json [--device cpu]

The campaigns draw each scenario's episodes from a generator seeded with the
eval seed itself (`eval.episode.run_episodes`), as `select_agents` and
`eval.run` do.  Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

from drone2d_tpu_torch.config import ALL_SCENARIOS
from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.eval.barplots import PUBLISHED_SR
from drone2d_tpu_torch.eval.episode import run_episodes
from drone2d_tpu_torch.eval.run import load_params, scenario_config

# (eval seed, file, what the seed is) of the two 100-episode summaries
SUMMARIES = (
    (0, "summary.json", "IN-SELECTION (seed 0 ranked the hunt pool)"),
    (777, "campaign_seed777_summary.json", "HELD-OUT robustness RNG (selection used seed 0)"),
)


def campaign_results(params, eval_seed: int, episodes: int, scenarios=ALL_SCENARIOS,
                     device=None) -> dict:
    """The device half: scenario -> `run_episodes` results of `episodes`
    stochastic episodes from a generator seeded with `eval_seed`."""
    return {scen: run_episodes(scenario_config(scen), params, eval_seed, episodes,
                               device=device)
            for scen in scenarios}


def campaign_rows(results: dict, episodes: int) -> list:
    """The summary's per-scenario rows from `campaign_results`."""
    return [dict(
        scenario=scen,
        episodes=episodes,
        success_rate=float(np.mean(r.success)),
        collision_rate=float(np.mean(r.collision)),
        avg_ape=float(np.mean(r.ape)),
        avg_flight_time=float(np.mean(r.time_steps)),
    ) for scen, r in results.items()]


def hidden_sizes(params) -> list:
    """The policy trunk's widths, read from the loaded weights."""
    hidden = [int(layer.w.shape[-1]) for layer in params.pi]
    if not hidden:
        raise ValueError("loaded params have no pi hidden layers")
    return hidden


def _coverage_and_mean(rows):
    coverage = sum(r["success_rate"] >= PUBLISHED_SR[r["scenario"]] for r in rows)
    return coverage, round(sum(r["success_rate"] for r in rows) / len(rows), 4)


def summary_doc(rows, *, seed: int, checkpoint_step: int, eval_seed: int, note: str, tag: str,
                hidden) -> dict:
    """A 100-episode summary (`summary.json`, `campaign_seed777_summary.json`)."""
    coverage, mean_sr = _coverage_and_mean(rows)
    return dict(
        seed=seed, checkpoint_step=checkpoint_step, eval_seed=eval_seed,
        note=f"{note}; eval seed {eval_seed} — {tag}",
        published_coverage=coverage, mean_success_rate=mean_sr,
        hidden_sizes=list(hidden), scenarios=rows,
    )


def n1000_doc(rep: dict, agent: str, *, seed: int, note: str) -> dict:
    """`campaign_n1000_summary.json` from a `precision_campaign` report, for
    the agent whose label is `agent`'s path (compared as absolute paths,
    since the labels are relative to where the campaign ran)."""
    match = [lab for lab in rep["agents"] if os.path.abspath(lab) == os.path.abspath(agent)]
    if not match:
        raise KeyError(f"{agent} not found in the report")
    rows = [dict(
        scenario=scen, episodes=r["episodes"],
        success_rate=r["success_rate"],
        sr_stderr=round(r["sr_stderr"], 4),
        collision_rate=r["collision_rate"],
        avg_ape=r["avg_ape"], avg_flight_time=r["avg_flight_time"],
    ) for scen, r in rep["agents"][match[0]].items()]
    coverage, mean_sr = _coverage_and_mean(rows)
    return dict(
        seed=seed, eval_seed=rep["seed"],
        note=(f"{note}; {rep['episodes']}-episode high-precision "
              "campaign (fresh RNG, not used in any selection)"),
        published_coverage=coverage, mean_success_rate=mean_sr, scenarios=rows,
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("agent", help="candidate .npz")
    p.add_argument("--seed", type=int, required=True, help="training seed")
    p.add_argument("--checkpoint-step", type=int, required=True)
    p.add_argument("--note", default="")
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--n1000", default=None,
                   help="precision_campaign report to convert (must contain this agent's "
                   "path as a key)")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to evaluate; the default is the CUDA card, and the run "
                   "fails without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    out_dir = args.out_dir or os.path.join("artifacts", f"agent_s{args.seed}")
    os.makedirs(out_dir, exist_ok=True)
    dst = os.path.join(out_dir, "new_agent.npz")
    if os.path.abspath(args.agent) != os.path.abspath(dst):
        shutil.copyfile(args.agent, dst)
    params = load_params(dst, device=dev)
    hidden = hidden_sizes(params)

    for eval_seed, fname, tag in SUMMARIES:
        results = campaign_results(params, eval_seed, args.episodes, device=dev)
        rows = campaign_rows(results, args.episodes)
        for r in rows:
            print(f"  seed {eval_seed} {r['scenario']}: SR {r['success_rate']:.2f}", flush=True)
        doc = summary_doc(rows, seed=args.seed, checkpoint_step=args.checkpoint_step,
                          eval_seed=eval_seed, note=args.note, tag=tag, hidden=hidden)
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(doc, f, indent=1)
        print(f"{fname}: coverage {doc['published_coverage']}/12 mean "
              f"{doc['mean_success_rate']}", flush=True)

    if args.n1000:
        with open(args.n1000) as f:
            rep = json.load(f)
        try:
            doc = n1000_doc(rep, args.agent, seed=args.seed, note=args.note)
        except KeyError:
            sys.exit(f"{args.agent} not found in {args.n1000}")
        with open(os.path.join(out_dir, "campaign_n1000_summary.json"), "w") as f:
            json.dump(doc, f, indent=1)
        print(f"campaign_n1000_summary.json: coverage {doc['published_coverage']}/12 mean "
              f"{doc['mean_success_rate']}", flush=True)


if __name__ == "__main__":
    main()
