"""High-precision multi-agent evaluation campaigns on the card: the port's
counterpart of `scripts/precision_campaign.py`.

The reference's campaigns are 100-episode loops (main.py:242-400), which
leaves ~±5pp of binomial noise on every published rate.  This tool runs
N-thousand-episode campaigns for a whole STACK of agents in chunked
`run_episodes_multi` batches (one kernel launch a step for all agents) and
writes per-agent per-scenario aggregates with exact success/failure counts.

    python -m drone2d_tpu_torch.scripts.precision_campaign \\
        artifacts/agent_s147/new_agent.npz artifacts/agent_s250/new_agent.npz \\
        --scenarios stage_1 --episodes 4000 --chunk 500 --seed 555 \\
        --out artifacts/stage1_assay.json [--device cpu]

Chunk c of scenario s runs from a generator seeded with the c-th of
`eval.episode.campaign_keys(seed, s, n_chunks)`: per-scenario disjoint,
process-stable, reproducible and extendable.  The agents must share one
architecture (a stack); agents of different widths raise.  Runs on the CUDA
card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from drone2d_tpu_torch.config import ALL_SCENARIOS
from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.eval.episode import campaign_keys, run_episodes_multi
from drone2d_tpu_torch.eval.run import load_params, scenario_config
from drone2d_tpu_torch.models.policy import stack_params


def stack_agents(paths, device=None):
    """One stack of the agents at `paths`; raises ValueError naming them when
    their architectures differ (a stack holds one)."""
    params = [load_params(a, device=device) for a in paths]
    shapes = [tuple(tuple(p.shape) for p in prm.parameters()) for prm in params]
    if len(set(shapes)) > 1:
        hidden = {a: [int(layer.w.shape[-1]) for layer in prm.pi]
                  for a, prm in zip(paths, params)}
        raise ValueError(f"agents of different architectures cannot share a stack: {hidden}")
    return stack_params(params)


def campaign_chunks(stack, scenario: str, seed: int, episodes: int, chunk: int, device=None):
    """The device half: the stack's results on each chunk of `scenario`'s
    campaign (`run_episodes_multi`, arrays (A, chunk))."""
    n_chunks = (episodes + chunk - 1) // chunk
    cfg = scenario_config(scenario)
    return [run_episodes_multi(cfg, stack, key, chunk, device=device)
            for key in campaign_keys(seed, scenario, n_chunks)]


def scenario_rows(labels, chunks) -> dict:
    """Per-agent rows of one scenario from its chunks' results (anything with
    `success`, `fail`, `collision`, `ape`, `time_steps` arrays (A, n)).
    APE and flight-time averages divide by the episodes run: every episode
    reports them once; success + fail can exceed that only through the
    dual latch (reach-end and step cap on one step)."""
    total = sum(int(np.shape(r.success)[1]) for r in chunks)
    acc = {k: sum(np.asarray(getattr(r, f)).sum(axis=1) for r in chunks)
           for k, f in (("success", "success"), ("fail", "fail"), ("collision", "collision"),
                        ("ape", "ape"), ("time", "time_steps"))}
    rows = {}
    for i, lab in enumerate(labels):
        n = float(acc["success"][i] + acc["fail"][i])
        sr = float(acc["success"][i]) / max(n, 1.0)
        rows[lab] = dict(
            episodes=int(n),
            episodes_run=total,
            successes=int(acc["success"][i]),
            success_rate=sr,
            sr_stderr=float(np.sqrt(sr * (1 - sr) / max(n, 1.0))),
            collision_rate=float(acc["collision"][i]) / max(n, 1.0),
            avg_ape=float(acc["ape"][i]) / total,
            avg_flight_time=float(acc["time"][i]) / total,
        )
    return rows


def report(labels, rows_by_scenario: dict, *, seed: int, episodes: int, chunk: int,
           note: str = "") -> dict:
    """The original's report document from each scenario's `scenario_rows`."""
    out = {"seed": seed, "episodes": episodes, "chunk": chunk, "note": note,
           "agents": {lab: {} for lab in labels}}
    for scen, rows in rows_by_scenario.items():
        for lab in labels:
            out["agents"][lab][scen] = rows[lab]
    return out


def run(paths, scenarios=None, *, episodes: int = 1000, chunk: int = 500, seed: int = 555,
        note: str = "", device=None) -> dict:
    """The campaign of the agents at `paths`, printing as it goes; returns the
    report document (labels: the paths relative to the working directory)."""
    scenarios = list(scenarios or ALL_SCENARIOS)
    labels = [os.path.relpath(a) for a in paths]
    stack = stack_agents(paths, device=device)
    n_chunks = (episodes + chunk - 1) // chunk
    total = n_chunks * chunk
    rows_by_scenario = {}
    for scen in scenarios:
        rows = scenario_rows(labels, campaign_chunks(stack, scen, seed, episodes, chunk, device))
        for lab, r in rows.items():
            if r["episodes"] != total:
                print(f"WARNING: {lab}/{scen}: success+fail = {r['episodes']} != {total} "
                      "episodes (dual-latch or lost outcome)", flush=True)
        rows_by_scenario[scen] = rows
        best = max(r["success_rate"] for r in rows.values())
        print(f"{scen}: done over {total} episodes (best SR {best:.4f})", flush=True)
    doc = report(labels, rows_by_scenario, seed=seed, episodes=total, chunk=chunk, note=note)
    for lab in labels:
        rows = doc["agents"][lab]
        mean_sr = sum(r["success_rate"] for r in rows.values()) / len(rows)
        counts = " ".join(f"{s}:{r['successes']}/{r['episodes']}" for s, r in rows.items())
        print(f"{lab}: mean SR {mean_sr:.4f}  {counts}", flush=True)
    return doc


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("agents", nargs="+", help="agent .npz paths")
    p.add_argument("--scenarios", nargs="+", default=None,
                   help="subset of the 12 (default: all)")
    p.add_argument("--episodes", type=int, default=1000)
    p.add_argument("--chunk", type=int, default=500)
    p.add_argument("--seed", type=int, default=555)
    p.add_argument("--out", default=None)
    p.add_argument("--note", default="")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to evaluate; the default is the CUDA card, and the run "
                   "fails without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    doc = run(args.agents, args.scenarios, episodes=args.episodes, chunk=args.chunk,
              seed=args.seed, note=args.note, device=dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.out}")
    return doc


if __name__ == "__main__":
    main()
