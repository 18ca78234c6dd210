"""AAPE survivorship analysis: the port's counterpart of
`scripts/aape_survivorship.py` — why the flagship's all-episode AAPE exceeds
the published "Reactive" table on some scenarios.

The published AAPE (reference barplots.py:8,26) averages APE over ALL
episodes of a campaign.  The reference agents fail most hard episodes, and an
episode that ends in an early collision freezes its APE at death, while an
agent that survives the same episode logs the larger APE of the whole
avoidance detour.  This tool measures that effect:

- PAIRED campaigns: the focal agent and the four imported reference agents
  fly the IDENTICAL episodes a scenario (spawn, path, obstacles and policy
  noise).  The focal agent is 128-128 and the references 64-64, so they fly
  as two stacks (`run_episodes_multi`, same_episodes) under the same chunk
  seeds: each stack draws a chunk's episodes and noise from one generator
  before repeating them over its agents, so the draws do not depend on the
  stack's size or width.
- Keeps per-episode (success, ape, time) rows and writes them to an .npz
  next to the JSON report.
- Reports, per agent x scenario, the AAPE over all / successful / failed
  episodes, and the focal agent's AAPE conditioned on each reference agent's
  outcome on the same episodes (the survivorship counterfactual).

    python -m drone2d_tpu_torch.scripts.aape_survivorship \\
        --focal artifacts/agent_s8004/new_agent.npz --episodes 1000 --chunk 250 \\
        --seed 909 --out artifacts/campaigns/r5/aape_survivorship.json [--device cpu]

Chunk c of scenario s runs from a generator seeded with the c-th of
`eval.episode.campaign_keys(seed, s, n_chunks)`.  Runs on the CUDA card
unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from drone2d_tpu_torch.config import ALL_SCENARIOS
from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.eval.barplots import PUBLISHED_AAPE
from drone2d_tpu_torch.eval.episode import campaign_keys, run_episodes_multi
from drone2d_tpu_torch.eval.run import load_params, scenario_config
from drone2d_tpu_torch.models.policy import stack_params

REFERENCE_IMPORTS = [
    "artifacts/imported/agent_17_90.npz",
    "artifacts/imported/agent_19_90.npz",
    "artifacts/imported/agent_20_90.npz",
    "artifacts/imported/agent_21_90.npz",
]


def agent_labels(paths) -> list:
    """A label an agent: its directory's name for a `new_agent.npz`, else its
    file's stem; a repeated label gets `#<index>`."""
    labels = [os.path.splitext(os.path.basename(os.path.dirname(a) if
              os.path.basename(a) == "new_agent.npz" else a))[0] for a in paths]
    seen = set()
    for i, lab in enumerate(labels):
        if lab in seen:
            labels[i] = f"{lab}#{i}"
        seen.add(labels[i])
    return labels


def width_groups(all_params) -> list:
    """(agent indices, stack) for each architecture among the agents, in the
    order of first appearance."""
    groups = {}
    for i, prm in enumerate(all_params):
        groups.setdefault(tuple(tuple(p.shape) for p in prm.parameters()), []).append(i)
    return [(idxs, stack_params([all_params[i] for i in idxs])) for idxs in groups.values()]


def paired_outcomes(groups, n_agents: int, scenario: str, seed: int, episodes: int, chunk: int,
                    device=None):
    """The device half: (success (A, N) bool, ape (A, N), time (A, N)) of
    every agent over `scenario`'s chunks, each group under the same chunk
    seeds."""
    n_chunks = (episodes + chunk - 1) // chunk
    N = n_chunks * chunk
    succ = np.zeros((n_agents, N), dtype=bool)
    ape = np.zeros((n_agents, N))
    time_s = np.zeros((n_agents, N))
    cfg = scenario_config(scenario)
    for c, key in enumerate(campaign_keys(seed, scenario, n_chunks)):
        lo = c * chunk
        for idxs, stack in groups:
            res = run_episodes_multi(cfg, stack, key, chunk, device=device)
            succ[idxs, lo:lo + chunk] = res.success
            ape[idxs, lo:lo + chunk] = res.ape
            time_s[idxs, lo:lo + chunk] = res.time_steps
    return succ, ape, time_s


def _cond_mean(values, mask):
    n = int(mask.sum())
    return (float(values[mask].mean()) if n else None), n


def scenario_report(labels, scenario: str, succ, ape, time_s) -> dict:
    """One scenario's entry of the report from the agents' per-episode rows
    (agent 0 is the focal one)."""
    rows = {}
    for i, lab in enumerate(labels):
        s = succ[i]
        a_succ, n_succ = _cond_mean(ape[i], s)
        a_fail, n_fail = _cond_mean(ape[i], ~s)
        t_succ, _ = _cond_mean(time_s[i].astype(np.float64), s)
        t_fail, _ = _cond_mean(time_s[i].astype(np.float64), ~s)
        rows[lab] = dict(
            success_rate=float(s.mean()), n_success=n_succ, n_fail=n_fail,
            aape_all=float(ape[i].mean()), aape_success=a_succ, aape_fail=a_fail,
            time_success=t_succ, time_fail=t_fail,
        )
    # the focal agent's AAPE conditioned on each reference agent's outcome
    # over the SAME episodes
    cond = {}
    for i, lab in enumerate(labels[1:], start=1):
        a_s, n_s = _cond_mean(ape[0], succ[i])
        a_f, n_f = _cond_mean(ape[0], ~succ[i])
        cond[lab] = dict(focal_aape_ref_success=a_s, n_ref_success=n_s,
                         focal_aape_ref_fail=a_f, n_ref_fail=n_f)
    return dict(published_aape=PUBLISHED_AAPE.get(scenario), agents=rows,
                focal_conditioned_on_ref=cond)


def survivorship_report(labels, outcomes: dict, *, seed: int, episodes: int) -> dict:
    """The report from each scenario's per-episode rows (`paired_outcomes`'s
    (success, ape, time), agent 0 the focal one)."""
    return {"seed": seed, "episodes": episodes, "focal": labels[0], "agents": labels,
            "scenarios": {scen: scenario_report(labels, scen, *o)
                          for scen, o in outcomes.items()}}


def run(focal: str, refs=REFERENCE_IMPORTS, scenarios=None, *, episodes: int = 1000,
        chunk: int = 250, seed: int = 909, device=None):
    """The paired campaigns, printing a line a scenario -> (report, raw
    per-episode arrays keyed `<scenario>/{success,ape,time}`)."""
    paths = [focal] + list(refs)
    labels = agent_labels(paths)
    groups = width_groups([load_params(a, device=device) for a in paths])
    outcomes = {}
    for scen in scenarios or ALL_SCENARIOS:
        outcomes[scen] = paired_outcomes(groups, len(paths), scen, seed, episodes, chunk, device)
        f = scenario_report(labels, scen, *outcomes[scen])["agents"][labels[0]]
        print(
            f"{scen:>14s}: focal SR {f['success_rate']:.3f}  "
            f"AAPE all {f['aape_all']:.1f}  succ {f['aape_success'] or 0:.1f} "
            f" fail {(f['aape_fail'] if f['aape_fail'] is not None else float('nan')):.1f}  "
            f"(published {PUBLISHED_AAPE.get(scen)})",
            flush=True,
        )
    n_chunks = (episodes + chunk - 1) // chunk
    report = survivorship_report(labels, outcomes, seed=seed, episodes=n_chunks * chunk)
    raw = {f"{scen}/{k}": v for scen, o in outcomes.items()
           for k, v in zip(("success", "ape", "time"), o)}
    return report, raw


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--focal", default="artifacts/agent_s8004/new_agent.npz")
    p.add_argument("--refs", nargs="*", default=REFERENCE_IMPORTS)
    p.add_argument("--scenarios", nargs="+", default=None)
    p.add_argument("--episodes", type=int, default=1000)
    p.add_argument("--chunk", type=int, default=250)
    p.add_argument("--seed", type=int, default=909)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to evaluate; the default is the CUDA card, and the run "
                   "fails without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    report, raw = run(args.focal, args.refs, args.scenarios, episodes=args.episodes,
                      chunk=args.chunk, seed=args.seed, device=dev)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(report, fp, indent=1)
    np.savez_compressed(args.out.replace(".json", "_raw.npz"), **raw)
    print(f"wrote {args.out} (+ raw npz)")
    return report


if __name__ == "__main__":
    main()
