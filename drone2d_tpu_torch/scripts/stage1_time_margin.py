"""How much faster must an agent fly to clear the stage_1 timeout tail?  The
port's counterpart of `scripts/stage1_time_margin.py`.

Runs stage_1 episodes with a doubled cap (2200) and reports the flight-time
distribution of episodes that finish in (1100, 2200] — the would-be
failures — plus episodes still running at 2200 (truly stuck) and early
terminations (aggressive tilt), separately.  It also runs a
deterministic-action pass: if mean behaviour clears the cap everywhere, the
failures are sampling noise; if not, they are systematic geometry.

    python -m drone2d_tpu_torch.scripts.stage1_time_margin \\
        artifacts/agent_s147/new_agent.npz --episodes 2000 \\
        --out artifacts/campaigns/r4/stage1_margin_s147.json [--device cpu]

Every step cap on the eval path reads `cfg.n_steps` (the episode loop, its
noise draws and trajectory buffers, the env's cap), so the doubled cap is
only the config's.  Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.eval.run import load_params, scenario_config
from drone2d_tpu_torch.scripts.stage1_failure_modes import stage1_chunks


def margin_row(chunks, cap: int, ref_cap: int) -> dict:
    """One mode's row from its chunks' results (anything with `success`,
    `time_steps` arrays (n,)), run at step cap `cap` against `ref_cap`."""
    times, succ_n, stuck_n, early_n = [], 0, 0, 0
    for r in chunks:
        succ = np.asarray(r.success, bool)
        t = np.asarray(r.time_steps)
        succ_n += int(succ.sum())
        stuck_n += int((~succ & (t >= cap)).sum())
        early_n += int((~succ & (t < cap)).sum())
        times.extend(int(x) for x in t[succ])
    times = np.array(sorted(times))
    over = times[times > ref_cap]
    return dict(
        finish_within_ref_cap=int((times <= ref_cap).sum()),
        finish_over_ref_cap=int(over.size),
        stuck_at_cap=stuck_n,
        early_termination=early_n,
        over_cap_times=[int(x) for x in over],
        # pace multiplier that would pull each slow finisher under the cap
        # if the whole episode sped up uniformly
        needed_speedup=[round(float(x) / ref_cap, 3) for x in over],
        time_p50=float(np.percentile(times, 50)) if times.size else None,
        time_p99=float(np.percentile(times, 99)) if times.size else None,
        time_max=int(times.max()) if times.size else None,
    )


def run(agents, *, episodes: int = 2000, chunk: int = 500, cap: int = 2200, seed: int = 608,
        device=None) -> dict:
    """Both modes for each agent, printing a line each; returns the report."""
    ref_cap = EnvConfig().n_steps  # 1100 (rl_config.py:16)
    cfg = scenario_config("stage_1").replace(n_steps=cap)
    n_chunks = (episodes + chunk - 1) // chunk
    report = {"seed": seed, "cap": cap, "ref_cap": ref_cap, "episodes": n_chunks * chunk,
              "agents": {}}
    for agent in agents:
        params = load_params(agent, device=device)
        rows = {}
        for det in (False, True):
            mode = "deterministic" if det else "stochastic"
            row = margin_row(stage1_chunks(params, seed, episodes, chunk, cfg,
                                           deterministic=det, device=device), cap, ref_cap)
            rows[mode] = row
            print(f"{agent} det={det}: <=cap {row['finish_within_ref_cap']}"
                  f" over-cap {row['finish_over_ref_cap']} stuck {row['stuck_at_cap']}"
                  f" early-term {row['early_termination']} p99 {row['time_p99']}", flush=True)
        report["agents"][agent] = rows
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("agents", nargs="+")
    p.add_argument("--episodes", type=int, default=2000)
    p.add_argument("--chunk", type=int, default=500)
    p.add_argument("--cap", type=int, default=2200)
    p.add_argument("--seed", type=int, default=608)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to evaluate; the default is the CUDA card, and the run "
                   "fails without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    report = run(args.agents, episodes=args.episodes, chunk=args.chunk, cap=args.cap,
                 seed=args.seed, device=dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
