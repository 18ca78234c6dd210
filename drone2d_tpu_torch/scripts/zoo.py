"""Agent zoo: aggregate sweep summaries into one comparison table; the
port's counterpart of `scripts/zoo.py`.

    python -m drone2d_tpu_torch.scripts.zoo /tmp/sweep_r19 /tmp/sweep_gen ... \
        [--json out.json]

Scans <dir>/seed_*/summary.json (written by `drone2d_tpu_torch.scripts.sweep`
or `scripts/sweep.py`) and prints a
scenario x agent success-rate matrix plus each agent's mean SR — the
framework's version of the reference's ppo_agents/ checkpoint zoo plus
barplots comparison.  Host only: it reads files and touches no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from drone2d_tpu_torch.config import ALL_SCENARIOS


def load_zoo(dirs):
    zoo = {}
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "seed_*", "summary.json"))):
            with open(path) as f:
                s = json.load(f)
            name = f"{os.path.basename(d.rstrip('/'))}/s{s['seed']}"
            zoo[name] = {
                row["scenario"]: row for row in s["scenarios"]
            } | {"_train_seconds": s.get("train_seconds")}
    return zoo


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dirs", nargs="+")
    p.add_argument("--json", default=None)
    p.add_argument("--metric", default="success_rate",
                   choices=["success_rate", "collision_rate", "avg_ape",
                            "avg_flight_time"])
    args = p.parse_args(argv)

    zoo = load_zoo(args.dirs)
    if not zoo:
        raise SystemExit("no summary.json found")

    names = list(zoo)
    col = max(len(n) for n in names) + 2
    header = f"{'scenario':>14s}" + "".join(f"{n:>{col}s}" for n in names)
    print(header)
    means = {n: [] for n in names}
    for scen in ALL_SCENARIOS:
        row = f"{scen:>14s}"
        for n in names:
            v = zoo[n].get(scen, {}).get(args.metric)
            means[n].append(v)
            row += f"{v:>{col}.2f}" if v is not None else " " * (col - 1) + "-"
        print(row)
    print(
        f"{'MEAN':>14s}"
        + "".join(
            f"{sum(v for v in means[n] if v is not None) / max(sum(1 for v in means[n] if v is not None), 1):>{col}.3f}"
            for n in names
        )
    )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(zoo, f, indent=1)


if __name__ == "__main__":
    main()
