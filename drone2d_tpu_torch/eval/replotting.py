"""Offline re-plotting of saved campaign artifacts (reference replotting.py);
the port's copy of `drone2d_tpu/eval/replotting.py`.

Rebuilds a scenario scene and re-draws a previously saved campaign's flight
paths (from the `flight_paths` JSON + `rewards.npy`/`collisions.npy`
artifacts) as a fresh overlay PNG — the reference script's exact job
(`replotting.py:24-107`), as a CLI:

    python -m drone2d_tpu_torch.eval.replotting --campaign Tests/agent_19/test_0/large \\
        --scenario large --out replot.png
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from drone2d_tpu_torch.eval.run import scenario_config


def replot(campaign_dir: str, scenario: str, out_path: str) -> None:
    """Draw the overlay PNG of a saved campaign directory (pygame)."""
    from drone2d_tpu_torch.eval.render import overlay_plot

    with open(os.path.join(campaign_dir, "flight_paths")) as f:
        flight_paths = json.load(f)
    rewards = np.load(os.path.join(campaign_dir, "rewards.npy"))
    collisions = np.load(os.path.join(campaign_dir, "collisions.npy"))
    cfg = scenario_config(scenario)
    overlay_plot(cfg, flight_paths, rewards, collisions, out_path)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--campaign", required=True, help="Tests/<agent>/test_k/<scenario> dir")
    p.add_argument("--scenario", required=True)
    p.add_argument("--out", default="replot.png")
    args = p.parse_args(argv)
    replot(args.campaign, args.scenario, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
