"""Learning-curve plots from metrics.jsonl: the reference's TensorBoard
reward-component curves (tensorboardlogger.py channels) as a CLI, the
port's copy of `drone2d_tpu/eval/curves.py` (matplotlib is imported only
to draw):

    python -m drone2d_tpu_torch.eval.curves logs/metrics.jsonl --out curves.png

Draws the episode return / success rate / component averages over
global_step, optionally overlaying several runs for comparison.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Sequence

CHANNELS = (
    "episodes/avg_total_reward",
    "episodes/success_rate",
    "episodes/avg_length",
    "episodes/avg_APE",
    "episodes/avg_collision_avoidance_reward",
    "episodes/avg_path_adherence",
    "episodes/avg_path_progression",
    "entropy",
)


def load_metrics(path: str) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {"global_step": []}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            out["global_step"].append(row.get("global_step", 0))
            for c in CHANNELS:
                out.setdefault(c, []).append(row.get(c, float("nan")))
    return out


def plot_curves(
    runs: Dict[str, Dict[str, List[float]]],
    out_path: str,
    channels: Sequence[str] = CHANNELS,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(channels)
    cols = 2
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(12, 3 * rows))
    axes = axes.ravel()
    for ax, c in zip(axes, channels):
        for name, m in runs.items():
            if c in m:
                ax.plot(m["global_step"], m[c], label=name, linewidth=1)
        ax.set_title(c, fontsize=9)
        ax.set_xlabel("env steps")
        if len(runs) > 1:
            ax.legend(fontsize=7)
    for ax in axes[n:]:
        ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("metrics", nargs="+", help="one or more metrics.jsonl files")
    p.add_argument("--out", default="curves.png")
    p.add_argument("--labels", nargs="*", default=None)
    args = p.parse_args(argv)
    labels = args.labels or [os.path.dirname(m) or m for m in args.metrics]
    if len(labels) != len(args.metrics):
        raise SystemExit(
            f"--labels needs one label per metrics file "
            f"({len(labels)} labels, {len(args.metrics)} files)"
        )
    if len(set(labels)) != len(labels):
        raise SystemExit(f"duplicate labels would collapse runs: {labels}")
    runs = {lab: load_metrics(m) for lab, m in zip(labels, args.metrics)}
    plot_curves(runs, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
