"""Published-results tables and grouped bar charts (reference barplots.py);
the port's copy of `drone2d_tpu/eval/barplots.py`.

The reference hard-codes its final campaign numbers, "Reactive" (sees 3
obstacles, lambda-blended CA reward) against "Static" (the ablation), in
`barplots.py:6-29`, and draws grouped bar charts per metric
(`plot_{aape,sr,cr,fr}_scenarios_stages`, `barplots.py:39-199`).  The
tables are mirrored verbatim; the "Reactive" success rates and AAPE, keyed
by the framework's scenario names, are what `scripts/select_agents.py`
ranks candidates against.  The same four chart families are drawn from the
tables or from a fresh campaign tree (`load_campaign_data`); matplotlib is
imported only to draw.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import numpy as np

# Reference barplots.py:6-16 (scenarios) and :19-29 (curriculum stages).
SCENARIO_DATA: Dict[str, Dict[str, list]] = {
    "scenario": ["Corridor", "S-corridor", "Parallel", "S-parallel",
                  "Perpendicular", "Large", "Impossible"],
    "reactive": {
        "AAPE": [104, 104, 111, 87, 119, 90, 87],
        "SR": [88, 71, 55, 3, 28, 71, 0],
        "FR": [12, 29, 45, 97, 72, 29, 100],
        "CR": [12, 29, 45, 97, 71, 29, 85],
    },
    "static": {
        "AAPE": [113, 115, 112, 84, 128, 44, 59],
        "SR": [21, 0, 9, 2, 21, 93, 0],
        "FR": [79, 100, 91, 98, 79, 7, 100],
        "CR": [48, 45, 91, 96, 79, 7, 100],
    },
}

STAGES_DATA: Dict[str, Dict[str, list]] = {
    "stage": ["Stage 1", "Stage 2", "Stage 3", "Stage 4", "Stage 5"],
    "reactive": {
        "AAPE": [7, 119, 18, 35, 35],
        "SR": [100, 96, 94, 48, 49],
        "FR": [0, 4, 6, 52, 51],
        "CR": [0, 0, 5, 49, 48],
    },
    "static": {
        "AAPE": [4, 115, 14, 19, 8],
        "SR": [92, 79, 69, 11, 15],
        "FR": [8, 21, 31, 89, 85],
        "CR": [0, 0, 7, 62, 79],
    },
}

# The framework's scenario keys for each published row above — the bridge
# between the verbatim table labels and the eval harness's scenario names.
_SCENARIO_KEYS = ["corridor", "S_corridor", "parallel", "S_parallel",
                  "perpendicular", "large", "impossible"]
_STAGE_KEYS = ["stage_1", "stage_2", "stage_3", "stage_4", "stage_5"]

# Published "Reactive" success rates as fractions keyed by scenario name —
# the single source for selection ranking (scripts/select_agents.py) and the
# artifact regression tests (tests/test_artifact_agent.py); derived from the
# verbatim tables above, never duplicated.
PUBLISHED_SR: Dict[str, float] = {
    **dict(zip(_SCENARIO_KEYS,
               (v / 100.0 for v in SCENARIO_DATA["reactive"]["SR"]))),
    **dict(zip(_STAGE_KEYS,
               (v / 100.0 for v in STAGES_DATA["reactive"]["SR"]))),
}

# Published "Reactive" AAPE (px; the table says cm, but the values are the
# env's pixel-space APE means — reference barplots.py:8,26) keyed by
# scenario name.  Single source for the r5 AAPE-axis work
# (scripts/aape_survivorship.py, select_agents.py AAPE coverage).
PUBLISHED_AAPE: Dict[str, float] = {
    **dict(zip(_SCENARIO_KEYS,
               (float(v) for v in SCENARIO_DATA["reactive"]["AAPE"]))),
    **dict(zip(_STAGE_KEYS,
               (float(v) for v in STAGES_DATA["reactive"]["AAPE"]))),
}

_METRIC_TITLES = {
    "AAPE": ("Average APE [cm]", "AAPE"),
    "SR": ("Success rate [%]", "Success rate"),
    "FR": ("Failure rate [%]", "Failure rate"),
    "CR": ("Collision rate [%]", "Collision rate"),
}


def load_campaign_data(tests_root: str, agent: str) -> Dict[str, Dict[str, list]]:
    """Read a fresh campaign tree (Tests/<agent>/test_k/<scenario>/results.txt,
    as written by drone2d_tpu_torch.eval.artifacts) into the barplot table format."""
    agent_dir = os.path.join(tests_root, agent)
    rows: Dict[str, Dict[str, float]] = {}
    # numeric sort: lexicographic would put test_10 before test_2 and let a
    # stale campaign overwrite a newer one (artifacts._campaign_dirs bumps k
    # per re-run; later must win)
    test_dirs = sorted(
        (d for d in os.listdir(agent_dir)
         if d.startswith("test_") and d.split("_")[1].isdigit()),
        key=lambda d: int(d.split("_")[1]),
    )
    for test_dir in test_dirs:
        base = os.path.join(agent_dir, test_dir)
        if not os.path.isdir(base):
            continue
        for scen in sorted(os.listdir(base)):
            sdir = os.path.join(base, scen)
            if scen == "plots" or not os.path.isdir(sdir):
                continue
            for fname in os.listdir(sdir):
                if fname.endswith("_results.txt"):
                    txt = open(os.path.join(sdir, fname)).read()

                    def grab(label):
                        m = re.search(rf"{label}: ([\d.eE+-]+)", txt)
                        return float(m.group(1)) if m else float("nan")

                    rows[scen] = {
                        "SR": grab("Success rate") * 100,
                        "CR": grab("Collision rate") * 100,
                        "FR": (1 - grab("Success rate")) * 100,
                        "AAPE": grab("Average APE"),
                    }
    names = list(rows)
    return {
        "scenario": names,
        "agent": {m: [rows[s][m] for s in names] for m in ("AAPE", "SR", "FR", "CR")},
    }


def grouped_bars(
    metric: str,
    groups: Sequence[str],
    series: Dict[str, Sequence[float]],
    out_path: Optional[str] = None,
    *,
    title_suffix: str = "",
):
    """One grouped bar chart: `groups` on x, one bar per `series` entry —
    the generic form of plot_*_scenarios_stages (barplots.py:39-199)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ylabel, title = _METRIC_TITLES[metric]
    x = np.arange(len(groups))
    width = 0.8 / max(len(series), 1)
    fig, ax = plt.subplots(figsize=(10, 5))
    for i, (name, vals) in enumerate(series.items()):
        ax.bar(x + (i - (len(series) - 1) / 2) * width, vals, width, label=name)
    ax.set_xticks(x)
    ax.set_xticklabels(groups, rotation=20)
    ax.set_ylabel(ylabel)
    ax.set_title((title + " " + title_suffix).strip())
    ax.legend()
    fig.tight_layout()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def plot_published(out_dir: str) -> None:
    """Re-generate all eight reference charts (4 metrics x scenarios/stages)."""
    for metric in ("AAPE", "SR", "FR", "CR"):
        grouped_bars(
            metric, SCENARIO_DATA["scenario"],
            {"Reactive": SCENARIO_DATA["reactive"][metric],
             "Static": SCENARIO_DATA["static"][metric]},
            os.path.join(out_dir, f"{metric.lower()}_scenarios.png"),
            title_suffix="(test scenarios)",
        )
        grouped_bars(
            metric, STAGES_DATA["stage"],
            {"Reactive": STAGES_DATA["reactive"][metric],
             "Static": STAGES_DATA["static"][metric]},
            os.path.join(out_dir, f"{metric.lower()}_stages.png"),
            title_suffix="(curriculum stages)",
        )


if __name__ == "__main__":
    import sys

    plot_published(sys.argv[1] if len(sys.argv) > 1 else "plots")
