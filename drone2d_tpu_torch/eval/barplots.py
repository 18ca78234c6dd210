"""The reference's published results as tables (the port's copy of the
tables in `drone2d_tpu/eval/barplots.py`).

The reference hard-codes its final campaign numbers in `barplots.py:6-29`:
"Reactive" (sees 3 obstacles, lambda-blended CA reward) against "Static"
(the ablation).  The "Reactive" success rates and AAPE, keyed by the
framework's scenario names, are what `scripts/select_agents.py` ranks
candidates against.  The grouped bar charts are not ported yet.
"""

from __future__ import annotations

from typing import Dict

# reference barplots.py:6-16 (scenarios) and :19-29 (curriculum stages),
# the "Reactive" rows
_SCENARIO_KEYS = ["corridor", "S_corridor", "parallel", "S_parallel",
                  "perpendicular", "large", "impossible"]
_SCENARIO_SR = [88, 71, 55, 3, 28, 71, 0]
_SCENARIO_AAPE = [104, 104, 111, 87, 119, 90, 87]
_STAGE_KEYS = ["stage_1", "stage_2", "stage_3", "stage_4", "stage_5"]
_STAGE_SR = [100, 96, 94, 48, 49]
_STAGE_AAPE = [7, 119, 18, 35, 35]

# published "Reactive" success rates as fractions, by scenario name
PUBLISHED_SR: Dict[str, float] = {
    **dict(zip(_SCENARIO_KEYS, (v / 100.0 for v in _SCENARIO_SR))),
    **dict(zip(_STAGE_KEYS, (v / 100.0 for v in _STAGE_SR))),
}

# published "Reactive" AAPE in px (the table says cm, but the values are the
# env's pixel-space APE means, reference barplots.py:8,26), by scenario name
PUBLISHED_AAPE: Dict[str, float] = {
    **dict(zip(_SCENARIO_KEYS, (float(v) for v in _SCENARIO_AAPE))),
    **dict(zip(_STAGE_KEYS, (float(v) for v in _STAGE_AAPE))),
}
