"""Learning parity of a seed hunt: its selection record against the JAX
package's hunt 7 (`artifacts/campaigns/r4/r4_h7_scratch_pp8_select.json`,
flagship-scratch, seeds 7000-7023, 12 scenarios x 100 episodes).

    python -m drone2d_tpu_torch.scripts.hunt_check PORT_SELECT.json \\
        [--reference artifacts/campaigns/r4/r4_h7_scratch_pp8_select.json] \\
        [--alpha 0.01] [--checkpoints 18743296 ... final]

Both records are `select_agents --out` JSON: label `seed_<s>/<step>` or
`seed_<s>/final` -> scenario -> success_rate.  Each seed's score at a
checkpoint is its mean success rate over the 12 scenarios.  For each
checkpoint compared (default: every one the reference holds) the script
prints n, median, min and max of each side, the Mann-Whitney U and its
two-sided p, then each side's cover-12 count (candidates at or above every
published success rate, as `select_agents` counts coverage).  It exits
non-zero unless every checkpoint's p >= alpha / (number compared): a
Bonferroni family-wise alpha.  A checkpoint that either side lacks is
refused.  Host only: numpy and scipy, no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

import numpy as np
from scipy.stats import mannwhitneyu

from drone2d_tpu_torch.config import ALL_SCENARIOS
from drone2d_tpu_torch.eval.barplots import PUBLISHED_SR

# the JAX package's hunt 7, read as data from the repo's artifacts
REFERENCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts", "campaigns", "r4", "r4_h7_scratch_pp8_select.json")


def checkpoint_key(ckpt: str):
    """Sort order of checkpoint labels: env steps ascending, `final` last."""
    return (1, 0) if ckpt == "final" else (0, int(ckpt))


def seed_table(record: dict) -> dict[str, dict[str, float]]:
    """checkpoint -> seed -> the seed's mean success rate over the 12
    scenarios.  Raises ValueError for a candidate that lacks a scenario."""
    table: dict[str, dict[str, float]] = defaultdict(dict)
    for label, per in record.items():
        seed, ckpt = label.split("/")
        missing = [s for s in ALL_SCENARIOS if s not in per]
        if missing:
            raise ValueError(f"{label} lacks scenarios {missing}")
        table[ckpt][seed] = float(np.mean([per[s]["success_rate"] for s in ALL_SCENARIOS]))
    return dict(table)


def cover_count(record: dict, finals_only: bool = False) -> int:
    """Candidates whose success rate meets or beats every published one."""
    return sum(
        all(per[s]["success_rate"] >= sr for s, sr in PUBLISHED_SR.items())
        for label, per in record.items()
        if not finals_only or label.endswith("/final")
    )


def compare(port_table, ref_table, checkpoints=None, alpha: float = 0.01) -> dict:
    """Two-sided Mann-Whitney U of the port's seeds against the reference's
    at each checkpoint (default: the reference's), Bonferroni over them.
    Returns {"ok", "threshold", "rows": [...]}; raises ValueError for a
    checkpoint that either table lacks."""
    if checkpoints is None:
        checkpoints = sorted(ref_table, key=checkpoint_key)
    if not checkpoints:
        raise ValueError("no checkpoints to compare")
    for c in checkpoints:
        for side, table in (("port", port_table), ("reference", ref_table)):
            if c not in table:
                raise ValueError(f"the {side} record has no checkpoint {c} "
                                 f"(it has {sorted(table, key=checkpoint_key)})")
    threshold = alpha / len(checkpoints)
    rows = []
    for c in checkpoints:
        port = np.array(sorted(port_table[c].values()))
        ref = np.array(sorted(ref_table[c].values()))
        res = mannwhitneyu(port, ref, alternative="two-sided")
        rows.append(dict(
            checkpoint=c, port=_summary(port), reference=_summary(ref),
            u=float(res.statistic), p=float(res.pvalue),
            ok=bool(res.pvalue >= threshold),
        ))
    return dict(ok=all(r["ok"] for r in rows), threshold=threshold, rows=rows)


def _summary(x: np.ndarray) -> dict:
    return dict(n=int(x.size), median=float(np.median(x)),
                min=float(x.min()), max=float(x.max()))


def format_report(result: dict) -> str:
    head = (f"{'checkpoint':>10s} | {'port n':>6s} {'median':>6s} {'min':>6s} {'max':>6s} "
            f"| {'ref n':>5s} {'median':>6s} {'min':>6s} {'max':>6s} | {'U':>6s} {'p':>8s}")
    lines = [head]
    for r in result["rows"]:
        a, b = r["port"], r["reference"]
        lines.append(
            f"{r['checkpoint']:>10s} | {a['n']:6d} {a['median']:6.3f} {a['min']:6.3f} "
            f"{a['max']:6.3f} | {b['n']:5d} {b['median']:6.3f} {b['min']:6.3f} "
            f"{b['max']:6.3f} | {r['u']:6.1f} {r['p']:8.5f}{'' if r['ok'] else '  FAIL'}"
        )
    lines.append(f"every p >= {result['threshold']:.5g}: {result['ok']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("port", help="the port's select_agents --out JSON")
    p.add_argument("--reference", default=REFERENCE)
    p.add_argument("--alpha", type=float, default=0.01,
                   help="family-wise alpha, split over the checkpoints (Bonferroni)")
    p.add_argument("--checkpoints", nargs="+", default=None,
                   help="env-step labels and/or 'final' (default: the reference's)")
    args = p.parse_args(argv)
    with open(args.port) as f:
        port = json.load(f)
    with open(args.reference) as f:
        ref = json.load(f)
    try:
        result = compare(seed_table(port), seed_table(ref), args.checkpoints, args.alpha)
    except ValueError as e:
        print(f"hunt_check: {e}", file=sys.stderr)
        return 2
    print(f"port {args.port} against reference {os.path.relpath(args.reference)}, "
          f"two-sided Mann-Whitney U, family-wise alpha {args.alpha}")
    print(format_report(result))
    for name, record in (("port", port), ("reference", ref)):
        print(f"cover-12 ({name}): {cover_count(record)} of {len(record)} candidates, "
              f"{cover_count(record, finals_only=True)} of "
              f"{sum(k.endswith('/final') for k in record)} finals")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
