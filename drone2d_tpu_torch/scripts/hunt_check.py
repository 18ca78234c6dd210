"""Learning parity of a seed hunt: its selection record against one of the
JAX package's hunts, read as data from the repo's artifacts: hunt 7
(`REFERENCE`, `artifacts/campaigns/r4/r4_h7_scratch_pp8_select.json`,
flagship-scratch, seeds 7000-7023), hunt 8 (`REFERENCE_H8`,
`artifacts/campaigns/r4/r4_h8_gen2_select.json`, flagship-finetune from
agent_s6006, seeds 8000-8007) or the SB3-shape hunt (`REFERENCE_SB3`,
`artifacts/campaigns/r3/r3_9m_sb3shape/select.json`, the reference's own
training shape: 14 envs x 2048 steps, 448 minibatches of 64, exact, 64-64,
the published reward recipe, seeds 40-47 x 9M), each 12 scenarios x 100
episodes.

    python -m drone2d_tpu_torch.scripts.hunt_check PORT_SELECT.json \\
        [--reference artifacts/campaigns/r4/r4_h8_gen2_select.json] \\
        [--alpha 0.01] [--checkpoints 3014656 ... final] \\
        [--finalists PORT_SELECT777.json] \\
        [--n1000 PORT_FINALISTS_N1000.json ...]

Both records are `select_agents --out` JSON: label `seed_<s>/<step>` or
`seed_<s>/final` -> scenario -> success_rate.  Each seed's score at a
checkpoint is its mean success rate over the 12 scenarios.  For each
checkpoint compared (default: every one the reference holds) the script
prints n, median, min and max of each side, the Mann-Whitney U and its
two-sided p, then each side's cover-12 count (candidates at or above every
published success rate, as `select_agents` counts coverage).  It exits
non-zero unless every checkpoint's p >= alpha / (number compared): a
Bonferroni family-wise alpha.  A checkpoint that either side lacks is
refused.

`--finalists OTHER` lists the both-RNG finalists of PORT_SELECT and a second
selection record of the same candidates under another eval RNG (`select_agents
--seed 777`): the candidates that cover all 12 published success rates in
both, ranked by the lower of their two 12-scenario means, the first
N_FINALISTS (`finalists`; on hunt 8's two records this picks the record's
own three n=1000 finalists).
`--n1000 REPORT ...` prints each agent of a `precision_campaign` report:
its mean, its cover count and whether it is strict (all 12 at or above the
published rates, stage_1 without a failed episode).  Host only: numpy and
scipy, no device.
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

# the JAX package's hunts, read as data from the repo's artifacts
_RECORDS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts", "campaigns")
# hunt 7: flagship-scratch, 24 seeds x 150M steps
REFERENCE = os.path.join(_RECORDS, "r4", "r4_h7_scratch_pp8_select.json")
# hunt 8: flagship-finetune from agent_s6006, 8 seeds x 30M steps (made agent_s8004)
REFERENCE_H8 = os.path.join(_RECORDS, "r4", "r4_h8_gen2_select.json")
# the SB3-shape hunt: PPOConfig's defaults at 14 envs x 2048 steps and 448
# minibatches, the published reward recipe (PP_rew_max 3.5, rew_collision
# -70, abs_inv_CA_min_rew 1/6: docs/RESULTS.md:88-93, 604-621), 8 seeds x 9M
REFERENCE_SB3 = os.path.join(_RECORDS, "r3", "r3_9m_sb3shape", "select.json")
# each record by its path under artifacts/campaigns/
_HUNTS = {
    "r4/r4_h7_scratch_pp8_select.json":
        "the JAX package's hunt 7 (flagship-scratch), eval seed 0",
    "r4/r4_h8_gen2_select.json":
        "the JAX package's hunt 8 (flagship-finetune from agent_s6006), eval seed 0",
    "r4/r4_h8_gen2_select777.json":
        "the JAX package's hunt 8 (flagship-finetune from agent_s6006), eval seed 777",
    "r3/r3_9m_sb3shape/select.json":
        "the JAX package's SB3-shape hunt (14 envs x 2048 steps, 448 minibatches of 64, "
        "exact, 64-64, the published reward recipe, 9M steps), eval seed 0",
    "r4/r4_9m_sb3_pp8_select.json":
        "the JAX package's SB3-shape rerun with PP_rew_max 8 (9M steps), eval seed 0",
}
# hunt 8 took its three both-RNG finalists to n=1000
N_FINALISTS = 3


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
        table[ckpt][seed] = mean_sr(per)
    return dict(table)


def cover_count(record: dict, finals_only: bool = False) -> int:
    """Candidates whose success rate meets or beats every published one."""
    return sum(covers(per) for label, per in record.items()
               if not finals_only or label.endswith("/final"))


def cover(per: dict) -> int:
    """How many of a candidate's scenarios are at or above their published
    success rate."""
    return sum(per[s]["success_rate"] >= sr for s, sr in PUBLISHED_SR.items())


def covers(per: dict) -> bool:
    """A candidate's scenarios all at or above their published success rate."""
    return cover(per) == len(PUBLISHED_SR)


def mean_sr(per: dict) -> float:
    return float(np.mean([per[s]["success_rate"] for s in ALL_SCENARIOS]))


def finalists(record: dict, other: dict, n: int | None = N_FINALISTS) -> list[dict]:
    """The both-RNG finalists of two selection records of the same candidates:
    those that cover all 12 in both, ranked by the lower of their two means
    (then by label), the first `n` (all of them for None).  Each is
    {"label", "means": (record's, other's), "low"}.  Raises ValueError when
    the records hold different candidates."""
    if set(record) != set(other):
        raise ValueError(f"the records hold different candidates: "
                         f"{sorted(set(record) ^ set(other))}")
    both = [dict(label=k, means=(mean_sr(record[k]), mean_sr(other[k])))
            for k in record if covers(record[k]) and covers(other[k])]
    for f in both:
        f["low"] = min(f["means"])
    return sorted(both, key=lambda f: (-f["low"], f["label"]))[:n]


def agent_file(label: str) -> str:
    """A candidate label's file under a sweep's `--out` directory:
    `seed_<s>/<step>` -> `seed_<s>/ckpt_<step>.npz`, `seed_<s>/final` ->
    `seed_<s>/new_agent.npz`."""
    seed, ckpt = label.split("/")
    return f"{seed}/new_agent.npz" if ckpt == "final" else f"{seed}/ckpt_{ckpt}.npz"


def strict_rows(report: dict) -> list[dict]:
    """Each agent of a `precision_campaign` report: its 12-scenario mean,
    its cover count, stage_1's successes of its episodes, and `strict`:
    every scenario at or above its published rate, stage_1 with no failed
    episode."""
    rows = []
    for agent, per in report["agents"].items():
        s1 = per["stage_1"]
        rows.append(dict(
            agent=agent, mean=mean_sr(per), cover=cover(per),
            stage_1=(int(s1["successes"]), int(s1["episodes"])),
            strict=covers(per) and s1["successes"] == s1["episodes"]))
    return rows


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


def reference_name(path: str) -> str:
    """What a reference record is: the JAX package's hunt it holds, named by
    its path under artifacts/campaigns/, or its path for a record that is
    not one of them."""
    under = os.path.relpath(os.path.abspath(path), _RECORDS).replace(os.sep, "/")
    return _HUNTS.get(under, os.path.relpath(path))


def format_finalists(record: dict, other: dict) -> str:
    every = finalists(record, other, None)
    lines = [f"both-RNG cover-12: {len(every)} of {len(record)} candidates; "
             f"{sum(f['low'] > 0.87 for f in every)} of them with both means above 0.87",
             f"finalists (the first {N_FINALISTS} by the lower of the two means):"]
    for f in every[:N_FINALISTS]:
        lines.append(f"  {f['label']:>20s}  means {f['means'][0]:.4f} / {f['means'][1]:.4f}"
                     f"  low {f['low']:.4f}  -> {agent_file(f['label'])}")
    return "\n".join(lines)


def format_strict(report: dict) -> str:
    lines = [f"n={report['episodes']} (seed {report['seed']}, chunk {report['chunk']}):"]
    for r in strict_rows(report):
        lines.append(f"  {r['agent']}: mean {r['mean']:.4f}, cover {r['cover']}/12, "
                     f"stage_1 {r['stage_1'][0]}/{r['stage_1'][1]}, strict {r['strict']}")
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
    p.add_argument("--finalists", default=None, metavar="OTHER_SELECT.json",
                   help="the same candidates' select_agents record under another eval "
                   "RNG: list the both-RNG finalists of the two port records")
    p.add_argument("--n1000", nargs="+", default=(), metavar="REPORT.json",
                   help="precision_campaign reports: each agent's mean, cover count "
                   "and whether it is strict")
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
    print(f"port {args.port} against {reference_name(args.reference)} "
          f"({os.path.relpath(args.reference)}), two-sided Mann-Whitney U, "
          f"family-wise alpha {args.alpha}")
    print(format_report(result))
    for name, record in (("port", port), ("reference", ref)):
        print(f"cover-12 ({name}): {cover_count(record)} of {len(record)} candidates, "
              f"{cover_count(record, finals_only=True)} of "
              f"{sum(k.endswith('/final') for k in record)} finals")
    if args.finalists:
        with open(args.finalists) as f:
            other = json.load(f)
        try:
            text = format_finalists(port, other)
        except ValueError as e:
            print(f"hunt_check: {e}", file=sys.stderr)
            return 2
        print(f"port {args.port} and {args.finalists}:")
        print(text)
    for path in args.n1000:
        with open(path) as f:
            print(f"{path}: " + format_strict(json.load(f)))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
