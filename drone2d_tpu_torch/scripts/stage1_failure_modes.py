"""Classify an agent's residual stage_1 failures: the port's counterpart of
`scripts/stage1_failure_modes.py`.

The published stage_1 success rate is 1.00 (barplots.py:22); chasing it
needs to know WHAT the last ~0.5% of failures are.  Possible ends
(drone_2d_env.py:567-610): timeout at the 1100-step cap, aggressive-alpha
termination (|alpha| >= pi/2), or collision (impossible in stage_1 — no
obstacles).  For timeouts it also reports how far from the path the drone
flew (near-miss vs stuck).

    python -m drone2d_tpu_torch.scripts.stage1_failure_modes <agent.npz> \\
        --episodes 2000 [--device cpu]

Chunk c runs from a generator seeded with the c-th of
`eval.episode.campaign_keys(seed, "stage_1", n_chunks)`.  Runs on the CUDA
card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.eval.episode import campaign_keys, run_episodes
from drone2d_tpu_torch.eval.run import load_params, scenario_config


def stage1_chunks(params, seed: int, episodes: int, chunk: int, cfg=None, *,
                  deterministic: bool = False, device=None):
    """The device half: `run_episodes` results of each chunk of the stage_1
    campaign at `seed` (`cfg`: stage_1's config unless given)."""
    cfg = cfg or scenario_config("stage_1")
    n_chunks = (episodes + chunk - 1) // chunk
    return [run_episodes(cfg, params, key, chunk, deterministic=deterministic, device=device)
            for key in campaign_keys(seed, "stage_1", n_chunks)]


def failure_report(agent: str, chunks, cap: int) -> dict:
    """The report from the chunks' results (anything with `success`, `fail`,
    `collision`, `ape`, `time_steps` arrays (n,)); `cap` is the step cap the
    episodes ran with."""
    n_to = n_aa = n_coll = n_succ = n_fail = 0
    to_ape, aa_t = [], []
    for r in chunks:
        succ = np.asarray(r.success).astype(bool)
        fail = np.asarray(r.fail).astype(bool)
        coll = np.asarray(r.collision).astype(bool)
        t = np.asarray(r.time_steps)
        timeout = fail & (t >= cap) & ~coll
        aa = fail & ~timeout & ~coll
        n_succ += int(succ.sum())
        n_fail += int(fail.sum())
        n_to += int(timeout.sum())
        n_aa += int(aa.sum())
        n_coll += int((fail & coll).sum())
        to_ape.extend(float(r.ape[i]) for i in np.nonzero(timeout)[0])
        aa_t.extend(int(t[i]) for i in np.nonzero(aa)[0])
    return dict(
        agent=agent, episodes=n_succ + n_fail, successes=n_succ,
        failures=n_fail, timeouts=n_to, aggressive_alpha=n_aa,
        collisions=n_coll,
        timeout_apes=sorted(to_ape),
        aa_end_steps=sorted(aa_t),
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("agent")
    p.add_argument("--episodes", type=int, default=2000)
    p.add_argument("--chunk", type=int, default=500)
    p.add_argument("--seed", type=int, default=606)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to evaluate; the default is the CUDA card, and the run "
                   "fails without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = scenario_config("stage_1")
    chunks = stage1_chunks(load_params(args.agent, device=dev), args.seed, args.episodes,
                           args.chunk, cfg, device=dev)
    rep = failure_report(args.agent, chunks, cfg.n_steps)
    print(json.dumps(rep, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
