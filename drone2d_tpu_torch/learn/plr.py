"""PLR-lite: rehearsal-family reweighting from the training rollouts.

The port's own copy of `drone2d_tpu/learn/plr.py` (numpy).  Prioritized
Level Replay (Jiang et al. 2021) samples training levels proportionally to a
regret estimate.  Here the "levels" are the 7 rehearsal families
(env.types.FAMILY_NAMES[1:]: stage_1..stage_5, corridor, cross) and the
regret proxy is each family's measured FAILURE rate on the training
rollouts themselves, counted on the device (TrainState.family_counts /
family_wins).

The controller is host arithmetic over two (8,) arrays copied on the
logging cadence; the new probabilities go back to the device as data
(TrainState.rehearsal_probs).

The total rehearsal budget (the sum of the probabilities, i.e. the fraction
of episodes that are rehearsals rather than scheduled-curriculum draws)
stays FIXED; only its split across families adapts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from drone2d_tpu_torch.env.types import FAMILY_NAMES, N_FAMILIES


def reweight_rehearsal(
    probs: np.ndarray,
    counts_delta: np.ndarray,
    wins_delta: np.ndarray,
    *,
    floor_frac: float = 0.05,
    min_episodes: float = 8.0,
    ema: float = 0.5,
    active: Optional[np.ndarray] = None,
) -> np.ndarray:
    """One controller tick: new (…, 7) family probabilities.

    probs:        current rehearsal probabilities, (..., 7)
    counts_delta: per-family episodes finished since the last tick, (..., 8)
    wins_delta:   per-family successes since the last tick, (..., 8)
    floor_frac:   every ACTIVE family keeps at least this fraction of the
                  budget (a family with p=0 generates no episodes, so its
                  failure rate would never update)
    min_episodes: below this sample count a family is 'unmeasured' and its
                  probability is kept EXACTLY; only the measured families'
                  remaining budget share is redistributed
    ema:          smoothing toward the new target (1.0 = jump immediately)
    active:       boolean (..., 7) mask of families allowed to receive budget
                  (default: the families with nonzero probability at t=0).
                  Inactive families stay at exactly their current
                  probability (normally 0).

    Leading batch dimensions broadcast.
    """
    probs = np.asarray(probs, np.float64)
    counts = np.asarray(counts_delta, np.float64)[..., 1:]  # drop 'schedule'
    wins = np.asarray(wins_delta, np.float64)[..., 1:]
    if active is None:
        active = probs > 0.0
    active = np.broadcast_to(np.asarray(active, bool), probs.shape)

    measured = active & (counts >= min_episodes)
    n_meas = np.sum(measured, axis=-1, keepdims=True)
    # unmeasured/inactive families keep their probability exactly; only the
    # measured families' combined mass is redistributed among themselves
    budget = np.sum(np.where(measured, probs, 0.0), axis=-1, keepdims=True)

    fail_rate = np.where(measured, 1.0 - wins / np.maximum(counts, 1.0), 0.0)
    z = np.sum(fail_rate, axis=-1, keepdims=True)
    uniform = np.where(n_meas > 0, measured / np.maximum(n_meas, 1), 0.0)
    target_share = np.where(z > 1e-12, fail_rate / np.maximum(z, 1e-12), uniform)
    # per-family floor, renormalized over measured families
    floored = np.where(
        measured,
        floor_frac + (1.0 - floor_frac * n_meas) * target_share,
        0.0,
    )
    new = budget * floored
    out = np.where(measured, (1.0 - ema) * probs + ema * new, probs)
    return out.astype(np.float32)


def family_report(counts: np.ndarray, wins: np.ndarray) -> str:
    """One-line human summary: per-family episodes and success rate."""
    parts = []
    for f in range(N_FAMILIES):
        c = float(np.sum(counts[..., f]))
        if c > 0:
            sr = float(np.sum(wins[..., f])) / c
            parts.append(f"{FAMILY_NAMES[f]}:{sr:.2f}({int(c)})")
    return " ".join(parts) or "no finished episodes"
