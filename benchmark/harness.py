"""What the drivers share: where the files are, the seeds, a run's record
and the gaps that decide `correct`."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark found by its file, whose name may hold dots
    (`metrics/train_mfu.py`, `metrics/device_idle_share.train.py`)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def derived_seeds(seed: int, tag: str, n: int) -> list:
    """n seeds derived from the run's `--seed` for one use (`tag`): the
    same seed gives the same seeds, other tags give other seeds."""
    words = np.random.SeedSequence([int(seed), *tag.encode()]).generate_state(n, np.uint32)
    return [int(w) for w in words]


@dataclasses.dataclass
class Run:
    """One run of a cell, as a driver hands it to the harness."""

    setup_s: float
    end_to_end: Dict[str, float]          # by metric name, tracing off
    attempted: int
    failed: int
    memory_peak_bytes: int
    readings: Dict[str, float]            # the program against the reference
    shape: Dict[str, int]                 # what the readers multiply by
    counters: Dict[str, float]            # counted in the run (launches, calls)
    trace: Optional[object] = None        # trace.Trace of a traced run
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def checks(self) -> Dict[str, tuple]:
        """The numbers that decide `correct`, each (value, limit): the
        readings the cell's limits name."""
        return {k: (self.readings[k], limit) for k, limit in self.limits.items()}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(np.isfinite(v) and v <= limit
                                         for v, limit in self.checks.values())


def leaf_gaps(program: Dict[str, np.ndarray], reference: Dict[str, np.ndarray],
              members: int, skip=frozenset()) -> np.ndarray:
    """Each (member, leaf) gap between the two sides' norms of a leaf,
    |norm_p - norm_r| / max(norm_r, the member's median leaf norm_r), for
    the leaves not in `skip` ((member, leaf) pairs)."""
    gaps = []
    for m in range(members):
        ref = {k: float(np.linalg.norm(v[m])) for k, v in reference.items()}
        median = float(np.median(list(ref.values())))
        for k, r in ref.items():
            if (m, k) not in skip:
                p = float(np.linalg.norm(program[k][m]))
                gaps.append(abs(p - r) / max(r, median, 1e-30))
    return np.asarray(gaps)


def quiet_leaves(grads: Dict[str, np.ndarray], members: int, share: float = 1e-3) -> set:
    """(member, leaf) pairs whose reference gradient norm is under `share` of
    the member's median leaf's: round-off moves them under Adam, so their
    change is left out."""
    out = set()
    for m in range(members):
        norms = {k: float(np.linalg.norm(v[m])) for k, v in grads.items()}
        median = float(np.median(list(norms.values())))
        out |= {(m, k) for k, n in norms.items() if n < share * median}
    return out
