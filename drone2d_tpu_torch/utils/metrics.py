"""Host-side metrics sink: JSONL always, TensorBoard when available.

The port's copy of `drone2d_tpu/utils/metrics.py`.

Mirrors the reference's observability rails: the 8 `episodes/avg_*` channels
plus `time/episodes` written by `tensorboardlogger.py:101-108`, and the
config snapshots `main.py:202-206` dumps to `logs/*.txt` (without
reproducing the single-threaded-path bug that overwrites the env config —
`main.py:170-174`, SURVEY.md §5.5).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricsWriter:
    def __init__(
        self,
        jsonl_path: str,
        tensorboard_dir: Optional[str] = None,
        *,
        resume: bool = False,
    ):
        os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
        self._episodes_total = 0
        if resume and os.path.exists(jsonl_path):
            # seed the cumulative counter from the last row already on disk
            # so time/episodes survives checkpoint-resume (train.py then
            # overrides it from the device accumulator; this fallback covers
            # writers without one).  Parse only the final non-empty line.
            last = ""
            with open(jsonl_path) as f:
                for line in f:
                    if line.strip():
                        last = line
            if last:
                try:
                    self._episodes_total = int(
                        json.loads(last).get("time/episodes", 0)
                    )
                except json.JSONDecodeError:
                    pass
        self._f = open(jsonl_path, "a", buffering=1)
        self._tb = None
        if tensorboard_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception:
                self._tb = None  # TB optional; JSONL is the source of truth

    def add_episodes(self, n: int) -> None:
        """Accumulate finished-episode counts.  MUST be called for EVERY
        update (not only logged ones) so the cumulative `time/episodes`
        channel counts every episode, as the reference does per learner step
        (tensorboardlogger.py:110)."""
        self._episodes_total += int(n)

    def set_episodes_total(self, n: int) -> None:
        """Set the absolute cumulative count — used when the learner
        accumulates episodes on device (TrainState.episodes_total), which
        counts every update exactly without per-update host syncs."""
        self._episodes_total = int(n)

    @property
    def episodes_total(self) -> int:
        return self._episodes_total

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"global_step": int(step), "time": time.time()}
        for k, v in metrics.items():
            if k == "global_step":
                continue  # the exact host-side step argument wins over the
                # device's float32 copy (which rounds past 2^24 steps)
            row[k] = float(np.asarray(v))
        # reference channel time/episodes is the cumulative finished count,
        # fed by add_episodes() every update
        row["time/episodes"] = self._episodes_total
        self._f.write(json.dumps(row) + "\n")
        if self._tb is not None:
            for k, v in row.items():
                if k != "time" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def write_config_snapshot(self, directory: str, **configs) -> None:
        """One file per config object (reference writes env + rl snapshots)."""
        os.makedirs(directory, exist_ok=True)
        for name, cfg in configs.items():
            d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
            with open(os.path.join(directory, f"{name}.txt"), "w") as f:
                f.write(repr(d))

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
