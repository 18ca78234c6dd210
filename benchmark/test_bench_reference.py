"""The frozen reference against the port's CPU path at a tiny size, where
the port's policy sample is its plain version: the compared numbers come
out at rounding, and the selection's episodes equal.  CPU only.

    python -m pytest benchmark/test_bench_reference.py -q
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.conftest import tiny
from benchmark.drivers import select
from benchmark.run import measure

CPU = torch.device("cpu")


def test_training_reference_follows_the_port():
    run = measure(tiny("scratch-pop8-train"), 3_000_000_019, 0.2, False, CPU, time.perf_counter())
    assert run.attempted >= 1 and run.failed == 0
    for name, (value, _) in run.checks.items():
        assert value <= 1e-5, (name, value)
    assert run.correct


def test_selection_reference_flies_the_port_episodes():
    from drone2d_tpu_torch.eval.episode import run_episodes_multi
    from drone2d_tpu_torch.eval.run import load_params, scenario_config
    from drone2d_tpu_torch.models.policy import stack_params

    traffic = tiny("scratch-select64")["traffic"]
    stack = stack_params([load_params(f"{select.ROOT}/{a}", device=CPU)
                          for a in traffic["agents"]])
    for scenario in traffic["scenarios"]:
        got = run_episodes_multi(scenario_config(scenario), stack, 77, 3, device=CPU)
        want = select.reference_call(traffic, scenario, 77, CPU)
        for k in select.FIELDS:
            np.testing.assert_array_equal(getattr(got, k), want[k], err_msg=k)


def test_selection_reference_follows_the_port_flights():
    """The port's flights, followed from their own states over their whole
    length, part from the reference's blocks by rounding alone."""
    run = measure(tiny("scratch-select64"), 3_000_000_037, 0.1, False, CPU, time.perf_counter())
    assert run.readings["path_gap_q99"] == 0.0 and run.readings["follow_gap_q90"] > 0.0
    assert run.correct, run.checks
