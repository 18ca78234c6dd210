"""The control comes out not correct: the reference computed in TF32 (the
nearest precision below the configurations' float32 with TF32 off), put in
the program's place at each cell's own size, fails the cell's limits.  On
the card only; the benchmark's own runs never run it.

    python -m pytest benchmark/test_bench_control.py -q -m cuda
"""

from __future__ import annotations

import pytest

from benchmark.harness import BENCH, ROOT, load_json, load_module
from benchmark.run import cell_files

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda_device, cell):
    files = cell_files(cell)
    driver = load_module(BENCH / "drivers" / f"{files['traffic']['driver']}.py")
    readings = driver.control(files["config"], files["traffic"], files["limits"], 5_000_000_011,
                              cuda_device)
    limits = files["limits"]["limits"]
    assert any(readings[k] > limit for k, limit in limits.items()), readings
