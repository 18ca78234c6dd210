"""The port's stage-1 analyses against the JAX package's scripts, on the
CPU: `stage1_failure_modes` and `stage1_time_margin`
(`drone2d_tpu_torch/scripts/`), held as `tests/test_torch_campaign_tools.py`
holds the other campaign tools: the JAX script at a small size, its episode
results fed through the port's report function, the documents agreeing
(counts exactly, floats to 1e-6 relative).
"""

import json
import os

import torch

from drone2d_tpu_torch.eval import episode
from drone2d_tpu_torch.eval.run import scenario_config
from drone2d_tpu_torch.scripts import stage1_failure_modes, stage1_time_margin
from tests.test_torch_campaign_tools import (  # noqa: F401 (run_jax: a fixture)
    ROOT,
    S8004,
    _agree,
    _load,
    run_jax,
)

torch.set_num_threads(1)


def test_stage1_failure_modes_report_matches_jax(run_jax, tmp_path):
    """The random policy, whose stage_1 episodes end by timeouts and
    aggressive-alpha terminations, so that every class is counted."""
    out = tmp_path / "jax.json"
    calls = run_jax("stage1_failure_modes", ["random", "--episodes", "8", "--chunk", "8",
                                             "--seed", "606", "--out", str(out)])
    want = _load(out)
    assert len(calls) == 1 and want["failures"] == 8
    got = stage1_failure_modes.failure_report("random", calls, scenario_config("stage_1").n_steps)
    _agree(json.loads(json.dumps(got)), want)


def test_stage1_time_margin_report_matches_jax(run_jax, tmp_path):
    out = tmp_path / "jax.json"
    calls = run_jax("stage1_time_margin", [S8004, "--episodes", "4", "--chunk", "4",
                                           "--seed", "608", "--out", str(out)])
    want = _load(out)
    assert len(calls) == 2  # stochastic, then deterministic
    rows = {mode: stage1_time_margin.margin_row([r], 2200, 1100)
            for mode, r in zip(("stochastic", "deterministic"), calls)}
    got = {"seed": 608, "cap": 2200, "ref_cap": 1100, "episodes": 4, "agents": {S8004: rows}}
    _agree(json.loads(json.dumps(got)), want)


def test_stage1_time_margin_runs_at_the_doubled_cap(capsys):
    """The port's eval path reads the cap from the config: its draws and
    buffers are sized by the doubled cap, and a deterministic episode that
    could not finish runs to it."""
    cfg = scenario_config("stage_1").replace(n_steps=2200)
    res = episode.run_episodes(cfg, None, 3, 2, device="cpu")
    assert res.traj.shape[1] == 2200
    report = stage1_time_margin.run([os.path.join(ROOT, S8004)], episodes=2, chunk=2,
                                    device="cpu")
    row = report["agents"][os.path.join(ROOT, S8004)]["deterministic"]
    assert report["cap"] == 2200 and report["ref_cap"] == 1100
    assert row["finish_within_ref_cap"] == 2 and row["time_max"] < 1100
    assert "det=True" in capsys.readouterr().out
