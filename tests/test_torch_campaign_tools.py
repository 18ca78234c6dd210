"""The port's agent-shipping tools against the JAX package's scripts, on the
CPU: `precision_campaign`, `package_agent` and `zoo`
(`drone2d_tpu_torch/scripts/`); the stage-1 and AAPE analyses are held the
same way in `tests/test_torch_stage1.py` and `tests/test_torch_aape.py`.

Each JAX script runs at a small size (stage_1, at most 8 episodes and 2
chunks), loaded by path with its accelerator probe and runtime setup
stubbed (the setup would point JAX's process-wide compile cache at the home
directory).  The episode results the script computed are recorded on their
way out of the JAX package's `run_episodes` / `run_episodes_multi` and fed,
as numpy, through the port's report functions: the two documents agree,
counts exactly and floats to 1e-6 relative.  `package_agent`'s n1000
conversion reproduces each shipped agent's committed
`campaign_n1000_summary.json` from its committed source report exactly.
"""

import glob
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import drone2d_tpu.eval.episode as jepisode
import drone2d_tpu.utils.runtime as jruntime
from drone2d_tpu_torch.config import ALL_SCENARIOS
from drone2d_tpu_torch.eval import episode
from drone2d_tpu_torch.eval.run import load_params
from drone2d_tpu_torch.scripts import (
    package_agent,
    precision_campaign,
    zoo,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S8004 = "artifacts/agent_s8004/new_agent.npz"
S22307 = "artifacts/agent_s22307/new_agent.npz"
IMPORTED = "artifacts/imported/agent_{}_90.npz"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def run_jax(monkeypatch, tmp_path):
    """Run a JAX script's main with `argv` from the repo root; returns the
    EpisodeResults its `run_episodes*` calls produced, in call order."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(jruntime, "wait_for_accelerator", lambda *a, **k: True)
    monkeypatch.setattr(jruntime, "setup_runtime", lambda *a, **k: None)
    calls = []

    def recording(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            calls.append(out)
            return out
        return wrapped

    for fn in ("run_episodes", "run_episodes_multi"):
        monkeypatch.setattr(jepisode, fn, recording(getattr(jepisode, fn)))

    def run(name, argv):
        monkeypatch.setattr(sys, "argv", [name, *argv])
        _jax_script(name).main()
        return calls

    return run


def _agree(got, want, path="doc"):
    """Equal structure and key order; ints, bools, strings and None exactly;
    floats to 1e-6 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _agree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _agree(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and math.isclose(got, want, rel_tol=1e-6, abs_tol=0.0), (
            path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_precision_campaign_report_matches_jax(run_jax, tmp_path):
    out = tmp_path / "jax.json"
    calls = run_jax("precision_campaign", [S8004, S22307, "--scenarios", "stage_1",
                                           "--episodes", "8", "--chunk", "8", "--seed", "555",
                                           "--note", "n", "--out", str(out)])
    want = _load(out)
    assert len(calls) == 1 and calls[0].success.shape == (2, 8)
    labels = [S8004, S22307]
    rows = precision_campaign.scenario_rows(labels, calls)
    got = precision_campaign.report(labels, {"stage_1": rows}, seed=555, episodes=8, chunk=8,
                                    note="n")
    _agree(json.loads(json.dumps(got)), want)


def test_precision_campaign_refuses_mixed_widths():
    with pytest.raises(ValueError, match="agent_17_90"):
        precision_campaign.stack_agents([os.path.join(ROOT, S8004),
                                         os.path.join(ROOT, IMPORTED.format(17))], device="cpu")


def test_precision_campaign_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """The port's CLI end to end on the CPU: its document has the JAX
    script's layout, and chunk c runs at the c-th of the campaign's seeds."""
    monkeypatch.chdir(ROOT)
    seeds = []
    real = precision_campaign.run_episodes_multi

    def spy(cfg, stack, seed, n, **kw):
        seeds.append(seed)
        return real(cfg, stack, seed, n, **kw)

    monkeypatch.setattr(precision_campaign, "run_episodes_multi", spy)
    out = tmp_path / "p.json"
    doc = precision_campaign.main([S8004, S22307, "--scenarios", "stage_2", "--episodes", "4",
                                   "--chunk", "2", "--seed", "7", "--device", "cpu",
                                   "--out", str(out)])
    assert _load(out) == json.loads(json.dumps(doc))
    assert seeds == episode.campaign_keys(7, "stage_2", 2)
    assert list(doc) == ["seed", "episodes", "chunk", "note", "agents"] and doc["episodes"] == 4
    row = doc["agents"][S8004]["stage_2"]
    assert row["episodes_run"] == 4 and 0 <= row["successes"] <= row["episodes"]
    assert "stage_2: done over 4 episodes" in capsys.readouterr().out


def _n1000_sources():
    """(summary, source report, label) for each shipped agent whose n1000
    summary has its rows in a committed precision-campaign report."""
    reports = {}
    for p in glob.glob(os.path.join(ROOT, "artifacts", "campaigns", "**", "*.json"),
                       recursive=True):
        d = _load(p)
        if isinstance(d, dict) and "chunk" in d and isinstance(d.get("agents"), dict):
            reports[p] = d
    out = []
    for s in sorted(glob.glob(os.path.join(ROOT, "artifacts", "agent_s*",
                                           "campaign_n1000_summary.json"))):
        summary = _load(s)
        rows = {r["scenario"]: r for r in summary["scenarios"]}
        for rp, rep in sorted(reports.items()):
            if rep["seed"] != summary["eval_seed"]:
                continue
            for label, agent in rep["agents"].items():
                if list(agent) == list(rows) and all(
                        agent[k]["success_rate"] == rows[k]["success_rate"]
                        and agent[k]["avg_ape"] == rows[k]["avg_ape"] for k in rows):
                    out.append(pytest.param(s, rp, label, id=os.path.basename(os.path.dirname(s))))
    return out


N1000 = _n1000_sources()


def test_every_n1000_source_found():
    ids = sorted(p.id for p in N1000)
    assert ids == ["agent_s22307", "agent_s5004", "agent_s6006", "agent_s8004"], ids


@pytest.mark.parametrize("summary, source, label", N1000)
def test_package_agent_n1000_reproduces_committed(summary, source, label):
    want_text = open(summary).read()
    want = json.loads(want_text)
    rep = _load(source)
    tail = (f"; {rep['episodes']}-episode high-precision campaign (fresh RNG, not used in any "
            "selection)")
    assert want["note"].endswith(tail)
    got = package_agent.n1000_doc(rep, label, seed=want["seed"],
                                  note=want["note"][:-len(tail)])
    assert got == want and list(got) == list(want)
    assert json.dumps(got, indent=1) == want_text.rstrip("\n")
    with pytest.raises(KeyError):
        package_agent.n1000_doc(rep, "results/no_such_agent.npz", seed=1, note="")


def _summaries():
    out = []
    names = [name for _, name, _ in package_agent.SUMMARIES]
    for p in sorted(p for name in names
                    for p in glob.glob(os.path.join(ROOT, "artifacts", "agent_s*", name))):
        d = _load(p)
        if "hidden_sizes" in d and "checkpoint_step" in d:
            out.append(pytest.param(p, id=os.path.relpath(p, os.path.join(ROOT, "artifacts"))))
    return out


@pytest.mark.parametrize("path", _summaries())
def test_package_agent_summary_doc_fields(path):
    want = _load(path)
    tag = dict((s, t) for s, _, t in package_agent.SUMMARIES)[want["eval_seed"]]
    hidden = package_agent.hidden_sizes(load_params(
        os.path.join(os.path.dirname(path), "new_agent.npz"), device="cpu"))
    got = package_agent.summary_doc(want["scenarios"], seed=want["seed"],
                                    checkpoint_step=want["checkpoint_step"],
                                    eval_seed=want["eval_seed"], note="n", tag=tag, hidden=hidden)
    for k in ("published_coverage", "mean_success_rate", "hidden_sizes", "scenarios",
              "seed", "checkpoint_step", "eval_seed"):
        assert got[k] == want[k], k
    assert list(got) == list(want)
    if want["note"].endswith(f"; eval seed {want['eval_seed']} — {tag}"):
        assert got["note"] == f"n; eval seed {want['eval_seed']} — {tag}"


def test_package_agent_campaign_rows_on_cpu(monkeypatch):
    """The campaign flies `run_episodes` from the eval seed itself, and its
    rows are the means of the results."""
    seeds = []
    real = package_agent.run_episodes

    def spy(cfg, params, seed, n, **kw):
        seeds.append(seed)
        return real(cfg, params, seed, n, **kw)

    monkeypatch.setattr(package_agent, "run_episodes", spy)
    params = load_params(os.path.join(ROOT, S8004), device="cpu")
    res = package_agent.campaign_results(params, 777, 3, scenarios=("stage_2",), device="cpu")
    assert seeds == [777] and list(res) == ["stage_2"]
    want = res["stage_2"]
    (row,) = package_agent.campaign_rows(res, 3)
    assert row == dict(scenario="stage_2", episodes=3,
                       success_rate=float(np.mean(want.success)),
                       collision_rate=float(np.mean(want.collision)),
                       avg_ape=float(np.mean(want.ape)),
                       avg_flight_time=float(np.mean(want.time_steps)))


def _sweep_dir(root, name, seeds):
    for i, s in enumerate(seeds):
        d = root / name / f"seed_{s}"
        d.mkdir(parents=True)
        rows = [dict(scenario=scen, success_rate=round(0.07 * (i + 1) * (j % 5), 3),
                     collision_rate=0.01 * j, avg_ape=100.0 + j, avg_flight_time=400.5 + i)
                for j, scen in enumerate(ALL_SCENARIOS) if (i + j) % 4]
        with open(d / "summary.json", "w") as f:
            json.dump(dict(seed=s, scenarios=rows, train_seconds=12.5 * (i + 1)), f)
    return str(root / name)


@pytest.mark.parametrize("metric", ["success_rate", "avg_ape"])
def test_zoo_output_byte_equal_to_jax(tmp_path, capsys, metric):
    dirs = [_sweep_dir(tmp_path, "sweepA", [3, 1]), _sweep_dir(tmp_path, "sweepB", [20])]
    jzoo = _jax_script("zoo")
    jzoo.main([*dirs, "--metric", metric, "--json", str(tmp_path / "j.json")])
    want = capsys.readouterr().out
    zoo.main([*dirs, "--metric", metric, "--json", str(tmp_path / "t.json")])
    got = capsys.readouterr().out
    assert got == want and "MEAN" in got
    assert open(tmp_path / "t.json", "rb").read() == open(tmp_path / "j.json", "rb").read()
    with pytest.raises(SystemExit, match="no summary.json"):
        zoo.main([str(tmp_path / "empty")])
