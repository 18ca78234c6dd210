"""The benchmark's files: BENCHMARK.json against its contract's shape, every
configuration, traffic, cell, driver and metric reader found by its name,
the yardstick's FLOP counts, and what the benchmark may import.  CPU only.

    python -m pytest benchmark/test_bench_files.py -q
"""

from __future__ import annotations

import ast
import re

import pytest

from benchmark import counts
from benchmark.harness import BENCH, ROOT, load_json, load_module

SPEC = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "drone2d_tpu"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_sizes():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {"setup_s"} <= {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert all(w["chips"] == 1 and len(w["why"]) <= 200 for w in SPEC["workloads"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_cell_reports_what_it_must():
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in SPEC["per_layer"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "per_layer"])
def test_files_found_by_name(kind):
    for entry in SPEC[kind]:
        if kind == "configs":
            config = load_json(ROOT / entry["file"])
            assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
            assert config["policy"]["tf32"] is False and config["policy"]["dtype"] == "float32"
        elif kind == "workloads":
            traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
            assert (BENCH / "drivers" / f"{traffic['driver']}.py").exists()
            load_module(BENCH / "drivers" / f"{traffic['driver']}.py")
            limits = load_json(BENCH / "workloads" / f"{entry['name']}.json")
            assert limits["limits"] and all(v >= 0 for v in limits["limits"].values())
        else:
            assert callable(load_module(BENCH / "metrics" / f"{entry['name']}.py").read)


@pytest.mark.parametrize("rows,hidden,members,mflop", [
    (1024, 128, 1, 82.1), (8 * 1024, 128, 8, 656.4), (64 * 100, 128, 64, 512.8)])
def test_kernel_flops_match_the_published_rows(rows, hidden, members, mflop):
    """PERF.md §6's rows: B=1024 H=128, S=8 x N=1024, S=64 x N=100."""
    work = counts.policy_kernel_work(rows, hidden, members)
    assert round(work["flops"] / 1e6, 1) == mflop


def test_update_flops_an_env_step():
    """~2.48 MFLOP an env step of a flagship update (rollout, last values,
    3 x forward for 10 epochs)."""
    flops = counts.update_model_flops(8, 1024, 128, 10, 128) / (8 * 1024 * 128)
    assert 2.47e6 < flops < 2.49e6


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: drone2d_tpu_torch is not drone2d_tpu."""
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "drone2d_tpu_torch" not in tops, path
        assert tops <= {"__future__", "benchmark", "dataclasses", "functools", "math", "typing",
                        "numpy", "torch"}, (path, tops)


def test_run_refuses_without_a_card(capsys, monkeypatch):
    """Without a card the run exits with 2 and prints no result."""
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", SPEC["workloads"][0]["name"], "--seed", "3000000000",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    from benchmark import run

    monkeypatch.setitem(sys.modules, "drone2d_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "drone2d_tpu.fake", sys)
    assert run.forbidden_modules() == ["drone2d_tpu"]


class _Event:
    def __init__(self, name, cuda, start, length):
        self._name, self._cuda, self._start, self._length = name, cuda, start, length

    def name(self):
        return self._name

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._length

    def is_user_annotation(self):
        return False


def test_trace_counts_the_window_without_the_profilers_own_work():
    """Device records up to the lead-in's marker are left out, and idle gaps
    in which the host flushed the profiler's buffers leave the window."""
    from benchmark import trace

    lead = [_Event("lead add", True, 1_000 * i, 500) for i in range(4)]
    lead.append(_Event("at::cuda::(anonymous namespace)::spin_kernel(long)", True, 4_000, 500))
    ms = 1_000_000
    window = [_Event("kernel a", True, 2 * ms, ms), _Event("Buffer Flush", False, 3 * ms, ms),
              _Event("kernel b", True, 4 * ms, ms), _Event("cudaGraphLaunch", False, 5 * ms, ms),
              _Event("kernel c", True, 6 * ms, ms)]
    got = trace.reduce(lead + window, window_s=5e-3)
    assert got.n_ops == 3 and got.busy_s == pytest.approx(3e-3)
    assert got.idle_by_host["host: Buffer Flush"] == pytest.approx(1e-3)
    assert got.idle_by_host["host: cudaGraphLaunch"] == pytest.approx(1e-3)
    assert got.window_s == pytest.approx(4e-3)
