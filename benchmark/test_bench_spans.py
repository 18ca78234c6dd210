"""The readers of the program's spans and counters
(`metrics/graph_captures_per_eval_call.py`, `eval_capture_share.py`,
`rollout_device_s.py`, `sgd_device_s.py`) over a recorder filled by hand,
and over a program without the recorder.  CPU only.

    python -m pytest benchmark/test_bench_spans.py -q
"""

from __future__ import annotations

import types

import pytest

from benchmark.harness import BENCH, load_module
from drone2d_tpu_torch.utils import profiling


def _read(name, run):
    return load_module(BENCH / "metrics" / f"{name}.py").read(run)


@pytest.fixture
def recorder():
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _traced_run():
    return types.SimpleNamespace(trace=object())


def _capture(cause, seconds):
    with profiling.span("graphs.capture", cause=cause) as s:
        s.set(seconds=seconds)
    profiling.count("graphs.captures")
    profiling.count(f"graphs.captures[{cause}]")
    profiling.count("graphs.capture_s", seconds)
    profiling.count(f"graphs.capture_s[{cause}]", seconds)


def _call(seconds, captures):
    with profiling.span("eval.call") as s:
        for cause, capture_s in captures:
            _capture(cause, capture_s)
        s.set(seconds=seconds)
    profiling.count("eval.calls")
    profiling.count("eval.call_s", seconds)


def test_eval_readers_leave_out_the_traced_call(recorder):
    """Three untraced calls (spans off: counters alone), one of them making
    one capture only, a capture of another cause, then one traced call whose
    slow captures are left out."""
    _call(3.0, [("eval.draws:new_env", 0.5), ("eval.runner:new_env", 1.0)])
    _call(3.0, [("eval.draws:new_env", 0.5), ("eval.runner:new_env", 1.0)])
    _call(2.0, [("eval.runner", 0.5)])
    _capture("update", 20.0)
    recorder.enable()
    _call(6.0, [("eval.draws:new_env", 1.5), ("eval.runner:new_env", 3.0)])
    recorder.enable(False)
    run = _traced_run()
    assert _read("graph_captures_per_eval_call", run) == pytest.approx(5 / 3)
    assert _read("eval_capture_share", run) == pytest.approx(100 * 3.5 / 8.0)


def test_eval_readers_find_nothing_without_untraced_calls(recorder):
    recorder.enable()
    _call(6.0, [("eval.draws:new_env", 1.5)])
    recorder.enable(False)
    assert _read("graph_captures_per_eval_call", _traced_run()) is None
    assert _read("eval_capture_share", _traced_run()) is None


def _update(rollout_s, sgd_s):
    with profiling.span("update"):
        with profiling.span("update.rollout"):
            pass
        with profiling.span("update.sgd"):
            pass
    rollout, sgd = profiling.spans()[-2:]
    rollout.device_s, sgd.device_s = rollout_s, sgd_s


def test_update_readers_take_the_last_update(recorder):
    recorder.enable()
    _update(0.5, 2.0)
    _update(0.25, 0.75)
    recorder.enable(False)
    run = _traced_run()
    assert _read("rollout_device_s", run) == 0.25 and _read("sgd_device_s", run) == 0.75
    assert _read("rollout_device_s", types.SimpleNamespace(trace=None)) is None


def test_update_readers_find_nothing_without_device_time(recorder):
    recorder.enable()
    with profiling.span("update"):
        with profiling.span("update.rollout"):
            pass
    recorder.enable(False)
    assert _read("rollout_device_s", _traced_run()) is None
    assert _read("sgd_device_s", _traced_run()) is None


@pytest.mark.parametrize("name", ["graph_captures_per_eval_call", "eval_capture_share",
                                  "rollout_device_s", "sgd_device_s"])
def test_readers_find_nothing_in_a_program_without_the_recorder(monkeypatch, name):
    """A program whose `utils/profiling.py` has no recorder (the parent of
    the change that added it) reads nothing, and does not raise."""
    import sys

    bare = types.ModuleType("drone2d_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "drone2d_tpu_torch.utils.profiling", bare)
    import drone2d_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "profiling", bare)
    assert _read(name, _traced_run()) is None
