"""The port's spans and counters (`drone2d_tpu_torch/utils/profiling.py`) on
the CPU: the recorder off and on, its clock against the profiler's, and
where the program records them (the update, the graph caches, the eval
calls, their campaign envs and their runners, one shared across
scenarios).  Nothing of the JAX package is used.

    python -m pytest tests/test_torch_spans.py -q
"""

from __future__ import annotations

import collections
import os
import time

import numpy as np
import pytest
import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.eval import episode
from drone2d_tpu_torch.eval.run import scenario_config
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.models.policy import flat_dict_to_params, stack_params
from drone2d_tpu_torch.scripts.select_agents import capture_line
from drone2d_tpu_torch.utils import graphs, profiling

torch.set_num_threads(1)

AGENT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "agent_s8004",
                     "new_agent.npz")
SCENARIOS = ["stage_1", "stage_2", "stage_3", "corridor", "S_corridor"]


@pytest.fixture
def recorder():
    """An empty recorder, off; left off and empty."""
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def test_off_records_nothing_and_counters_still_count(recorder):
    off = recorder.span("a")
    assert off is recorder.span("b", device=True, cause="x")
    with off as s:
        s.set(nodes=3)
    assert recorder.spans() == []
    recorder.count("calls")
    recorder.count("calls")
    recorder.count("seconds", 0.25)
    assert recorder.counters() == {"calls": 2, "seconds": 0.25}
    recorder.reset()
    assert recorder.counters() == {}


def test_nested_spans_carry_parent_root_and_self_time(recorder):
    recorder.enable()
    with recorder.span("request", kind="test") as r:
        with recorder.span("first"):
            time.sleep(2e-3)
        with recorder.span("second") as second:
            second.set(n=2)
            with recorder.span("inner"):
                time.sleep(1e-3)
        r.set(done=True)
    with recorder.span("next"):
        pass
    spans = recorder.spans()
    assert [s.name for s in spans] == ["request", "first", "second", "inner", "next"]
    req, first, second, inner, nxt = spans
    assert req.parent is None and req.root == req.id
    assert first.parent == req.id and second.parent == req.id and inner.parent == second.id
    assert {s.root for s in (first, second, inner)} == {req.id}
    assert nxt.parent is None and nxt.root == nxt.id != req.id
    assert len({s.id for s in spans}) == 5
    assert req.attrs == {"kind": "test", "done": True} and second.attrs == {"n": 2}
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_s is None
    assert req.start_ns <= first.start_ns and second.end_ns <= req.end_ns
    assert req.self_ns == req.duration_ns - first.duration_ns - second.duration_ns
    assert second.self_ns == second.duration_ns - inner.duration_ns
    assert inner.self_ns == inner.duration_ns and inner.duration_ns >= 1e6


def test_span_clock_holds_the_profilers_events(recorder):
    """A span around an op under the profiler contains the op's start and
    end as the profiler records them, and opens a host range of its name."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("outer"):
            torch.mm(a, a)
    events = list(prof.profiler.kineto_results.events())
    (outer,) = recorder.spans()
    mm = [e for e in events if e.name() == "aten::mm"]
    ranges = [e for e in events if e.name() == "outer"]
    assert mm and ranges
    for e in mm + ranges:
        assert outer.start_ns <= e.start_ns() <= e.end_ns() <= outer.end_ns


def test_on_inside_a_profiler_window_and_off_after(recorder):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with recorder.span("inside"):
            pass
    with recorder.span("after") as s:
        assert s is recorder.span("x")
    recorder.enable()
    with recorder.span("enabled"):
        pass
    recorder.enable(False)
    assert [s.name for s in recorder.spans()] == ["inside", "enabled"]


def test_spans_past_the_cap_are_counted(recorder, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    recorder.enable()
    with recorder.span("root"):
        for _ in range(4):
            with recorder.span("child"):
                pass
    spans = recorder.spans()
    assert [s.name for s in spans] == ["root", "child", "child"]
    assert recorder.counters()["profiling.spans_dropped"] == 2
    assert spans[0].self_ns == spans[0].duration_ns - sum(s.duration_ns for s in spans[1:])


def test_threads_keep_their_own_spans_and_lose_no_count(recorder):
    """More threads than cores, switching often: every count lands, and each
    thread's inner spans hang under that thread's own outer span."""
    import sys
    import threading

    recorder.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        with recorder.span("outer", thread=k):
            for _ in range(2000):
                recorder.count("hits")
            with recorder.span("inner", thread=k):
                recorder.count("hits")

    workers = [threading.Thread(target=work, args=(k,)) for k in range(2 * os.cpu_count() + 2)]
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert recorder.counters()["hits"] == 2001 * len(workers)
    spans = recorder.spans()
    outer = {s.id: s for s in spans if s.name == "outer"}
    inner = [s for s in spans if s.name == "inner"]
    assert len(outer) == len(inner) == len(workers)
    for s in inner:
        assert outer[s.parent].attrs["thread"] == s.attrs["thread"] and s.root == s.parent


def _tiny_learner():
    return PPOLearner(EnvConfig(path_table_n=128),
                      PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2), 8, device="cpu")


def test_update_jit_spans_on_the_cpu_bit_equal_to_off(recorder):
    """update_jit with spans off and on from twin states: the same weights,
    Adam state and metrics; on, one `update` root holding `update.rollout`
    and `update.sgd` (no device time on the CPU, no capture counted)."""
    learner = _tiny_learner()
    a, b = learner.init(5), learner.init(5)
    a, ma = learner.update_jit(a)
    assert recorder.spans() == []
    recorder.enable()
    b, mb = learner.update_jit(b)
    recorder.enable(False)
    assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    xs, ys = graphs.optimizer_tensors(a.optimizer), graphs.optimizer_tensors(b.optimizer)
    assert len(xs) == len(ys) > 0 and all(torch.equal(x, y) for x, y in zip(xs, ys))
    by = _by_name(recorder.spans())
    (update,) = by["update"]
    assert update.parent is None and set(by) == {"update", "update.rollout", "update.sgd"}
    for name in ("update.rollout", "update.sgd"):
        (s,) = by[name]
        assert s.parent == update.id and s.root == update.id and s.device_s is None
    assert by["update.rollout"][0].end_ns <= by["update.sgd"][0].start_ns
    c = recorder.counters()
    assert "graphs.captures" not in c
    assert c["graph_cache.misses"] == 2  # twin states: two programs


def test_graph_cache_counts_hits_misses_and_evictions(recorder):
    cache = graphs.GraphCache(size=2)
    assert cache.get("a") is None
    cache.put("a", 1)
    assert cache.get("a") == 1
    cache.put("b", 2)
    cache.put("c", 3)  # releases "a"
    assert cache.get("a") is None and cache.get("c") == 3
    assert cache.captures == 3
    c = recorder.counters()
    assert (c["graph_cache.hits"], c["graph_cache.misses"], c["graph_cache.evictions"]) == (
        2, 2, 1)


def test_capture_counts_nothing_on_the_cpu(recorder):
    g = graphs.Graph(lambda: torch.ones(2), "cpu")
    assert graphs.capture([g], cause="eval.runner:new_env") is None
    assert recorder.counters() == {}


def _stack():
    agent = dict(np.load(AGENT))
    return stack_params([flat_dict_to_params(agent, device="cpu") for _ in range(2)])


def test_campaign_envs_counted_past_their_cap(recorder, monkeypatch):
    """Five scenario configurations through `run_episodes_multi` with room
    for four campaign envs, then the fifth again: 5 misses, 1 eviction,
    1 hit; six eval calls, each one root with its four phases."""
    monkeypatch.setattr(episode, "_CAMPAIGN_ENVS", collections.OrderedDict())
    monkeypatch.setattr(episode, "CAMPAIGN_ENVS", 4)
    stack = _stack()
    cfgs = [scenario_config(s).replace(n_steps=4, path_table_n=128) for s in SCENARIOS]
    recorder.enable()
    for cfg in cfgs + cfgs[-1:]:
        res = episode.run_episodes_multi(cfg, stack, 3, 1, device="cpu")
        assert res.success.shape == (2, 1)
    recorder.enable(False)
    c = recorder.counters()
    assert (c["campaign_env.misses"], c["campaign_env.evictions"], c["campaign_env.hits"]) == (
        5, 1, 1)
    assert c["eval.calls"] == 6 and c["eval.call_s"] > 0
    spans = recorder.spans()
    roots = [s for s in spans if s.name == "eval.call"]
    assert len(roots) == 6 and all(s.parent is None for s in roots)
    assert sum(s.attrs["seconds"] for s in roots) == pytest.approx(c["eval.call_s"])
    for root in roots:
        kids = [s.name for s in spans if s.parent == root.id]
        assert kids == ["eval.draws", "eval.runner", "eval.chunks", "eval.results"]


def test_runner_shared_across_scenarios_bit_equal_to_its_own(recorder, monkeypatch):
    """`run_episodes_multi` on a spatial scenario after a stage scenario
    flies the stage's runner (one miss, one hit, shared once) and gives
    what the spatial scenario gives alone, with the caches emptied and its
    runner stepping an env of the scenario's own configuration: `step`
    reads nothing of the scenario."""
    def emptied(step_config):
        monkeypatch.setattr(episode, "_CAMPAIGN_ENVS", collections.OrderedDict())
        monkeypatch.setattr(episode, "_EVAL_RUNNERS",
                            graphs.GraphCache(size=2, counter="eval_runner"))
        monkeypatch.setattr(episode, "step_config", step_config)
        recorder.reset()

    stack = _stack()
    stage, spatial = (scenario_config(s).replace(n_steps=70, path_table_n=128)
                      for s in ("stage_2", "corridor"))
    emptied(episode.step_config)
    episode.run_episodes_multi(stage, stack, 3, 4, device="cpu")
    got = episode.run_episodes_multi(spatial, stack, 5, 4, device="cpu")
    c = recorder.counters()
    assert (c["eval_runner.misses"], c["eval_runner.hits"], c["eval_runner.shared"]) == (
        1, 1, 1)
    emptied(lambda cfg: cfg)
    want = episode.run_episodes_multi(spatial, stack, 5, 4, device="cpu")
    assert recorder.counters()["eval_runner.misses"] == 1
    assert (episode._EVAL_RUNNERS.entries.popitem()[1].env.cfg.mode, got.traj.shape) == (
        "test", (2, 4, 70, 2))
    for k, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_run_episodes_from_called_directly_is_its_own_root(recorder):
    cfg = scenario_config("stage_2").replace(n_steps=4, path_table_n=128)
    env, state, obs, draws = episode._campaign_draws(cfg, "cpu", 7, 2, 0.0, "stochastic")
    params = flat_dict_to_params(dict(np.load(AGENT)), device="cpu")
    recorder.enable()
    episode.run_episodes_from(env, params, state, obs, draws)
    recorder.enable(False)
    spans = recorder.spans()
    assert [s.name for s in spans] == ["eval.call", "eval.runner", "eval.chunks",
                                       "eval.results"]
    assert all(s.root == spans[0].id for s in spans) and recorder.counters()["eval.calls"] == 1


def test_select_agents_capture_line():
    before = {"graphs.captures": 2, "graphs.capture_s": 1.0,
              "graphs.captures[eval.draws:new_env]": 1,
              "graphs.capture_s[eval.draws:new_env]": 0.25}
    after = {"graphs.captures": 6, "graphs.capture_s": 9.5,
             "graphs.captures[eval.draws:new_env]": 3,
             "graphs.capture_s[eval.draws:new_env]": 0.75,
             "graphs.captures[eval.runner:new_env]": 2,
             "graphs.capture_s[eval.runner:new_env]": 8.0,
             "campaign_env.hits": 1, "campaign_env.misses": 2, "campaign_env.evictions": 1,
             "eval_runner.hits": 5, "eval_runner.shared": 4, "eval_runner.misses": 2,
             "graph_cache.hits": 3, "graph_cache.misses": 4}
    assert capture_line(before, after) == (
        "graph captures 4 in 8.5 s (eval.draws:new_env 2 (0.5 s), eval.runner:new_env 2 "
        "(8.0 s)); campaign envs: 1 reused, 2 made, 1 released; eval runners: 5 hits "
        "(4 shared across scenarios), 2 misses, 0 evictions; graph caches: 3 hits, "
        "4 misses, 0 evictions")
    assert capture_line(after, after).startswith("graph captures 0 in 0.0 s;")
