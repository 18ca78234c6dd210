"""The port's probes on the CPU (`drone2d_tpu_torch/scripts/`):
`bench_update_split`, `roofline_probe`, `roofline_update`, `bench_kernels`,
`bench_fused_policy`, `profile_step` and `probe_split_carry`, at tiny
sizes: their reports carry the JAX scripts' keys, the closest-point scan
agrees with the JAX script's math, the split-carry chunk with the template
chunk bit for bit; the three chunk probes time the bench's captured chunks.  Also: every new entry point of the port refuses to run
without CUDA unless asked for the CPU.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu_torch import bench
from drone2d_tpu_torch.scripts import (
    aape_survivorship,
    bench_fused_policy,
    bench_kernels,
    bench_update_split,
    package_agent,
    precision_campaign,
    probe_split_carry,
    profile_step,
    roofline_probe,
    roofline_update,
    stage1_failure_modes,
    stage1_time_margin,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENT = os.path.join(ROOT, "artifacts", "agent_s8004", "new_agent.npz")


def test_bench_update_split_prints_the_split(capsys):
    out = bench_update_split.main(["8", "8", "4", "--device", "cpu"])
    text = capsys.readouterr().out
    for head in ("config: 8 envs x 8 steps, 4 mb x 10 epochs (40 SGD steps/update)",
                 "rollout:", "full update:", "gae+sgd share:"):
        assert head in text
    assert 0 < out["rollout_s"] < out["update_s"] and out["sgd_s"] > 0


def test_roofline_probe_rows(tmp_path):
    rows = roofline_probe.probe((8, 16), (128, 256), chunk_t=2, repeats=1, device="cpu")
    assert [(r["probe"], r["num_envs"], r["table_n"]) for r in rows] == [
        ("envs", 8, 512), ("envs", 16, 512), ("table", 16, 128), ("table", 16, 256),
        ("autoreset", 16, 512), ("autoreset", 16, 512)]
    assert [r.get("autoreset") for r in rows[-2:]] == [True, False]
    assert all(r["ns_per_env_step"] > 0 for r in rows)
    assert roofline_probe.ENVS_GRID == (512, 1024, 2048, 4096, 8192)
    assert roofline_probe.TABLE_GRID == (128, 256, 512, 1024, 2048)


def test_roofline_update_report_keys():
    """The report has the JAX script's layout (`scripts/roofline_update.py`
    `report`), and its floors are the H100's."""
    rep = roofline_update.decompose(8, 8, 4, reps=1, iters=2, device="cpu")
    assert list(rep) == ["config", "ms", "env_steps_per_s", "floors_us", "shares"]
    assert list(rep["ms"]) == ["rollout", "full_update", "sgd_phase", "gae", "perm_per_epoch",
                               "grad_per_step", "opt_per_step", "components_sum"]
    assert list(rep["shares"]) == ["sgd_of_update", "grad_of_sgd", "opt_of_sgd",
                                   "perm_of_sgd", "gae_of_sgd", "unexplained"]
    cfg = rep["config"]
    assert cfg["minibatch_rows"] == 16 and cfg["hidden"] == [128, 128]
    # 27-128-128 towers with 2 + 1 head outputs and a 2-entry log_std
    assert cfg["n_params"] == 2 * (27 * 128 + 128 + 128 * 128 + 128) + 128 * 3 + 3 + 2
    dims = (27 * 128 + 128 * 128 + 128 * 3) * 2 * 2
    assert rep["floors_us"]["grad_compute"] == pytest.approx(3 * dims * 16 / 67e12 * 1e6)
    assert all(v > 0 for v in rep["ms"].values())


def test_bench_kernels_matches_jax_math(capsys):
    """The closest-point scan against `scripts/bench_kernels.py`'s jnp math
    on the same synthetic tables."""
    B, T = 64, 128
    args = bench_kernels.tables(B, T, "cpu")
    got = bench_kernels.closest(*args).numpy()
    table_x, table_y, table_u0, du, pos = (jnp.asarray(a.numpy()) for a in args)
    dx = table_x - pos[:, 0:1]
    dy = table_y - pos[:, 1:2]
    d2 = dx * dx + dy * dy
    idx = jnp.argmin(d2, axis=1)
    onehot = jnp.arange(T)[None, :] == idx[:, None]

    def pick(a):
        return jnp.sum(jnp.where(onehot, a, 0.0), axis=1)

    f0 = pick(d2)
    fa = pick(jnp.concatenate([d2[:, :1], d2[:, :-1]], axis=1))
    fb = pick(jnp.concatenate([d2[:, 1:], d2[:, -1:]], axis=1))
    denom = fa - 2.0 * f0 + fb
    off = jnp.where(jnp.abs(denom) < 1e-9, 0.0, 0.5 * du * (fa - fb) / denom)
    off = jnp.clip(off, -du, du)
    u0 = table_u0 + idx.astype(jnp.float32) * du
    want = np.asarray(jnp.where((idx == 0) | (idx == T - 1), u0, u0 + off))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert bench_kernels.main([str(B), str(T), "--device", "cpu"]) > 0
    assert f"({B} envs x {T} table)" in capsys.readouterr().out


def test_bench_fused_policy_json(capsys, tmp_path):
    out = tmp_path / "f.json"
    res = bench_fused_policy.main(["--batch", "16", "--iters", "3", "--reps", "1",
                                   "--device", "cpu", "--out", str(out)])
    assert list(res) == ["plain", "kernel", "speedup_plain_over_kernel", "scaled_errors"]
    assert res["scaled_errors"] == {"action": 0.0, "logp": 0.0, "value": 0.0}  # both plain
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")][0]
    assert json.loads(line) == res
    assert json.load(open(out))["batch"] == 16


def test_profile_step_writes_trace(tmp_path):
    path = profile_step.profile(str(tmp_path / "prof"), num_envs=4, chunk_t=2, chunks=1,
                                device="cpu")
    assert path == str(tmp_path / "prof" / "trace.json")
    names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_probe_split_carry_bit_equal(capsys):
    out = probe_split_carry.main(["--num-envs", "8", "--chunk", "3", "--repeats", "1",
                                  "--device", "cpu"])
    assert out["first_chunk_reward_equal"] is True
    assert list(out) == ["num_envs", "chunk", "template_ns", "split_ns", "speedup",
                         "first_chunk_reward_equal"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


# each probe at a tiny size -> (expected captured chunk classes, chunks each)
PROBES = {
    "roofline_probe": (lambda d: roofline_probe.measure(8, 128, chunk_t=4, repeats=1,
                                                        device="cpu"),
                       ["CapturedChunk"], 2),
    "profile_step": (lambda d: profile_step.profile(str(d / "prof"), num_envs=4, chunk_t=4,
                                                    chunks=1, device="cpu"),
                     ["CapturedChunk"], 2),
    "probe_split_carry": (lambda d: probe_split_carry.run(8, 4, repeats=1, device="cpu"),
                          ["CapturedChunk", "CapturedSplitChunk"], 2),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_times_the_captured_chunk(name, tmp_path, monkeypatch):
    """Each probe times what the bench's env line times: the captured chunk
    (`bench.CapturedChunk`; `CapturedSplitChunk` for the split carry) of
    `bench.graph_steps(chunk)` steps, built once and called for the warm-up
    and every timed chunk; on the CPU its graph's body runs directly."""
    module = getattr(__import__("drone2d_tpu_torch.scripts", fromlist=[name]), name)
    made = []
    for cls_name in ("CapturedChunk", "CapturedSplitChunk"):
        base = getattr(module, cls_name, None)
        if base is None:
            continue

        class Spy(base):
            label = cls_name

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.calls = 0
                made.append((self.label, self))

            def __call__(self, *a):
                self.calls += 1
                return super().__call__(*a)

        monkeypatch.setattr(module, cls_name, Spy)
    run, classes, calls = PROBES[name]
    run(tmp_path)
    assert [c for c, _ in made] == classes
    for _, chunk in made:
        assert chunk.graph.eager and chunk.steps == bench.graph_steps(4) == 4
        assert chunk.calls == calls and chunk.graph.outputs is not None


# each new entry point with arguments that would otherwise run
ENTRY_POINTS = {
    "bench": (bench.main, ["--num-envs", "4", "--chunk", "2"]),
    "precision_campaign": (precision_campaign.main, [AGENT, "--episodes", "2", "--chunk", "2",
                                                     "--scenarios", "stage_1"]),
    "package_agent": (package_agent.main, [AGENT, "--seed", "1", "--checkpoint-step", "1",
                                           "--out-dir", os.devnull]),
    "stage1_failure_modes": (stage1_failure_modes.main, [AGENT, "--episodes", "2"]),
    "stage1_time_margin": (stage1_time_margin.main, [AGENT, "--episodes", "2"]),
    "aape_survivorship": (aape_survivorship.main, ["--episodes", "2", "--out", os.devnull]),
    "bench_update_split": (bench_update_split.main, ["8", "8", "4"]),
    "roofline_probe": (roofline_probe.main, ["--chunk", "2", "--out", os.devnull]),
    "roofline_update": (roofline_update.main, ["8", "8", "4"]),
    "bench_kernels": (bench_kernels.main, ["8", "16"]),
    "bench_fused_policy": (bench_fused_policy.main, ["--batch", "8", "--iters", "2"]),
    "profile_step": (profile_step.main, [os.devnull]),
    "probe_split_carry": (probe_split_carry.main, ["--num-envs", "8", "--chunk", "2"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_needs_cuda_unless_asked_for_cpu(name, tmp_path, monkeypatch):
    """Without `--device` the entry point runs on the card, and raises
    instead of falling back to the CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    monkeypatch.chdir(ROOT)
    main, argv = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([*argv, "--device", "cuda"])
