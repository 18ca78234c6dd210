"""The port's host tools on the CPU: `utils/profiling.py`'s trace, `debug.py`
and the plots (`eval/curves.py`, `eval/replotting.py`, `eval/barplots.py`).

The plots are drawn by the port and by the JAX package from the same data
and must come out pixel-equal: the same matplotlib figures, and for the
replot the same pygame overlay (`tests/test_torch_render.py` holds the
renderers pixel-equal).
"""

import json
import os
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from drone2d_tpu.eval import barplots as jbarplots
from drone2d_tpu.eval import curves as jcurves
from drone2d_tpu.eval import replotting as jreplotting
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.eval import barplots, curves, replotting
from drone2d_tpu_torch.eval.artifacts import write_campaign
from drone2d_tpu_torch.eval.episode import run_episodes
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.utils.profiling import trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_png(a, b):
    np.testing.assert_array_equal(imageio.imread(a), imageio.imread(b))


def test_trace_writes_chrome_trace_on_cpu(tmp_path):
    """One rollout step of the learner under `trace`: a Chrome trace with
    the step's operators (the policy's products among them)."""
    learner = PPOLearner(EnvConfig(path_table_n=128), PPOConfig(n_steps=1, num_minibatches=1),
                         4, device="cpu")
    state = learner.init(0)
    with trace(str(tmp_path / "prof")) as path:
        learner.rollout(state)
    assert path == str(tmp_path / "prof" / "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any(n.startswith("aten::") for n in names)
    assert any("mm" in n or "linear" in n or "matmul" in n for n in names)


def test_debug_viewer_records_gif_headless(tmp_path):
    gif = tmp_path / "debug.gif"
    env = {**os.environ, "SDL_VIDEODRIVER": "dummy", "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-m", "drone2d_tpu_torch.debug", "--device", "cpu", "--scenario",
         "corridor", "--agent", os.path.join(ROOT, "artifacts", "agent_s8004", "new_agent.npz"),
         "--max-frames", "6", "--fps", "1000", "--render-shade", "true", "--gif-out", str(gif)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "wrote" in out.stdout and "(3 frames)" in out.stdout
    frames = imageio.mimread(gif)
    assert len(frames) == 3 and frames[0].shape[:2] == (int(EnvConfig().screensize_y),
                                                         int(EnvConfig().screensize_x))
    # the drone moved between the first and the last frame
    assert not np.array_equal(frames[0], frames[-1])


def _metrics(path, n=6, offset=0.0):
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "global_step": i * 1000, "episodes/avg_total_reward": offset + 1.5 * i,
                "episodes/success_rate": min(1.0, 0.1 * i), "entropy": 1.0 - 0.05 * i,
            }) + "\n")
    return str(path)


def test_curves_match_jax(tmp_path):
    runs = [_metrics(tmp_path / "a.jsonl"), _metrics(tmp_path / "b.jsonl", offset=10.0)]
    got = {k: curves.load_metrics(m) for k, m in zip(("runA", "runB"), runs)}
    want = {k: jcurves.load_metrics(m) for k, m in zip(("runA", "runB"), runs)}
    assert json.dumps(got) == json.dumps(want)
    curves.main(runs + ["--labels", "runA", "runB", "--out", str(tmp_path / "t.png")])
    jcurves.main(runs + ["--labels", "runA", "runB", "--out", str(tmp_path / "j.png")])
    _same_png(tmp_path / "t.png", tmp_path / "j.png")
    with pytest.raises(SystemExit, match="duplicate labels"):
        curves.main(runs + ["--labels", "x", "x", "--out", str(tmp_path / "x.png")])


def test_barplots_match_jax(tmp_path):
    for name in ("SCENARIO_DATA", "STAGES_DATA", "PUBLISHED_SR", "PUBLISHED_AAPE"):
        assert getattr(barplots, name) == getattr(jbarplots, name), name
    barplots.plot_published(str(tmp_path / "t"))
    jbarplots.plot_published(str(tmp_path / "j"))
    pngs = sorted(os.listdir(tmp_path / "t"))
    assert len(pngs) == 8 and pngs == sorted(os.listdir(tmp_path / "j"))
    for p in pngs:
        _same_png(tmp_path / "t" / p, tmp_path / "j" / p)
    fig = barplots.grouped_bars("SR", ["a", "b"], {"x": [1, 2], "y": [3, 4]})
    heights = sorted(r.get_height() for r in fig.axes[0].patches)
    assert heights == [1, 2, 3, 4] and fig.axes[0].get_title() == "Success rate"


@pytest.fixture(scope="module")
def campaign_dir(tmp_path_factory):
    """A small corridor campaign of a random policy in the Tests/ schema."""
    root = tmp_path_factory.mktemp("tests")
    cfg = EnvConfig(mode="test", scenario="corridor", path_table_n=128, n_steps=64)
    results = run_episodes(cfg, None, 0, 4, device="cpu")
    out = write_campaign(cfg, results, agent="agent_3", agent_path="x.npz", root=str(root),
                         gif_root=None)
    return str(root), out


def test_replot_matches_jax(campaign_dir, tmp_path):
    _, out = campaign_dir
    replotting.main(["--campaign", out, "--scenario", "corridor", "--out",
                     str(tmp_path / "t.png")])
    jreplotting.replot(out, "corridor", str(tmp_path / "j.png"))
    _same_png(tmp_path / "t.png", tmp_path / "j.png")


def test_load_campaign_data_matches_jax(campaign_dir):
    root, _ = campaign_dir
    got = barplots.load_campaign_data(root, "agent_3")
    assert got == jbarplots.load_campaign_data(root, "agent_3")
    assert got["scenario"] == ["corridor"] and len(got["agent"]["SR"]) == 1
