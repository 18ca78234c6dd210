"""The port's AAPE survivorship analysis against the JAX package's script,
on the CPU (`drone2d_tpu_torch/scripts/aape_survivorship.py`), held as
`tests/test_torch_campaign_tools.py` holds the other campaign tools: the
JAX script at a small size, its episode results fed through the port's
report function, the documents agreeing (counts exactly, floats to 1e-6
relative).  Also: its two width groups fly identical episodes.
"""

import json

import numpy as np
import torch

from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.eval import episode
from drone2d_tpu_torch.scripts import aape_survivorship
from tests.test_torch_campaign_tools import (  # noqa: F401 (run_jax: a fixture)
    IMPORTED,
    ROOT,
    S8004,
    _agree,
    _load,
    run_jax,
)

torch.set_num_threads(1)

# the episodes' steps the pairing test flies (the cap's draws are compared)
SHORT_STEPS = 16


def test_aape_survivorship_report_matches_jax(run_jax, tmp_path):
    out = tmp_path / "jax.json"
    calls = run_jax("aape_survivorship", ["--focal", S8004, "--refs", IMPORTED.format(17),
                                          "--scenarios", "stage_1", "--episodes", "4",
                                          "--chunk", "4", "--seed", "909", "--out", str(out)])
    want = _load(out)
    assert len(calls) == 2  # the 128-128 group, then the 64-64 group
    labels = aape_survivorship.agent_labels([S8004, IMPORTED.format(17)])
    succ, ape, time_s = (np.concatenate([np.asarray(getattr(r, f)) for r in calls])
                         for f in ("success", "ape", "time_steps"))
    got = aape_survivorship.survivorship_report(
        labels, {"stage_1": (succ.astype(bool), ape.astype(np.float64),
                             time_s.astype(np.float64))}, seed=909, episodes=4)
    _agree(json.loads(json.dumps(got)), want)
    raw = np.load(str(out).replace(".json", "_raw.npz"))
    assert sorted(raw.files) == ["stage_1/ape", "stage_1/success", "stage_1/time"]


def test_aape_labels_disambiguate_repeats():
    assert aape_survivorship.agent_labels(
        [S8004, IMPORTED.format(17), "x/agent_17_90.npz"]) == [
        "agent_s8004", "agent_17_90", "agent_17_90#2"]


def test_width_groups_draw_identical_episodes(monkeypatch, tmp_path):
    """Under one seed a 1 x 128 stack and a 4 x 64 stack fly identical
    episodes (start states, obstacles and noise), each agent of the larger
    stack the same ones: the draws are made before the repeat over the
    stack.  The port's CLI writes the report and the raw rows."""
    seen = []
    real = episode.run_episodes_from

    def spy(env, params, state, obs, draws, **kw):
        seen.append((params.members, state, obs, draws))
        # the episodes' first steps suffice for the CLI's plumbing
        short = Drone2DEnv(env.cfg.replace(n_steps=SHORT_STEPS), env.device)
        return real(short, params, state, obs, draws[:SHORT_STEPS], **kw)

    monkeypatch.setattr(episode, "run_episodes_from", spy)
    monkeypatch.chdir(ROOT)
    n = 3
    out = tmp_path / "a.json"
    aape_survivorship.main(["--focal", S8004, "--refs", *(IMPORTED.format(k) for k in
                                                          (17, 19, 20, 21)),
                            "--scenarios", "stage_2", "--episodes", str(n), "--chunk", str(n),
                            "--out", str(out), "--device", "cpu"])
    assert [m for m, *_ in seen] == [1, 4]
    (_, s1, o1, d1), (_, s4, o4, d4) = seen
    for a in range(4):
        rows = slice(a * n, (a + 1) * n)
        assert torch.equal(o4[rows], o1) and torch.equal(d4[:, rows], d1)
        assert torch.equal(s4.body.pos[rows], s1.body.pos)
        assert torch.equal(s4.obstacles.xy[rows], s1.obstacles.xy)
        assert torch.equal(s4.path.wps[rows], s1.path.wps)
    doc = _load(out)
    assert doc["agents"] == ["agent_s8004"] + [f"agent_{k}_90" for k in (17, 19, 20, 21)]
    assert set(doc["scenarios"]["stage_2"]["focal_conditioned_on_ref"]) == set(
        doc["agents"][1:])
    raw = np.load(str(out).replace(".json", "_raw.npz"))
    assert raw["stage_2/success"].shape == (5, n)
