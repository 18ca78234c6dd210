"""Flight-path replay in the port against the JAX package, on the CPU.

`ops/path.closest_position` and `path_coords` are held against JAX's on
seeded paths (the bounds of `tests/test_torch_ops.py`: the distance at the
closest point to rtol 1e-4, atol 1e-2 px, the point itself to a table cell,
path points to rtol 1e-5, atol 2e-3).  `eval/replay.py` replays the
`flight_paths` and `apes.npy` that the port's own campaign writer
(`eval/artifacts.py`) leaves for a small campaign: the kernel replay against
JAX's `replay_ape` (1e-3 px: both take the same 24 golden-section steps in
float32), against the live APEs (the JAX package's bar, 0.05 px on a
straight path; never farther on a curved one), and the scipy-fminbound
replay against JAX's (the same float64 host code: 1e-9 px).
"""

import os

import jax
import numpy as np
import pytest
import torch

from drone2d_tpu.eval import replay as jreplay
from drone2d_tpu.ops import path as jpath
from drone2d_tpu_torch.env import scenarios
from drone2d_tpu_torch.eval import replay
from drone2d_tpu_torch.eval.run import evaluate, scenario_config
from drone2d_tpu_torch.ops import path as tpath
from tests.test_torch_ops import _chains, _np, _path_pair

torch.set_num_threads(1)

AGENT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "agent_s8004",
                     "new_agent.npz")
EPISODES = 3


@pytest.fixture(scope="module")
def paths():
    """Seeded waypoint chains of 3 to 12 live waypoints, as both packages'
    PathData."""
    wps, live = _chains(n=8, seed=6, n_live=(3, 5, 9, 12))
    return (wps, live, *_path_pair(wps, live, table_n=512))


def test_closest_position_matches_jax(paths):
    wps, live, got, want = paths
    rng = np.random.default_rng(7)
    lo, hi = wps.min(1) - 100, wps.max(1) + 100
    q = (lo + rng.random((8, 2)) * (hi - lo)).astype(np.float32)
    cp = _np(tpath.closest_position(got, torch.as_tensor(q), golden_iters=24))
    jcp = np.asarray(jax.vmap(lambda pd, p: jpath.closest_position(pd, p, golden_iters=24))(
        want, q))
    np.testing.assert_allclose(np.linalg.norm(cp - q, axis=1),
                               np.linalg.norm(jcp - q, axis=1), rtol=1e-4, atol=1e-2)
    cell = float(np.max(np.asarray(want.table_u[:, 1] - want.table_u[:, 0])))
    assert np.linalg.norm(cp - jcp, axis=1).max() <= cell


def test_path_coords_match_jax(paths):
    wps, live, got, want = paths
    coords = _np(tpath.path_coords(got, 50))
    assert coords.shape == (8, 50, 2)
    np.testing.assert_allclose(coords, jax.vmap(lambda pd: jpath.path_coords(pd, 50))(want),
                               rtol=1e-5, atol=2e-3)
    # the ends are the path's first and last live waypoints
    np.testing.assert_allclose(coords[:, 0], wps[:, 0], atol=2e-3)
    np.testing.assert_allclose(coords[np.arange(8), -1], wps[np.arange(8), live - 1], atol=2e-2)


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    """agent_s8004's campaign of EPISODES on a straight and a curved
    scenario, written by the port's eval CLI path (the Tests/ schema)."""
    root = tmp_path_factory.mktemp("tests")
    return {scen: evaluate(AGENT, scen, EPISODES, out_root=str(root), gif_root=None,
                           device="cpu")["out_dir"]
            for scen in ("corridor", "S_corridor")}


@pytest.mark.parametrize("scen", ["corridor", "S_corridor"])
def test_replay_campaign_matches_jax(campaigns, scen):
    rep = replay.replay_campaign(campaigns[scen], scen, device="cpu")
    want = jreplay.replay_campaign(campaigns[scen], scen)
    assert len(rep.ape_ref) == EPISODES and rep.n_steps.min() > 0
    np.testing.assert_array_equal(rep.ape_ref, want.ape_ref)
    np.testing.assert_array_equal(rep.n_steps, want.n_steps)
    np.testing.assert_allclose(rep.ape_ours, want.ape_ours, rtol=0, atol=1e-3)
    if scen == "corridor":
        assert rep.abs_err.max() < 0.05, rep.abs_err
    else:
        assert (rep.ape_ours - rep.ape_ref).max() < 0.05


def test_replay_ape_chunks_agree(campaigns, monkeypatch):
    """A batch cut into chunks of 7 positions replays to the same APEs."""
    cfg = scenario_config("corridor").replace(path_table_n=2048)
    geo = scenarios.build_test_scenario(cfg)
    pd = tpath.make_path(torch.tensor(geo.wps)[None], torch.tensor([geo.n_wps]),
                         table_n=2048, margin=cfg.closest_u_margin)
    eps = replay.load_flight_paths(campaigns["corridor"], cfg.screensize_y)
    whole = replay.replay_ape(pd, eps)
    monkeypatch.setattr(replay, "CHUNK", 7)
    np.testing.assert_array_equal(replay.replay_ape(pd, eps), whole)


def test_replay_fminbound_matches_jax(campaigns):
    scen = "S_corridor"
    cfg = scenario_config(scen)
    geo = scenarios.build_test_scenario(cfg)
    eps = [e[:60] for e in replay.load_flight_paths(campaigns[scen], cfg.screensize_y)[:2]]
    jeps = [e[:60] for e in jreplay.load_flight_paths(campaigns[scen], cfg.screensize_y)[:2]]
    for a, b in zip(eps, jeps):
        np.testing.assert_array_equal(a, b)
    got = replay.replay_ape_fminbound(geo.wps[:geo.n_wps], eps)
    want = jreplay.replay_ape_fminbound(geo.wps[:geo.n_wps], jeps)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
