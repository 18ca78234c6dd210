"""The port's renderer (`eval/render.py`) against the JAX package's, on the
CPU: the overlay PNG pixel for pixel on the same flight paths, the scene
of every spatial scenario, the box obstacles drawn as boxes, and the
episode and campaign GIFs with as many frames."""

import imageio.v2 as imageio
import numpy as np
import pytest

from drone2d_tpu.config import EnvConfig as JEnvConfig
from drone2d_tpu.eval import render as jrender
from drone2d_tpu_torch.config import EXTRA_SCENARIOS, TEST_SCENARIOS, EnvConfig
from drone2d_tpu_torch.eval import render


def _cfgs(scen):
    cfg = EnvConfig(mode="test", scenario=scen)
    return cfg, JEnvConfig(**{k: getattr(cfg, k) for k in JEnvConfig.__dataclass_fields__})


def _paths(seed, n=6, t=40):
    """n flight paths in screen coordinates, their returns and collisions."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(100, 1200, (n, 1, 2))
    paths = start + np.cumsum(rng.normal(0, 8, (n, t, 2)), axis=1)
    return ([[(float(x), float(y)) for x, y in p] for p in paths],
            rng.normal(0, 50, n).astype(np.float32), rng.integers(0, 2, n).astype(np.int32))


@pytest.mark.parametrize("scen", TEST_SCENARIOS + EXTRA_SCENARIOS)
def test_overlay_plot_matches_jax(scen, tmp_path):
    cfg, jcfg = _cfgs(scen)
    paths, rewards, collisions = _paths(len(scen))
    render.overlay_plot(cfg, paths, rewards, collisions, str(tmp_path / "port.png"))
    jrender.overlay_plot(jcfg, paths, rewards, collisions, str(tmp_path / "jax.png"))
    got, want = imageio.imread(tmp_path / "port.png"), imageio.imread(tmp_path / "jax.png")
    assert got.shape == (1300, 1300, 3)
    np.testing.assert_array_equal(got, want)


def test_boxes_draw_as_boxes():
    """parallel_boxes' squares fill their corners, where the circle of the
    parallel scenario (same centers, radius = half-side) leaves background."""
    frames = {}
    for scen in ("parallel_boxes", "parallel"):
        r = render.SceneRenderer(_cfgs(scen)[0])
        r.draw_scene()
        frames[scen] = r.frame()
    g = render.scen_mod.build_test_scenario(_cfgs("parallel_boxes")[0])
    x, y = g.obs_xy[0]
    col, row = int(x + 27), int(1300 - (y + 27))  # 27 px along both axes from the center
    assert tuple(frames["parallel_boxes"][row, col]) == render.OBSTACLE_COLOR
    assert tuple(frames["parallel"][row, col]) == render.BG


def test_gifs_match_jax(tmp_path):
    """An episode's GIF and a campaign's GIF: as many frames as JAX's (every
    2nd step of each episode's live length), and the same first frame."""
    cfg, jcfg = _cfgs("corridor")
    rng = np.random.default_rng(0)
    traj = rng.uniform(200, 1100, (3, 9, 2)).astype(np.float32)
    angles = rng.uniform(-1, 1, (3, 9)).astype(np.float32)
    lens = np.array([9, 4, 7], np.int32)
    for mod, tag, c in ((render, "port", cfg), (jrender, "jax", jcfg)):
        mod.episode_gif(c, traj[0], angles[0], int(lens[0]), str(tmp_path / f"ep_{tag}.gif"))
        mod.campaign_gif(c, traj, angles, lens, str(tmp_path / f"all_{tag}.gif"))
    for name, frames in (("ep", 5), ("all", 5 + 2 + 4)):
        got = imageio.mimread(tmp_path / f"{name}_port.gif")
        want = imageio.mimread(tmp_path / f"{name}_jax.gif")
        assert len(got) == len(want) == frames
        np.testing.assert_array_equal(got[0], want[0])


def test_scene_and_drone_match_jax():
    """The scene with a drone, a flight trail and the diagnostics layers,
    drawn by both renderers from the same values, pixel for pixel."""
    cfg, jcfg = _cfgs("S_corridor")
    out = []
    for mod, c in ((render, cfg), (jrender, jcfg)):
        r = mod.SceneRenderer(c)
        r.draw_scene()
        r.draw_spawn_rect((50.0, 150.0, 200.0, 400.0))
        r.draw_flight_path([(100.0, 900.0), (150.0, 880.0), (210.0, 870.0)], (16, 19, 97))
        r.draw_drone((400.0, 650.0), 0.3)
        r.maybe_add_shade((380.0, 640.0), 0.2, 10.0)
        r.draw_shades()
        out.append(r.frame())
    np.testing.assert_array_equal(out[0], out[1])
