"""Evaluation artifacts in the reference `Tests/` schema.

Counterpart of `drone2d_tpu/eval/artifacts.py`.  Writes what `main.py:287-327`
writes per campaign:
  Tests/<agent>/test_<k>/<scenario>/
    flight_paths                      (JSON list of [(x, h-y), ...])
    collisions.npy rewards.npy apes.npy time_spent.npy
    <scenario>_<nr>_results.txt       (Successes/Fails/.../Agent path lines)
  Tests/<agent>/test_<k>/plots/<scenario>_<nr>.png   (overlay plot)
  Gifs/<agent>/<scenario>.gif
with the same test_<k> bumping rule: a new test_<k> directory is started
when the current latest one already contains this scenario.  The plot and
the GIF are drawn for spatial (test-mode) scenarios only, by the pygame
renderer (`eval/render.py`), which is imported there and nowhere else: a
stage scenario needs no pygame.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.eval.episode import EpisodeResults


def _campaign_dirs(root: str, agent: str, scenario: str):
    """test_<k> selection (main.py:297-302): reuse the latest test dir unless
    it already holds this scenario; else start the next index."""
    agent_dir = os.path.join(root, agent)
    os.makedirs(agent_dir, exist_ok=True)
    existing = sorted(
        int(d.split("_")[1]) for d in os.listdir(agent_dir)
        if d.startswith("test_") and d.split("_")[1].isdigit()
    )
    k = existing[-1] if existing else 0
    if existing and scenario in os.listdir(os.path.join(agent_dir, f"test_{k}")):
        k += 1
    base = os.path.join(agent_dir, f"test_{k}")
    file_path = os.path.join(base, scenario)
    plot_path = os.path.join(base, "plots")
    os.makedirs(file_path, exist_ok=True)
    os.makedirs(plot_path, exist_ok=True)
    return file_path, plot_path


def write_campaign(
    cfg: EnvConfig,
    results: EpisodeResults,
    *,
    agent: str,
    agent_path: str,
    scenario: Optional[str] = None,
    root: str = "Tests",
    gif_root: Optional[str] = "Gifs",
    gif_episode: int = 0,
    gif_all_episodes: bool = False,
) -> str:
    """Persist one campaign's artifacts; returns the scenario directory.
    A spatial scenario also gets the overlay plot and, unless `gif_root` is
    None, the GIF of episode `gif_episode` (or of every episode, with
    `gif_all_episodes`)."""
    scenario = scenario or cfg.scenario
    file_path, plot_path = _campaign_dirs(root, agent, scenario)

    successes = int(np.sum(results.success))
    fails = int(np.sum(results.fail))
    collision_sum = int(np.sum(results.collision))
    n = max(successes + fails, 1)

    flight_paths = results.flight_paths(cfg.screensize_y)
    with open(os.path.join(file_path, "flight_paths"), "w") as f:
        json.dump(flight_paths, f)

    np.save(os.path.join(file_path, "collisions.npy"), results.collision)
    np.save(os.path.join(file_path, "rewards.npy"), results.total_reward)
    np.save(os.path.join(file_path, "apes.npy"), results.ape)
    np.save(os.path.join(file_path, "time_spent.npy"), results.time_steps)

    # reference files are <scenario>_<nr>_results.txt for agent_<nr> names
    # (main.py:319-327); other agent names ('new_agent') keep the full name
    agent_nr = agent[6:] if agent.startswith("agent_") and len(agent) > 6 else agent
    results_txt = os.path.join(file_path, f"{scenario}_{agent_nr}_results.txt")
    with open(results_txt, "w") as f:
        f.write(f"Successes: {successes}\n")
        f.write(f"Fails: {fails}\n")
        f.write(f"Collisions: {collision_sum}\n")
        f.write(f"Success rate: {successes / n}\n")
        f.write(f"Collision rate: {collision_sum / n}\n")
        f.write(f"Average APE: {np.mean(results.ape)}\n")
        f.write(f"Average flight time: {np.mean(results.time_steps.astype(np.float64))}\n")
        f.write(f"Agent path: {agent_path}\n")

    # the plot only for spatial scenarios: a stage_k campaign flies a random
    # geometry per episode, and the reference draws nothing there
    # (main.py:355-356)
    if cfg.mode == "test":
        from drone2d_tpu_torch.eval.render import campaign_gif, episode_gif, overlay_plot

        overlay_plot(cfg, flight_paths, results.total_reward, results.collision,
                     os.path.join(plot_path, f"{scenario}_{agent_nr}.png"))
        if gif_root is not None and len(results.traj):
            gif_path = os.path.join(gif_root, agent, f"{scenario}.gif")
            if gif_all_episodes:
                # the reference's way: one GIF over the whole campaign
                # (main.py:259-295 gathers the frames of every episode)
                campaign_gif(cfg, results.traj, results.angles, results.traj_len, gif_path)
            else:
                i = gif_episode
                episode_gif(cfg, results.traj[i], results.angles[i], int(results.traj_len[i]),
                            gif_path)
    return file_path
