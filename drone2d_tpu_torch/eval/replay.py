"""Replay recorded flight paths through the path kernel.

Counterpart of `drone2d_tpu/eval/replay.py`.  A campaign directory in the
reference's `Tests/` schema holds, per episode, the drone position at every
step as `(x, screen_height - y)` pairs (`flight_paths`, written by
`eval/artifacts.py`) next to `apes.npy`, where `APE = path_error / t`
accumulates the per-step distance to the closest path point
(`drone_2d_env.py:529,589-590`).  Feeding those positions back through
`ops.path.closest_position` must reproduce each episode's APE, with no
simulation in the loop.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, NamedTuple

import numpy as np
import torch

from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.ops import path as tpath

# positions replayed a batch: the table argmin holds CHUNK x path_table_n
# distances (64 MB at the default 2048-entry table)
CHUNK = 8192


class ReplayReport(NamedTuple):
    ape_ref: np.ndarray    # (N,) the campaign's apes.npy
    ape_ours: np.ndarray   # (N,) replayed through the kernel
    n_steps: np.ndarray    # (N,) episode lengths

    @property
    def abs_err(self) -> np.ndarray:
        return np.abs(self.ape_ours - self.ape_ref)


def load_flight_paths(res_dir: str, screen_h: float) -> List[np.ndarray]:
    """A campaign's flight_paths JSON -> list of (n_i, 2) WORLD positions."""
    with open(os.path.join(res_dir, "flight_paths")) as f:
        raw = json.load(f)
    out = []
    for ep in raw:
        a = np.asarray(ep, dtype=np.float64)
        a[:, 1] = screen_h - a[:, 1]  # undo the screen-coordinate flip
        out.append(a)
    return out


def replay_ape(pd: tpath.PathData, episodes: List[np.ndarray], *,
               golden_iters: int = 24) -> np.ndarray:
    """Per-episode mean distance to the path `pd` (one path, N = 1) over
    the recorded positions.

    Every episode's positions go through the kernel as one float32 batch on
    the path's device (in chunks of CHUNK rows, each against a stride-0
    view of the one path); the per-episode means are a segment reduction on
    the host, in float64."""
    lens = np.array([len(e) for e in episodes])
    dev = pd.length.device
    flat = torch.as_tensor(np.concatenate(episodes, axis=0).astype(np.float32), device=dev)
    d = []
    for start in range(0, flat.shape[0], CHUNK):
        p = flat[start:start + CHUNK]
        view = tpath.PathData(**{f.name: getattr(pd, f.name).expand(
            p.shape[0], *getattr(pd, f.name).shape[1:]) for f in dataclasses.fields(pd)})
        cp = tpath.closest_position(view, p, golden_iters=golden_iters)
        d.append(torch.sqrt(torch.sum((cp - p) ** 2, dim=-1)))
    d = torch.cat(d).cpu().numpy().astype(np.float64)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    return np.array([d[bounds[i]:bounds[i + 1]].mean() for i in range(len(lens))])


def replay_ape_fminbound(wps: np.ndarray, episodes: List[np.ndarray]) -> np.ndarray:
    """Per-episode APE replay with the reference's own optimizer:
    scipy.optimize.fminbound (xtol=1e-6, maxfun=500, the whole [-10, L+10]
    interval, predef_path.py:242-248) minimizing the distance to the host
    float64 path evaluation (`utils.host_path.HostQPMI`).

    On curved paths the distance is multimodal and fminbound stops at a
    probe-dependent local minimum; this replay holds the optimizer equal so
    that only the path evaluation is compared (`replay_ape` finds the
    global minimum)."""
    from scipy.optimize import fminbound

    from drone2d_tpu_torch.utils.host_path import HostQPMI

    host = HostQPMI(np.asarray(wps, np.float64))
    L = host.us[-1]

    def dist_fn(pos):
        return lambda u: float(np.linalg.norm(host.point(u) - pos))

    out = []
    for ep in episodes:
        d = np.empty(len(ep))
        for i, pos in enumerate(ep):
            u = fminbound(dist_fn(pos), x1=-10.0, x2=L + 10.0, xtol=1e-6, maxfun=500)
            d[i] = np.linalg.norm(host.point(u) - pos)
        out.append(d.mean())
    return np.array(out)


def replay_campaign(res_dir: str, scenario: str, *, golden_iters: int = 24,
                    table_n: int = 2048, device=None) -> ReplayReport:
    """Replay one campaign directory of spatial `scenario` against the
    kernel, on the card unless device="cpu"."""
    from drone2d_tpu_torch.env import scenarios
    from drone2d_tpu_torch.eval.run import scenario_config

    dev = resolve_device(device)
    cfg = scenario_config(scenario).replace(path_table_n=table_n)
    geo = scenarios.build_test_scenario(cfg)
    pd = tpath.make_path(torch.tensor(geo.wps, device=dev)[None],
                         torch.tensor([geo.n_wps], dtype=torch.int32, device=dev),
                         table_n=cfg.path_table_n, margin=cfg.closest_u_margin)
    episodes = load_flight_paths(res_dir, cfg.screensize_y)
    ape_ref = np.load(os.path.join(res_dir, "apes.npy"))
    if len(episodes) != len(ape_ref):
        raise ValueError(f"{res_dir}: {len(episodes)} flight paths, {len(ape_ref)} APEs")
    return ReplayReport(
        ape_ref=np.asarray(ape_ref, np.float64),
        ape_ours=replay_ape(pd, episodes, golden_iters=golden_iters),
        n_steps=np.array([len(e) for e in episodes]),
    )
