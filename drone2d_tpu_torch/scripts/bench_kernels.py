"""Micro-benchmark: the batched closest-point table scan on the card; the
port's counterpart of `scripts/bench_kernels.py`.

    python -m drone2d_tpu_torch.scripts.bench_kernels [B] [TABLE_N] [--device cpu]

Times, in plain torch ops, the math of `ops/path.closest_u`'s table refine
(fine_points=0) over synthetic structure-of-arrays tables: a squared-distance
argmin over TABLE_N points an env, then a parabolic refine between the
argmin's neighbours.  The JAX package's hand-written Pallas kernel for this
op was retired in round 2 (it lost to XLA's fused reduce twice), so this is
the plain path, kept so that regressions are visible.  Runs on the CUDA card
unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from drone2d_tpu_torch.device import resolve_device

_EPS = 1e-9


def tables(B: int, T: int, device) -> tuple:
    """(table_x, table_y (B, T), table_u0, du (B,), pos (B, 2)), synthetic,
    from numpy's generator at seed 0."""
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return (f32(rng.uniform(0, 1300, (B, T))), f32(rng.uniform(0, 1300, (B, T))),
            torch.full((B,), -10.0, device=device), torch.full((B,), 2.2, device=device),
            f32(rng.uniform(0, 1300, (B, 2))))


def closest(table_x, table_y, table_u0, du, pos):
    """The refined closest path parameter u of each env's position."""
    T = table_x.shape[1]
    dx = table_x - pos[:, 0:1]
    dy = table_y - pos[:, 1:2]
    d2 = dx * dx + dy * dy
    idx = torch.argmin(d2, dim=1)
    onehot = torch.arange(T, device=d2.device)[None, :] == idx[:, None]

    def pick(a):
        return torch.sum(torch.where(onehot, a, 0.0), dim=1)

    f0 = pick(d2)
    fa = pick(torch.cat([d2[:, :1], d2[:, :-1]], dim=1))
    fb = pick(torch.cat([d2[:, 1:], d2[:, -1:]], dim=1))
    denom = fa - 2.0 * f0 + fb
    off = torch.where(denom.abs() < _EPS, 0.0, 0.5 * du * (fa - fb) / denom)
    off = torch.minimum(torch.maximum(off, -du), du)
    u0 = table_u0 + idx.to(torch.float32) * du
    boundary = (idx == 0) | (idx == T - 1)
    return torch.where(boundary, u0, u0 + off)


def time_closest(B: int = 4096, T: int = 512, iters: int = 200, device=None) -> float:
    """Seconds a call, over `iters` calls after a warm-up one, synchronized."""
    dev = resolve_device(device)
    args = tables(B, T, dev)
    float(closest(*args)[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        out = closest(*args)
    float(out[0])
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("B", nargs="?", type=int, default=4096)
    p.add_argument("T", nargs="?", type=int, default=512)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to run; the default is the CUDA card, and the run fails "
                   "without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dt = time_closest(args.B, args.T, device=args.device)
    print(f"torch closest-point: {dt*1e6:8.1f} us/call  ({args.B} envs x {args.T} table)")
    return dt


if __name__ == "__main__":
    main()
