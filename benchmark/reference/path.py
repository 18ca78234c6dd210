# Frozen copy of `drone2d_tpu_torch/ops/path.py` at commit 012002a (the port's plain math);
# imports rewritten to this package, nothing of the port imported.
"""QPMI2D path: quadratic-membership interpolation through waypoints.

Counterpart of `drone2d_tpu/ops/path.py`, batched over envs: every
`PathData` field carries a leading env dimension N, and a query `u` is (N,)
or (N, Q).  The JAX code is written gather-free (one-hot sums) for the TPU;
here the segment coefficients are gathered by index, which gives the same
values: the one-hot weight vector of the JAX `_eval` has at most two
non-zero entries, written below as two (index, weight) pairs.
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-9


@dataclasses.dataclass
class PathData:
    """Per-env path tables, padded beyond n_wps (JAX `PathData` + env dim)."""

    wps: torch.Tensor       # (N, W, 2) waypoints, padded with the last one
    n_wps: torch.Tensor     # (N,) int32 live waypoint count (>= 3)
    us: torch.Tensor        # (N, W) cumulative arc parameter per waypoint
    centers: torch.Tensor   # (N, S) tau-origin of each segment fit, S = W-2
    coef_x: torch.Tensor    # (N, S, 3) centered quadratic [a, b, c]
    coef_y: torch.Tensor    # (N, S, 3)
    length: torch.Tensor    # (N,) total arc parameter, us[n_wps-1]
    table_u: torch.Tensor   # (N, T) sample params over [-margin, L+margin]
    table_x: torch.Tensor   # (N, T) path points at table_u
    table_y: torch.Tensor   # (N, T)


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (N, M), idx (N, Q) integer -> arr[n, idx[n, q]] as (N, Q)."""
    return torch.gather(arr, 1, idx.long())


def cumsum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Cumulative sum accumulated left to right in the tensor's own dtype.

    `jnp.cumsum` adds in that order in float32; `torch.cumsum` accumulates
    float32 in double on the CPU, which rounds differently.  The axes summed
    here are short (waypoint counts), so a loop costs little.
    """
    parts = list(torch.unbind(x, dim))
    for i in range(1, len(parts)):
        parts[i] = parts[i - 1] + parts[i]
    return torch.stack(parts, dim)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """(N,) bounds -> (N, num), in the float32 arithmetic `jnp.linspace`
    uses: start*(1-s) + stop*s with s = i/(num-1), and stop itself last."""
    step = torch.arange(num - 1, dtype=start.dtype, device=start.device) / (num - 1)
    out = start[:, None] * (1 - step) + stop[:, None] * step
    return torch.cat([out, stop[:, None]], dim=1)


def _segment_value(pd: PathData, j: torch.Tensor, u: torch.Tensor, deriv: bool):
    """Segment j's centered quadratic (or its derivative) at u; j, u (N, Q)."""
    tau = u - _take(pd.centers, j)
    jj = j.long()[..., None].expand(-1, -1, 3)
    cx = torch.gather(pd.coef_x, 1, jj)
    cy = torch.gather(pd.coef_y, 1, jj)
    if deriv:
        vx = 2.0 * cx[..., 0] * tau + cx[..., 1]
        vy = 2.0 * cy[..., 0] * tau + cy[..., 1]
    else:
        vx = (cx[..., 0] * tau + cx[..., 1]) * tau + cx[..., 2]
        vy = (cy[..., 0] * tau + cy[..., 1]) * tau + cy[..., 2]
    return vx, vy


def _eval(pd: PathData, u: torch.Tensor, deriv: bool) -> torch.Tensor:
    """Shared body of path_point / path_gradient; u (N, Q) -> (N, Q, 2).

    The reference's membership branches (predef_path.py:114-141), including
    the Python-negative-index wrap for u below the path start (x_params[n-1]
    with n == 0 selects the LAST live segment).
    """
    n_wps = pd.n_wps.long()[:, None]                       # (N, 1)
    S = pd.centers.shape[1]
    W = pd.us.shape[1]
    n_params = n_wps - 2

    us_last = _take(pd.us, n_wps - 1)
    us_second_last = _take(pd.us, n_wps - 2)

    # segment index (predef_path.py:53-63): how many of us[1..n_wps-1] lie
    # strictly below u
    k = torch.arange(1, W, device=u.device)
    hits = (u[..., None] > pd.us[:, None, 1:]) & (k <= n_wps[..., None] - 1)
    n = hits.sum(dim=-1)                                   # (N, Q)

    first = (u >= pd.us[:, 0:1]) & (u <= pd.us[:, 1:2])
    if deriv:
        last = u >= us_second_last
    else:
        last = ((u >= us_second_last - 0.001) & (u <= us_last)) | (n == n_wps - 1)

    j1 = torch.where(n - 1 < 0, n_params - 1, n - 1).clamp(0, S - 1)
    j2 = n.clamp(0, S - 1)
    un = _take(pd.us, n.clamp(0, W - 1))
    un1 = _take(pd.us, (n + 1).clamp(0, W - 1))
    gap = un1 - un
    denom = torch.where(gap.abs() < _EPS, torch.full_like(gap, _EPS), gap)
    mu_r = (u - un) / denom
    mu_f = (un1 - u) / denom
    jl = (n_params - 1).clamp(0, S - 1).expand_as(n)

    # first -> segment 0, last -> segment jl, else mu_r*seg[j2] + mu_f*seg[j1]
    # (one weight mu_r+mu_f where j1 == j2, as the one-hot sum gives)
    edge = first | last
    same = j1 == j2
    ia = torch.where(first, torch.zeros_like(n), torch.where(last, jl, j2))
    one = torch.ones_like(u)
    wa = torch.where(edge, one, torch.where(same, mu_r + mu_f, mu_r))
    wb = torch.where(edge | same, torch.zeros_like(u), mu_f)
    ax, ay = _segment_value(pd, ia, u, deriv)
    bx, by = _segment_value(pd, j1, u, deriv)
    return torch.stack([wa * ax + wb * bx, wa * ay + wb * by], dim=-1)


def _query(pd: PathData, u: torch.Tensor, deriv: bool) -> torch.Tensor:
    if u.dim() == 1:
        return _eval(pd, u[:, None], deriv)[:, 0]
    return _eval(pd, u, deriv)


def path_point(pd: PathData, u: torch.Tensor) -> torch.Tensor:
    """Path position at u (N,) or (N, Q) -> (N, 2) or (N, Q, 2)."""
    return _query(pd, u, deriv=False)


def path_gradient(pd: PathData, u: torch.Tensor) -> torch.Tensor:
    """d(path)/du at u (predef_path.py:145-188)."""
    return _query(pd, u, deriv=True)


def direction_angle(pd: PathData, u: torch.Tensor) -> torch.Tensor:
    """Tangent azimuth atan2(dy, dx) (predef_path.py:216-223)."""
    g = path_gradient(pd, u)
    return torch.atan2(g[..., 1], g[..., 0])


def _lagrange_quad(t0, t1, t2, p0, p1, p2):
    """Quadratic a*t^2 + b*t + c through three points (distinct t)."""
    d0 = (t0 - t1) * (t0 - t2)
    d1 = (t1 - t0) * (t1 - t2)
    d2 = (t2 - t0) * (t2 - t1)
    w0, w1, w2 = p0 / d0, p1 / d1, p2 / d2
    a = w0 + w1 + w2
    b = -(w0 * (t1 + t2) + w1 * (t0 + t2) + w2 * (t0 + t1))
    c = w0 * t1 * t2 + w1 * t0 * t2 + w2 * t0 * t1
    return a, b, c


def make_path(
    wps: torch.Tensor, n_wps: torch.Tensor, *, table_n: int, margin: float = 10.0
) -> PathData:
    """Build PathData from padded waypoints wps (N, W, 2), n_wps (N,) >= 3.

    Entries at index >= n_wps must repeat the last live waypoint.  The fit is
    the reference's quadratic through each waypoint triple, in the
    segment-centered variable tau = u - u_center (float32-safe).
    """
    N, W = wps.shape[:2]
    dev, dt = wps.device, wps.dtype
    n_wps = n_wps.to(torch.int32)
    live = n_wps.long()[:, None]
    idx = torch.arange(W, device=dev)

    diffs = wps[:, 1:] - wps[:, :-1]
    seg_valid = (idx[:-1] < live - 1).to(dt)
    seg_len = torch.sqrt(torch.sum(diffs * diffs, dim=-1)) * seg_valid
    us = torch.cat([torch.zeros((N, 1), dtype=dt, device=dev),
                    cumsum(seg_len, dim=1)], dim=1)
    length = _take(us, live - 1)[:, 0]

    n = torch.arange(1, W - 1, device=dev)
    valid = n <= live - 2
    i0, i1, i2 = n - 1, n, n + 1
    centers = us[:, i1]
    t0 = torch.where(valid, us[:, i0] - centers, torch.full_like(centers, -1.0))
    t1 = torch.zeros_like(centers)
    t2 = torch.where(valid, us[:, i2] - centers, torch.full_like(centers, 1.0))
    ax, bx, cx = _lagrange_quad(t0, t1, t2, wps[:, i0, 0], wps[:, i1, 0], wps[:, i2, 0])
    ay, by, cy = _lagrange_quad(t0, t1, t2, wps[:, i0, 1], wps[:, i1, 1], wps[:, i2, 1])

    empty = torch.zeros((N, table_n), dtype=dt, device=dev)
    pd = PathData(
        wps=wps, n_wps=n_wps, us=us, centers=centers,
        coef_x=torch.stack([ax, bx, cx], dim=-1),
        coef_y=torch.stack([ay, by, cy], dim=-1),
        length=length, table_u=empty, table_x=empty, table_y=empty,
    )
    # dense sample table over fminbound's interval [-margin, L+margin]
    t = _linspace(torch.zeros(1, dtype=dt, device=dev),
                  torch.ones(1, dtype=dt, device=dev), table_n)
    table_u = -margin + t * (length[:, None] + 2 * margin)
    xy = path_point(pd, table_u)
    return dataclasses.replace(pd, table_u=table_u, table_x=xy[..., 0], table_y=xy[..., 1])


def closest_u(
    pd: PathData, position: torch.Tensor, *, golden_iters: int = 0, fine_points: int = 0
) -> torch.Tensor:
    """argmin_u |path(u) - position| over [-margin, L+margin]; (N, 2) -> (N,).

    A table argmin (first index on ties, as `jnp.argmin`), then one of three
    refinements: a parabola through the bracketing table samples
    (fine_points=0), a rescan of the bracket with `fine_points` path
    evaluations plus a parabola, or `golden_iters` golden-section steps.
    """
    dx = pd.table_x - position[:, 0:1]
    dy = pd.table_y - position[:, 1:2]
    dist2 = dx * dx + dy * dy
    T = pd.table_u.shape[1]
    i0 = torch.argmin(dist2, dim=1, keepdim=True)
    im = (i0 - 1).clamp(min=0)
    ip = (i0 + 1).clamp(max=T - 1)
    u0 = _take(pd.table_u, i0)[:, 0]
    lo, hi = pd.table_u[:, 0], pd.table_u[:, -1]
    du = (hi - lo) / (T - 1)

    def f(u):
        p = path_point(pd, u) - (position if u.dim() == 1 else position[:, None])
        return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]

    if golden_iters <= 0 and fine_points <= 0:
        fa, f0, fb = (_take(dist2, i)[:, 0] for i in (im, i0, ip))
        denom = fa - 2.0 * f0 + fb
        offset = torch.where(denom.abs() < _EPS, torch.zeros_like(denom),
                             0.5 * du * (fa - fb) / denom)
        u_star = u0 + torch.clamp(offset, -du, du)
        at_edge = ((i0 == 0) | (i0 == T - 1))[:, 0]
        u_star = torch.where(at_edge, u0, u_star)
        return torch.clamp(u_star, lo, hi)

    if golden_iters <= 0:
        R = fine_points
        fine_u = u0[:, None] + _linspace(-du, du, R)
        fine_f = f(fine_u)
        j = torch.argmin(fine_f, dim=1, keepdim=True).clamp(1, R - 2)
        fa2, f02, fb2 = (_take(fine_f, i)[:, 0] for i in (j - 1, j, j + 1))
        h = 2.0 * du / (R - 1)
        denom = fa2 - 2.0 * f02 + fb2
        offset = torch.where(denom.abs() < _EPS, torch.zeros_like(denom),
                             0.5 * h * (fa2 - fb2) / denom)
        u_star = _take(fine_u, j)[:, 0] + torch.clamp(offset, -h, h)
        return torch.clamp(u_star, lo, hi)

    invphi = 0.6180339887498949   # 1/phi
    invphi2 = 0.3819660112501051  # 1/phi^2
    a, b = _take(pd.table_u, im)[:, 0], _take(pd.table_u, ip)[:, 0]
    c = a + invphi2 * (b - a)
    d = a + invphi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(golden_iters):
        left = fc < fd
        a2 = torch.where(left, a, c)
        b2 = torch.where(left, d, b)
        c2 = torch.where(left, a2 + invphi2 * (b2 - a2), d)
        d2 = torch.where(left, c, a2 + invphi * (b2 - a2))
        f_new = f(torch.where(left, c2, d2))
        fc, fd = torch.where(left, f_new, fd), torch.where(left, fc, f_new)
        a, b, c, d = a2, b2, c2, d2
    return 0.5 * (a + b)


def lookahead_u(pd: PathData, u: torch.Tensor, lookahead_distance) -> torch.Tensor:
    """Lookahead parameter min(u + distance, L) (predef_path.py:257-266)."""
    return torch.minimum(u + lookahead_distance, pd.length)


def lookahead_point_from_u(pd: PathData, u: torch.Tensor, lookahead_distance) -> torch.Tensor:
    """Lookahead point given an already-computed closest u."""
    return path_point(pd, lookahead_u(pd, u, lookahead_distance))


def closest_position(pd: PathData, position: torch.Tensor, *, golden_iters: int) -> torch.Tensor:
    """Closest point on the path to position (N, 2) -> (N, 2), by
    `golden_iters` golden-section steps (reference get_closest_position,
    predef_path.py:251-255)."""
    return path_point(pd, closest_u(pd, position, golden_iters=golden_iters))


def path_coords(pd: PathData, n: int = 100) -> torch.Tensor:
    """n evenly spaced points over [0, L] of each path -> (N, n, 2)
    (reference get_path_coord, predef_path.py:297-304), a host-side
    rendering helper."""
    zero = torch.zeros(1, dtype=pd.length.dtype, device=pd.length.device)
    return path_point(pd, _linspace(zero, zero + 1, n) * pd.length[:, None])
