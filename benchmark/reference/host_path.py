# Frozen copy of `drone2d_tpu_torch/utils/host_path.py` at commit 012002a (the port's plain math);
# imports rewritten to this package, nothing of the port imported.
"""Host-side (numpy, float64) QPMI path evaluation.

The port's own copy of `drone2d_tpu/utils/host_path.py`, used to build the
deterministic test scenarios (`env/scenarios.py`).  Semantics identical to
the device path (`ops/path.py`, and thus to reference predef_path.py
QPMI2D); coefficients are segment-centered Lagrange fits of the same
quadratics.
"""

from __future__ import annotations

import numpy as np


class HostQPMI:
    def __init__(self, wps: np.ndarray):
        wps = np.asarray(wps, dtype=np.float64)
        if wps.ndim != 2 or wps.shape[0] < 3:
            raise ValueError("need at least 3 waypoints")
        self.wps = wps
        seg = np.linalg.norm(np.diff(wps, axis=0), axis=1)
        self.us = np.concatenate([[0.0], np.cumsum(seg)])
        self.length = float(self.us[-1])

        # centered quadratic through consecutive waypoint triples
        n = np.arange(1, len(wps) - 1)
        self.centers = self.us[n]
        t0 = self.us[n - 1] - self.centers
        t2 = self.us[n + 1] - self.centers
        self.coef_x = self._fit(t0, t2, wps[n - 1, 0], wps[n, 0], wps[n + 1, 0])
        self.coef_y = self._fit(t0, t2, wps[n - 1, 1], wps[n, 1], wps[n + 1, 1])

    @staticmethod
    def _fit(t0, t2, p0, p1, p2):
        # Lagrange quadratic through (t0,p0), (0,p1), (t2,p2)
        w0 = p0 / (t0 * (t0 - t2))
        w1 = p1 / (t0 * t2)
        w2 = p2 / (t2 * (t2 - t0))
        a = w0 + w1 + w2
        b = -(w0 * t2 + w1 * (t0 + t2) + w2 * t0)
        c = np.broadcast_to(p1, np.shape(a)).astype(np.float64)
        return np.stack([a, b, c], axis=-1)

    def _poly(self, coef, j, u):
        tau = u - self.centers[j]
        a, b, c = coef[j]
        return (a * tau + b) * tau + c

    def _dpoly(self, coef, j, u):
        tau = u - self.centers[j]
        a, b, _ = coef[j]
        return 2 * a * tau + b

    def _idx(self, u: float) -> int:
        return int(np.sum(u > self.us[1:]))

    def point(self, u: float) -> np.ndarray:
        us = self.us
        n = self._idx(u)
        if us[0] <= u <= us[1]:
            j = 0
        elif (us[-2] - 0.001 <= u <= us[-1]) or n == len(us) - 1:
            j = len(self.centers) - 1
        else:
            mu_r = (u - us[n]) / (us[n + 1] - us[n])
            mu_f = (us[n + 1] - u) / (us[n + 1] - us[n])
            j1 = (n - 1) % len(self.centers)  # reference's negative-index wrap
            return np.array(
                [
                    mu_r * self._poly(self.coef_x, n, u) + mu_f * self._poly(self.coef_x, j1, u),
                    mu_r * self._poly(self.coef_y, n, u) + mu_f * self._poly(self.coef_y, j1, u),
                ]
            )
        return np.array([self._poly(self.coef_x, j, u), self._poly(self.coef_y, j, u)])

    def gradient(self, u: float) -> np.ndarray:
        us = self.us
        if us[0] <= u <= us[1]:
            j = 0
        elif u >= us[-2]:
            j = len(self.centers) - 1
        else:
            n = self._idx(u)
            mu_r = (u - us[n]) / (us[n + 1] - us[n])
            mu_f = (us[n + 1] - u) / (us[n + 1] - us[n])
            j1 = (n - 1) % len(self.centers)
            return np.array(
                [
                    mu_r * self._dpoly(self.coef_x, n, u) + mu_f * self._dpoly(self.coef_x, j1, u),
                    mu_r * self._dpoly(self.coef_y, n, u) + mu_f * self._dpoly(self.coef_y, j1, u),
                ]
            )
        return np.array([self._dpoly(self.coef_x, j, u), self._dpoly(self.coef_y, j, u)])

    def direction_angle(self, u: float) -> float:
        g = self.gradient(u)
        return float(np.arctan2(g[1], g[0]))

    def coords(self, n: int = 100) -> np.ndarray:
        return np.stack([self.point(u) for u in np.linspace(0, self.length, n)])
