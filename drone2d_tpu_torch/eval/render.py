"""Host-side replay rendering: scenario scenes, flight-path overlays, GIFs.

A copy of `drone2d_tpu/eval/render.py` over the port's config, scenarios
and host path.  The reference renders live inside the env (pygame window,
drone_2d_env.py:775-906) and grabs frames during evaluation
(main.py:267-270); here rendering never touches the device: episodes come
back as trajectory arrays and are replayed on headless pygame surfaces.

Replicates the flight-path overlay plot with its red-blue reward gradient
and colorbar (main.py:329-400, red_blue_grad at main.py:18-29), the episode
GIF (main.py:293-295: every 2nd frame at 30 fps) and the scene (path
polyline, waypoint dots, obstacle circles and boxes, drone boxes).  Needs
pygame, and imageio for the GIFs; the rest of the port imports this module
only where it draws.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")  # headless
import pygame  # noqa: E402

from drone2d_tpu_torch.config import EnvConfig  # noqa: E402
from drone2d_tpu_torch.env import scenarios as scen_mod  # noqa: E402

BG = (243, 243, 243)
PATH_COLOR = (0, 0, 0)
OBSTACLE_COLOR = (67, 81, 116)  # pymunk debug-draw default-ish shape color
FRAME_COLOR = (66, 135, 245)
MOTOR_COLOR = (33, 33, 33)
LOOKAHEAD_COLOR = (0, 150, 150)
CLOSEST_PT_COLOR = (0, 0, 255)
TARGET_COLOR = (255, 0, 0)
DANGER_RED = (255, 0, 0)
SAFE_GREEN = (0, 255, 0)
WARN_ORANGE = (255, 165, 0)
SHADE_RGBA = (90, 90, 110, 70)


def red_blue_grad(x: float) -> Tuple[float, float, float]:
    """0 -> red, 1 -> blue (reference main.py:18-29)."""
    if x < 0.5:
        return (255, 0, 255 * x * 2)
    return (255 * (1 - x) * 2, 0, 255)


def _flip(y: float, h: float) -> float:
    return h - y  # pygame y grows downward; world y grows up


class SceneRenderer:
    """Draws one scenario's static scene + dynamic drone/trajectory layers."""

    def __init__(self, cfg: EnvConfig):
        self.cfg = cfg
        self.w = int(cfg.screensize_x)
        self.h = int(cfg.screensize_y)
        pygame.init()
        self.surface = pygame.Surface((self.w, self.h))
        self.geometry = None
        self._scene_coords = None  # cached static-path polyline (test mode)
        if cfg.mode == "test":
            self.geometry = scen_mod.build_test_scenario(cfg)

    # -- static scene --------------------------------------------------------

    def draw_scene(
        self,
        path_coords: Optional[np.ndarray] = None,
        obstacles: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    ) -> None:
        """Fill background, draw path + endpoint dots + obstacles.

        Defaults to the constructed test-scenario geometry; curriculum
        replays pass explicit per-episode (path_coords, obstacles)."""
        s, h = self.surface, float(self.h)
        s.fill(BG)

        if path_coords is None and self.geometry is not None:
            if self._scene_coords is None:
                # the test-scenario path is static: fit + sample it once, not
                # per frame (episode_gif/live render call draw_scene per frame)
                from drone2d_tpu_torch.utils.host_path import HostQPMI

                host = HostQPMI(self.geometry.wps[: self.geometry.n_wps])
                self._scene_coords = host.coords(100)
            path_coords = self._scene_coords
        if path_coords is not None and len(path_coords) > 1:
            pts = [(float(x), _flip(float(y), h)) for x, y in path_coords]
            pygame.draw.circle(s, PATH_COLOR, pts[0], 5)
            pygame.draw.circle(s, PATH_COLOR, pts[-1], 5)
            pygame.draw.aalines(s, PATH_COLOR, False, pts)

        if obstacles is None and self.geometry is not None:
            g = self.geometry
            obstacles = (g.obs_xy, g.obs_r, g.obs_mask, g.obs_half_wh)
        if obstacles is not None:
            xy, r, mask = obstacles[:3]
            half_wh = obstacles[3] if len(obstacles) > 3 else None
            for i in range(len(r)):
                if not mask[i]:
                    continue
                cx, cy = float(xy[i, 0]), _flip(float(xy[i, 1]), h)
                if half_wh is not None and (half_wh[i] > 0).any():
                    hw, hh = float(half_wh[i][0]), float(half_wh[i][1])
                    pygame.draw.rect(
                        s, OBSTACLE_COLOR,
                        pygame.Rect(cx - hw, cy - hh, 2 * hw, 2 * hh),
                    )
                else:
                    pygame.draw.circle(s, OBSTACLE_COLOR, (cx, cy), float(r[i]))

    # -- dynamic layers ------------------------------------------------------

    def draw_drone(self, pos, angle: float) -> None:
        """Drone as its 3-box composite (frame 100x10 + two 20x20 motors,
        Drone.py geometry) at a world pose."""
        cfg, s, h = self.cfg, self.surface, float(self.h)
        c, sn = np.cos(angle), np.sin(angle)
        R = np.array([[c, -sn], [sn, c]])

        def poly(local_corners):
            world = (R @ np.asarray(local_corners).T).T + np.asarray(pos)
            return [(float(x), _flip(float(y), h)) for x, y in world]

        hw, hh = cfg.drone_width / 2, cfg.drone_height / 4
        pygame.draw.polygon(
            s, FRAME_COLOR, poly([(-hw, -hh), (-hw, hh), (hw, hh), (hw, -hh)])
        )
        m = cfg.drone_height / 2
        for side in (-cfg.drone_radius, cfg.drone_radius):
            pygame.draw.polygon(
                s, MOTOR_COLOR,
                poly([(side - m, -m), (side - m, m), (side + m, m), (side + m, -m)]),
            )

    def draw_flight_path(self, path: Sequence[Tuple[float, float]], color) -> None:
        """path is already in screen coords (reference flight_path format)."""
        if len(path) > 2:
            pygame.draw.aalines(self.surface, color, False, list(path), 1)

    # -- live diagnostics (reference drone_2d_env.py:788-894) ----------------

    def draw_spawn_rect(self, rect) -> None:
        """Test-mode spawn rectangle outline (drone_2d_env.py:832-834).
        `rect` is world-coords (xmin, ymin, xmax, ymax)."""
        xmin, ymin, xmax, ymax = (float(v) for v in rect)
        pygame.draw.rect(
            self.surface, PATH_COLOR,
            pygame.Rect(xmin, _flip(ymax, self.h), xmax - xmin, ymax - ymin), 2,
        )

    def draw_reward_text(self, info: dict) -> None:
        """Per-step reward components as a top-left text column
        (drone_2d_env.py:788-819; gated by render_text there and here)."""
        font = getattr(self, "_text_font", None)
        if font is None:
            # SysFont does font-path matching per call; cache it — the live
            # viewer calls this at up to 60 fps
            font = self._text_font = pygame.font.SysFont("freesansbold", 22)
        lines = [
            (f"Total reward: {float(info['reward']):.2f}", (0, 0, 0)),
            (f"Collision avoidance: {float(info['collision_avoidance_reward']):.2f}", (0, 0, 0)),
            (f"Path adherence: {float(info['path_adherence']):.2f}", (0, 0, 0)),
            (f"Path progression: {float(info['path_progression']):.2f}", (0, 0, 0)),
            (f"Aggressive alpha: {float(info['agressive_alpha_reward']):.2f}", (0, 0, 0)),
        ]
        d_obs = float(info.get("dist_closest_obs", np.inf))
        if np.isfinite(d_obs):
            lines.append((f"Closest obs dist: {d_obs:.2f}", (150, 0, 0)))
        for i, (txt, color) in enumerate(lines):
            y = i * 16 + (10 if i == 5 else 0)  # obs-dist line offset, as ref
            self.surface.blit(font.render(txt, True, color, BG), (0, y))

    def draw_diagnostics(self, state, obs, cfg: Optional[EnvConfig] = None) -> None:
        """Velocity / lookahead / nearest-obstacle vectors with the CA-state
        color logic, closest-point + target dots, angle arcs, and motor-force
        bars (drone_2d_env.py:838-894, color flags :496-523).

        Everything is reconstructed host-side from the EnvState + the 27-D
        observation — the same round-trip the reference's reward code does
        (step :422-455), so the colors flip exactly when the CA reward fires.
        """
        # invm1to1 is plain arithmetic — works on host numpy scalars too
        from drone2d_tpu_torch.ops.transforms import invm1to1 as _inv

        cfg = cfg or self.cfg
        s, h = self.surface, float(self.h)
        w_scr = cfg.screensize_x
        obs = np.asarray(obs, np.float64)
        pos = np.asarray(state.body.pos, np.float64)
        vel = np.asarray(state.body.vel, np.float64)
        alpha = float(np.asarray(state.body.angle))
        target = np.asarray(state.target, np.float64)
        two_pi = 2 * np.pi

        def spt(p):  # world -> screen point
            return (float(p[0]), _flip(float(p[1]), h))

        def arc(radius, color, a0, a1, width=3):
            # the reference passes world angles straight to pygame.draw.arc
            # around the drone (:841,:858-868); same convention kept
            rect = pygame.Rect(0, 0, 2 * radius, 2 * radius)
            rect.center = spt(pos)
            try:
                pygame.draw.arc(s, color, rect, a0, a1, width)
            except ValueError:
                pass  # degenerate angle span

        # angle round-trips exactly as the reward path (:433-445)
        vel_angle = (np.arctan2(obs[17], obs[18]) + two_pi) % two_pi
        la_angle = (np.arctan2(obs[23], obs[24]) + two_pi) % two_pi
        cp = np.array([_inv(obs[19], 0.0, w_scr), _inv(obs[20], 0.0, cfg.screensize_y)])
        la = np.array([_inv(obs[21], 0.0, w_scr), _inv(obs[22], 0.0, cfg.screensize_y)])

        # nearest obstacle + CA state (:469-523)
        oxy = np.asarray(state.obstacles.xy, np.float64)
        orad = np.asarray(state.obstacles.r, np.float64)
        omask = np.asarray(state.obstacles.mask, bool)
        has_obs = bool(omask.any())
        d_obs = _inv(obs[8], 0.0, cfg.screen_diag)
        obs_angle = (np.arctan2(obs[9], obs[10]) + two_pi) % two_pi
        angle_diff = abs(
            np.rad2deg((obs_angle - vel_angle + np.pi) % two_pi - np.pi)
        )
        in_range = has_obs and d_obs < cfg.danger_range
        draw_red_velocity = in_range and angle_diff < cfg.danger_angle

        # closest point on path: blue dot (:842)
        pygame.draw.circle(s, CLOSEST_PT_COLOR, spt(cp), 5)

        # lookahead vector + dot + arc (:848-850)
        pygame.draw.line(s, LOOKAHEAD_COLOR, spt(pos), spt(la), 4)
        pygame.draw.circle(s, LOOKAHEAD_COLOR, spt(la), 5)
        arc(100, LOOKAHEAD_COLOR, alpha, la_angle)

        # velocity vector, red when the CA angle+range condition fires (:852-859)
        vel_color = DANGER_RED if draw_red_velocity else PATH_COLOR
        pygame.draw.line(s, vel_color, spt(pos), spt(pos + vel), 4)
        arc(50, vel_color, alpha, vel_angle)

        # nearest-obstacle vector: orange inside danger range, green outside
        # (:861-868)
        if has_obs:
            d_center = np.where(
                omask, np.hypot(*(oxy - pos).T) - orad, np.inf
            )
            nearest = oxy[int(np.argmin(d_center))]
            obs_color = WARN_ORANGE if in_range else SAFE_GREEN
            pygame.draw.line(s, obs_color, spt(pos), spt(nearest), 4)
            arc(25, obs_color, alpha, obs_angle)

        # motor-force bars: gray full-scale reference, red actual (:879-894)
        c, sn = np.cos(alpha), np.sin(alpha)
        R = np.array([[c, -sn], [sn, c]])
        vscale = 0.05
        for side, force in (
            (-cfg.drone_radius, float(np.asarray(state.left_force))),
            (cfg.drone_radius, float(np.asarray(state.right_force))),
        ):
            base = pos + R @ np.array([side, 0.0])
            full = pos + R @ np.array([side, cfg.force_scale * vscale])
            act = pos + R @ np.array([side, force * vscale])
            pygame.draw.line(s, (179, 179, 179), spt(base), spt(full), 4)
            pygame.draw.line(s, DANGER_RED, spt(base), spt(act), 4)

        # target dot (:896)
        pygame.draw.circle(s, TARGET_COLOR, spt(target), 5)

    # -- drone shade trail (drone_2d_env.py:870-875, :416-419) ---------------

    def reset_shades(self) -> None:
        self._shades: list = []

    def maybe_add_shade(self, pos, angle: float, shade_distance: float) -> None:
        """Record a shade pose when the drone moved more than shade_distance
        on either axis since the last one (drone_2d_env.py:416-419)."""
        if not hasattr(self, "_shades"):
            self._shades = []
        x, y = float(pos[0]), float(pos[1])
        if not self._shades:
            self._shades.append((x, y, float(angle)))
            return
        lx, ly, _ = self._shades[-1]
        if abs(x - lx) > shade_distance or abs(y - ly) > shade_distance:
            self._shades.append((x, y, float(angle)))

    def draw_shades(self) -> None:
        """Translucent drone silhouettes at the recorded poses.  The
        reference blits a rotated shade.png sprite (:870-875); we draw the
        same 3-box silhouette as an alpha polygon layer instead of shipping
        an image asset."""
        if not getattr(self, "_shades", None):
            return
        cfg, h = self.cfg, float(self.h)
        overlay = pygame.Surface((self.w, self.h), pygame.SRCALPHA)
        hw, hh = cfg.drone_width / 2, cfg.drone_height / 4
        m = cfg.drone_height / 2
        for x, y, angle in self._shades:
            c, sn = np.cos(angle), np.sin(angle)
            R = np.array([[c, -sn], [sn, c]])

            def poly(local):
                world = (R @ np.asarray(local).T).T + np.array([x, y])
                return [(float(px), _flip(float(py), h)) for px, py in world]

            pygame.draw.polygon(
                overlay, SHADE_RGBA, poly([(-hw, -hh), (-hw, hh), (hw, hh), (hw, -hh)])
            )
            for side in (-cfg.drone_radius, cfg.drone_radius):
                pygame.draw.polygon(
                    overlay, SHADE_RGBA,
                    poly([(side - m, -m), (side - m, m), (side + m, m), (side + m, -m)]),
                )
        self.surface.blit(overlay, (0, 0))

    def draw_reward_colorbar(self) -> None:
        """The red-blue legend strip (main.py:387-397)."""
        s, w, h = self.surface, self.w, self.h
        for i in range(100):
            pygame.draw.line(
                s, red_blue_grad(i / 100),
                (w - 100, h - 900 - i), (w - 50, h - 900 - i), 1,
            )
        font = pygame.font.SysFont("Arial", 30)
        s.blit(font.render("High reward", True, (0, 0, 0)), (w - 140, h - 1030))
        s.blit(font.render("Low reward", True, (0, 0, 0)), (w - 140, h - 910))

    # -- outputs -------------------------------------------------------------

    def frame(self) -> np.ndarray:
        """Current surface as (H, W, 3) uint8 (main.py:267-270 orientation)."""
        arr = pygame.surfarray.array3d(self.surface)
        return np.flipud(np.rot90(arr))

    def save_png(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        pygame.image.save(self.surface, path)


def overlay_plot(
    cfg: EnvConfig,
    flight_paths: Sequence[Sequence[Tuple[float, float]]],
    rewards: np.ndarray,
    collisions: np.ndarray,
    out_path: str,
) -> None:
    """All-episodes flight-path overlay PNG (main.py:329-400): paths colored
    by min-max-normalized episode reward (red=low, blue=high); collision
    episodes forced red."""
    r = SceneRenderer(cfg)
    r.draw_scene()
    rewards = np.asarray(rewards, np.float64)
    lo, hi = rewards.min(), rewards.max()
    normed = np.zeros_like(rewards) if hi == lo else (rewards - lo) / (hi - lo)
    single = len(flight_paths) == 1
    for i, path in enumerate(flight_paths):
        forced_red = bool(collisions[i] == 1) or single
        color = (255, 0, 0) if forced_red else red_blue_grad(float(normed[i]))
        r.draw_flight_path(path, color)
    r.draw_reward_colorbar()
    r.save_png(out_path)


def episode_gif(
    cfg: EnvConfig,
    traj: np.ndarray,
    angles: Optional[np.ndarray],
    traj_len: int,
    out_path: str,
    *,
    fps: int = 30,
    every: int = 2,
) -> None:
    """Replay one episode's trajectory to a GIF (main.py:293-295 cadence:
    every 2nd frame at 30 fps)."""
    campaign_gif(cfg, traj[None], None if angles is None else angles[None],
                 np.asarray([traj_len]), out_path, fps=fps, every=every)


def campaign_gif(
    cfg: EnvConfig,
    traj: np.ndarray,
    angles: Optional[np.ndarray],
    traj_len: np.ndarray,
    out_path: str,
    *,
    fps: int = 30,
    every: int = 2,
) -> None:
    """Concatenate EVERY episode of a campaign into one GIF — the reference's
    test-mode behavior (main.py:259-295 accumulates frames across the whole
    run_n_times loop, sampling every 2nd frame at 30 fps); the flight trail
    restarts with each episode, as its env re-init clears self.flight_path.

    traj: (N, T, 2), angles: (N, T) or None, traj_len: (N,) live lengths.
    """
    import imageio

    r = SceneRenderer(cfg)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    # stream frames straight to the encoder: a cap-length episode at the
    # default 1300x1300 screen is ~550 frames x ~5 MB — accumulating them in
    # a list (as mimsave needs) peaks at multi-GB RSS
    with imageio.get_writer(out_path, mode="I", fps=fps) as w:
        for i in range(traj.shape[0]):
            trail: list = []
            for t in range(0, int(traj_len[i]), every):
                r.draw_scene()
                x, y = float(traj[i, t, 0]), float(traj[i, t, 1])
                trail.append((x, _flip(y, cfg.screensize_y)))
                if len(trail) > 2:
                    r.draw_flight_path(trail, (16, 19, 97))
                r.draw_drone(
                    (x, y), float(angles[i, t]) if angles is not None else 0.0
                )
                w.append_data(r.frame())
