"""Interactive live viewer: manual control and policy-eval mode (the port's
counterpart of `drone2d_tpu/debug.py`).

Covers two reference modes:

* `mode == "debug"` (`main.py:32-85,136-146` + `event_handler.py`): arrow
  keys map to rotor-action pairs as `_manual_control` does
  (`main.py:49-60`): RIGHT=[1,-1], LEFT=[-1,1], UP=[1,1], DOWN=[-1,-1],
  no key=[-1,-1] (both rotors idle); S saves a screenshot; ESC/close quits.
* `mode == "eval"` (`main.py:212-241`): pass `--agent <npz|ckpt-dir>` and
  the loaded policy flies while you watch (stochastic like the reference's
  `model.predict`, or `--deterministic`).

The live diagnostics are `eval/render.py`'s (reward-component text,
velocity / lookahead / nearest-obstacle vectors, motor-force bars, shade
trail, flight path, the test-mode spawn rectangle).  The env steps one env
on the device (the card unless `--device cpu`) and each frame is drawn on
the host from the returned state.  Auto-resets on done.  `--gif-out`
records the run headless (SDL_VIDEODRIVER=dummy).  Needs pygame (and
imageio for `--gif-out`), which only this module and the renderer import.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenario", default=None,
                   help="spatial scenario or stage_k; default: curriculum stage_1")
    p.add_argument("--agent", default=None,
                   help=".npz params, the port's checkpoint dir, or 'random': the "
                        "policy flies (reference eval mode, main.py:212-241); "
                        "omit for keyboard control")
    p.add_argument("--deterministic", action="store_true",
                   help="policy mean instead of sampling (with --agent)")
    p.add_argument("--fps", type=int, default=60)
    p.add_argument("--screenshot-dir", default="screenshots")
    p.add_argument("--max-frames", type=int, default=0,
                   help="exit after N frames (0 = run until ESC; useful headless)")
    p.add_argument("--gif-out", default=None,
                   help="record every 2nd frame to this GIF (works headless)")
    _bool = lambda s: s.lower() in ("1", "true", "yes")  # noqa: E731
    p.add_argument("--render-text", type=_bool, default=True, metavar="BOOL",
                   help="reward-component text overlay (drone_2d_env.py:788-819)")
    p.add_argument("--render-path", type=_bool, default=True, metavar="BOOL",
                   help="flight-path trail (drone_2d_env.py:898-900)")
    p.add_argument("--render-shade", type=_bool, default=False, metavar="BOOL",
                   help="drone shade trail (drone_2d_env.py:870-875)")
    p.add_argument("--shade-distance", type=float, default=75.0)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where the env steps; the default is the CUDA card")
    return p


def host_env(tree):
    """Env 0 of a batched state or info tree, as host numpy leaves (what the
    renderer draws from)."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: host_env(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: host_env(v) for k, v in tree.items()}
    return None if tree is None else tree[0].cpu().numpy()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import pygame

    from drone2d_tpu_torch.config import EnvConfig
    from drone2d_tpu_torch.device import resolve_device
    from drone2d_tpu_torch.env.env import Drone2DEnv
    from drone2d_tpu_torch.eval.render import SceneRenderer, _flip
    from drone2d_tpu_torch.utils.host_path import HostQPMI

    render_kw = dict(
        render_sim=True, render_text=args.render_text,
        render_path=args.render_path, render_shade=args.render_shade,
        shade_distance=args.shade_distance,
    )
    if args.scenario and not args.scenario.startswith("stage_"):
        cfg = EnvConfig(mode="test", scenario=args.scenario, **render_kw)
    else:
        cfg = EnvConfig(mode="curriculum", scenario=args.scenario or "stage_1", **render_kw)
    dev = resolve_device(args.device)
    env = Drone2DEnv(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    policy = None
    if args.agent:
        from drone2d_tpu_torch.eval.run import load_params

        params = load_params(args.agent, device=dev)

        @torch.no_grad()
        def policy(obs):
            if params is None:  # 'random'
                return torch.rand(1, 2, generator=gen, device=dev) * 2.0 - 1.0
            if args.deterministic:
                return params.deterministic_action(obs)
            return torch.clamp(params.sample_action(obs, generator=gen)[0], -1.0, 1.0)

    state, obs = env.reset(gen)

    pygame.init()
    screen = pygame.display.set_mode((int(cfg.screensize_x), int(cfg.screensize_y)))
    pygame.display.set_caption("Drone2d Environment (drone2d_tpu_torch debug)")
    clock = pygame.time.Clock()
    renderer = SceneRenderer(cfg)
    renderer.reset_shades()
    gif_frames: list = []

    # curriculum mode: the scene's geometry is per-episode state
    def scene_layers(state):
        if cfg.mode == "test":
            return None, None
        s = host_env(state)
        host = HostQPMI(s.path.wps[:int(s.path.n_wps)])
        return host.coords(100), (s.obstacles.xy, s.obstacles.r, s.obstacles.mask)

    keymap = ((pygame.K_RIGHT, (1.0, -1.0)), (pygame.K_LEFT, (-1.0, 1.0)),
              (pygame.K_UP, (1.0, 1.0)), (pygame.K_DOWN, (-1.0, -1.0)))
    path_coords, obstacles = scene_layers(state)
    trail = []
    frames = 0
    running = True
    with torch.no_grad():
        while running:
            action = (-1.0, -1.0)
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    running = False
                elif event.type == pygame.MOUSEBUTTONDOWN and cfg.change_target:
                    # click-to-retarget (reference event_handler.py:5-13), with
                    # the real screen height in place of its stale 800
                    mx, my = event.pos
                    state.target = torch.tensor([[float(mx), cfg.screensize_y - float(my)]],
                                                device=dev)
            keys = pygame.key.get_pressed()
            if keys[pygame.K_ESCAPE]:
                running = False
            else:
                action = next((a for k, a in keymap if keys[k]), action)
            if keys[pygame.K_s]:
                os.makedirs(args.screenshot_dir, exist_ok=True)
                pygame.image.save(screen, os.path.join(args.screenshot_dir,
                                                       f"frame_{frames}.png"))

            act = (policy(obs) if policy is not None
                   else torch.tensor([action], dtype=torch.float32, device=dev))
            out = env.step(state, act)
            state, obs = out.state, out.obs
            s = host_env(state)
            pos, angle = s.body.pos.astype(np.float64), float(s.body.angle)
            if args.render_path:
                trail.append((float(pos[0]), _flip(float(pos[1]), cfg.screensize_y)))
            if args.render_shade:
                renderer.maybe_add_shade(pos, angle, cfg.shade_distance)

            renderer.draw_scene(path_coords, obstacles)
            if cfg.mode == "test":
                renderer.draw_spawn_rect(np.asarray(env._spawn_rect))
            if args.render_shade:
                renderer.draw_shades()
            if len(trail) > 2:
                renderer.draw_flight_path(trail, (16, 19, 97))
            renderer.draw_drone(pos, angle)
            renderer.draw_diagnostics(s, host_env(obs))
            if args.render_text:
                renderer.draw_reward_text(host_env(out.info))
            screen.blit(renderer.surface, (0, 0))
            pygame.display.flip()
            if args.gif_out and frames % 2 == 0:  # main.py:293-295 cadence
                gif_frames.append(renderer.frame())
            clock.tick(args.fps)
            frames += 1

            if bool(out.done[0]):
                state, obs = env.reset(gen)
                path_coords, obstacles = scene_layers(state)
                trail = []
                renderer.reset_shades()
            if args.max_frames and frames >= args.max_frames:
                running = False
    pygame.quit()
    if args.gif_out and gif_frames:
        import imageio

        os.makedirs(os.path.dirname(args.gif_out) or ".", exist_ok=True)
        imageio.mimsave(args.gif_out, gif_frames, fps=30)
        print(f"wrote {args.gif_out} ({len(gif_frames)} frames)")


if __name__ == "__main__":
    main()
