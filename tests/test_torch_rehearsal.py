"""The port's rehearsal fine-tune against the JAX package, on the CPU.

The corridor and crossing walls are fed the JAX package's own draws (its
keys split as `drone2d_tpu/env/scenarios.py` splits them) on the same
paths; the adaptive family draw is held exactly at the cumulative bounds;
the PLR controller and the starting probabilities are compared value for
value; resets with the mixes on are held by invariants and frequencies; a
rollout bridged from a JAX state with adaptive reset templates must count
the same episodes and wins per family; the train CLI runs the
flagship-finetune preset with the controller ticking, and its checkpoints
carry the PLR fields through a resume.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig, PPOConfig as JPPOConfig
from drone2d_tpu.env import scenarios as jscen
from drone2d_tpu.env.types import FAMILY_NAMES as JFAMILY_NAMES
from drone2d_tpu.learn import plr as jplr
from drone2d_tpu.learn.ppo import PPOLearner as JPPOLearner, TrainState as JTrainState
from drone2d_tpu.models.policy import init_actor_critic as jax_init
from drone2d_tpu.ops import path as jpath
from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy, train_state_from_numpy
from drone2d_tpu_torch.config import EnvConfig, PPOConfig, TrainConfig, apply_preset
from drone2d_tpu_torch.env import scenarios
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.env.types import FAMILY_NAMES
from drone2d_tpu_torch.learn import plr
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.ops import path as tpath
from drone2d_tpu_torch.train import main, train
from drone2d_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
AGENT_S6006 = os.path.join(ROOT, "artifacts", "agent_s6006", "new_agent.npz")
SMALL = dict(path_table_n=128)
# the flagship-finetune recipe's env with the two wall mixes at 0.04: the
# probabilities 0.3*(3, 1, 1, 1, 1)/7, 0.04, 0.04 (budget 0.38)
FINETUNE_ENV = apply_preset("flagship-finetune", EnvConfig(**SMALL), PPOConfig(),
                            TrainConfig())[0].replace(corridor_mix_prob=0.04,
                                                      cross_mix_prob=0.04)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_cfg(cfg: EnvConfig) -> JEnvConfig:
    return JEnvConfig(**{k: getattr(cfg, k) for k in JEnvConfig.__dataclass_fields__})


# -- the walls, with the JAX package's draws ----------------------------------


@pytest.fixture(scope="module")
def paths():
    """32 random curriculum paths, as JAX PathData and as the port's."""
    cfg = JEnvConfig(**SMALL)
    keys = jax.random.split(jax.random.PRNGKey(5), 32)
    wps = jax.vmap(lambda k: jscen.random_corner_waypoints(k, cfg))(keys)
    jpd = jax.vmap(lambda w: jpath.make_path(w, jnp.int32(cfg.n_wps), table_n=128))(wps)
    tpd = tpath.PathData(**{k: torch.tensor(np.asarray(v)) for k, v in jpd._asdict().items()})
    return keys, jpd, tpd


# wall centers to 1e-4 px, or to one float32 ulp of the coordinate where
# that is larger (1.2e-4 px from 1024 px on): the two packages evaluate the
# path in another order (measured: at most one ulp)
WALL_TOL_PX = 1e-4


@pytest.mark.parametrize("wall", ["corridor", "cross"])
def test_walls_match_jax_on_jax_draws(paths, wall):
    keys, jpd, tpd = paths
    cfg = JEnvConfig(**SMALL)
    if wall == "corridor":
        want = jax.vmap(lambda k, p: jscen.corridor_obstacles(k, cfg, p))(keys, jpd)
        off = jax.vmap(lambda k: jax.random.uniform(k, (), minval=90.0, maxval=180.0))(keys)
        got = scenarios.corridor_walls(EnvConfig(**SMALL), tpd, torch.tensor(np.asarray(off)))
        live = 62
    else:
        want = jax.vmap(lambda k, p: jscen.cross_obstacles(k, cfg, p))(keys, jpd)

        def draws(k):
            k_u, k_r, k_c = jax.random.split(k, 3)
            return (jax.random.uniform(k_u, (), minval=0.3, maxval=0.7),
                    jax.random.uniform(k_r, (), minval=15.0, maxval=40.0),
                    jax.random.uniform(k_c, (), minval=-60.0, maxval=60.0))

        drawn = [torch.tensor(np.asarray(d)) for d in jax.vmap(draws)(keys)]
        got = scenarios.cross_walls(EnvConfig(**SMALL), tpd, *drawn)
        live = 6
    (gxy, gr, gmask), (wxy, wr, wmask) = [[_np(x) for x in t] for t in (got, want)]
    np.testing.assert_array_equal(gmask, wmask)
    assert (gmask.sum(1) == live).all()
    np.testing.assert_array_equal(gxy[~gmask], wxy[~wmask])  # padding at 1e6
    np.testing.assert_array_equal(gr[~gmask], 0.0)
    np.testing.assert_allclose(gr, wr, rtol=1e-6, atol=0)
    tol = np.maximum(WALL_TOL_PX, np.spacing(np.abs(wxy)))
    assert (np.abs(gxy - wxy) <= tol).all(), np.abs(gxy - wxy).max()


def test_family_draw_at_the_cumulative_bounds():
    """u placed exactly on each float32 cumulative bound, one ulp either
    side, and at 0 and just below 1: the same family as JAX's
    sum(u >= cumsum(probs)), exactly."""
    probs = np.array([0.3 * 3 / 7, 0.3 / 7, 0.3 / 7, 0.3 / 7, 0.3 / 7, 0.04, 0.04], np.float32)
    cum = np.asarray(jnp.cumsum(jnp.asarray(probs)))
    u = np.concatenate([cum, np.nextafter(cum, 0.0, dtype=np.float32),
                        np.nextafter(cum, 1.0, dtype=np.float32),
                        np.array([0.0, np.nextafter(1.0, 0.0, dtype=np.float32)], np.float32)])
    want = np.asarray(jax.vmap(lambda x: jnp.sum(x >= jnp.cumsum(jnp.asarray(probs))))(u))
    got = _np(scenarios.family_from_uniform(torch.tensor(u), torch.tensor(probs)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:7], np.arange(1, 8))  # on a bound: the next family
    np.testing.assert_array_equal(_np(tpath.cumsum(torch.tensor(probs)[None]))[0], cum)


# -- the starting probabilities and the controller -----------------------------

PROB_CASES = {
    "default": {},
    "flagship_finetune": dict(stage_mix_prob=0.3, stage_mix_weights=(3.0, 1.0, 1.0, 1.0, 1.0),
                              adaptive_rehearsal=True),
    "finetune_walls": dict(stage_mix_prob=0.3, stage_mix_weights=(3.0, 1.0, 1.0, 1.0, 1.0),
                           adaptive_rehearsal=True, corridor_mix_prob=0.04,
                           cross_mix_prob=0.04),
    "static_uniform": dict(stage_mix_prob=0.25, corridor_mix_prob=0.1),
}


@pytest.mark.parametrize("case", list(PROB_CASES))
def test_initial_rehearsal_probs_match_jax(case):
    kw = PROB_CASES[case]
    got = PPOLearner(EnvConfig(**SMALL, **kw), PPOConfig(), 4,
                     device="cpu").initial_rehearsal_probs()
    want = JPPOLearner(JEnvConfig(**SMALL, **kw), JPPOConfig(), 4).initial_rehearsal_probs()
    assert got.dtype == torch.float32 and got.shape == (7,)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("kw", [
    dict(stage_mix_weights=(1.0, 1.0, 1.0, 1.0), adaptive_rehearsal=True),
    dict(stage_mix_weights=(-1.0, 1.0, 1.0, 1.0, 1.0), adaptive_rehearsal=True),
    dict(stage_mix_weights=(0.0, 0.0, 0.0, 0.0, 0.0), adaptive_rehearsal=True),
    dict(stage_mix_weights=(3.0, 1.0, 1.0, 1.0, 1.0)),
], ids=["four", "negative", "zero_sum", "non_uniform_static"])
def test_initial_rehearsal_probs_errors_as_jax(kw):
    cfg = dict(SMALL, stage_mix_prob=0.2, **kw)
    with pytest.raises(ValueError, match="stage_mix_weights"):
        JPPOLearner(JEnvConfig(**cfg), JPPOConfig(), 4).initial_rehearsal_probs()
    with pytest.raises(ValueError, match="stage_mix_weights"):
        PPOLearner(EnvConfig(**cfg), PPOConfig(), 4, device="cpu").initial_rehearsal_probs()


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "population"])
def test_reweight_rehearsal_matches_jax(batch):
    """Seeded probabilities, counts and wins (some families unmeasured, one
    inactive, one all-won): bit-equal new probabilities and the same report."""
    rng = np.random.default_rng(len(batch))
    for _ in range(20):
        probs = rng.uniform(0.0, 0.1, batch + (7,)).astype(np.float32)
        probs[..., 3] = 0.0
        counts = rng.integers(0, 40, batch + (8,)).astype(np.float32)
        wins = np.floor(counts * rng.uniform(0, 1, counts.shape)).astype(np.float32)
        wins[..., 2] = counts[..., 2]
        for kw in ({}, dict(ema=1.0, floor_frac=0.1, min_episodes=4.0)):
            got = plr.reweight_rehearsal(probs, counts, wins, **kw)
            want = jplr.reweight_rehearsal(probs, counts, wins, **kw)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got.sum(-1), probs.sum(-1), rtol=1e-6)
        assert plr.family_report(counts, wins) == jplr.family_report(counts, wins)
    assert plr.family_report(np.zeros(8), np.zeros(8)) == "no finished episodes"
    assert FAMILY_NAMES == JFAMILY_NAMES


# -- resets with the mixes on ------------------------------------------------


def _reset(cfg, n, seed=0, global_step=0.0, probs=None):
    env = Drone2DEnv(cfg, device="cpu")
    return env.reset_batch(torch.Generator().manual_seed(seed), n, global_step, probs)


def _sigma5(p, n):
    return 5.0 * np.sqrt(p * (1.0 - p) / n)


def test_adaptive_reset_frequencies_and_invariants():
    """4096 envs at the fine-tune recipe plus the two 0.04 wall mixes: each
    family's share within 5 sigma of its probability; corridor episodes get
    62 circles, cross episodes 6, both start at the path start; the stage
    families get their forced stage's field; scheduled envs (step 0, stage
    1) get none."""
    n = 4096
    learner = PPOLearner(FINETUNE_ENV, PPOConfig(), n, device="cpu")
    probs = learner.initial_rehearsal_probs()
    state, obs = _reset(FINETUNE_ENV, n, seed=11, probs=probs)
    fam = _np(state.family)
    p = np.concatenate([[1.0 - float(probs.sum())], _np(probs)])
    for f in range(8):
        share = (fam == f).mean()
        assert abs(share - p[f]) <= _sigma5(p[f], n), (FAMILY_NAMES[f], share, p[f])
    mask, r = _np(state.obstacles.mask), _np(state.obstacles.r)
    xy, pos, wps = _np(state.obstacles.xy), _np(state.body.pos), _np(state.path.wps)
    count = mask.sum(1)
    at_start = (pos == wps[:, 0]).all(1)
    assert (count[fam == 6] == 62).all() and (count[fam == 7] == 6).all()
    for f in (6, 7):
        rows = fam == f
        live = mask[rows]
        assert (r[rows][live] > 0).all() and (r[rows][~live] == 0).all()
        assert (xy[rows][~live] == 1e6).all()
        assert at_start[rows].all()
        # touching circles of one radius per env
        assert (np.ptp(np.where(live, r[rows], r[rows].max(1, keepdims=True)), 1) == 0).all()
    m = FINETUNE_ENV.max_curriculum_obs
    assert (count[np.isin(fam, (0, 1, 2))] == 0).all()
    assert mask[fam == 4, m].all() and (count[fam == 4] == 1).all()
    assert (count[fam == 3] <= 1).all()
    assert not at_start[fam == 2].any() and at_start[fam != 2].all()
    assert np.isfinite(_np(obs)).all()


def test_static_wall_mixes_and_forced_stages():
    """Without adaptive rehearsal each wall fires with its probability and
    the crossing wall wins when both fire (P(cross) = 0.5, P(corridor) =
    0.5 * 0.5); under a forced stage no mix fires, adaptive or not."""
    n = 2048
    cfg = EnvConfig(**SMALL, corridor_mix_prob=0.5, cross_mix_prob=0.5)
    state, _ = _reset(cfg, n, seed=3)
    fam = _np(state.family)
    assert set(np.unique(fam)) == {0, 6, 7}
    assert abs((fam == 7).mean() - 0.5) <= _sigma5(0.5, n)
    assert abs((fam == 6).mean() - 0.25) <= _sigma5(0.25, n)
    assert (_np(state.obstacles.mask).sum(1)[fam == 7] == 6).all()
    for forced in (cfg.replace(scenario="stage_4"),
                   FINETUNE_ENV.replace(scenario="stage_4")):
        probs = torch.full((7,), 0.14)
        state, _ = _reset(forced, 512, seed=4, probs=probs)
        assert not state.family.any()
        assert (_np(state.obstacles.mask).sum(1) == 1).all()  # stage 4's one obstacle


def test_adaptive_reset_needs_probs():
    with pytest.raises(ValueError, match="rehearsal_probs"):
        _reset(FINETUNE_ENV, 4)
    # a zero budget keeps every env on the schedule
    state, _ = _reset(FINETUNE_ENV, 256, probs=torch.zeros(7))
    assert not state.family.any()


# -- the rollout's family accounting, bridged from JAX ------------------------

N, T = 32, 16


@pytest.fixture(scope="module")
def jax_adaptive_rollout():
    """A JAX rollout at the fine-tune env (episode cap 12, so that episodes
    end inside it) from a JAX state whose every third env starts 5 px from
    its target (a win on its first step)."""
    cfg = _jax_cfg(FINETUNE_ENV.replace(n_steps=12))
    jl = JPPOLearner(cfg, JPPOConfig(n_steps=T, hidden_sizes=(32, 32)), N)
    probs = jl.initial_rehearsal_probs()
    reset = jax.jit(jl.env.reset_batch, static_argnums=1)
    env_state, obs = reset(jax.random.PRNGKey(1), N, jnp.float32(0.0), probs)
    near = (jnp.arange(N) % 3 == 0)[:, None]
    env_state = env_state._replace(body=env_state.body._replace(
        pos=jnp.where(near, env_state.target + 5.0, env_state.body.pos)))
    state = JTrainState(
        params=jax_init(jax.random.PRNGKey(0), 27, 2, (32, 32)), opt_state=None,
        env_state=env_state, obs=obs, rng=jax.random.PRNGKey(2), global_step=jnp.float32(0.0),
        episodes_total=jnp.float32(0.0), rehearsal_probs=probs,
        family_counts=jnp.arange(8, dtype=jnp.float32), family_wins=jnp.zeros(8),
    )
    _, batch, _, stats = jax.jit(jl.rollout)(state)
    template_key, rng = jax.random.split(state.rng)
    reset_state, reset_obs = reset(template_key, N, state.global_step, probs)
    noise = []
    for _ in range(T):
        rng, k_act = jax.random.split(rng)
        noise.append(np.asarray(jax.random.normal(k_act, (N, 2), jnp.float32)))
    return dict(state=jax.tree.map(np.asarray, state), batch=batch, stats=stats,
                reset_state=jax.tree.map(np.asarray, reset_state),
                reset_obs=np.asarray(reset_obs), noise=np.stack(noise), cfg=cfg)


def test_adaptive_rollout_counts_families_as_jax(jax_adaptive_rollout):
    """The port's rollout from the bridged state with JAX's adaptive reset
    template and noise: the same dones, and family_counts and family_wins
    equal to JAX's exactly; the update then adds them to the state's."""
    run = jax_adaptive_rollout
    cfg = FINETUNE_ENV.replace(n_steps=12)
    learner = PPOLearner(cfg, PPOConfig(n_steps=T, hidden_sizes=(32, 32), num_minibatches=4,
                                        n_epochs=1, shuffle="timeperm"), N, device="cpu")
    state = train_state_from_numpy(run["state"], 3e-4, device="cpu")
    np.testing.assert_array_equal(_np(state.rehearsal_probs), run["state"].rehearsal_probs)
    np.testing.assert_array_equal(_np(state.family_counts), np.arange(8))
    draws = (env_state_from_numpy(run["reset_state"], device="cpu"),
             torch.tensor(run["reset_obs"]), torch.tensor(run["noise"]))
    _, batch, _, stats = learner.rollout_from(state, *draws)
    np.testing.assert_array_equal(_np(batch.dones), np.asarray(run["batch"].dones))
    js = run["stats"]
    np.testing.assert_array_equal(_np(stats.family_counts), np.asarray(js.family_counts))
    np.testing.assert_array_equal(_np(stats.family_wins), np.asarray(js.family_wins))
    counts, wins = np.asarray(js.family_counts), np.asarray(js.family_wins)
    assert (counts > 0).sum() >= 4 and wins.sum() >= N // 3
    assert counts.sum() == float(js.n_episodes) and wins.sum() == float(js.n_success)

    perms = torch.stack([torch.randperm(T, generator=torch.Generator().manual_seed(0))])
    new, _ = learner.update_from(state, *draws, perms)
    np.testing.assert_array_equal(_np(new.family_counts), np.arange(8) + counts)
    np.testing.assert_array_equal(_np(new.family_wins), wins)


def test_rollout_counts_nothing_without_adaptive():
    learner = PPOLearner(EnvConfig(**SMALL, n_steps=6, stage_mix_prob=0.5),
                         PPOConfig(n_steps=8, hidden_sizes=(32, 32)), 8, device="cpu")
    state = learner.init(0)
    _, _, _, stats = learner.rollout(state)
    assert float(stats.n_episodes) > 0
    assert not stats.family_counts.any() and not stats.family_wins.any()


# -- the controller in the train CLI, checkpoints and resume -----------------


def _argv(ckpt, *extra):
    return ["--preset", "flagship-finetune", "--device", "cpu", "--num-envs", "64",
            "--ppo-n-steps", "16", "--ppo-num-minibatches", "4", "--ppo-n-epochs", "1",
            "--env-path-table-n", "128", "--env-n-steps", "12",
            "--env-corridor-mix-prob", "0.2", "--env-cross-mix-prob", "0.2",
            "--env-rehearsal-adapt", "true", "--checkpoint-dir", ckpt,
            "--metrics-path", f"{ckpt}/m.jsonl", *extra]


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_finetune_cli_ticks_and_resumes(tmp_path, capsys):
    """flagship-finetune with both wall mixes at 0.2 and the controller on,
    from agent_s6006, episodes capped at 12 steps: every update logs the
    rehearsal/p_* rows and a rehearsal line; the tick moves the measured
    families and keeps the budget (0.3 + 0.4); the PLR fields round-trip
    through the checkpoint, and a resumed run starts from them."""
    ckpt = str(tmp_path / "ft")
    main(_argv(ckpt, "--max-updates", "3", "--init-params", AGENT_S6006))
    rows = _rows(f"{ckpt}/m.jsonl")
    assert [r["global_step"] for r in rows] == [1024, 2048, 3072]
    names = [f"rehearsal/p_{n}" for n in FAMILY_NAMES[1:]]
    start = np.array([0.3 * 3 / 7] + [0.3 / 7] * 4 + [0.2, 0.2])
    for r in rows:
        p = np.array([r[k] for k in names])
        assert abs(p.sum() - start.sum()) <= 1e-6
    last = np.array([rows[-1][k] for k in names])
    assert np.abs(last - start).max() > 1e-3
    assert capsys.readouterr().out.count("  rehearsal: ") == 3

    learner = PPOLearner(*_cli_cfgs(ckpt)[1:], 64, device="cpu")
    restored, step = restore_checkpoint(ckpt, learner)
    assert step == 3072
    np.testing.assert_allclose(_np(restored.rehearsal_probs), last, rtol=1e-7)
    assert float(restored.family_counts.sum()) > 0
    assert float(restored.family_wins.sum()) <= float(restored.family_counts.sum())

    state = train(*_cli_cfgs(ckpt), resume=True, max_updates=1, device="cpu")
    assert _rows(f"{ckpt}/m.jsonl")[-1]["global_step"] == 4096
    assert (_np(state.family_counts) >= _np(restored.family_counts)).all()
    assert float(state.family_counts.sum()) > float(restored.family_counts.sum())


def _cli_cfgs(ckpt):
    from drone2d_tpu_torch.train import parse_args

    _, train_cfg, env_cfg, ppo_cfg = parse_args(_argv(ckpt))
    return train_cfg, env_cfg, ppo_cfg


def test_checkpoint_without_plr_fields_restores_the_initial_ones(tmp_path):
    learner = PPOLearner(FINETUNE_ENV, PPOConfig(n_steps=4, num_minibatches=2, n_epochs=1,
                                                 hidden_sizes=(32, 32)), 8, device="cpu")
    state = learner.init(0)
    state.family_counts += 3.0
    d = str(tmp_path / "c")
    step = save_checkpoint(d, state)
    restored, _ = restore_checkpoint(d, learner)
    for k in ("rehearsal_probs", "family_counts", "family_wins"):
        torch.testing.assert_close(getattr(restored, k), getattr(state, k), rtol=0, atol=0)
    path = os.path.join(d, f"ckpt_{step}.pt")
    payload = torch.load(path, weights_only=True)
    for k in ("rehearsal_probs", "family_counts", "family_wins"):
        del payload[k]
    torch.save(payload, path)
    old, _ = restore_checkpoint(d, learner)
    torch.testing.assert_close(old.rehearsal_probs, learner.initial_rehearsal_probs(),
                               rtol=0, atol=0)
    assert not old.family_counts.any() and not old.family_wins.any()


def test_zero_budget_adaptive_run_raises(tmp_path):
    cfg = EnvConfig(**SMALL, adaptive_rehearsal=True)
    with pytest.raises(ValueError, match="zero rehearsal budget"):
        train(TrainConfig(num_envs=4, checkpoint_dir=str(tmp_path)), cfg,
              PPOConfig(n_steps=4, num_minibatches=2), device="cpu")
