"""The rehearsal fine-tune hunt (the JAX package's hunt 8) on the CPU.

Hunt 8 trained 8 seeds (8000-8007) x 30M env steps of the
`flagship-finetune` recipe from `artifacts/agent_s6006`, snapshotting at
3M, 6M, ..., 27M, and made the shipped `agent_s8004`.  Its selection
records (`artifacts/campaigns/r4/r4_h8_gen2_select.json`, eval seed 0, and
`..._select777.json`) and its n=1000 finalists (`h8_finalists_n1000.json`)
are the port's reference.  Here: the snapshot schedule gives the record's
step keys; the port's sweep CLI builds the configs that the JAX package's
does (the preset, the warm start, `rehearsal_adapt=False`); `hunt_check`
passes hunt 8 against itself and fails it moved down by 0.02 or 0.03; the
finalist rule picks the record's three finalists; and one population update
at the fine-tune's env and PPO config, warm-started from agent_s6006,
matches the JAX package's `ZooTrainer` with its draws injected.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import (
    PRESETS as JPRESETS,
    EnvConfig as JEnvConfig,
    PPOConfig as JPPOConfig,
)
from drone2d_tpu.eval.run import load_params as jax_load_params
from drone2d_tpu.learn import zoo as jzoo
from drone2d_tpu.learn.ppo import PPOLearner as JPPOLearner
from drone2d_tpu_torch.compat.from_jax import (
    env_state_from_numpy,
    params_to_flat,
    zoo_state_from_numpy,
)
from drone2d_tpu_torch.config import PRESETS, EnvConfig, PPOConfig
from drone2d_tpu_torch.env.types import cat_states
from drone2d_tpu_torch.eval.run import load_params
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.learn.zoo import ZooTrainer, snapshot_schedule
from drone2d_tpu_torch.scripts import hunt_check, sweep
from tests.test_torch_ppo import _assert_params_close, _jax_draws, _params_bound
from tests.test_torch_zoo import _near_cap

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
R4 = os.path.join(ROOT, "artifacts", "campaigns", "r4")
S6006 = os.path.join(ROOT, "artifacts", "agent_s6006", "new_agent.npz")
SPU = 1024 * 128
SNAPSHOT_STEPS = [3_000_000 * k for k in range(1, 10)]
RECORD_STEPS = ["3014656", "6029312", "9043968", "12058624", "15073280",
                "18087936", "21102592", "24117248", "27000832"]
HUNT_ARGV = ["--seeds", *map(str, range(8000, 8008)), "--vmap", "8",
             "--preset", "flagship-finetune", "--init-params", S6006,
             "--total-timesteps", "30000000",
             "--snapshot-steps", *map(str, SNAPSHOT_STEPS)]
FINETUNE = PRESETS["flagship-finetune"]
# the fine-tune's env at a small path table; its PPO config at 8 envs x 8
# steps (4 minibatches: timeperm needs them to divide the 8 steps)
N, T, SEEDS = 8, 8, [8000, 8001, 8002]
ENV_KW = dict(FINETUNE["env"], path_table_n=128)
PPO_KW = dict(FINETUNE["ppo"], n_steps=T, num_minibatches=4)


@pytest.fixture(scope="module")
def records():
    out = {}
    for name in ("r4_h8_gen2_select.json", "r4_h8_gen2_select777.json",
                 "h8_finalists_n1000.json"):
        with open(os.path.join(R4, name)) as f:
            out[name] = json.load(f)
    return out


def test_snapshot_schedule_gives_hunt8s_keys(records):
    """--snapshot-steps 3M ... 27M at --total-timesteps 30M and 1024 envs x
    128 steps: 229 updates, snapshots after 23, 46, ..., 206, whose env
    steps are exactly the record's step keys; --snapshots 9 gives others."""
    n_updates, snaps = snapshot_schedule(30_000_000, SPU, snapshot_steps=SNAPSHOT_STEPS)
    assert n_updates == 229
    assert sorted(snaps) == [23, 46, 69, 92, 115, 138, 161, 184, 206]
    keys = {label.split("/")[1] for label in records["r4_h8_gen2_select.json"]}
    assert [str(u * SPU) for u in sorted(snaps)] == RECORD_STEPS == sorted(
        keys - {"final"}, key=int)
    # evenly spaced, the fifth snapshot falls at update 114 (114.5, half
    # to even), 14942208 env steps, and every later one a step early
    _, even = snapshot_schedule(30_000_000, SPU, snapshots=9)
    assert sorted(even)[4:] == [114, 137, 160, 183, 206]
    assert sorted(u * SPU for u in even)[4:6] == [14942208, 17956864]


def _load_jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_script_sweep", os.path.join(ROOT, "scripts", "sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sweep_builds_the_jax_sweeps_configs(monkeypatch, tmp_path):
    """The hunt's command line gives the port's sweep the configs that the
    JAX package's `scripts/sweep.py` builds from it (train_zoo stubbed on
    both sides): the preset's env with `adaptive_rehearsal=True` and
    `rehearsal_adapt=False`, timeperm at 1024 envs x 128 steps, 64 x 10
    SGD, hidden 128-128, the explicit 30M steps, the 9 snapshot steps and
    the warm start; the presets of both packages are equal."""
    assert PRESETS["flagship-finetune"] == JPRESETS["flagship-finetune"]
    calls = {}

    def stub(side):
        def train_zoo(env_cfg, ppo_cfg, num_envs, seeds, total, out, **kw):
            calls[side] = (env_cfg, ppo_cfg, num_envs, list(seeds), total, kw)
        return train_zoo

    jax_sweep = _load_jax_sweep()
    import drone2d_tpu.utils.runtime as jruntime

    monkeypatch.setattr(jruntime, "setup_runtime", lambda *a, **k: None)
    monkeypatch.setattr(jruntime, "wait_for_accelerator", lambda *a, **k: True)
    monkeypatch.setattr(jzoo, "train_zoo", stub("jax"))
    monkeypatch.setattr("sys.argv", ["sweep.py", "--out", str(tmp_path / "jax"), *HUNT_ARGV])
    jax_sweep.main()
    monkeypatch.setattr(sweep, "train_zoo", stub("port"))
    sweep.main(["--out", str(tmp_path / "port"), "--device", "cpu", *HUNT_ARGV])

    jenv, jppo, jn, jseeds, jtotal, jkw = calls["jax"]
    env, ppo, n, seeds, total, kw = calls["port"]
    for got, want in ((env, jenv), (ppo, jppo)):
        for field in type(want).__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), field
    assert (n, seeds, total) == (jn, jseeds, jtotal) == (1024, list(range(8000, 8008)),
                                                        30_000_000)
    assert kw["snapshot_steps"] == jkw["snapshot_steps"] == SNAPSHOT_STEPS
    assert kw["init_params"] == jkw["init_params"] == S6006
    assert env.adaptive_rehearsal and not env.rehearsal_adapt
    assert (env.curriculum_scale, env.PP_rew_max, env.rew_collision) == (0.05, 8.0, -70.0)
    assert (env.stage_mix_prob, env.stage_mix_weights) == (0.3, (3.0, 1.0, 1.0, 1.0, 1.0))
    assert (ppo.hidden_sizes, ppo.n_steps, ppo.num_minibatches, ppo.n_epochs,
            ppo.shuffle) == ((128, 128), 128, 64, 10, "timeperm")


def test_initial_rehearsal_probs_match_the_jax_learners():
    """The fine-tune's fixed weighted mix: stage_mix_prob 0.3 over the five
    stages weighted 3,1,1,1,1 (0.9/7, then 0.3/7 each), no corridor or
    cross mix; equal to the JAX learner's to float32 rounding (1e-7)."""
    got = PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**PPO_KW), N,
                     device="cpu").initial_rehearsal_probs().numpy()
    want = np.asarray(JPPOLearner(JEnvConfig(**ENV_KW), JPPOConfig(**PPO_KW),
                                  N).initial_rehearsal_probs())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, [0.9 / 7] + [0.3 / 7] * 4 + [0, 0], atol=1e-7)


# -- hunt_check on hunt 8's record ---------------------------------------------


def _shifted(record, by):
    return {k: {s: dict(v, success_rate=v["success_rate"] - by) for s, v in per.items()}
            for k, per in record.items()}


def test_hunt_check_passes_hunt8_against_itself(records):
    """Every one of the 10 checkpoints at p = 1 and the Bonferroni bar at
    0.01 / 10; the CLI exits 0 and names hunt 8."""
    rec = records["r4_h8_gen2_select.json"]
    table = hunt_check.seed_table(rec)
    result = hunt_check.compare(table, table)
    assert [r["checkpoint"] for r in result["rows"]] == RECORD_STEPS + ["final"]
    assert result["ok"] and result["threshold"] == pytest.approx(0.001)
    assert all(r["p"] == 1.0 and r["port"]["n"] == 8 for r in result["rows"])
    assert os.path.samefile(hunt_check.REFERENCE_H8, os.path.join(R4, "r4_h8_gen2_select.json"))
    assert "hunt 8 (flagship-finetune from agent_s6006)" in hunt_check.reference_name(
        hunt_check.REFERENCE_H8)


@pytest.mark.parametrize("by", [0.02, 0.03])
def test_hunt_check_fails_hunt8_moved_down(records, by):
    """The record's seeds moved down by 0.02 or 0.03 success rate fail the
    gate: hunt 8's seeds sit so close together (0.810-0.886) that a port
    that fine-tunes that much worse is caught (the lowest p 0.00016)."""
    rec = records["r4_h8_gen2_select.json"]
    result = hunt_check.compare(hunt_check.seed_table(_shifted(rec, by)),
                                hunt_check.seed_table(rec))
    assert not result["ok"]
    assert min(r["p"] for r in result["rows"]) < 0.0002


def test_finalist_rule_picks_hunt8s_finalists(records):
    """Candidates that cover all 12 under both eval RNGs, ranked by the lower
    of their two means: 63 of the 80, 5 above 0.87, and the first three are
    the record's n=1000 finalists, each strict there (means 0.8758-0.8822,
    stage_1 1000/1000)."""
    rec, rec777 = records["r4_h8_gen2_select.json"], records["r4_h8_gen2_select777.json"]
    every = hunt_check.finalists(rec, rec777, None)
    assert len(every) == 63 and sum(f["low"] > 0.87 for f in every) == 5
    top = hunt_check.finalists(rec, rec777)
    assert [f["label"] for f in top] == [
        "seed_8004/24117248", "seed_8000/12058624", "seed_8000/15073280"]
    n1000 = records["h8_finalists_n1000.json"]
    assert {f"results/r4_h8_gen2/{hunt_check.agent_file(f['label'])}" for f in top} == set(
        n1000["agents"])
    rows = hunt_check.strict_rows(n1000)
    assert all(r["strict"] and r["cover"] == 12 and r["stage_1"] == (1000, 1000) for r in rows)
    assert sorted(round(r["mean"], 4) for r in rows) == [0.8758, 0.8785, 0.8822]
    assert hunt_check.agent_file("seed_8001/final") == "seed_8001/new_agent.npz"
    with pytest.raises(ValueError, match="different candidates"):
        hunt_check.finalists(rec, {k: v for k, v in rec777.items() if k != "seed_8000/final"})


def test_hunt_check_cli_finalists_and_n1000(capsys):
    """The CLI against hunt 8 with --finalists and --n1000: exit 0, the
    both-RNG count and finalists, each n=1000 agent's strict line."""
    rec = os.path.join(R4, "r4_h8_gen2_select.json")
    assert hunt_check.main([rec, "--reference", hunt_check.REFERENCE_H8, "--finalists",
                            os.path.join(R4, "r4_h8_gen2_select777.json"), "--n1000",
                            os.path.join(R4, "h8_finalists_n1000.json")]) == 0
    out = capsys.readouterr().out
    assert "against the JAX package's hunt 8" in out
    assert "every p >= 0.001: True" in out
    assert "both-RNG cover-12: 63 of 80 candidates; 5 of them with both means above 0.87" in out
    assert "seed_8004/24117248  means 0.8808 / 0.8817  low 0.8808" in out
    assert out.count("strict True") == 3


# -- one population update at the fine-tune's config against JAX's ZooTrainer ----


@pytest.fixture(scope="module")
def jax_finetune_zoo():
    """JAX's ZooTrainer of 3 members at the fine-tune's env and PPO config,
    warm-started from agent_s6006 as its `train_zoo` warm-starts (the
    agent's leaves broadcast over the members): one update gives a
    mid-training state, then the update under test from it with every other
    env near the cap, each member's draws reproduced from its key with its
    rehearsal probabilities.  One compile each of init and update."""
    trainer = jzoo.ZooTrainer(JEnvConfig(**ENV_KW), JPPOConfig(**PPO_KW), N)
    reset = jax.jit(trainer.learner.env.reset_batch, static_argnums=1)
    state = trainer.init(SEEDS)
    loaded = jax_load_params(S6006)
    state = state._replace(params=jax.tree.map(
        lambda x: jnp.broadcast_to(jnp.asarray(x), (len(SEEDS),) + jnp.shape(x)), loaded))
    state, _ = trainer.update(state)
    t = np.stack([_near_cap(np.zeros(N)) for _ in SEEDS])
    state = state._replace(env_state=state.env_state._replace(t=jnp.asarray(t)))
    new_state, metrics = trainer.update(state)
    draws = []
    for m in range(len(SEEDS)):
        member = jax.tree.map(lambda x: x[m], state)
        draws.append(_jax_draws(
            trainer.learner,
            lambda k, n, g, p=member.rehearsal_probs: reset(k, n, g, p), member))
    return dict(state=state, new_state=new_state, metrics=jax.tree.map(np.asarray, metrics),
                draws=draws)


def test_warm_start_gives_every_member_s6006s_leaves():
    """The port's population from agent_s6006: every member's leaves equal
    the agent's exactly, each member in storage of its own."""
    trainer = ZooTrainer(EnvConfig(**ENV_KW), PPOConfig(**PPO_KW), N, device="cpu")
    state = trainer.init(SEEDS, params=load_params(S6006, device="cpu"))
    agent = dict(np.load(S6006))
    for m in range(len(SEEDS)):
        got = params_to_flat(state.params.member(m))
        assert set(got) == set(agent)
        for k, v in agent.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{m} {k}")
    for p in state.params.parameters():
        assert p.stride(0) == p[0].numel()
    np.testing.assert_array_equal(state.rehearsal_probs.numpy(), np.tile(
        trainer.initial_rehearsal_probs().numpy(), (len(SEEDS), 1)))


def test_finetune_zoo_update_matches_jax(jax_finetune_zoo):
    """One population update from the JAX zoo's warm-started, mid-training
    state, each member's JAX draws (its weighted stage-mix template
    included) injected: weights to 1e-3 of the lr x SGD-steps budget and
    metrics to 1e-4 of max(|v|, 1), the tolerances of
    test_zoo_update_matches_jax; the episode counts, step counters and the
    families' counts and wins exactly; the rehearsal probabilities left as
    they were (rehearsal_adapt=False)."""
    run = jax_finetune_zoo
    trainer = ZooTrainer(EnvConfig(**ENV_KW), PPOConfig(**PPO_KW), N, device="cpu")
    state = zoo_state_from_numpy(jax.tree.map(np.asarray, run["state"]),
                                 PPO_KW.get("learning_rate", 3e-4), device="cpu")
    draws = run["draws"]
    new_state, metrics = trainer.update_from(
        state, cat_states([env_state_from_numpy(d[0], device="cpu") for d in draws]),
        torch.tensor(np.concatenate([d[1] for d in draws])),
        torch.tensor(np.stack([d[2] for d in draws], axis=1)),
        torch.tensor(np.stack([d[3] for d in draws])))
    jm = run["metrics"]
    assert set(metrics) == set(jm)
    assert (jm["episodes/episodes"] >= 2).all()
    for k, v in metrics.items():
        assert v.shape == jm[k].shape == (len(SEEDS),), k
        want = jm[k].astype(np.float64)
        assert (np.abs(v.numpy() - want) <= 1e-4 * np.maximum(np.abs(want), 1.0)).all(), k
    for k in ("episodes/episodes", "episodes/total", "global_step",
              "episodes/success_rate", "episodes/failure_rate"):
        np.testing.assert_array_equal(metrics[k].numpy(), jm[k], err_msg=k)
    js = run["new_state"]
    _assert_params_close(new_state.params, js.params, _params_bound(trainer))
    for k in ("global_step", "episodes_total", "family_counts", "family_wins",
              "rehearsal_probs"):
        np.testing.assert_array_equal(getattr(new_state, k).numpy(), np.asarray(getattr(js, k)),
                                      err_msg=k)
    assert float(np.asarray(js.family_counts).sum()) > 0
