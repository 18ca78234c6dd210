"""The seed hunt's learning-parity check, on the CPU.

`drone2d_tpu_torch.scripts.hunt_check` holds a hunt's selection record
against the JAX package's hunt 7 (`artifacts/campaigns/r4/
r4_h7_scratch_pp8_select.json`: flagship-scratch, 24 seeds x 8 checkpoints
x 12 scenarios x 100 episodes) with a two-sided Mann-Whitney U a
checkpoint, Bonferroni over the checkpoints.  Here: `train_zoo`'s snapshot
schedule gives exactly the record's step keys at the recipe's shape; the
gate passes on the record's own seeds 7000-7007 against 7008-7023, fails on
those 8 moved down by 0.08 success rate, refuses a checkpoint that a side
lacks, and imports nothing of the JAX package; the committed port-trained
agents (hunt 7's top final and the fine-tune hunt's best n=1000 finalist,
tests/test_torch_finetune_hunt.py) fly `stage_2` alike in both packages
(two-proportion |z| <= 3, the bar of tests/test_sb3_import.py).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from drone2d_tpu_torch.learn.zoo import snapshot_schedule
from drone2d_tpu_torch.scripts import hunt_check

ROOT = os.path.join(os.path.dirname(__file__), "..")
RECORD_STEPS = ["18743296", "37486592", "56229888", "74973184",
                "93847552", "112590848", "131334144"]
CHECKPOINTS = RECORD_STEPS + ["final"]
Z_MAX, Z_EPISODES = 3.0, 200


@pytest.fixture(scope="module")
def record():
    with open(hunt_check.REFERENCE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def halves(record):
    """The record's seed table split into seeds 7000-7007 and 7008-7023."""
    table = hunt_check.seed_table(record)
    first = {c: {s: v for s, v in per.items() if int(s.split("_")[1]) < 7008}
             for c, per in table.items()}
    rest = {c: {s: v for s, v in per.items() if int(s.split("_")[1]) >= 7008}
            for c, per in table.items()}
    return first, rest


def test_snapshot_schedule_gives_the_record_steps(record):
    """--snapshots 7 --total-timesteps 150000000 at 1024 envs x 128 steps:
    1,145 updates, snapshots after 143, 286, 429, 572, 716, 859 and 1002
    (572 from round-half-even), whose env steps are exactly the record's
    step keys."""
    spu = 1024 * 128
    n_updates, snaps = snapshot_schedule(150_000_000, spu, snapshots=7)
    assert n_updates == 1145
    assert sorted(snaps) == [143, 286, 429, 572, 716, 859, 1002]
    keys = {label.split("/")[1] for label in record}
    assert [str(u * spu) for u in sorted(snaps)] == sorted(keys - {"final"}, key=int)
    assert keys - {"final"} == set(RECORD_STEPS)
    # explicit steps: the first update that reaches each, the end kept
    assert snapshot_schedule(10 * spu, spu, snapshot_steps=[spu, spu + 1, 99 * spu]) == (
        10, {1, 2, 10})
    assert snapshot_schedule(spu, spu, snapshots=3) == (1, set())


def test_compare_passes_on_the_record_halves(halves):
    first, rest = halves
    result = hunt_check.compare(first, rest)
    assert [r["checkpoint"] for r in result["rows"]] == CHECKPOINTS
    assert result["threshold"] == pytest.approx(0.01 / 8)
    assert result["ok"], hunt_check.format_report(result)
    ps = [r["p"] for r in result["rows"]]
    assert 0.06 < min(ps) and max(ps) < 0.93
    for r in result["rows"]:
        assert (r["port"]["n"], r["reference"]["n"]) == (8, 16)


def test_compare_fails_on_a_shift_of_008(halves):
    first, rest = halves
    shifted = {c: {s: v - 0.08 for s, v in per.items()} for c, per in first.items()}
    result = hunt_check.compare(shifted, rest)
    assert not result["ok"]
    failed = [r["checkpoint"] for r in result["rows"] if not r["ok"]]
    assert failed == ["112590848", "final"]
    assert all(r["p"] < 0.0005 for r in result["rows"] if not r["ok"])
    # one checkpoint alone is held at alpha itself
    one = hunt_check.compare(shifted, rest, ["final"])
    assert one["threshold"] == 0.01 and not one["ok"]


def test_compare_refuses_a_missing_checkpoint(halves):
    first, rest = halves
    short = {c: per for c, per in first.items() if c != "final"}
    with pytest.raises(ValueError, match="port record has no checkpoint final"):
        hunt_check.compare(short, rest)
    with pytest.raises(ValueError, match="reference record has no checkpoint final"):
        hunt_check.compare(first, short, CHECKPOINTS)
    with pytest.raises(ValueError, match="port record has no checkpoint 123"):
        hunt_check.compare(first, rest, ["123"])
    with pytest.raises(ValueError, match="no checkpoints"):
        hunt_check.compare(first, rest, [])


def test_seed_table_and_cover_count(record):
    """Each candidate's mean over the 12 scenarios; cover-12 as
    `select_agents` counts coverage: 45 of the record's 192 candidates and
    12 of its 24 finals; a candidate without a scenario is refused."""
    table = hunt_check.seed_table(record)
    assert sorted(table, key=hunt_check.checkpoint_key) == CHECKPOINTS
    assert all(len(per) == 24 for per in table.values())
    per = record["seed_7017/final"]
    assert table["final"]["seed_7017"] == pytest.approx(
        np.mean([v["success_rate"] for v in per.values()]))
    assert hunt_check.cover_count(record) == 45
    assert hunt_check.cover_count(record, finals_only=True) == 12
    cut = {"seed_1/final": {k: v for k, v in per.items() if k != "stage_5"}}
    with pytest.raises(ValueError, match="lacks scenarios"):
        hunt_check.seed_table(cut)


def test_cli_exit_codes(tmp_path, record, capsys):
    """0 on a record that matches, 1 on one that does not, 2 on one that
    lacks a checkpoint."""
    assert hunt_check.main([hunt_check.REFERENCE]) == 0
    assert "cover-12 (port): 45 of 192 candidates, 12 of 24 finals" in capsys.readouterr().out
    low = {k: {s: dict(v, success_rate=v["success_rate"] - 0.2) for s, v in per.items()}
           for k, per in record.items()}
    path = tmp_path / "low.json"
    path.write_text(json.dumps(low))
    assert hunt_check.main([str(path)]) == 1
    assert "FAIL" in capsys.readouterr().out
    finals = {k: v for k, v in record.items() if k.endswith("/final")}
    path.write_text(json.dumps(finals))
    assert hunt_check.main([str(path)]) == 2
    assert hunt_check.main([str(path), "--checkpoints", "final"]) == 0


def test_hunt_check_imports_no_jax():
    code = (
        "import sys\n"
        "import drone2d_tpu_torch.scripts.hunt_check\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'drone2d_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.fixture(scope="module")
def jax_stage2():
    """The JAX package's `run_episodes` on stage_2 x Z_EPISODES stochastic
    episodes from PRNGKey(0), its runner compiled once for every agent of
    one architecture (the weights are an argument of the program)."""
    import jax

    from drone2d_tpu.eval.episode import _episode_runner, _to_results
    from drone2d_tpu.eval.run import load_params as jax_load_params, scenario_config as jax_cfg

    one_episode = _episode_runner(jax_cfg("stage_2"), False, False, 0)
    program = jax.jit(jax.vmap(one_episode, in_axes=(None, 0)))
    keys = jax.random.split(jax.random.PRNGKey(0), Z_EPISODES)
    return lambda path: _to_results(*program(jax_load_params(path), keys))


def _flies_alike(jax_stage2, pattern):
    """The committed agent at `pattern`, flown on stage_2 x Z_EPISODES
    stochastic episodes by the JAX package and by the port, both on the
    CPU: the success rates agree within two-proportion |z| <= Z_MAX.
    Returns the port's successes."""
    from drone2d_tpu_torch.eval.episode import run_episodes
    from drone2d_tpu_torch.eval.run import load_params, scenario_config

    (path,) = glob.glob(os.path.join(ROOT, "artifacts", pattern, "new_agent.npz"))
    n = Z_EPISODES
    want = jax_stage2(path)
    got = run_episodes(scenario_config("stage_2"), load_params(path, device="cpu"), 0, n,
                       device="cpu")
    s_jax, s_port = int(np.asarray(want.success).sum()), int(got.success.sum())
    pooled = (s_jax + s_port) / (2 * n)
    sigma = np.sqrt(pooled * (1 - pooled) * 2 / n)
    z = 0.0 if sigma == 0 else (s_port - s_jax) / n / sigma
    assert abs(z) <= Z_MAX, (s_port, s_jax, z)
    return s_port


def test_port_trained_agent_flies_alike_in_both_packages(jax_stage2):
    """The hunt's top-ranked final, trained by the port on the card, flown
    on stage_2 x 200 stochastic episodes by the JAX package's
    `run_episodes` and by the port's, both on the CPU: the success rates
    agree within two-proportion |z| <= 3."""
    s_port = _flies_alike(jax_stage2, "agent_torch_h7_s*")
    # a trained agent, not a random one
    assert s_port / Z_EPISODES >= 0.5, s_port


def test_port_finetuned_agent_flies_alike_in_both_packages(jax_stage2):
    """The fine-tune hunt's best n=1000 finalist, fine-tuned by the port on
    the card from agent_s6006 and shipped through `package_agent`, flown on
    stage_2 x 200 by both packages: |z| <= 3 (the runner compiled once for
    both hunts' agents, which share one architecture)."""
    s_port = _flies_alike(jax_stage2, "agent_torch_h8_s*")
    assert s_port / Z_EPISODES >= 0.9, s_port
