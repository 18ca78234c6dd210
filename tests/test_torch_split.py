"""The split-carry step (`env/types.py` EpisodeStatic / EpisodeDyn /
finalize_split, `Drone2DEnv.step_autoreset_split`) on the CPU.

Against the port's own template step it is bit-exact over a chunk: every
step's observation, reward, done and info equal, and `finalize_split` gives
back the template variant's state (the JAX package's
`tests/test_env.py::test_split_carry_bitexact`).  Against the JAX package's
`step_autoreset_split` it is teacher-forced: at each step of a JAX split
trajectory the port is fed JAX's carry (a random `fresh` mask to start, so
that both blends are taken) and must give the same outputs, at the float32
bounds of `tests/test_torch_env.py` (the flags, `t`, `fresh` and every
integer leaf exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig
from drone2d_tpu.env import env as jenv
from drone2d_tpu.env import types as jtypes
from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy, flatten_fields
from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.env.types import (
    EpisodeDyn,
    cat_states,
    finalize_split,
    merge_state,
    split_state,
)
from tests.test_torch_env import _check_step, _concat

torch.set_num_threads(1)

N, T = 96, 48
STAGE_STEPS = (8e5, 1.8e6, 3e6)  # stages 2, 4, 5


def _equal_trees(a, b):
    if dataclasses.is_dataclass(a):
        return all(_equal_trees(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return (a is None and b is None) or torch.equal(a, b)


def _start(env, gen):
    """N envs over three stages, every other env a few steps from the cap
    so that episodes end (and some envs end twice) inside the chunk."""
    parts = [env.reset_batch(gen, N // 3, gs) for gs in STAGE_STEPS]
    state, obs = cat_states([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    k = torch.arange(N)
    state.t = torch.where(k % 2 == 0, env.cfg.n_steps - 2 - k % 9, state.t).to(torch.int32)
    return state, obs


def test_split_chunk_bit_exact_against_template():
    env = Drone2DEnv(EnvConfig(path_table_n=128), device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = _start(env, gen)
    tmpl, tmpl_obs = _start(env, gen)
    actions = torch.rand(T, N, 2, generator=gen) * 2.0 - 1.0

    init_static, dyn = split_state(state)
    tmpl_static, tmpl_dyn = split_state(tmpl)
    fresh = torch.zeros(N, dtype=torch.bool)
    ends = 0
    for t in range(T):
        out = env.step_batch_template(state, actions[t], tmpl, tmpl_obs)
        dyn, fresh, o, r, d, info = env.step_batch_split(
            dyn, fresh, actions[t], init_static, tmpl_static, tmpl_dyn, tmpl_obs)
        assert torch.equal(o, out.obs) and torch.equal(r, out.reward), t
        assert torch.equal(d, out.done), t
        for k in out.info:
            assert torch.equal(info[k], out.info[k]), (t, k)
        assert _equal_trees(dyn, split_state(out.state)[1]), t
        state, ends = out.state, ends + int(d.sum())
    assert ends >= N // 2 and int(fresh.sum()) >= N // 2
    assert _equal_trees(finalize_split(init_static, tmpl_static, fresh, dyn), state)
    # the split round trip, and an env that never reset keeps its own statics
    assert _equal_trees(merge_state(*split_state(state)), state)
    keep = ~fresh
    assert torch.equal(state.path.wps[keep], init_static.path.wps[keep])


@pytest.fixture(scope="module")
def jax_split_run():
    """A JAX split-carry trajectory of N envs x 8 steps; each step's input
    carry and output, flattened to (8 N, ...)."""
    jenv_ = jenv.Drone2DEnv(JEnvConfig(path_table_n=128))
    reset = jax.jit(jenv_.reset_batch, static_argnums=1)

    def batch(seed):
        parts = [reset(jax.random.PRNGKey(seed + i), N // 3, jnp.float32(gs))
                 for i, gs in enumerate(STAGE_STEPS)]
        return _concat([p[0] for p in parts]), jnp.concatenate([p[1] for p in parts])

    state, _ = batch(0)
    tmpl, tmpl_obs = batch(10)
    k = np.arange(N)
    state = state._replace(t=jnp.asarray(
        np.where(k % 2 == 0, jenv_.cfg.n_steps - 2 - k % 5, np.asarray(state.t)), jnp.int32))
    init_static, dyn = jtypes.split_state(state)
    tmpl_static, tmpl_dyn = jtypes.split_state(tmpl)
    rng = np.random.default_rng(1)
    fresh = jnp.asarray(rng.random(N) < 0.3)
    actions = rng.uniform(-1, 1, (8, N, 2)).astype(np.float32)

    @jax.jit
    def run(dyn, fresh):
        def body(carry, a):
            d, f = carry
            out = jenv_.step_batch_split(d, f, a, init_static, tmpl_static, tmpl_dyn, tmpl_obs)
            return (out[0], out[1]), ((d, f), out)
        return jax.lax.scan(body, (dyn, fresh), actions)[1]

    (pre_dyn, pre_fresh), outs = run(dyn, fresh)
    flat = lambda x: np.asarray(x).reshape((-1,) + x.shape[2:])  # noqa: E731
    tile = lambda x: np.tile(np.asarray(x), (8,) + (1,) * (x.ndim - 1))  # noqa: E731
    return dict(pre_dyn=jax.tree.map(flat, pre_dyn), pre_fresh=flat(pre_fresh),
                outs=jax.tree.map(flat, outs), actions=actions.reshape(-1, 2),
                init_static=jax.tree.map(tile, init_static),
                tmpl_static=jax.tree.map(tile, tmpl_static),
                tmpl_dyn=jax.tree.map(tile, tmpl_dyn), tmpl_obs=tile(tmpl_obs))


def _state(static, dyn):
    """A port EnvState from JAX's (static, dyn) numpy trees."""
    return env_state_from_numpy(jtypes.merge_state(static, dyn), device="cpu")


def test_step_autoreset_split_matches_jax(jax_split_run):
    run = jax_split_run
    env = Drone2DEnv(EnvConfig(path_table_n=128), device="cpu")
    init_static = split_state(_state(run["init_static"], run["pre_dyn"]))[0]
    tmpl_static, tmpl_dyn = split_state(_state(run["tmpl_static"], run["tmpl_dyn"]))
    dyn = split_state(_state(run["init_static"], run["pre_dyn"]))[1]
    fresh = torch.tensor(run["pre_fresh"])
    new_dyn, new_fresh, obs, reward, done, info = env.step_autoreset_split(
        dyn, fresh, torch.as_tensor(run["actions"]), init_static, tmpl_static, tmpl_dyn,
        torch.as_tensor(run["tmpl_obs"]))
    w_dyn, w_fresh, w_obs, w_reward, w_done, w_info = run["outs"]
    np.testing.assert_array_equal(new_fresh.numpy(), w_fresh)
    assert w_done.sum() >= N // 2 and w_fresh.sum() > run["pre_fresh"].sum()
    # the outputs and the next dyn carry at test_torch_env's bounds (the
    # statics are inputs, carried unchanged, so the whole state compares)
    got = dict(obs=obs, reward=reward, done=done, info=info,
               state=merge_state(init_static, new_dyn))
    want = dict(obs=w_obs, reward=w_reward, done=w_done, info=w_info,
                state=jtypes.merge_state(run["init_static"], w_dyn))
    _check_step(_Out(**got), _Out(**want))
    assert isinstance(new_dyn, EpisodeDyn)
    assert sorted(flatten_fields(new_dyn)) == sorted(flatten_fields(w_dyn))


@dataclasses.dataclass
class _Out:
    obs: object
    reward: object
    done: object
    info: object
    state: object
