"""Parity of the port's actor-critic and fused policy sample with the JAX
package, for the flagship and for every depth and width, the agent-file
round trip, and the wrapper's input checks."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.models.policy import (
    flat_dict_to_params as jax_from_flat,
    init_actor_critic as jax_init,
    params_to_flat_dict as jax_to_flat,
    policy_value as jax_policy_value,
    sample_action as jax_sample_action,
)
from drone2d_tpu.ops.pallas_policy import fused_sample_action as jax_fused
from drone2d_tpu_torch.compat.from_jax import params_from_flat, params_to_flat
from drone2d_tpu_torch.models.policy import ActorCritic
from drone2d_tpu_torch.ops.fused_policy import (
    fused_sample_action,
    fused_sample_action_ref,
)

torch.set_num_threads(1)

AGENT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "agent_s8004",
                     "new_agent.npz")
LOG_STD = np.array([-0.3, 0.2], np.float32)


def _agent_flat():
    flat = dict(np.load(AGENT))
    flat["log_std"] = LOG_STD  # non-zero and unequal: exercises exp/affine
    return flat


def _inputs(b=512, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((b, 27)).astype(np.float32)
    noise = rng.standard_normal((b, 2)).astype(np.float32)
    return obs, noise


def _np(t):
    return t.detach().cpu().numpy()


def _assert_close(got, want, tol=1e-5):
    """max |got - want| <= tol * max(1, max |want|).

    Products of the same float32 weights summed in different orders (XLA's
    and PyTorch's matmuls) differ by rounding relative to the size of the
    summed terms, not of the result: the flagship critic's head sums terms
    of ~1e3 to values anywhere from ~0 to ~1e3 (one float32 ulp at 1e3 is
    6e-5).  So the error is held relative to the output's largest magnitude.
    """
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (err, np.abs(want).max())


def test_fused_sample_matches_jax_kernel_and_sample_action():
    """B=512, H=128, the flagship agent's weights, 1e-5 of each output's
    scale (see _assert_close); log_prob does not pass through the network
    and agrees to 1e-6 absolute."""
    flat = _agent_flat()
    obs, noise = _inputs()
    params = params_from_flat(flat, device="cpu")
    act, logp, val = fused_sample_action(params, torch.as_tensor(obs), torch.as_tensor(noise))

    jparams = jax_from_flat(flat)
    ja, jl, jv = jax_fused(jparams, jnp.asarray(obs), jnp.asarray(noise),
                           block=256, interpret=True)
    key = jax.random.PRNGKey(3)
    jnoise = np.array(jax.random.normal(key, (512, 2), jnp.float32))
    sa, sl, sv = jax_sample_action(jparams, jnp.asarray(obs), key)
    act2, logp2, val2 = fused_sample_action(params, torch.as_tensor(obs),
                                            torch.as_tensor(jnoise))
    for got, want in ((act, ja), (val, jv), (act2, sa), (val2, sv)):
        _assert_close(_np(got), want)
    for got, want in ((logp, jl), (logp2, sl)):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
    assert np.abs(np.asarray(jv)).max() > 100.0  # the large-value regime


def test_policy_value_and_deterministic_action_match_jax():
    flat = _agent_flat()
    obs, _ = _inputs(256, seed=1)
    params = params_from_flat(flat, device="cpu")
    mean, log_std, value = params.policy_value(torch.as_tensor(obs))
    jm, jls, jv = jax_policy_value(jax_from_flat(flat), jnp.asarray(obs))
    _assert_close(_np(mean), jm)
    np.testing.assert_array_equal(_np(log_std), jls)
    _assert_close(_np(value), jv)
    det = _np(params.deterministic_action(torch.as_tensor(obs)))
    _assert_close(det, np.clip(np.asarray(jm), -1, 1))
    assert det.min() >= -1.0 and det.max() <= 1.0


def _random_flat(hidden, seed):
    """An actor-critic of any hidden sizes as the `.npz` dict: weights and
    non-zero biases from one numpy seed."""
    rng = np.random.default_rng(seed)
    dims = [27, *hidden]
    flat = {"log_std": LOG_STD}
    for trunk in ("pi", "vf"):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            flat[f"{trunk}{i}/w"] = (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
            flat[f"{trunk}{i}/b"] = (0.1 * rng.standard_normal(b)).astype(np.float32)
    for name, n_out in (("pi_out", 2), ("vf_out", 1)):
        flat[f"{name}/w"] = rng.standard_normal((hidden[-1], n_out)).astype(np.float32)
        flat[f"{name}/b"] = (0.1 * rng.standard_normal(n_out)).astype(np.float32)
    return flat


@pytest.mark.parametrize("hidden", [(32, 32), (64,), (64, 64, 64), (96, 96)],
                         ids=lambda h: "x".join(map(str, h)))
def test_sample_action_any_hidden_matches_jax(hidden):
    """On the CPU the port samples for every actor-critic the JAX package
    builds (the kernel's shape rules apply on the card only): its sample
    matches the JAX package's policy_value plus the same injected noise, to
    1e-5 of each output's scale, and log-prob to 1e-6 absolute."""
    flat = _random_flat(hidden, seed=len(hidden) * 1000 + hidden[0])
    obs, noise = _inputs(256, seed=hidden[0])
    params = params_from_flat(flat, device="cpu")
    act, logp, val = params.sample_action(torch.as_tensor(obs), noise=torch.as_tensor(noise))
    jm, jls, jv = jax_policy_value(jax_from_flat(flat), jnp.asarray(obs))
    jls = np.asarray(jls)
    _assert_close(_np(act), np.asarray(jm) + np.exp(jls) * noise)
    _assert_close(_np(val), jv)
    want_logp = np.sum(-0.5 * (noise**2 + math.log(2 * math.pi)) - jls, axis=-1)
    np.testing.assert_allclose(_np(logp), want_logp, rtol=0, atol=1e-6)


def test_sample_action_draws_noise_from_generator():
    params = ActorCritic(27, 2, (64, 64), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    obs = torch.as_tensor(_inputs(64)[0])
    a1 = params.sample_action(obs, generator=torch.Generator().manual_seed(5))
    a2 = params.sample_action(obs, generator=torch.Generator().manual_seed(5))
    for x, y in zip(a1, a2):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    noise = torch.randn(64, 2, generator=torch.Generator().manual_seed(5))
    ref = fused_sample_action_ref(params, obs, noise)
    for x, y in zip(a1, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_flat_dict_round_trip():
    """The agent file loads into the port and writes back unchanged, and the
    JAX package reads the port's dict back to the same leaves."""
    flat = dict(np.load(AGENT))
    params = params_from_flat(flat, device="cpu")
    back = params_to_flat(params)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    jback = jax_to_flat(jax_from_flat(back))
    for k in flat:
        np.testing.assert_array_equal(np.asarray(jback[k]), flat[k], err_msg=k)


def test_orthogonal_init():
    """SB3 init: orthogonal weights with gains sqrt(2) / 0.01 / 1, zero
    biases and log_std, the JAX package's layout."""
    params = ActorCritic(27, 2, (128, 128), generator=torch.Generator().manual_seed(1),
                         device="cpu")
    flat = params_to_flat(params)
    ref = jax_to_flat(jax_init(jax.random.PRNGKey(0), 27, 2, (128, 128)))
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}
    for k, gain in (("pi0/w", 2.0), ("pi1/w", 2.0), ("vf1/w", 2.0),
                    ("pi_out/w", 1e-4), ("vf_out/w", 1.0)):
        w = flat[k].astype(np.float64)
        gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        np.testing.assert_allclose(gram, gain * np.eye(len(gram)), atol=1e-5 * max(gain, 1),
                                   err_msg=k)
    for k in flat:
        if k.endswith("/b") or k == "log_std":
            assert not flat[k].any(), k


def _bad(params, obs, noise):
    with pytest.raises(ValueError):
        fused_sample_action(params, obs, noise)


def test_wrapper_rejects_bad_inputs():
    params = params_from_flat(dict(np.load(AGENT)), device="cpu")
    obs, noise = (torch.as_tensor(x) for x in _inputs(32))
    _bad(params, obs[:, :26], noise)                 # wrong obs width
    _bad(params, obs[None], noise)                   # wrong obs rank
    _bad(params, obs, noise[:16])                    # noise batch mismatch
    _bad(params, obs, noise[:, :1])                  # noise width
    _bad(params, obs.double(), noise)                # dtype
    _bad(params, obs.t().contiguous().t(), noise)    # non-contiguous
    # any depth and width runs on the CPU (test_sample_action_any_hidden_...);
    # the kernel's architecture checks apply on the card only
    # (tests/test_torch_cuda.py::test_depth_three_raises_on_card_and_runs_on_cpu)
