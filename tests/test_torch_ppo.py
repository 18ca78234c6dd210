"""The port's PPO update against the JAX package's, on the CPU.

The same inputs go through both: the flagship agent or a JAX-initialised
(32, 32) actor-critic, a JAX rollout batch, and the JAX update's own draws
(its reset template, action noise and minibatch permutations, reproduced
from its key as `drone2d_tpu/learn/ppo.py` splits it).  Both start from a
mid-training state: the JAX package's parameters and Adam state after one
update, carried across by `params_from_flat` and `opt_state_from_numpy`.
Also: the clip-plus-Adam step against optax, the learner's config checks,
and the static stage-rehearsal mix of `reset_batch`.
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig, PPOConfig as JPPOConfig
from drone2d_tpu.learn.gae import compute_gae as jax_gae
from drone2d_tpu.learn.ppo import PPOLearner as JPPOLearner, TrainState as JTrainState
from drone2d_tpu.models.policy import (
    action_log_prob_entropy as jax_alpe,
    flat_dict_to_params as jax_from_flat,
    init_actor_critic as jax_init,
    params_to_flat_dict as jax_to_flat,
)
from drone2d_tpu_torch.compat.from_jax import (
    env_state_from_numpy,
    env_state_to_numpy,
    opt_state_from_numpy,
    params_from_flat,
    params_to_flat,
)
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner, RolloutBatch, TrainState, affine_perm
from drone2d_tpu_torch.models.policy import ActorCritic, state_dict_key

torch.set_num_threads(1)

AGENT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "agent_s8004",
                     "new_agent.npz")
N, T, HIDDEN = 16, 8, (32, 32)
SHUFFLES = ("exact", "affine", "timeperm")
LR = 3e-4
GLOBAL_STEP = 8e5  # curriculum stage 2: random spawns, no obstacles
ENV_KW = dict(path_table_n=128)


def _ppo_kw(shuffle):
    return dict(n_steps=T, num_minibatches=4, n_epochs=2, shuffle=shuffle,
                hidden_sizes=HIDDEN, learning_rate=LR)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scaled_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _leaf_err(got, want):
    """max |got - want| / max |want|: a gradient leaf's error relative to
    its own largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_draws(jl, reset, state):
    """What JAX's `update(state)` draws from state.rng: the reset template
    (made by `reset`, the jitted `reset_batch`), the (T, N, 2) action noise
    and the (n_epochs, ...) shuffles."""
    cfg, B = jl.cfg, jl.cfg.n_steps * jl.num_envs
    template_key, rng = jax.random.split(state.rng)
    reset_state, reset_obs = reset(template_key, jl.num_envs, state.global_step)
    noise = []
    for _ in range(cfg.n_steps):
        rng, k_act = jax.random.split(rng)
        noise.append(np.asarray(jax.random.normal(k_act, (jl.num_envs, 2), jnp.float32)))
    perms = []
    for _ in range(cfg.n_epochs):
        rng, k_perm = jax.random.split(rng)
        if cfg.shuffle == "exact":
            perm = jax.random.permutation(k_perm, B)
        elif cfg.shuffle == "timeperm":
            perm = jax.random.permutation(k_perm, cfg.n_steps)
        else:
            ka, kb = jax.random.split(k_perm)
            a = (jax.random.randint(ka, (), 0, B // 2) * 2 + 1).astype(jnp.uint32)
            b = jax.random.randint(kb, (), 0, B).astype(jnp.uint32)
            perm = (a * jnp.arange(B, dtype=jnp.uint32) + b) % B
        perms.append(np.asarray(perm))
    return (jax.tree.map(np.asarray, reset_state), np.asarray(reset_obs), np.stack(noise),
            np.stack(perms).astype(np.int64))


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX update (exact) from init gives the mid-training state; the
    update under test then runs from it in each shuffle mode, at stage 2,
    with every other env close to the episode cap so that episodes end and
    auto-reset inside the rollout."""
    learners = {s: JPPOLearner(JEnvConfig(**ENV_KW), JPPOConfig(**_ppo_kw(s)), N)
                for s in SHUFFLES}
    # one compile per JAX function: the jitted callables are made once
    updates = {s: jax.jit(jl.update) for s, jl in learners.items()}
    reset = jax.jit(learners["exact"].env.reset_batch, static_argnums=1)
    params = jax_init(jax.random.PRNGKey(0), 27, 2, HIDDEN)
    env_state, obs = reset(jax.random.PRNGKey(1), N, jnp.float32(0.0))
    state = JTrainState(
        params=params, opt_state=learners["exact"].tx.init(params), env_state=env_state,
        obs=obs, rng=jax.random.PRNGKey(2), global_step=jnp.float32(0.0),
        episodes_total=jnp.float32(0.0), rehearsal_probs=jnp.zeros(7),
        family_counts=jnp.zeros(8), family_wins=jnp.zeros(8),
    )
    state, _ = updates["exact"](state)
    t0 = np.where(np.arange(N) % 2 == 0, JEnvConfig().n_steps - 1 - np.arange(N) % 6, 0)
    state = state._replace(
        global_step=jnp.float32(GLOBAL_STEP),
        env_state=state.env_state._replace(t=jnp.asarray(t0, jnp.int32)),
    )
    batch, last_values = jax.jit(learners["exact"].rollout)(state)[1:3]
    out = {"state": state, "batch": jax.tree.map(np.asarray, batch),
           "last_values": np.asarray(last_values)}
    for s, jl in learners.items():
        new_state, metrics = updates[s](state)
        out[s] = dict(new_state=new_state, metrics=jax.tree.map(np.asarray, metrics),
                      draws=_jax_draws(jl, reset, state))
    return out


def _port_state(learner, js):
    """The port's TrainState from the JAX one: params, Adam, envs, counters."""
    params = params_from_flat({k: np.asarray(v) for k, v in jax_to_flat(js.params).items()},
                              device="cpu")
    opt = optim.adam(params.parameters(), learner.cfg.learning_rate)
    opt_state_from_numpy(opt, params, jax.tree.map(np.asarray, js.opt_state[1][0]))
    return TrainState(
        params=params, optimizer=opt,
        env_state=env_state_from_numpy(jax.tree.map(np.asarray, js.env_state), device="cpu"),
        obs=torch.tensor(np.asarray(js.obs)), generator=torch.Generator(),
        global_step=torch.tensor(float(js.global_step)),
        episodes_total=torch.tensor(float(js.episodes_total)),
    )


def _params_bound(learner):
    """Adam moves a parameter by at most ~lr a step, so `lr x SGD steps`
    bounds how far either package's parameters travel in one update.  The
    two updates see the same data and differ by float32 rounding, which
    Adam's normalised step does not amplify (eps 1e-5 keeps the step of a
    near-zero gradient near zero); they are held to 1e-3 of that budget."""
    cfg = learner.cfg
    return 1e-3 * cfg.learning_rate * cfg.n_epochs * cfg.num_minibatches


def _assert_params_close(params, jax_params, bound):
    want = {k: np.asarray(v) for k, v in jax_to_flat(jax_params).items()}
    got = params_to_flat(params)
    assert set(got) == set(want)
    for k in want:
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        assert err <= bound, (k, err, bound)


# -- the actor-critic's update pass ----------------------------------------


def _agent_flat(case):
    if case == "flagship":
        flat = dict(np.load(AGENT))
    else:
        rng = np.random.default_rng(1)
        shapes = params_to_flat(ActorCritic(27, 2, HIDDEN, device="cpu"))
        flat = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
                for k, v in shapes.items()}
    flat["log_std"] = np.array([-0.3, 0.2], np.float32)
    return flat


@pytest.mark.parametrize("case", ["flagship", "32x32"])
def test_action_log_prob_entropy_matches_jax(case):
    """Values to 1e-5 of each output's scale (float32 products summed in
    another order, as in tests/test_torch_policy.py); the gradients of a
    weighted sum of all three outputs, by torch.autograd and jax.grad, to
    1e-4 of each leaf's largest magnitude (the backward pass sums B
    rounding-level differences into each leaf)."""
    flat = _agent_flat(case)
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((256, 27)).astype(np.float32)
    act = (2.0 * rng.standard_normal((256, 2))).astype(np.float32)
    w = rng.standard_normal((3, 256)).astype(np.float32)

    def jax_obj(p):
        lp, ent, v = jax_alpe(p, jnp.asarray(obs), jnp.asarray(act))
        return jnp.sum(w[0] * lp) + jnp.sum(w[1] * ent) + jnp.sum(w[2] * v) / 100.0

    jp = jax_from_flat(flat)
    want = [np.asarray(x) for x in jax_alpe(jp, jnp.asarray(obs), jnp.asarray(act))]
    want_grad = {k: np.asarray(v) for k, v in jax_to_flat(jax.grad(jax_obj)(jp)).items()}

    params = params_from_flat(flat, device="cpu")
    got = params.action_log_prob_entropy(torch.tensor(obs), torch.tensor(act))
    for g, wv in zip(got, want):
        assert g.shape == wv.shape
        assert _scaled_err(_np(g), wv) <= 1e-5
    wt = torch.tensor(w)
    obj = (wt[0] * got[0]).sum() + (wt[1] * got[1]).sum() + (wt[2] * got[2]).sum() / 100.0
    obj.backward()
    grads = _flat_grads(params)
    for k, g in want_grad.items():
        assert _leaf_err(grads[k], g) <= 1e-4, (k, _leaf_err(grads[k], g))

    # the entropy's gradient reaches log_std only: d/d log_std of its sum is B
    fresh = params_from_flat(flat, device="cpu")
    fresh.action_log_prob_entropy(torch.tensor(obs), torch.tensor(act))[1].sum().backward()
    for name, p in fresh.named_parameters():
        if name == "log_std":
            torch.testing.assert_close(p.grad, torch.full((2,), 256.0))
        else:
            assert p.grad is None, name


def _flat_grads(params):
    """{agent-file name: gradient as numpy} of a port actor-critic."""
    by_key = dict(params.named_parameters())
    return {k: _np(by_key[state_dict_key(k)].grad) for k in params_to_flat(params)}


# -- the loss ----------------------------------------------------------------


@pytest.mark.parametrize("old_logp", ["rollout", "shifted"])
def test_loss_fn_matches_jax(jax_runs, old_logp):
    """loss_fn and its gradients on the JAX rollout batch (all T*N samples
    as one minibatch, GAE by the JAX package), at the rollout's own
    parameters: with the rollout's log-probs (every ratio 1), and with them
    shifted by 0.3 N(0, 1) so that ratios spread and the clip acts.  Loss
    and aux to 1e-5 of max(|value|, 1): float32 means of 128 terms in
    another order, where the policy loss at ratio 1 (a mean of normalised
    advantages) and approx_kl (of log-prob differences) are means of O(1)
    terms that cancel to ~1e-8.  Each gradient leaf to 1e-4 of its largest
    magnitude (the backward pass sums 128 rounding-level differences into
    it)."""
    js, jb = jax_runs["state"], jax_runs["batch"]
    adv, ret = (np.asarray(x) for x in jax_gae(jb.rewards, jb.values, jb.dones,
                                                jax_runs["last_values"], gamma=0.99,
                                                gae_lambda=0.95))
    logp = jb.log_probs
    if old_logp == "shifted":
        logp = logp + 0.3 * np.random.default_rng(3).standard_normal(logp.shape).astype(np.float32)
    flat_in = [x.reshape((T * N,) + x.shape[2:]) for x in (jb.obs, jb.actions, logp, adv, ret)]
    jl = JPPOLearner(JEnvConfig(**ENV_KW), JPPOConfig(**_ppo_kw("exact")), N)
    (jloss, jaux), jgrads = jax.value_and_grad(jl.loss_fn, has_aux=True)(
        js.params, *map(jnp.asarray, flat_in))

    learner = PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw("exact")), N, device="cpu")
    params = params_from_flat({k: np.asarray(v) for k, v in jax_to_flat(js.params).items()},
                              device="cpu")
    loss, aux = learner.loss_fn(params, *map(torch.tensor, flat_in))
    loss.backward()
    assert set(aux) == set(jaux)
    for k, got, want in [("loss", loss, jloss), *((k, aux[k], jaux[k]) for k in aux)]:
        got, want = float(got.detach()), float(want)
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (k, got, want)
    assert (float(jaux["clip_fraction"]) > 0.1) == (old_logp == "shifted")
    grads = _flat_grads(params)
    for k, g in jax_to_flat(jgrads).items():
        assert _leaf_err(grads[k], g) <= 1e-4, (k, _leaf_err(grads[k], g))


# -- the optimizer -----------------------------------------------------------


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_clip_adam_matches_optax(clip):
    """clip_by_global_norm_ + Adam against optax.chain(clip_by_global_norm(0.5),
    adam(3e-4, eps=1e-5)) over 5 steps of fixed gradients (global norm ~8
    or ~0.05).  The clipped gradients, Adam's two moments and the
    parameters after each step agree to 1e-6 of each leaf's largest
    magnitude: the same algebra, rounded in another order (torch's moment
    update is a lerp, and it computes the bias corrections in double where
    optax uses float32)."""
    rng = np.random.default_rng(4)
    shapes = {k: v.shape for k, v in params_to_flat(ActorCritic(27, 2, HIDDEN,
                                                                device="cpu")).items()}
    scale = 0.05 if clip == "active" else 3e-4
    start = {k: rng.standard_normal(sh).astype(np.float32) for k, sh in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(sh)).astype(np.float32)
              for k, sh in shapes.items()} for _ in range(5)]

    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(LR, eps=1e-5))
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    opt_state = tx.init(jp)
    params = params_from_flat(start, device="cpu")
    by_name = {k: dict(params.named_parameters())[state_dict_key(k)] for k in shapes}
    opt = optim.adam(params.parameters(), LR)
    for g in grads:
        norm = float(np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in g.values())))
        assert (norm > 0.5) == (clip == "active")
        # the clip alone, against optax's
        want_clip, _ = optax.clip_by_global_norm(0.5).update(
            {k: jnp.asarray(v) for k, v in g.items()}, optax.EmptyState())
        leaves = [torch.tensor(g[k]) for k in shapes]
        got_norm = optim.clip_by_global_norm_(leaves, 0.5)
        assert abs(float(got_norm) - norm) <= 1e-6 * norm
        for k, leaf in zip(shapes, leaves):
            assert _leaf_err(_np(leaf), want_clip[k]) <= 1e-6, k
            if clip == "inactive":
                np.testing.assert_array_equal(_np(leaf), g[k])
            by_name[k].grad = leaf
        opt.step()
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        adam_state = opt_state[1][0]
        for k in shapes:
            assert _leaf_err(_np(by_name[k]), jp[k]) <= 1e-6, k
            moments = opt.state[by_name[k]]
            assert float(moments["step"]) == int(adam_state.count)
            assert _leaf_err(_np(moments["exp_avg"]), adam_state.mu[k]) <= 1e-6, k
            assert _leaf_err(_np(moments["exp_avg_sq"]), adam_state.nu[k]) <= 1e-6, k


# -- learn_from and the whole update ------------------------------------------


def _port_batch(jb):
    return RolloutBatch(**{f: torch.tensor(np.asarray(getattr(jb, f)))
                           for f in RolloutBatch.__dataclass_fields__})


@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_learn_from_matches_jax(jax_runs, shuffle):
    """GAE, 2 epochs x 4 minibatches of SGD on the JAX rollout batch with
    the JAX update's own shuffles, from the JAX parameters and Adam state
    after one update (count 8, so the bias correction is mid-way): the
    parameters after the update agree with the JAX update's to 1e-3 of the
    lr x SGD-steps budget (see _params_bound), and the SGD metrics to 1e-5
    of max(|value|, 1), as in test_loss_fn_matches_jax."""
    learner = PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw(shuffle)), N, device="cpu")
    state = _port_state(learner, jax_runs["state"])
    assert int(np.asarray(jax_runs["state"].opt_state[1][0].count)) == 8
    perms = torch.tensor(jax_runs[shuffle]["draws"][3])
    metrics = learner.learn_from(state, _port_batch(jax_runs["batch"]),
                                 torch.tensor(jax_runs["last_values"]), perms)
    _assert_params_close(state.params, jax_runs[shuffle]["new_state"].params,
                         _params_bound(learner))
    jm = jax_runs[shuffle]["metrics"]
    for k, v in metrics.items():
        assert abs(float(v) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1.0), k
    # the next step starts from the same Adam moments
    count = int(np.asarray(jax_runs[shuffle]["new_state"].opt_state[1][0].count))
    assert count == 16
    assert all(float(s["step"]) == count for s in state.optimizer.state.values())


def test_update_matches_jax(jax_runs):
    """One whole update ('timeperm', the flagship recipe's shuffle) from an
    identical mid-training state at stage 2, hidden (32, 32), with the JAX
    update's template, noise and shuffles injected.  The rollouts agree as
    in tests/test_torch_rollout.py (equal dones, float32-level drift over 8
    steps), and the SGD that follows adds no more than in
    test_learn_from_matches_jax: parameters to the same 1e-3 of the lr x
    SGD-steps budget, the metrics to 1e-4 of max(|value|, 1) (the episode
    sums carry the rollout's drift), the episode counts and the step
    counter exactly."""
    shuffle = "timeperm"
    learner = PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw(shuffle)), N, device="cpu")
    state = _port_state(learner, jax_runs["state"])
    reset_state, reset_obs, noise, perms = jax_runs[shuffle]["draws"]
    new_state, metrics = learner.update_from(
        state, env_state_from_numpy(reset_state, device="cpu"), torch.tensor(reset_obs),
        torch.tensor(noise), torch.tensor(perms))
    jm = jax_runs[shuffle]["metrics"]
    assert set(metrics) == set(jm)
    assert float(jm["episodes/episodes"]) >= 4
    for k in ("episodes/episodes", "episodes/total", "global_step",
              "episodes/success_rate", "episodes/failure_rate"):
        assert float(metrics[k]) == float(jm[k]), k
    for k, v in metrics.items():
        assert abs(float(v) - float(jm[k])) <= 1e-4 * max(abs(float(jm[k])), 1.0), k
    _assert_params_close(new_state.params, jax_runs[shuffle]["new_state"].params,
                         _params_bound(learner))
    assert float(new_state.global_step) == float(jax_runs[shuffle]["new_state"].global_step)
    assert float(new_state.episodes_total) == float(jax_runs[shuffle]["new_state"].episodes_total)


# -- the learner's checks and shuffles ----------------------------------------


@pytest.mark.parametrize("num_envs, ppo_kw", [
    (8, dict(n_steps=6, num_minibatches=4)),                     # batch % minibatches
    (8, dict(n_steps=8, num_minibatches=4, shuffle="bogus")),    # unknown shuffle
    (3, dict(n_steps=8, num_minibatches=4, shuffle="affine")),   # affine: batch 24
    (8, dict(n_steps=6, num_minibatches=3, shuffle="timeperm")),  # fine: 6 % 3 == 0
    (8, dict(n_steps=6, num_minibatches=4, shuffle="timeperm")),  # batch % minibatches
    (16, dict(n_steps=6, num_minibatches=4, shuffle="timeperm")),  # n_steps % minibatches
], ids=["divisible", "mode", "affine_pow2", "timeperm_ok", "timeperm_batch", "timeperm_steps"])
def test_learner_checks_config_as_jax(num_envs, ppo_kw):
    """The constructor raises the JAX learner's ValueError, message and all,
    and accepts what it accepts."""
    try:
        JPPOLearner(JEnvConfig(), JPPOConfig(**ppo_kw), num_envs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PPOLearner(EnvConfig(), PPOConfig(**ppo_kw), num_envs, device="cpu")
        assert str(got.value) == str(e)
    else:
        PPOLearner(EnvConfig(), PPOConfig(**ppo_kw), num_envs, device="cpu")


def test_affine_perm_matches_jax_uint32():
    """(a*i + b) mod B in int64 equals the JAX package's uint32 arithmetic,
    which wraps at 2^32, for a batch large enough that a*i wraps."""
    B = 2**20
    a = np.array([[1], [B // 2 - 1], [2 * 123457 + 1]], np.int64)
    b = np.array([[0], [B - 1], [98765]], np.int64)
    want = (jnp.asarray(a, jnp.uint32) * jnp.arange(B, dtype=jnp.uint32)
            + jnp.asarray(b, jnp.uint32)) % B
    got = affine_perm(torch.tensor(a), torch.tensor(b), B)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_draw_perms_are_shuffles(shuffle):
    """update() draws one permutation an epoch of the flat batch (exact,
    affine) or of the time axis (timeperm), each a bijection."""
    learner = PPOLearner(EnvConfig(), PPOConfig(**_ppo_kw(shuffle)), N, device="cpu")
    perms = _np(learner.draw_perms(torch.Generator().manual_seed(0)))
    n = T if shuffle == "timeperm" else T * N
    assert perms.shape == (2, n)
    for row in perms:
        np.testing.assert_array_equal(np.sort(row), np.arange(n))
    assert not np.array_equal(perms[0], perms[1])
    if shuffle == "affine":
        a = (perms[:, 1] - perms[:, 0]) % n
        assert (a % 2 == 1).all()
        np.testing.assert_array_equal(perms, (a[:, None] * np.arange(n) + perms[:, :1]) % n)


# -- the static stage-rehearsal mix ---------------------------------------------


def _reset(seed=7, n=64, global_step=0.0, **kw):
    env = Drone2DEnv(EnvConfig(**ENV_KW, **kw), device="cpu")
    return env.reset_batch(torch.Generator().manual_seed(seed), n, global_step)


def test_stage_mix_one_replaces_every_stage():
    """stage_mix_prob=1: every env rehearses a uniform stage 1..5, recorded
    as its family, with that stage's obstacle field drawn as a forced stage
    (gs = -1: stage 4's on-path obstacle then always spawns, where the
    schedule at step 0 would give it 0.6)."""
    state, obs = _reset(n=512, stage_mix_prob=1.0)
    fam = _np(state.family)
    assert set(np.unique(fam)) == {1, 2, 3, 4, 5}
    mask = _np(state.obstacles.mask)
    m = EnvConfig().max_curriculum_obs
    near, on = mask[:, :m].sum(1), mask[:, m]
    assert (mask[:, m + 1:] == 0).all()
    assert (near[fam <= 2] == 0).all() and (on[fam <= 2] == 0).all()
    assert (near[fam == 3] <= 1).all() and (on[fam == 3] == 0).all()
    assert (near[fam == 4] == 0).all() and on[fam == 4].all()
    assert (on[fam == 5] == (near[fam == 5] > 0)).all()
    # stage 2 spawns anywhere on screen, the others at the path's start
    at_start = np.all(_np(state.body.pos) == _np(state.path.wps)[:, 0], axis=1)
    assert at_start[fam != 2].all() and not at_start[fam == 2].any()
    assert np.isfinite(_np(obs)).all()


def test_stage_mix_share():
    """At stage_mix_prob=0.25 over 4096 envs the mixed share is within 4
    sigma of 0.25 (sigma = sqrt(0.25 * 0.75 / 4096))."""
    state, _ = _reset(n=4096, stage_mix_prob=0.25)
    share = float((state.family != 0).float().mean())
    assert abs(share - 0.25) <= 4 * np.sqrt(0.25 * 0.75 / 4096)


def test_stage_mix_never_fires_under_forced_stage():
    state, _ = _reset(n=512, stage_mix_prob=1.0, scenario="stage_3")
    assert not bool(state.family.any())
    assert int(state.obstacles.mask[:, EnvConfig().max_curriculum_obs].sum()) == 0


def test_stage_mix_weights_must_be_uniform():
    """Non-uniform weights act only through adaptive rehearsal (not ported);
    the static mix refuses them, as the JAX learner does."""
    with pytest.raises(ValueError, match="stage_mix_weights"):
        _reset(stage_mix_prob=0.25, stage_mix_weights=(3.0, 1.0, 1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="stage_mix_weights"):
        JPPOLearner(JEnvConfig(stage_mix_prob=0.25, stage_mix_weights=(3.0, 1.0, 1.0, 1.0, 1.0)),
                    JPPOConfig(), 4).initial_rehearsal_probs()


def _digest(state, obs):
    h = hashlib.sha256()
    for k, v in sorted(env_state_to_numpy(state).items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    h.update(_np(obs).tobytes())
    return h.hexdigest()


# sha256 of the reset (every state leaf and the observation) of 64 envs from
# seed 7 at stage_mix_prob 0, made by the reset_batch before the mix was
# ported: the mix draws nothing when it is off
PARENT_RESETS = {
    (0.0, "large"): "ceee04f3f2f99f7083ee04e4dea45551fb7be9728564e29016eb08d83e871933",
    (8e5, "large"): "92214634f5b08872a2e3cf67f69ae990f91484e53d7291f42a525c76d602eb1c",
    (3e6, "large"): "5a31cc00f3d96c395c84268afb97e05e9426d36d547180812a7fd11bb2c61ec3",
    (0.0, "stage_3"): "a3821b6615307496cdfb639cb9ee89d8b3f422a2ff326d3efb731b7574604eb7",
}


@pytest.mark.parametrize("global_step, scenario", list(PARENT_RESETS))
def test_stage_mix_zero_keeps_the_reset_bit_identical(global_step, scenario):
    state, obs = _reset(global_step=global_step, scenario=scenario)
    assert _digest(state, obs) == PARENT_RESETS[(global_step, scenario)]
