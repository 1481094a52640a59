"""The port's env runners and learners against the JAX package's, on the CPU.

Runners: ``SingleAgentEnvRunner`` (``sample``, ``sample_trajectory``),
``DQNEnvRunner``, ``SACEnvRunner`` and ``MultiAgentEnvRunner`` of both
packages, built locally (no cluster) from the same weights and seed, give
**bitwise** equal batches over several calls (the environments are bitwise
gymnasium's, the numpy policies the same code).

Learners: each port learner starts from the JAX learner's initial weights
and takes the same updates on the same batch. Tolerances (PERF.md §2's
convention): losses and aux within 1e-5 relative; parameters within 1e-5
relative, or within 2·lr where Adam's first steps turn a near-zero gradient
(float32 rounding of another summation order) into ±lr, and such elements
are under 1% of the parameters. The JAX learners get ``mesh_devices=1``:
the tests' JAX sees 8 CPU devices and would pad each batch to a multiple of
8 by repeating its last row. SAC's JAX learner draws its noise from
``PRNGKey(seed + 2)``; the port's takes the same noise through
``update_with_noise``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.rllib.algorithms import bc as jax_bc
from ray_tpu.rllib.algorithms import dqn as jax_dqn
from ray_tpu.rllib.algorithms import sac as jax_sac
from ray_tpu.rllib.core import appo_learner as jax_appo
from ray_tpu.rllib.core import impala_learner as jax_impala
from ray_tpu.rllib.core import learner as jax_learner
from ray_tpu.rllib.core.rl_module import (
    ActorCriticModule as JaxActorCritic,
    QModule as JaxQ,
    SquashedGaussianModule as JaxGaussian,
)
from ray_tpu.rllib.env import env_runner as jax_runner
from ray_tpu.rllib.env import multi_agent as jax_ma
from ray_tpu_torch.rllib.algorithms import bc, dqn, sac
from ray_tpu_torch.rllib.core import appo_learner, impala_learner, learner
from ray_tpu_torch.rllib.core.rl_module import flax_params, load_flax_params
from ray_tpu_torch.rllib.env import env_runner, multi_agent

REL = 1e-5
OUTLIER_SHARE = 0.01


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def ac_params(seed=0, obs_dim=4, hidden=(64, 64)):
    return np_tree(JaxActorCritic(num_actions=2, hidden=hidden).init_params(obs_dim, seed))


def assert_bitwise(got, ref):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def assert_aux_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= REL * abs(ref[k]) + 1e-7, (k, got[k], ref[k])


def assert_params_close(got, ref, lr):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    outliers = total = 0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.abs(a - b)
        assert err.max() <= 2 * lr + 1e-6, err.max()
        outliers += int((err > REL * np.abs(b) + 1e-7).sum())
        total += b.size
    assert outliers <= OUTLIER_SHARE * total, (outliers, total)


# ---------------------------------------------------------------- runners


def test_single_agent_runner_sample_is_bitwise():
    params = ac_params(1)
    ref = jax_runner.SingleAgentEnvRunner("CartPole-v1", 4, gamma=0.99, lambda_=0.95, seed=3)
    got = env_runner.SingleAgentEnvRunner("CartPole-v1", 4, gamma=0.99, lambda_=0.95, seed=3)
    assert got.obs_and_action_dims() == ref.obs_and_action_dims()
    for _ in range(3):  # across calls: episodes, autoreset rows, returns
        assert_bitwise(got.sample(params, 48), ref.sample(params, 48))
    assert_bitwise(got.sample_trajectory(params, 40), ref.sample_trajectory(params, 40))


def test_dqn_runner_sample_is_bitwise():
    params = np_tree(JaxQ(num_actions=2).init_params(4, 2))
    ref = jax_dqn.DQNEnvRunner("CartPole-v1", 4, seed=5)
    got = dqn.DQNEnvRunner("CartPole-v1", 4, seed=5)
    assert got.obs_and_action_dims() == ref.obs_and_action_dims()
    for eps in (1.0, 0.3, 0.0):
        assert_bitwise(got.sample(params, 40, eps), ref.sample(params, 40, eps))


def test_sac_runner_sample_is_bitwise():
    params = np_tree(JaxGaussian(action_dim=1, hidden=(32, 32)).init_params(3, 0))
    ref = jax_sac.SACEnvRunner("Pendulum-v1", 3, seed=7)
    got = sac.SACEnvRunner("Pendulum-v1", 3, seed=7)
    assert got.space_dims() == ref.space_dims()
    for random in (True, False, False, False, False):  # crosses the 200-step limit
        assert_bitwise(got.sample(params, 48, random=random),
                       ref.sample(params, 48, random=random))


def test_multi_agent_runner_sample_is_bitwise():
    params = {"agent_0": ac_params(0, hidden=(16,)), "agent_1": ac_params(1, hidden=(16,))}
    ref = jax_ma.MultiAgentEnvRunner(lambda: jax_ma.MultiAgentCartPole(num_agents=2),
                                     lambda aid: aid, gamma=0.99, lambda_=0.95, seed=4)
    got = multi_agent.MultiAgentEnvRunner(
        lambda: multi_agent.MultiAgentCartPole(num_agents=2),
        lambda aid: aid, gamma=0.99, lambda_=0.95, seed=4)
    assert got.spaces() == ref.spaces()
    for _ in range(2):
        assert_bitwise(got.sample(params, 120), ref.sample(params, 120))


# --------------------------------------------------------------- learners


@pytest.fixture(scope="module")
def rollout():
    """A PPO batch and an IMPALA trajectory from the runner, both ragged
    (autoreset rows dropped or weighted out)."""
    runner = env_runner.SingleAgentEnvRunner("CartPole-v1", 6, gamma=0.99, lambda_=0.95,
                                             seed=11)
    params = ac_params(2)
    batch = runner.sample(params, 50)
    batch.pop("episode_returns")
    traj = runner.sample_trajectory(params, 30)
    return batch, traj


@pytest.mark.parametrize("epochs,minibatch", [(1, 4096), (2, 96)])
def test_ppo_learner_update_matches_jax(rollout, epochs, minibatch):
    batch, _ = rollout
    assert len(batch["obs"]) % minibatch  # a short last minibatch
    ref = jax_learner.JaxLearner(4, 2, lr=1e-3, seed=3, mesh_devices=1)
    got = learner.TorchLearner(4, 2, lr=1e-3, seed=9, device="cpu")
    got.set_weights(ref.get_weights())
    kw = dict(num_epochs=epochs, minibatch_size=minibatch, seed=4)
    assert_aux_close(got.update_from_batch(batch, **kw), ref.update_from_batch(batch, **kw))
    assert_params_close(got.get_weights(), ref.get_weights(), 1e-3)


def test_vtrace_matches_jax():
    rng = np.random.default_rng(0)
    T, N = 12, 5
    args = [rng.uniform(0.2, 1.0, (T, N)), rng.normal(size=(T, N)),
            0.99 * (rng.random((T, N)) > 0.1), rng.normal(size=(T, N)),
            rng.normal(size=N), rng.uniform(0.2, 1.0, (T, N))]
    args = [a.astype(np.float32) for a in args]
    ref = jax_impala.vtrace(*[jnp.asarray(a) for a in args])
    import torch

    got = impala_learner.vtrace(*[torch.from_numpy(a) for a in args])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=REL, atol=1e-6)


def test_impala_learner_update_matches_jax(rollout):
    _, traj = rollout
    ref = jax_impala.ImpalaLearner(4, 2, lr=5e-4, seed=0, mesh_devices=1)
    got = impala_learner.ImpalaLearner(4, 2, lr=5e-4, seed=5, device="cpu")
    got.set_weights(ref.get_weights())
    for _ in range(2):
        assert_aux_close(got.update_from_trajectories(traj),
                         ref.update_from_trajectories(traj))
    assert_params_close(got.get_weights(), ref.get_weights(), 5e-4)


def test_appo_learner_updates_match_jax(rollout):
    _, traj = rollout
    kw = dict(lr=5e-4, use_kl_loss=True, kl_coeff=0.5, target_update_freq=2, clip_param=0.3)
    ref = jax_appo.AppoLearner(4, 2, seed=0, mesh_devices=1, **kw)
    got = appo_learner.AppoLearner(4, 2, seed=5, device="cpu", **kw)
    got.set_weights(ref.get_weights())
    kls = []
    for _ in range(3):  # the target refreshes after the second
        aux = ref.update_from_trajectories(traj)
        assert_aux_close(got.update_from_trajectories(traj), aux)
        kls.append(aux["kl"])
    assert kls[0] == 0.0 < kls[1]  # the first update's target is the policy
    assert_params_close(got.get_weights(), ref.get_weights(), 5e-4)
    assert_params_close(flax_params(got.target), np_tree(ref.target_params), 5e-4)


def test_dqn_learner_updates_match_jax():
    runner = dqn.DQNEnvRunner("CartPole-v1", 8, seed=1)
    ref = jax_dqn.DQNLearner(4, 2, lr=1e-3, seed=0, mesh_devices=1)
    got = dqn.DQNLearner(4, 2, lr=1e-3, seed=6, device="cpu")
    got.set_weights(ref.get_weights())
    buf = dqn.ReplayBuffer(4096, 4)
    buf.add_batch(runner.sample(ref.get_weights(), 64, 0.5))
    rng = np.random.default_rng(0)
    for i in range(3):
        mb = buf.sample(rng, 200)
        assert_aux_close(got.update(mb), ref.update(mb))
        if i == 1:
            got.sync_target()
            ref.sync_target()
    assert_params_close(got.get_weights(), ref.get_weights(), 1e-3)
    assert_params_close(got.get_target_weights(), ref.get_target_weights(), 1e-3)


def test_dqn_argmax_takes_the_first_of_a_tie():
    got = dqn.DQNLearner(2, 3, hidden=(4,), device="cpu")
    w = got.get_weights()
    w["q"]["kernel"][:] = 0.0
    w["q"]["bias"][:] = [0.5, 2.0, 2.0]  # actions 1 and 2 tie everywhere
    tgt = {k: {n: a.copy() for n, a in v.items()} for k, v in w.items()}
    tgt["q"]["bias"][:] = [0.0, 1.0, 3.0]  # so the first index scores 1, the second 3
    got.set_weights(w, tgt)
    batch = {"obs": np.zeros((4, 2), np.float32), "next_obs": np.zeros((4, 2), np.float32),
             "actions": np.zeros(4, np.int64), "rewards": np.zeros(4, np.float32),
             "dones": np.zeros(4, np.float32)}
    aux = got.update(batch)
    # q_sa = 0.5, target = 0.99 * 1.0 (action 1, not 2): |td| = 0.49
    assert abs(aux["td_error_mean"] - 0.49) < 1e-6


def jax_sac_noise(seed, n_updates, shape):
    """The JAX SACLearner's noise: ``_key = PRNGKey(seed + 2)``; each update
    ``_key, sub = split(_key)``, ``k1, k2 = split(sub)`` (sac.py:174,290,208)."""
    key = jax.random.PRNGKey(seed + 2)
    out = []
    for _ in range(n_updates):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        out.append((np.asarray(jax.random.normal(k1, shape)),
                    np.asarray(jax.random.normal(k2, shape))))
    return out


def test_sac_learner_updates_with_the_jax_noise_match_jax():
    runner = sac.SACEnvRunner("Pendulum-v1", 4, seed=2)
    batch = runner.sample(None, 40, random=True)
    batch.pop("episode_returns")
    kw = dict(hidden=(32, 32), seed=3)
    ref = jax_sac.SACLearner(3, 1, [-2.0], [2.0], mesh_devices=1, **kw)
    got = sac.SACLearner(3, 1, [-2.0], [2.0], device="cpu", **kw)
    load_flax_params(got.actor, np_tree(ref.actor_params))
    load_flax_params(got.critic, np_tree(ref.critic_params))
    load_flax_params(got.target, np_tree(ref.target_params))
    for n1, n2 in jax_sac_noise(3, 3, (len(batch["obs"]), 1)):
        assert_aux_close(got.update_with_noise(batch, n1, n2), ref.update(batch))
    assert_params_close(got.get_actor_weights(), ref.get_actor_weights(), 3e-4)
    assert_params_close(flax_params(got.critic), np_tree(ref.critic_params), 3e-4)
    assert_params_close(flax_params(got.target), np_tree(ref.target_params), 3e-4)
    assert abs(float(got.log_alpha.detach()) - float(ref.log_alpha)) <= 2 * 3e-4
    # the public update draws its own noise (torch.Generator(seed + 2))
    again = sac.SACLearner(3, 1, [-2.0], [2.0], device="cpu", **kw)
    assert again.update(batch) == sac.SACLearner(3, 1, [-2.0], [2.0], device="cpu",
                                                 **kw).update(batch)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_marwil_learner_updates_match_jax(beta):
    rng = np.random.default_rng(int(beta))
    batches = [{"obs": rng.normal(size=(128, 4)).astype(np.float32),
                "action": rng.integers(0, 2, 128).astype(np.int32),
                "return_to_go": rng.normal(size=128).astype(np.float32)}
               for _ in range(3)]
    ref = jax_bc._MarwilLearner(4, 2, lr=3e-3, beta=beta, seed=0)
    got = bc._MarwilLearner(4, 2, lr=3e-3, beta=beta, seed=8, device="cpu")
    load_flax_params(got.module, np_tree(ref.params))
    for b in batches:  # the first runs the warm-start pass
        assert_aux_close(got.update(b), ref.update(b))
        assert abs(got.ma_adv_sq - ref.ma_adv_sq) <= REL * ref.ma_adv_sq
    assert_params_close(got.get_weights(), ref.get_weights(), 3e-3)
