"""The port's off-policy and offline RL algorithms on its runtime against the
JAX package's.

DQN, SAC (the port's learner fed the JAX learner's noise), BC and MARWIL
(episodes recorded to parquet by each package over its own environments,
read back through its ``data``): each program runs under ``ray_tpu``, then
under ``ray_tpu_torch`` (one runtime session per package for this file;
``tests/_torch_rllib.py`` says how the port's run starts from the JAX run's
weights and what the first iteration must match). The learning
thresholds are in ``tests/test_torch_rllib_thresholds.py``.
"""

import importlib
import sys

import numpy as np
import pytest

from _torch_data import result, run_both
from _torch_rllib import (
    ALGO_REL,
    W0,
    assert_losses_close,
    expert_policy,
    first_iteration,
    is_port,
    on_cpu,
    rllib,
)

pytestmark = pytest.mark.timeout(240)


def p_dqn(rt, rd, tmp):
    rl = rllib(rt)
    cfg = on_cpu(rt, rl.DQNConfig().environment("CartPole-v1")
                 .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                              rollout_fragment_length=16)
                 .training(learning_starts=64, updates_per_iteration=4,
                           train_batch_size=64, target_update_freq=1)
                 .debugging(seed=3))
    algo = cfg.build()
    try:
        def set_weights(w):
            algo._learner_call("set_weights", w)
            algo._weights = w

        return first_iteration(rt, "dqn", algo, set_weights)
    finally:
        algo.stop()


def p_sac(rt, rd, tmp):
    rl = rllib(rt)
    cfg = (rl.SACConfig().environment("Pendulum-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                        rollout_fragment_length=16)
           .training(model_hidden=(32, 32), learning_starts=32,
                     learner_steps_per_iteration=4, train_batch_size=64)
           .debugging(seed=4))
    if is_port(rt):
        cfg = cfg.learners(num_gpus_per_learner=0)
    algo = cfg.build()
    try:
        lrn = algo.learner
        parts = {}
        if is_port(rt):
            from ray_tpu_torch.rllib.core.rl_module import load_flax_params

            def set_weights(w):
                for part in ("actor", "critic", "target"):
                    load_flax_params(getattr(lrn, part), w[part])
                algo._weights = w["actor"]
                noise = iter(W0["sac_noise"])
                lrn.update = lambda b: lrn.update_with_noise(b, *next(noise))
        else:
            import jax

            def set_weights(w):
                pass

            parts = {"critic": jax.tree.map(np.asarray, lrn.critic_params),
                     "target": jax.tree.map(np.asarray, lrn.target_params)}
            key = jax.random.PRNGKey(4 + 2)  # SACLearner's _key sequence
            noise = []
            for _ in range(4):
                key, sub = jax.random.split(key)
                k1, k2 = jax.random.split(sub)
                noise.append(tuple(np.asarray(jax.random.normal(k, (64, 1))) for k in (k1, k2)))
            W0["sac_noise"] = noise
        out = first_iteration(rt, "sac", algo, set_weights)
        if not is_port(rt):
            W0["sac"] = {"actor": W0["sac"], **parts}
        return out
    finally:
        algo.stop()


def _offline(rt, tmp, config_cls, name, beta_data):
    rl = rllib(rt)
    off = importlib.import_module(f"{rt.__name__}.rllib.offline")
    stats = off.record_episodes("CartPole-v1", expert_policy, 3, str(tmp / "exp"), seed=0)
    if beta_data:
        stats = (stats, off.record_episodes("CartPole-v1", lambda o: 1 - expert_policy(o),
                                            40, str(tmp / "anti"), seed=7))
    paths = [str(tmp / "exp")] + ([str(tmp / "anti")] if beta_data else [])
    cfg = (config_cls().environment("CartPole-v1").offline_data(paths)
           .training(lr=3e-3, train_batch_size=128, minibatches_per_iter=4)
           .debugging(seed=6))
    if is_port(rt):
        cfg = cfg.learners(num_gpus_per_learner=0)
    algo = cfg.build()
    if is_port(rt):
        from ray_tpu_torch.rllib.core.rl_module import load_flax_params

        load_flax_params(algo.learner.module, W0[name])
    else:
        W0[name] = algo.get_weights()
    metrics = algo.train()
    return stats, algo._rtg_stats, metrics, algo.learner.ma_adv_sq


def p_bc(rt, rd, tmp):
    return _offline(rt, tmp, rllib(rt).BCConfig, "bc", False)


def p_marwil(rt, rd, tmp):
    return _offline(rt, tmp, rllib(rt).MARWILConfig, "marwil", True)


PROGRAMS = {name[2:]: fn for name, fn in list(globals().items())
            if name.startswith("p_") and callable(fn)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(sys.modules[__name__], PROGRAMS, tmp_path_factory.mktemp("rllib"))


@pytest.mark.parametrize("name", ["dqn", "sac"])
def test_first_iteration_follows_the_jax_algorithm(results, name):
    ref, got = result(results, name, 0), result(results, name, 1)
    assert got[0] == ref[0] > 0  # env steps sampled
    assert got[1] == ref[1]  # mean episode return
    assert_losses_close(got[2], ref[2])
    if name == "appo":
        assert got[2]["learner/kl"] >= 0.0


@pytest.mark.parametrize("name", ["bc", "marwil"])
def test_offline_first_iteration_follows_the_jax_algorithm(results, name):
    ref, got = result(results, name, 0), result(results, name, 1)
    assert got[0] == ref[0]  # the recorded episodes' stats
    assert got[1] == ref[1]  # the dataset's return-to-go mean and std
    ref_m = {k: v for k, v in ref[2].items() if k != "training_iteration"}
    assert_losses_close({k: v for k, v in got[2].items() if k != "training_iteration"}, ref_m)
    assert abs(got[3] - ref[3]) <= ALGO_REL * ref[3]
