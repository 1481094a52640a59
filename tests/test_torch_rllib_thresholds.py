"""The learning thresholds of the port's RLlib on the CPU: the counterparts
of ``tests/test_rllib.py::test_ppo_cartpole_learns`` (PPO on CartPole-v1 to
a mean return of 150 within 120 iterations) and
``tests/test_offline_rl.py::test_bc_learns_cartpole_from_parquet`` (BC from
40 recorded expert episodes to 150), with the learners on the CPU
(``.learners(num_gpus_per_learner=0)``; the PPO learner an actor) in one
session of the port's runtime. The other algorithms' thresholds run on the
card (``chip_smoke.py``'s rllib phase).
"""

import importlib

import pytest

import ray_tpu_torch
from _torch_data import _run, result
from _torch_rllib import expert_policy, rllib
from _torch_runtime import port_env

pytestmark = pytest.mark.timeout(240)


def p_ppo_learns(rt, rd, tmp):
    """tests/test_rllib.py::test_ppo_cartpole_learns on the port, CPU learner."""
    rl = rllib(rt)
    algo = (rl.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=4, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .training(lr=1e-3, num_epochs=8, minibatch_size=256, entropy_coeff=0.005)
            .learners(num_gpus_per_learner=0).debugging(seed=0).build())
    try:
        best, iters = 0.0, 0
        for iters in range(1, 121):
            best = max(best, algo.train()["episode_return_mean"])
            if best >= 150:
                break
        return best, iters, algo.learner_group.num_devices()
    finally:
        algo.stop()


def p_bc_learns(rt, rd, tmp):
    """tests/test_offline_rl.py::test_bc_learns_cartpole_from_parquet on the
    port, CPU learner."""
    rl = rllib(rt)
    off = importlib.import_module("ray_tpu_torch.rllib.offline")
    off.record_episodes("CartPole-v1", expert_policy, 40, str(tmp / "exp"), seed=0)
    algo = (rl.BCConfig().environment("CartPole-v1").offline_data(str(tmp / "exp"))
            .training(lr=3e-3, train_batch_size=512, minibatches_per_iter=24)
            .learners(num_gpus_per_learner=0).debugging(seed=0).build())
    best = 0.0
    for _ in range(12):
        metrics = algo.train()
        best = max(best, algo.evaluate(num_episodes=5)["episode_return_mean"])
        if best >= 150:
            break
    return best, metrics["mean_logp"]


PROGRAMS = {"ppo_learns": p_ppo_learns, "bc_learns": p_bc_learns}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        return None, _run(ray_tpu_torch, PROGRAMS, tmp_path_factory.mktemp("rllib"), 8)


def test_ppo_learns_cartpole_on_the_port(results):
    best, iters, devices = result(results, "ppo_learns")
    assert devices == 1
    assert best >= 150, f"PPO failed to learn CartPole: best={best:.1f} after {iters}"


def test_bc_learns_cartpole_from_parquet_on_the_port(results):
    best, mean_logp = result(results, "bc_learns")
    assert best >= 150, f"BC failed to imitate the expert: best={best:.1f}"
    assert mean_logp > -0.35
