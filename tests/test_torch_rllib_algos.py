"""The port's on-policy RL algorithms on its runtime against the JAX package's.

PPO, IMPALA, APPO and multi-agent PPO: each program runs under ``ray_tpu``,
then under ``ray_tpu_torch`` (one runtime session per package for this file;
``tests/_torch_rllib.py`` says how the port's run starts from the JAX run's
weights and what the first iteration must match). Port only: ``save`` /
``from_checkpoint`` (weights bitwise, in the driver and in the learner
actor), a runner actor's ``sys.modules`` without torch or gymnasium, and
``build()`` on a GPU-less cluster raising at once rather than waiting for a
lease. The off-policy and offline algorithms are in
``tests/test_torch_rllib_offpolicy.py``, the learning thresholds in
``tests/test_torch_rllib_thresholds.py``.
"""

import sys

import pytest

from _torch_data import result, run_both
from _torch_rllib import (
    assert_losses_close,
    first_iteration,
    is_port,
    on_cpu,
    one_device_jax_learner,
    rllib,
)

pytestmark = pytest.mark.timeout(240)


def p_ppo(rt, rd, tmp):
    rl = rllib(rt)
    cfg = on_cpu(rt, rl.PPOConfig().environment("CartPole-v1")
                 .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                              rollout_fragment_length=32)
                 .training(lr=1e-3, num_epochs=2, minibatch_size=64).debugging(seed=1))
    with one_device_jax_learner(rt):
        algo = cfg.build()
    try:
        def set_weights(w):
            algo.learner_group.set_weights(w)
            algo._weights = w

        return first_iteration(rt, "ppo", algo, set_weights)
    finally:
        algo.stop()


def _impala_like(rt, name, cfg):
    rl = rllib(rt)
    cfg = on_cpu(rt, cfg.environment("CartPole-v1")
                 .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                              rollout_fragment_length=16)
                 .debugging(seed=2))
    algo = cfg.build()
    try:
        def set_weights(w):
            algo._learner_call("set_weights", w)
            algo._weights = w

        out = first_iteration(rt, name, algo, set_weights)
        assert isinstance(algo, rl.IMPALA)
        return out
    finally:
        algo.stop()


def p_impala(rt, rd, tmp):
    # one runner: the async engine's order of rollouts is fixed; 8 envs: no pad
    return _impala_like(rt, "impala", rllib(rt).IMPALAConfig().training(
        lr=3e-3, train_iter_env_steps=256))


def p_appo(rt, rd, tmp):
    return _impala_like(rt, "appo", rllib(rt).APPOConfig().training(
        lr=3e-3, train_iter_env_steps=384, clip_param=0.3, target_update_freq=2,
        use_kl_loss=True))


def p_multi_agent_ppo(rt, rd, tmp):
    rl = rllib(rt)
    cartpole = rl.MultiAgentCartPole
    cfg = (rl.MultiAgentPPOConfig()
           .environment(lambda: cartpole(num_agents=2))
           .multi_agent(policy_mapping_fn=lambda aid: aid)
           .env_runners(num_env_runners=2, rollout_fragment_length=64)
           .training(num_epochs=2, minibatch_size=48, model_hidden=(32, 32))
           .debugging(seed=5))
    if is_port(rt):
        cfg = cfg.learners(num_gpus_per_learner=0)
    with one_device_jax_learner(rt):
        algo = cfg.build()
    try:
        def set_weights(w):
            for pid, lrn in algo.learners.items():
                lrn.set_weights(w[pid])
            algo._weights = dict(w)

        return first_iteration(rt, "ma_ppo", algo, set_weights)
    finally:
        algo.stop()


PROGRAMS = {name[2:]: fn for name, fn in list(globals().items())
            if name.startswith("p_") and callable(fn)}


# ------------------------------------------------------------ port only


def p_checkpoint(rt, rd, tmp):
    rl = rllib(rt)
    algo = (rl.PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                         rollout_fragment_length=32)
            .learners(num_gpus_per_learner=0).build())
    try:
        algo.train()
        path = algo.save(str(tmp / "ck"))
        w0 = algo.get_weights()
    finally:
        algo.stop()
    algo2 = rl.PPO.from_checkpoint(path)
    try:
        w1, w_learner = algo2.get_weights(), algo2.learner_group.get_weights()
        it = algo2.train()["training_iteration"]
    finally:
        algo2.stop()
    return w0, w1, w_learner, it


def p_runner_modules(rt, rd, tmp):
    from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

    class Probe(SingleAgentEnvRunner):
        def modules(self):
            import sys as _sys

            return sorted({m.split(".")[0] for m in _sys.modules}
                          & {"torch", "gymnasium", "jax", "ray_tpu"})

    runner = rt.remote(Probe).options(num_cpus=1).remote(
        "CartPole-v1", 2, gamma=0.99, lambda_=0.95)
    try:
        from ray_tpu_torch.rllib.core.learner import TorchLearner

        weights = TorchLearner(4, 2, device="cpu").get_weights()
        n = len(rt.get(runner.sample.remote(weights, 16), timeout=60)["obs"])
        return n, rt.get(runner.modules.remote(), timeout=60)
    finally:
        rt.kill(runner)


def p_no_gpu(rt, rd, tmp):
    """The default learner asks for a card: on this GPU-less cluster (and
    process) every build() raises at once, naming the CPU setting."""
    rl = rllib(rt)
    out = []
    for cfg in (rl.PPOConfig().environment("CartPole-v1"),
                rl.IMPALAConfig().environment("CartPole-v1"),
                rl.APPOConfig().environment("CartPole-v1"),
                rl.DQNConfig().environment("CartPole-v1"),
                rl.SACConfig().environment("Pendulum-v1"),
                rl.MultiAgentPPOConfig().environment(lambda: None)):
        try:
            cfg.build()
            out.append(None)
        except RuntimeError as e:
            out.append(str(e))
    return out, rt.cluster_resources().get("GPU", 0)


PORT_ONLY = {"checkpoint": p_checkpoint, "runner_modules": p_runner_modules,
             "no_gpu": p_no_gpu}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(sys.modules[__name__], PROGRAMS, tmp_path_factory.mktemp("rllib"),
                    port_only=PORT_ONLY)


@pytest.mark.parametrize("name", ["ppo", "impala", "appo", "multi_agent_ppo"])
def test_first_iteration_follows_the_jax_algorithm(results, name):
    ref, got = result(results, name, 0), result(results, name, 1)
    assert got[0] == ref[0] > 0  # env steps sampled
    assert got[1] == ref[1]  # mean episode return
    assert_losses_close(got[2], ref[2])
    if name == "appo":
        assert got[2]["learner/kl"] >= 0.0


def test_save_and_from_checkpoint_keep_the_weights_bitwise(results):
    w0, w1, w_learner, it = result(results, "checkpoint")
    for w in (w1, w_learner):
        assert w.keys() == w0.keys()
        for layer in w0:
            for part in ("kernel", "bias"):
                assert w[layer][part].tobytes() == w0[layer][part].tobytes()
    assert it == 2  # resumes counting from the checkpoint


def test_runner_actor_imports_neither_torch_nor_gymnasium(results):
    n, modules = result(results, "runner_modules")
    assert 16 <= n <= 32 and modules == []


def test_build_without_a_gpu_raises_and_names_the_cpu_setting(results):
    errors, gpus = result(results, "no_gpu")
    assert gpus == 0
    assert all(e and ".learners(num_gpus_per_learner=0)" in e for e in errors), errors


