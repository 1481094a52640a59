"""What the port's RL algorithm tests share (``tests/test_torch_rllib_algos.py``,
``tests/test_torch_rllib_offpolicy.py``, ``tests/test_torch_rllib_thresholds.py``).

Their programs ``p_<name>(rt, rd, tmp)`` run through ``tests/_torch_data.py``'s
``run_both``: under ``ray_tpu``, then under ``ray_tpu_torch``. The JAX run of
an algorithm keeps its initial weights in ``W0``; the port's run of it
starts from them (:func:`first_iteration`), with its learners on the CPU
(:func:`on_cpu`). Its first iteration then samples the same env steps with
the same episode returns (equal), and its losses agree within ``ALGO_REL``:
1e-4 relative, since an iteration takes several Adam steps from weights
that differ in float32 rounding. JAX learners that would pad a minibatch
to the tests' 8 CPU devices run with ``mesh_devices=1``
(:class:`one_device_jax_learner`). Everything here runs in the test process,
never in a worker.
"""

import importlib

import pytest

ALGO_REL = 1e-4
W0 = {}  # the JAX runs' initial weights (and SAC's noise), by program


def expert_policy(obs):
    # tests/test_offline_rl.py:20
    return 1 if obs[2] + 0.5 * obs[3] > 0 else 0


def is_port(rt):
    return rt.__name__ == "ray_tpu_torch"


def rllib(rt):
    return importlib.import_module(f"{rt.__name__}.rllib")


def on_cpu(rt, cfg):
    """The port's learner on the CPU; the JAX one local in the driver."""
    if is_port(rt):
        return cfg.learners(num_gpus_per_learner=0)
    cfg.remote_learner = False
    return cfg


class one_device_jax_learner:
    """The JAX ``JaxLearner`` built with ``mesh_devices=1`` while the
    context is open (a no-op for the port)."""

    def __init__(self, rt):
        self.rt, self.mp = rt, pytest.MonkeyPatch()

    def __enter__(self):
        if not is_port(self.rt):
            from ray_tpu.rllib.core import learner as jl

            base = jl.JaxLearner

            class OneDevice(base):
                def __init__(self, *args, **kwargs):
                    super().__init__(*args, **{**kwargs, "mesh_devices": 1})

            self.mp.setattr(jl, "JaxLearner", OneDevice)

    def __exit__(self, *exc):
        self.mp.undo()


def first_iteration(rt, name, algo, set_weights):
    """JAX: keep the initial weights; port: start from them. Then one
    ``train()``: (env steps, mean return, losses)."""
    if is_port(rt):
        set_weights(W0[name])
    else:
        W0[name] = algo.get_weights()
    r = algo.train()
    return (r["num_env_steps_sampled_lifetime"], r["episode_return_mean"],
            {k: v for k, v in r.items() if k.startswith("learner/")
             and k != "learner/learner_env_steps_per_s"})


def assert_losses_close(got, ref):
    assert set(got) == set(ref) and ref
    for k in ref:
        assert abs(got[k] - ref[k]) <= ALGO_REL * abs(ref[k]) + 1e-6, (k, got[k], ref[k])
