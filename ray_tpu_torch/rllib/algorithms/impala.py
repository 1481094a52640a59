"""IMPALA: decoupled async sampling + continuous v-trace learner, the port
of ``ray_tpu/rllib/algorithms/impala.py``.

Reference: rllib/algorithms/impala/ — env runner actors sample with
whatever weights they were last handed while the learner updates
continuously; the policy-lag is corrected by v-trace
(core/impala_learner.py). The async engine here is the idiomatic runtime
pattern: one in-flight sample_trajectory task per runner, `wait(...,
num_returns=1)` to consume whichever finishes first, and an immediate
redispatch carrying the LATEST weights — the learner never blocks on the
slowest runner (PPO's synchronous sample() does).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch


class IMPALAConfig:
    def __init__(self):
        self.env_name: Optional[str] = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 64
        self.lr = 5e-4
        self.gamma = 0.99
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.rho_bar = 1.0
        self.c_bar = 1.0
        self.hidden = (64, 64)
        self.seed = 0
        self.remote_learner = True
        self.num_gpus_per_learner = 1
        # env steps consumed per train() iteration
        self.train_iter_env_steps = 4096

    def environment(self, env: str) -> "IMPALAConfig":
        self.env_name = env
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None,
                    rollout_fragment_length=None) -> "IMPALAConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr=None, gamma=None, vf_loss_coeff=None,
                 entropy_coeff=None, vtrace_clip_rho_threshold=None,
                 vtrace_clip_c_threshold=None, model_hidden=None,
                 train_iter_env_steps=None) -> "IMPALAConfig":
        for name, val in [
            ("lr", lr), ("gamma", gamma), ("vf_coeff", vf_loss_coeff),
            ("entropy_coeff", entropy_coeff),
            ("rho_bar", vtrace_clip_rho_threshold),
            ("c_bar", vtrace_clip_c_threshold), ("hidden", model_hidden),
            ("train_iter_env_steps", train_iter_env_steps),
        ]:
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, *, num_gpus_per_learner: Optional[float] = None
                 ) -> "IMPALAConfig":
        """GPUs of the learner (upstream's AlgorithmConfig.learners): 1, the
        default, puts it on a leased card (the driver's card when
        ``remote_learner`` is off); 0 on the CPU."""
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "IMPALAConfig":
        if seed is not None:
            self.seed = seed
        return self

    # Seam for IMPALA-engined variants (APPO): which learner class hosts
    # the update, and what extra kwargs it takes.
    def _learner_path(self) -> str:
        return "ray_tpu_torch.rllib.core.impala_learner:ImpalaLearner"

    def _extra_learner_kwargs(self) -> dict:
        return {}

    def build(self) -> "IMPALA":
        assert self.env_name, "call .environment(env_name) first"
        return IMPALA(self)


def _load_learner_cls(path: str):
    import importlib

    mod, name = path.split(":")
    return getattr(importlib.import_module(mod), name)


class _LearnerActor:
    """Remote host for the learner (reference: learner_group.py:83)."""

    def __init__(self, obs_dim, num_actions, cfg, learner_path):
        cls = _load_learner_cls(learner_path)
        self.learner = cls(obs_dim, num_actions, **cfg)

    def update(self, batch):
        return self.learner.update_from_trajectories(batch)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w):
        return self.learner.set_weights(w)

    def num_devices(self):
        return self.learner.num_devices()


class IMPALA:
    def __init__(self, config: IMPALAConfig):
        from ray_tpu_torch.rllib.core.learner import check_learner_device, learner_device
        from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup

        check_learner_device(config.num_gpus_per_learner, config.remote_learner)
        self.config = config
        self.env_runner_group = EnvRunnerGroup(
            config.env_name,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            gamma=config.gamma, lambda_=1.0, seed=config.seed,
        )
        obs_dim, num_actions = self.env_runner_group.obs_and_action_dims()
        learner_cfg = dict(
            lr=config.lr, gamma=config.gamma, vf_coeff=config.vf_coeff,
            entropy_coeff=config.entropy_coeff, rho_bar=config.rho_bar,
            c_bar=config.c_bar, hidden=config.hidden, seed=config.seed,
            device=learner_device(config.num_gpus_per_learner),
            **config._extra_learner_kwargs(),
        )
        learner_path = config._learner_path()
        if config.remote_learner:
            cls = ray_tpu_torch.remote(_LearnerActor)
            self.learner = cls.options(
                num_cpus=1, num_gpus=config.num_gpus_per_learner).remote(
                obs_dim, num_actions, learner_cfg, learner_path
            )
            self._remote = True
        else:
            self.learner = _load_learner_cls(learner_path)(
                obs_dim, num_actions, **learner_cfg)
            self._remote = False
        self._weights = self._learner_call("get_weights")
        self._iteration = 0
        self._recent_returns: deque = deque(maxlen=100)
        self._timesteps = 0
        self._updates = 0
        # async engine state: one in-flight rollout per runner
        self._inflight: Dict[Any, Any] = {}

    def _learner_call(self, method, *args):
        if self._remote:
            return ray_tpu_torch.get(
                getattr(self.learner, method).remote(*args), timeout=300
            )
        fn = {
            "get_weights": self.learner.get_weights,
            "set_weights": self.learner.set_weights,
            "update": self.learner.update_from_trajectories,
            "num_devices": self.learner.num_devices,
        }[method]
        return fn(*args)

    def num_devices(self):
        return self._learner_call("num_devices")

    def _dispatch(self, runner):
        ref = runner.sample_trajectory.remote(
            self._weights, self.config.rollout_fragment_length
        )
        self._inflight[ref] = runner

    def training_step(self) -> Dict[str, Any]:
        """Consume ~train_iter_env_steps env steps: learner updates on
        whichever rollout lands first; runners immediately redispatch with
        the freshest weights (policy lag <= one rollout per runner)."""
        cfg = self.config
        for runner in self.env_runner_group.runners:
            if runner not in self._inflight.values():
                self._dispatch(runner)
        consumed = 0
        losses: Dict[str, float] = {}
        t_update = 0.0
        while consumed < cfg.train_iter_env_steps:
            ready, _ = ray_tpu_torch.wait(
                list(self._inflight), num_returns=1, timeout=300
            )
            if not ready:
                raise RuntimeError("no rollout arrived within 300s")
            ref = ready[0]
            runner = self._inflight.pop(ref)
            batch = ray_tpu_torch.get(ref)
            self._dispatch(runner)  # keep the runner busy, newest weights
            self._recent_returns.extend(
                batch.pop("episode_returns").tolist()
            )
            n = batch["actions"].shape[0] * batch["actions"].shape[1]
            consumed += n
            self._timesteps += n
            t0 = time.perf_counter()
            losses = self._learner_call("update", batch)
            self._weights = self._learner_call("get_weights")
            t_update += time.perf_counter() - t0
            self._updates += 1
        losses["learner_env_steps_per_s"] = (
            consumed / t_update if t_update else 0.0
        )
        return losses

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        losses = self.training_step()
        self._iteration += 1
        mean_ret = (float(np.mean(self._recent_returns))
                    if self._recent_returns else 0.0)
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": mean_ret,
            "num_env_steps_sampled_lifetime": self._timesteps,
            "num_learner_updates": self._updates,
            "time_this_iter_s": time.perf_counter() - t0,
            **{f"learner/{k}": v for k, v in losses.items()},
        }

    def get_weights(self):
        return self._weights

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        import os
        import tempfile

        import cloudpickle

        path = checkpoint_dir or tempfile.mkdtemp(prefix="impala_ckpt_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            cloudpickle.dump({
                "algo": "IMPALA",
                "config": self.config,
                "weights": self._weights,
                "iteration": self._iteration,
                "timesteps": self._timesteps,
            }, f)
        return path

    def restore(self, checkpoint_path: str, _state: dict = None):
        import os

        import cloudpickle

        if _state is None:
            with open(os.path.join(checkpoint_path, "algorithm_state.pkl"),
                      "rb") as f:
                _state = cloudpickle.load(f)
        self._weights = _state["weights"]
        self._iteration = _state["iteration"]
        self._timesteps = _state["timesteps"]
        self._learner_call("set_weights", self._weights)
        return self

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str) -> "IMPALA":
        import os

        import cloudpickle

        with open(os.path.join(checkpoint_path, "algorithm_state.pkl"),
                  "rb") as f:
            state = cloudpickle.load(f)
        algo = cls(state["config"])
        return algo.restore(checkpoint_path, _state=state)

    def stop(self):
        # drain in-flight rollouts so actor kills don't race them
        refs = list(self._inflight)
        self._inflight.clear()
        if refs:
            try:
                ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=30)
            except Exception:
                pass
        self.env_runner_group.shutdown()
        if self._remote:
            try:
                ray_tpu_torch.kill(self.learner)
            except Exception:
                pass
