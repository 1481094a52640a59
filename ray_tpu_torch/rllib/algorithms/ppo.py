"""PPO, the port of ``ray_tpu/rllib/algorithms/ppo.py`` (reference:
rllib/algorithms/ppo/ppo.py:401 + config :67, new-stack shape:
EnvRunnerGroup sampling + LearnerGroup update per training_step :1674).
CPU runner actors sample with a numpy copy of the policy; the learner
actor leases ``num_gpus_per_learner`` cards (default 1; 0 is the CPU) and
updates there.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np


class PPOConfig:
    def __init__(self):
        self.env_name: Optional[str] = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 128
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_epochs = 4
        self.minibatch_size = 512
        self.hidden = (64, 64)
        self.seed = 0
        self.remote_learner = True
        self.num_gpus_per_learner = 1

    # Fluent sections mirroring the reference AlgorithmConfig.
    def environment(self, env: str) -> "PPOConfig":
        self.env_name = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "PPOConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr=None, gamma=None, lambda_=None, clip_param=None,
                 vf_loss_coeff=None, entropy_coeff=None, num_epochs=None,
                 minibatch_size=None, model_hidden=None) -> "PPOConfig":
        for name, val in [("lr", lr), ("gamma", gamma), ("lambda_", lambda_),
                          ("clip", clip_param), ("vf_coeff", vf_loss_coeff),
                          ("entropy_coeff", entropy_coeff),
                          ("num_epochs", num_epochs),
                          ("minibatch_size", minibatch_size),
                          ("hidden", model_hidden)]:
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, *, num_gpus_per_learner: Optional[float] = None
                 ) -> "PPOConfig":
        """GPUs of the learner (upstream's AlgorithmConfig.learners): 1, the
        default, puts it on a leased card (the driver's card when
        ``remote_learner`` is off); 0 on the CPU."""
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "PPOConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build(self) -> "PPO":
        assert self.env_name, "call .environment(env_name) first"
        return PPO(self)


class PPO:
    """The algorithm driver (a Tune trainable shape: train() returns a result
    dict per iteration)."""

    def __init__(self, config: PPOConfig):
        from ray_tpu_torch.rllib.core.learner import LearnerGroup, check_learner_device
        from ray_tpu_torch.rllib.env.env_runner import EnvRunnerGroup

        check_learner_device(config.num_gpus_per_learner, config.remote_learner)
        self.config = config
        self.env_runner_group = EnvRunnerGroup(
            config.env_name,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            gamma=config.gamma, lambda_=config.lambda_, seed=config.seed,
        )
        obs_dim, num_actions = self.env_runner_group.obs_and_action_dims()
        self.learner_group = LearnerGroup(
            obs_dim, num_actions,
            config={
                "lr": config.lr, "clip": config.clip,
                "vf_coeff": config.vf_coeff,
                "entropy_coeff": config.entropy_coeff,
                "hidden": config.hidden, "seed": config.seed,
                "num_gpus_per_learner": config.num_gpus_per_learner,
            },
            remote=config.remote_learner,
        )
        self._weights = self.learner_group.get_weights()
        self._iteration = 0
        self._recent_returns: deque = deque(maxlen=100)
        self._timesteps = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batch = self.env_runner_group.sample(
            self._weights, cfg.rollout_fragment_length
        )
        episode_returns = batch.pop("episode_returns")
        self._recent_returns.extend(episode_returns.tolist())
        self._timesteps += len(batch["obs"])
        losses = self.learner_group.update_from_batch(
            batch, num_epochs=cfg.num_epochs,
            minibatch_size=cfg.minibatch_size,
            seed=cfg.seed + self._iteration,
        )
        self._weights = self.learner_group.get_weights()
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
            "time_this_iter_s": time.perf_counter() - t0,
            **{f"learner/{k}": v for k, v in losses.items()},
        }

    def get_weights(self):
        return self._weights

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        """Persist weights + config + counters (reference:
        Algorithm.save / Checkpointable)."""
        import os
        import tempfile

        import cloudpickle

        path = checkpoint_dir or tempfile.mkdtemp(prefix="ppo_ckpt_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            cloudpickle.dump({
                "algo": "PPO",
                "config": self.config,
                "weights": self._weights,
                "iteration": self._iteration,
                "timesteps": self._timesteps,
            }, f)
        return path

    def restore(self, checkpoint_path: str, _state: dict = None):
        import os

        import cloudpickle

        if _state is not None:
            state = _state
        else:
            with open(os.path.join(checkpoint_path, "algorithm_state.pkl"),
                      "rb") as f:
                state = cloudpickle.load(f)
        self._weights = state["weights"]
        self._iteration = state["iteration"]
        self._timesteps = state["timesteps"]
        self.learner_group.set_weights(self._weights)
        return self

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str) -> "PPO":
        import os

        import cloudpickle

        with open(os.path.join(checkpoint_path, "algorithm_state.pkl"),
                  "rb") as f:
            state = cloudpickle.load(f)
        algo = cls(state["config"])
        return algo.restore(checkpoint_path, _state=state)

    def stop(self):
        self.env_runner_group.shutdown()
        self.learner_group.shutdown()
