"""Multi-agent PPO: per-policy learners over multi-agent env runners, the
port of ``ray_tpu/rllib/algorithms/multi_agent_ppo.py``. The learners are
local ``TorchLearner``s, on the driver's card by default (reference: the
multi_agent() axis of AlgorithmConfig —
rllib/algorithms/algorithm_config.py policies/policy_mapping_fn — driving
rllib/env/multi_agent_env_runner.py:55; each policy trains on exactly the
transitions its mapped agents produced).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnvRunner


class MultiAgentPPOConfig:
    def __init__(self):
        self.env_creator: Optional[Callable] = None
        self.policy_mapping_fn: Callable[[str], str] = lambda aid: aid
        self.num_env_runners = 2
        self.rollout_fragment_length = 256
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_epochs = 4
        self.minibatch_size = 256
        self.hidden = (64, 64)
        self.seed = 0
        self.num_gpus_per_learner = 1

    def environment(self, env_creator: Callable) -> "MultiAgentPPOConfig":
        self.env_creator = env_creator
        return self

    def multi_agent(self, *, policy_mapping_fn: Callable[[str], str]
                    ) -> "MultiAgentPPOConfig":
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def env_runners(self, *, num_env_runners=None,
                    rollout_fragment_length=None) -> "MultiAgentPPOConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr=None, gamma=None, lambda_=None, clip_param=None,
                 num_epochs=None, minibatch_size=None, model_hidden=None
                 ) -> "MultiAgentPPOConfig":
        for name, val in [("lr", lr), ("gamma", gamma), ("lambda_", lambda_),
                          ("clip", clip_param), ("num_epochs", num_epochs),
                          ("minibatch_size", minibatch_size),
                          ("hidden", model_hidden)]:
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, *, num_gpus_per_learner: Optional[float] = None
                 ) -> "MultiAgentPPOConfig":
        """GPUs of each policy's learner, which runs in the driver
        (upstream's AlgorithmConfig.learners): 1, the default, puts it on
        the driver's card; 0 on the CPU."""
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def debugging(self, *, seed: Optional[int] = None
                  ) -> "MultiAgentPPOConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build(self) -> "MultiAgentPPO":
        assert self.env_creator, "call .environment(env_creator) first"
        return MultiAgentPPO(self)


class MultiAgentPPO:
    def __init__(self, config: MultiAgentPPOConfig):
        from ray_tpu_torch.rllib.core.learner import (
            TorchLearner,
            check_learner_device,
            learner_device,
        )

        cfg = config
        check_learner_device(cfg.num_gpus_per_learner, remote=False)
        self.config = cfg
        runner_cls = ray_tpu_torch.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                cfg.env_creator, cfg.policy_mapping_fn,
                gamma=cfg.gamma, lambda_=cfg.lambda_,
                seed=cfg.seed + 1000 * i,
            )
            for i in range(cfg.num_env_runners)
        ]
        spaces = ray_tpu_torch.get(self.runners[0].spaces.remote(), timeout=120)
        device = learner_device(cfg.num_gpus_per_learner)
        self.learners: Dict[str, TorchLearner] = {
            pid: TorchLearner(
                obs_dim, n_act, lr=cfg.lr, clip=cfg.clip,
                vf_coeff=cfg.vf_coeff, entropy_coeff=cfg.entropy_coeff,
                # sorted-index seeds: str hash() is salted per process and
                # would defeat .debugging(seed=...) reproducibility
                hidden=cfg.hidden, seed=cfg.seed + idx, device=device,
            )
            for idx, (pid, (obs_dim, n_act)) in enumerate(
                sorted(spaces.items())
            )
        }
        self._weights = {
            pid: learner.get_weights() for pid, learner in self.learners.items()
        }
        self._iteration = 0
        self._timesteps = 0
        self._recent_returns: deque = deque(maxlen=100)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        refs = [
            r.sample.remote(self._weights, cfg.rollout_fragment_length)
            for r in self.runners
        ]
        results = ray_tpu_torch.get(refs, timeout=300)
        merged: Dict[str, Dict[str, list]] = {}
        for res in results:
            for pid, batch in res.items():
                self._recent_returns.extend(
                    batch.pop("episode_returns").tolist()
                )
                dest = merged.setdefault(pid, {k: [] for k in batch})
                for k, v in batch.items():
                    dest[k].append(v)
        losses: Dict[str, float] = {}
        for pid, parts in merged.items():
            batch = {k: np.concatenate(v) for k, v in parts.items()}
            self._timesteps += len(batch["obs"])
            aux = self.learners[pid].update_from_batch(
                batch, num_epochs=cfg.num_epochs,
                minibatch_size=cfg.minibatch_size,
                seed=cfg.seed + self._iteration,
            )
            losses.update({f"{pid}/{k}": v for k, v in aux.items()})
            self._weights[pid] = self.learners[pid].get_weights()
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
        return dict(self._weights)

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
