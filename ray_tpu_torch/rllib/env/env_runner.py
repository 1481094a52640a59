"""SingleAgentEnvRunner + EnvRunnerGroup, the port of
``ray_tpu/rllib/env/env_runner.py`` (reference:
rllib/env/single_agent_env_runner.py:61, env_runner_group.py:71): CPU actors
stepping sync vector envs (``_classic_control.make_vec``: the numpy copies
of CartPole-v1 and Pendulum-v1, gymnasium for any other id) with a numpy
copy of the policy, returning GAE-processed rollout batches. The policy
forward is pure numpy, so runner processes never import torch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.core._numpy_policy import numpy_forward, sample_actions
from ray_tpu_torch.rllib.env._classic_control import make_vec


class SingleAgentEnvRunner:
    def __init__(self, env_name: str, num_envs: int, *, gamma: float,
                 lambda_: float, seed: int = 0):
        self.envs = make_vec(env_name, num_envs, vectorization_mode="sync")
        self.num_envs = num_envs
        self.gamma = gamma
        self.lambda_ = lambda_
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.envs.reset(seed=seed)
        self._episode_returns = np.zeros(num_envs)
        self._completed: List[float] = []
        # NEXT_STEP autoreset: the step after a done ignores the
        # action and returns the reset obs with reward 0 — those fabricated
        # transitions must not be trained on
        self._autoreset = np.zeros(num_envs, bool)

    def obs_and_action_dims(self):
        return (int(np.prod(self.envs.single_observation_space.shape)),
                int(self.envs.single_action_space.n))

    def _rollout(self, params, rollout_len: int) -> Dict[str, np.ndarray]:
        """Shared env-stepping core: time-major buffers for rollout_len
        steps per env (policy forward, vector step, episode bookkeeping).
        Both the on-policy (GAE) and off-policy (v-trace) samplers build on
        this."""
        T, N = rollout_len, self.num_envs
        obs_buf = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        act_buf = np.zeros((T, N), np.int64)
        logp_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        valid_buf = np.ones((T, N), bool)
        self._completed = []
        for t in range(T):
            logits, v = numpy_forward(params, self.obs)
            actions, logp = sample_actions(self.rng, logits)
            valid_buf[t] = ~self._autoreset
            nxt, rew, term, trunc, _ = self.envs.step(actions)
            done = np.logical_or(term, trunc)
            self._autoreset = done
            obs_buf[t] = self.obs
            act_buf[t] = actions
            logp_buf[t] = logp
            rew_buf[t] = rew
            val_buf[t] = v
            done_buf[t] = done.astype(np.float32)
            self._episode_returns += rew
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._episode_returns[i]))
                self._episode_returns[i] = 0.0
            self.obs = nxt
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "rewards": rew_buf, "values": val_buf, "dones": done_buf,
            "valid": valid_buf,
        }

    def sample(self, params, rollout_len: int) -> Dict[str, np.ndarray]:
        """Collect rollout_len steps per env; returns a flat batch with GAE
        advantages/returns plus completed-episode stats."""
        T, N = rollout_len, self.num_envs
        roll = self._rollout(params, rollout_len)
        obs_buf, act_buf, logp_buf = roll["obs"], roll["actions"], roll["logp"]
        rew_buf, val_buf, done_buf = (
            roll["rewards"], roll["values"], roll["dones"]
        )
        _, last_v = numpy_forward(params, self.obs)
        adv = np.zeros((T, N), np.float32)
        lastgae = np.zeros(N, np.float32)
        for t in reversed(range(T)):
            nonterminal = 1.0 - done_buf[t]
            next_v = val_buf[t + 1] if t + 1 < T else last_v
            delta = rew_buf[t] + self.gamma * next_v * nonterminal - val_buf[t]
            lastgae = delta + self.gamma * self.lambda_ * nonterminal * lastgae
            adv[t] = lastgae
        returns = adv + val_buf
        keep = roll["valid"].reshape(T * N)
        flat = lambda a: a.reshape((T * N,) + a.shape[2:])[keep]  # noqa: E731
        return {
            "obs": flat(obs_buf),
            "actions": flat(act_buf),
            "logp_old": flat(logp_buf),
            "advantages": flat(adv),
            "returns": flat(returns),
            "episode_returns": np.asarray(self._completed, np.float32),
        }

    def sample_trajectory(self, params, rollout_len: int) -> Dict[str, np.ndarray]:
        """Time-major trajectory WITHOUT advantage processing — the
        off-policy learner (IMPALA v-trace) needs raw sequences plus the
        behavior policy's log-probs (reference:
        rllib/algorithms/impala — decoupled sampling)."""
        roll = self._rollout(params, rollout_len)
        return {
            "obs": roll["obs"],
            "actions": roll["actions"],
            "behavior_logp": roll["logp"],
            "rewards": roll["rewards"],
            "dones": roll["dones"],
            # sequences must stay time-contiguous for v-trace, so invalid
            # (autoreset) rows are weighted out in the learner's loss
            "valid": roll["valid"].astype(np.float32),
            "bootstrap_obs": self.obs.astype(np.float32),
            "episode_returns": np.asarray(self._completed, np.float32),
        }


class EnvRunnerGroup:
    def __init__(self, env_name: str, *, num_runners: int,
                 num_envs_per_runner: int, gamma: float, lambda_: float,
                 seed: int = 0):
        runner_cls = ray_tpu_torch.remote(SingleAgentEnvRunner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                env_name, num_envs_per_runner, gamma=gamma, lambda_=lambda_,
                seed=seed + 1000 * i,
            )
            for i in range(num_runners)
        ]

    def obs_and_action_dims(self):
        return ray_tpu_torch.get(self.runners[0].obs_and_action_dims.remote(),
                           timeout=120)

    def sample(self, params, rollout_len: int) -> Dict[str, np.ndarray]:
        """Parallel rollouts; concatenated into one training batch."""
        refs = [r.sample.remote(params, rollout_len) for r in self.runners]
        batches = ray_tpu_torch.get(refs, timeout=300)
        out = {
            k: np.concatenate([b[k] for b in batches])
            for k in batches[0]
        }
        return out

    def shutdown(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
