"""DQN, the port of ``ray_tpu/rllib/algorithms/dqn.py`` (reference:
rllib/algorithms/dqn/ — double-DQN with target network and replay buffer,
new-stack EnvRunner/Learner shape: CPU actors collect epsilon-greedy
transitions with a numpy policy copy; the learner's double-DQN Huber update
runs on its device (a leased card by default), and the target-network sync
is a copy of the online weights there). Importing this module loads no
torch: the runners' processes never do.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.core._numpy_policy import numpy_q_forward
from ray_tpu_torch.rllib.core.learner import (
    DataParallel,
    adam,
    check_learner_device,
    host_floats,
    learner_device,
    optimizer_step,
    to_device,
)
from ray_tpu_torch.rllib.env._classic_control import make_vec


class ReplayBuffer:
    """Uniform ring buffer of transitions (reference:
    rllib/utils/replay_buffers/ — the uniform subset)."""

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int64)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self.size = 0
        self._pos = 0

    def add_batch(self, batch: Dict[str, np.ndarray]):
        n = len(batch["obs"])
        idx = (self._pos + np.arange(n)) % self.capacity
        self.obs[idx] = batch["obs"]
        self.next_obs[idx] = batch["next_obs"]
        self.actions[idx] = batch["actions"]
        self.rewards[idx] = batch["rewards"]
        self.dones[idx] = batch["dones"]
        self._pos = int((self._pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=n)
        return {
            "obs": self.obs[idx],
            "next_obs": self.next_obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
        }


class DQNEnvRunner:
    """Epsilon-greedy transition collector (CPU actor, numpy policy)."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0):
        self.envs = make_vec(env_name, num_envs, vectorization_mode="sync")
        self.num_envs = num_envs
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.envs.reset(seed=seed)
        self._episode_returns = np.zeros(num_envs)
        # NEXT_STEP autoreset: the step after a done is a
        # fabricated transition (action ignored, reward 0) — mask it out
        self._autoreset = np.zeros(num_envs, bool)

    def obs_and_action_dims(self):
        return (int(np.prod(self.envs.single_observation_space.shape)),
                int(self.envs.single_action_space.n))

    def sample(self, params, rollout_len: int, epsilon: float
               ) -> Dict[str, np.ndarray]:
        T, N = rollout_len, self.num_envs
        obs_b = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        nxt_b = np.zeros_like(obs_b)
        act_b = np.zeros((T, N), np.int64)
        rew_b = np.zeros((T, N), np.float32)
        done_b = np.zeros((T, N), np.float32)
        valid_b = np.ones((T, N), bool)
        completed = []
        for t in range(T):
            q = numpy_q_forward(params, self.obs)
            greedy = q.argmax(axis=-1)
            random = self.rng.integers(0, q.shape[-1], size=N)
            explore = self.rng.random(N) < epsilon
            actions = np.where(explore, random, greedy)
            valid_b[t] = ~self._autoreset
            nxt, rew, term, trunc, _ = self.envs.step(actions)
            done = np.logical_or(term, trunc)
            self._autoreset = done
            obs_b[t] = self.obs
            act_b[t] = actions
            rew_b[t] = rew
            # bootstrap through time-limit truncations, cut on terminations
            done_b[t] = term.astype(np.float32)
            nxt_b[t] = nxt
            self._episode_returns += rew
            for i in np.nonzero(done)[0]:
                completed.append(float(self._episode_returns[i]))
                self._episode_returns[i] = 0.0
            self.obs = nxt
        keep = valid_b.reshape(T * N)
        flat = lambda a: a.reshape((T * N,) + a.shape[2:])[keep]  # noqa: E731
        return {
            "obs": flat(obs_b),
            "next_obs": flat(nxt_b),
            "actions": flat(act_b),
            "rewards": flat(rew_b),
            "dones": flat(done_b),
            "episode_returns": np.asarray(completed, np.float32),
        }


class DQNLearner:
    """Double-DQN update on one device (the card unless built with
    ``device="cpu"``), or on one rank of a dp learner (``mesh_devices`` > 1:
    the batch padded as the JAX learner pads it, this rank's rows)."""

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float = 1e-3,
                 gamma: float = 0.99, hidden=(64, 64), seed: int = 0,
                 mesh_devices: Optional[int] = None, device=None):
        import copy

        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.rllib.core.rl_module import QModule

        self.device = resolve_device(device)
        self.dp = DataParallel(mesh_devices, self.device)
        self.module = QModule(obs_dim, num_actions, hidden, seed=seed).to(self.device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self.lr, self.gamma = lr, gamma
        self.opt = adam(self.module.parameters(), lr, self.device)

    def _loss(self, batch):
        import torch

        q = self.module(batch["obs"])
        q_sa = q.gather(-1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            # double DQN: online net picks the argmax (the first of a tie,
            # as jnp.argmax), target net scores it
            best = torch.argmax(self.module(batch["next_obs"]), dim=-1)
            q_best = self.target(batch["next_obs"]).gather(-1, best[:, None])[:, 0]
            target = batch["rewards"] + self.gamma * (1.0 - batch["dones"]) * q_best
        td = q_sa - target
        # huber
        loss = self.dp.mean(torch.where(torch.abs(td) < 1.0, 0.5 * td * td,
                                        torch.abs(td) - 0.5))
        return loss, {"td_error_mean": self.dp.mean(torch.abs(td))}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        dev = self.dp.rows(to_device(batch, self.device))
        return host_floats(optimizer_step(self.opt, *self._loss(dev), self.dp))

    def sync_target(self):
        self.target.load_state_dict(self.module.state_dict())

    def get_weights(self):
        from ray_tpu_torch.rllib.core.rl_module import flax_params

        return flax_params(self.module)

    def set_weights(self, weights, target_weights=None):
        from ray_tpu_torch.rllib.core.rl_module import load_flax_params

        load_flax_params(self.module, weights)
        load_flax_params(self.target,
                         target_weights if target_weights is not None else weights)
        self.opt = adam(self.module.parameters(), self.lr, self.device)
        return True

    def get_target_weights(self):
        from ray_tpu_torch.rllib.core.rl_module import flax_params

        return flax_params(self.target)

    def num_devices(self) -> int:
        return self.dp.size


class DQNConfig:
    def __init__(self):
        self.env_name: Optional[str] = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 32
        self.lr = 1e-3
        self.gamma = 0.99
        self.buffer_capacity = 100_000
        self.train_batch_size = 256
        self.updates_per_iteration = 32
        self.target_update_freq = 4  # iterations between target syncs
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_iters = 30
        self.learning_starts = 1_000
        self.hidden = (64, 64)
        self.seed = 0
        self.remote_learner = True
        self.num_gpus_per_learner = 1

    def environment(self, env: str) -> "DQNConfig":
        self.env_name = env
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None,
                    rollout_fragment_length=None) -> "DQNConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr=None, gamma=None, buffer_capacity=None,
                 train_batch_size=None, updates_per_iteration=None,
                 target_update_freq=None, epsilon_decay_iters=None,
                 learning_starts=None, model_hidden=None) -> "DQNConfig":
        for name, val in [("lr", lr), ("gamma", gamma),
                          ("buffer_capacity", buffer_capacity),
                          ("train_batch_size", train_batch_size),
                          ("updates_per_iteration", updates_per_iteration),
                          ("target_update_freq", target_update_freq),
                          ("epsilon_decay_iters", epsilon_decay_iters),
                          ("learning_starts", learning_starts),
                          ("hidden", model_hidden)]:
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, *, num_gpus_per_learner: Optional[float] = None
                 ) -> "DQNConfig":
        """GPUs of the learner (upstream's AlgorithmConfig.learners): 1, the
        default, puts it on a leased card (the driver's card when
        ``remote_learner`` is off); 0 on the CPU."""
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "DQNConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build(self) -> "DQN":
        assert self.env_name, "call .environment(env_name) first"
        return DQN(self)


class DQN:
    """Algorithm driver (Tune-trainable shape, like PPO)."""

    def __init__(self, config: DQNConfig):
        cfg = config
        check_learner_device(cfg.num_gpus_per_learner, cfg.remote_learner)
        self.config = cfg
        runner_cls = ray_tpu_torch.remote(DQNEnvRunner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                cfg.env_name, cfg.num_envs_per_runner, seed=cfg.seed + 1000 * i)
            for i in range(cfg.num_env_runners)
        ]
        obs_dim, num_actions = ray_tpu_torch.get(
            self.runners[0].obs_and_action_dims.remote(), timeout=120)
        kw = dict(lr=cfg.lr, gamma=cfg.gamma, hidden=cfg.hidden, seed=cfg.seed,
                  device=learner_device(cfg.num_gpus_per_learner))
        if cfg.remote_learner:
            self._learner_actor = ray_tpu_torch.remote(DQNLearner).options(
                num_cpus=1, num_gpus=cfg.num_gpus_per_learner).remote(
                    obs_dim, num_actions, **kw)
            self._learner = None
            self._weights = ray_tpu_torch.get(
                self._learner_actor.get_weights.remote(), timeout=120)
        else:
            self._learner_actor = None
            self._learner = DQNLearner(obs_dim, num_actions, **kw)
            self._weights = self._learner.get_weights()
        self.buffer = ReplayBuffer(cfg.buffer_capacity, obs_dim)
        self.rng = np.random.default_rng(cfg.seed)
        self._iteration = 0
        self._timesteps = 0
        self._recent_returns: deque = deque(maxlen=100)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def _learner_call(self, method, *args, **kw):
        if self._learner is not None:
            return getattr(self._learner, method)(*args, **kw)
        return ray_tpu_torch.get(
            getattr(self._learner_actor, method).remote(*args, **kw),
            timeout=300)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        eps = self._epsilon()
        refs = [r.sample.remote(self._weights, cfg.rollout_fragment_length, eps)
                for r in self.runners]
        batches = ray_tpu_torch.get(refs, timeout=300)
        for b in batches:
            self._recent_returns.extend(b.pop("episode_returns").tolist())
            self._timesteps += len(b["obs"])
            self.buffer.add_batch(b)
        losses: Dict[str, float] = {}
        if self.buffer.size >= cfg.learning_starts:
            for _ in range(cfg.updates_per_iteration):
                mb = self.buffer.sample(self.rng, cfg.train_batch_size)
                losses = self._learner_call("update", mb)
            if self._iteration % cfg.target_update_freq == 0:
                self._learner_call("sync_target")
            self._weights = self._learner_call("get_weights")
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
            "epsilon": self._epsilon(),
            "time_this_iter_s": time.perf_counter() - t0,
            **{f"learner/{k}": v for k, v in losses.items()},
        }

    def get_weights(self):
        return self._weights

    def save(self, checkpoint_dir: Optional[str] = None) -> str:
        """Persist online+target weights, config and counters (reference:
        Algorithm.save / Checkpointable)."""
        import os
        import tempfile

        import cloudpickle

        path = checkpoint_dir or tempfile.mkdtemp(prefix="dqn_ckpt_")
        os.makedirs(path, exist_ok=True)
        target = self._learner_call("get_target_weights")
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            cloudpickle.dump({
                "algo": "DQN",
                "config": self.config,
                "weights": self._weights,
                "target_weights": target,
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
        self._learner_call("set_weights", state["weights"],
                           state.get("target_weights"))
        return self

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str) -> "DQN":
        import os

        import cloudpickle

        with open(os.path.join(checkpoint_path, "algorithm_state.pkl"),
                  "rb") as f:
            state = cloudpickle.load(f)
        algo = cls(state["config"])
        return algo.restore(checkpoint_path, _state=state)

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        if self._learner_actor is not None:
            try:
                ray_tpu_torch.kill(self._learner_actor)
            except Exception:
                pass
