"""SAC — Soft Actor-Critic for continuous control, the port of
``ray_tpu/rllib/algorithms/sac.py`` (reference: rllib/algorithms/sac/sac.py:407
+ sac_learner/sac_torch_learner, new-stack EnvRunner/Learner shape: CPU
actors collect transitions with a numpy copy of the squashed-Gaussian
policy; the update — twin-critic TD, reparameterized actor, auto-tuned
temperature, polyak target sync — runs on the learner's device, the
driver's card by default). Importing this module loads no torch: the
runners' processes never do.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.core._numpy_policy import (
    numpy_gaussian_forward,
    sample_squashed_actions,
)
from ray_tpu_torch.rllib.core.learner import (
    DataParallel,
    adam,
    check_learner_device,
    host_floats,
    learner_device,
    to_device,
)
from ray_tpu_torch.rllib.env._classic_control import make_vec


class ContinuousReplayBuffer:
    """Uniform ring buffer of continuous-action transitions."""

    def __init__(self, capacity: int, obs_dim: int, action_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, action_dim), np.float32)
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


class SACEnvRunner:
    """Transition collector for continuous action spaces (CPU actor,
    numpy policy copy — never imports torch)."""

    def __init__(self, env_name: str, num_envs: int, seed: int = 0):
        self.envs = make_vec(env_name, num_envs, vectorization_mode="sync")
        self.num_envs = num_envs
        self.rng = np.random.default_rng(seed)
        self.obs, _ = self.envs.reset(seed=seed)
        space = self.envs.single_action_space
        self.low = np.asarray(space.low, np.float32)
        self.high = np.asarray(space.high, np.float32)
        self._episode_returns = np.zeros(num_envs)
        # NEXT_STEP autoreset: mask the fabricated post-done step
        self._autoreset = np.zeros(num_envs, bool)

    def space_dims(self):
        return (
            int(np.prod(self.envs.single_observation_space.shape)),
            int(np.prod(self.envs.single_action_space.shape)),
            self.low.tolist(),
            self.high.tolist(),
        )

    def sample(self, actor_params, rollout_len: int, *,
               random: bool = False) -> Dict[str, np.ndarray]:
        """rollout_len steps per env; `random=True` collects warm-up
        transitions from the uniform policy (reference: SAC's
        num_steps_sampled_before_learning_starts)."""
        T, N = rollout_len, self.num_envs
        obs_b = np.zeros((T, N) + self.obs.shape[1:], np.float32)
        nxt_b = np.zeros_like(obs_b)
        act_b = np.zeros((T, N) + self.low.shape, np.float32)
        rew_b = np.zeros((T, N), np.float32)
        done_b = np.zeros((T, N), np.float32)
        valid_b = np.ones((T, N), bool)
        completed = []
        for t in range(T):
            valid_b[t] = ~self._autoreset
            if random:
                actions = self.rng.uniform(
                    self.low, self.high, size=(N,) + self.low.shape
                ).astype(np.float32)
            else:
                mean, log_std = numpy_gaussian_forward(actor_params, self.obs)
                actions = sample_squashed_actions(
                    self.rng, mean, log_std, self.low, self.high
                ).astype(np.float32)
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


class SACLearner:
    """Twin critics, a reparameterized actor and auto-alpha on one device
    (the card unless built with ``device="cpu"``).

    Actions are learned in squashed space scaled to the env bounds; the
    tanh log-det correction keeps the entropy term exact
    (reference: sac_torch_learner.compute_loss_for_module). The noise of
    each update's two reparameterized samples is drawn on the host from a
    ``torch.Generator`` seeded with ``seed + 2``, for the whole batch padded
    to the rank count (as the JAX learner draws its noise for the padded
    batch); :meth:`update_with_noise` takes it from the caller. Under dp
    (``mesh_devices`` > 1) every rank draws the same noise and keeps its
    rows; the critic, actor and temperature gradients are summed over the
    ranks before each of their steps."""

    def __init__(self, obs_dim: int, action_dim: int, low, high, *,
                 actor_lr: float = 3e-4, critic_lr: float = 3e-4,
                 alpha_lr: float = 3e-4, gamma: float = 0.99,
                 tau: float = 0.005, hidden=(256, 256), seed: int = 0,
                 target_entropy: Optional[float] = None,
                 mesh_devices: Optional[int] = None, device=None):
        import copy

        import torch

        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.rllib.core.rl_module import (
            SquashedGaussianModule,
            TwinQModule,
        )

        self.device = dev = resolve_device(device)
        self.dp = DataParallel(mesh_devices, dev)
        self.action_dim = action_dim
        self.actor = SquashedGaussianModule(obs_dim, action_dim, hidden,
                                            seed=seed).to(dev)
        self.critic = TwinQModule(obs_dim, action_dim, hidden, seed=seed + 1).to(dev)
        self.target = copy.deepcopy(self.critic).requires_grad_(False)
        self.log_alpha = torch.zeros((), device=dev, requires_grad=True)
        self.actor_opt = adam(self.actor.parameters(), actor_lr, dev)
        self.critic_opt = adam(self.critic.parameters(), critic_lr, dev)
        self.alpha_opt = adam([self.log_alpha], alpha_lr, dev)
        self._gen = torch.Generator().manual_seed(seed + 2)
        if target_entropy is None:
            target_entropy = -float(action_dim)  # reference default
        self.gamma, self.tau, self.target_entropy = gamma, tau, target_entropy
        low = torch.as_tensor(np.asarray(low, np.float32), device=dev)
        high = torch.as_tensor(np.asarray(high, np.float32), device=dev)
        self.scale = (high - low) * 0.5
        self.center = (high + low) * 0.5

    def _sample_action(self, obs, noise):
        """A squashed action and its log-prob under the current actor, from
        standard-normal ``noise``."""
        import math

        import torch

        mean, log_std = self.actor(obs)
        std = torch.exp(log_std)
        raw = mean + std * noise
        squashed = torch.tanh(raw)
        action = self.center + self.scale * squashed
        # Gaussian logp minus tanh log-det minus the affine scale
        logp = (
            -0.5 * (((raw - mean) / std) ** 2
                    + 2.0 * log_std + math.log(2.0 * math.pi))
        ).sum(-1)
        logp = logp - torch.log(self.scale * (1.0 - squashed ** 2) + 1e-6).sum(-1)
        return action, logp

    def update_with_noise(self, batch, noise_next, noise) -> Dict[str, float]:
        """One update: the critics on the soft target from the next obs
        (actor noise ``noise_next``), then the actor under the fresh critics
        (``noise``), then the temperature, then the polyak target; both
        noise arrays are (rows, action_dim), of the batch's rows or of its
        rows padded to the rank count."""
        import torch

        dp = self.dp
        b = {k: dp.pad(v) for k, v in to_device(batch, self.device).items()}
        rows = len(b["obs"])
        for k, v in to_device({"noise_next": noise_next, "noise": noise},
                              self.device).items():
            b[k] = v if len(v) == rows else dp.pad(v)
        b = {k: dp.shard(v) for k, v in b.items()}
        alpha = torch.exp(self.log_alpha.detach())

        # --- critic: clipped double-Q soft target
        with torch.no_grad():
            next_a, next_logp = self._sample_action(b["next_obs"], b["noise_next"])
            tq1, tq2 = self.target(b["next_obs"], next_a)
            target_q = b["rewards"] + self.gamma * (1.0 - b["dones"]) * (
                torch.minimum(tq1, tq2) - alpha * next_logp)
        q1, q2 = self.critic(b["obs"], b["actions"])
        critic_loss = dp.mean((q1 - target_q) ** 2 + (q2 - target_q) ** 2)
        self.critic_opt.zero_grad(set_to_none=True)
        critic_loss.backward()
        critic_loss = critic_loss.detach().clone()
        dp.all_sum([p.grad for p in self.critic.parameters()] + [critic_loss])
        self.critic_opt.step()

        # --- actor: maximize soft value under the fresh critics
        a, logp = self._sample_action(b["obs"], b["noise"])
        q1, q2 = self.critic(b["obs"], a)
        actor_loss = dp.mean(alpha * logp - torch.minimum(q1, q2))
        actor_params = list(self.actor.parameters())
        grads = torch.autograd.grad(actor_loss, actor_params)
        for p, g in zip(actor_params, grads):
            p.grad = g

        # --- temperature: drive entropy toward the target (its loss reads
        # the actor's samples, not its parameters: stepping the actor first
        # or after changes nothing)
        alpha_loss = -dp.mean(self.log_alpha * (logp.detach() + self.target_entropy))
        self.alpha_opt.zero_grad(set_to_none=True)
        alpha_loss.backward()
        values = torch.stack([actor_loss.detach(), alpha_loss.detach(),
                              -dp.mean(logp.detach())])
        dp.all_sum(list(grads) + [self.log_alpha.grad, values])
        self.actor_opt.step()
        self.alpha_opt.step()

        # --- polyak target sync, every step (tau-weighted)
        with torch.no_grad():
            for t, o in zip(self.target.parameters(), self.critic.parameters()):
                t.mul_(1.0 - self.tau).add_(self.tau * o)
        return host_floats({
            "critic_loss": critic_loss,
            "actor_loss": values[0],
            "alpha_loss": values[1],
            "alpha": alpha,
            "entropy": values[2],
        })

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        import torch

        rows = len(batch["obs"])
        rows += (-rows) % self.dp.size
        shape = (2, rows, self.action_dim)
        noise = torch.randn(shape, generator=self._gen).numpy()
        return self.update_with_noise(batch, noise[0], noise[1])

    def get_actor_weights(self):
        from ray_tpu_torch.rllib.core.rl_module import flax_params

        return flax_params(self.actor)

    def num_devices(self) -> int:
        return self.dp.size


class SACConfig:
    def __init__(self):
        self.env_name: Optional[str] = None
        self.num_env_runners = 1
        self.num_envs_per_runner = 4
        self.rollout_fragment_length = 32
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4
        self.alpha_lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005
        self.hidden = (256, 256)
        self.buffer_capacity = 200_000
        self.train_batch_size = 256
        self.learner_steps_per_iteration = 32
        self.learning_starts = 1_500
        self.target_entropy: Optional[float] = None
        self.seed = 0
        self.num_gpus_per_learner = 1

    def environment(self, env: str) -> "SACConfig":
        self.env_name = env
        return self

    def env_runners(self, *, num_env_runners=None,
                    num_envs_per_env_runner=None,
                    rollout_fragment_length=None) -> "SACConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, actor_lr=None, critic_lr=None, alpha_lr=None,
                 gamma=None, tau=None, model_hidden=None,
                 buffer_capacity=None, train_batch_size=None,
                 learner_steps_per_iteration=None, learning_starts=None,
                 target_entropy=None) -> "SACConfig":
        for name, val in [
            ("actor_lr", actor_lr), ("critic_lr", critic_lr),
            ("alpha_lr", alpha_lr), ("gamma", gamma), ("tau", tau),
            ("hidden", model_hidden), ("buffer_capacity", buffer_capacity),
            ("train_batch_size", train_batch_size),
            ("learner_steps_per_iteration", learner_steps_per_iteration),
            ("learning_starts", learning_starts),
            ("target_entropy", target_entropy),
        ]:
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, *, num_gpus_per_learner: Optional[float] = None
                 ) -> "SACConfig":
        """GPUs of the learner, which runs in the driver (upstream's
        AlgorithmConfig.learners): 1, the default, puts it on the driver's
        card; 0 on the CPU."""
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "SACConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build(self) -> "SAC":
        assert self.env_name, "call .environment(env_name) first"
        return SAC(self)


class SAC:
    """Algorithm driver (Tune-trainable shape: train() per iteration).

    Off-policy loop: runners push transitions into the driver-side
    replay buffer; `learner_steps_per_iteration` updates sample from
    it (reference: sac.py training_step)."""

    def __init__(self, config: SACConfig):
        cfg = config
        check_learner_device(cfg.num_gpus_per_learner, remote=False)
        self.config = cfg
        runner_cls = ray_tpu_torch.remote(SACEnvRunner)
        self.runners = [
            runner_cls.options(num_cpus=1).remote(
                cfg.env_name, cfg.num_envs_per_runner,
                seed=cfg.seed + 1000 * i,
            )
            for i in range(cfg.num_env_runners)
        ]
        obs_dim, act_dim, low, high = ray_tpu_torch.get(
            self.runners[0].space_dims.remote(), timeout=120
        )
        self.learner = SACLearner(
            obs_dim, act_dim, low, high,
            actor_lr=cfg.actor_lr, critic_lr=cfg.critic_lr,
            alpha_lr=cfg.alpha_lr, gamma=cfg.gamma, tau=cfg.tau,
            hidden=cfg.hidden, seed=cfg.seed,
            target_entropy=cfg.target_entropy,
            device=learner_device(cfg.num_gpus_per_learner),
        )
        self.buffer = ContinuousReplayBuffer(cfg.buffer_capacity, obs_dim,
                                             act_dim)
        self.rng = np.random.default_rng(cfg.seed)
        self._weights = self.learner.get_actor_weights()
        self._iteration = 0
        self._timesteps = 0
        self._recent_returns: deque = deque(maxlen=50)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        warmup = self.buffer.size < cfg.learning_starts
        refs = [
            r.sample.remote(self._weights, cfg.rollout_fragment_length,
                            random=warmup)
            for r in self.runners
        ]
        losses: Dict[str, float] = {}
        for b in ray_tpu_torch.get(refs, timeout=300):
            self._recent_returns.extend(b.pop("episode_returns").tolist())
            self._timesteps += len(b["obs"])
            self.buffer.add_batch(b)
        if self.buffer.size >= cfg.learning_starts:
            for _ in range(cfg.learner_steps_per_iteration):
                mb = self.buffer.sample(self.rng, cfg.train_batch_size)
                losses = self.learner.update(mb)
            self._weights = self.learner.get_actor_weights()
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
        import os
        import tempfile

        import cloudpickle

        path = checkpoint_dir or tempfile.mkdtemp(prefix="sac_ckpt_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            cloudpickle.dump({
                "algo": "SAC",
                "config": self.config,
                "weights": self._weights,
                "iteration": self._iteration,
                "timesteps": self._timesteps,
            }, f)
        return path

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
