"""BC and MARWIL: offline RL from recorded experiences via ray_tpu_torch.data,
the port of ``ray_tpu/rllib/algorithms/bc.py``.

Reference: rllib/algorithms/bc/bc.py + rllib/algorithms/marwil/marwil.py —
MARWIL (Wang et al. 2018) is exponentially advantage-weighted behavior
cloning; BC is its beta=0 special case (the reference literally subclasses
MARWIL for BC). One minibatch update is one Adam step on the learner's
device (the driver's card by default); the advantage normalizer c^2 is
the same running average of squared advantages the reference keeps
(marwil_torch_policy moving_average of ma_adv_norm).

Data path: experiences load through ray_tpu_torch.data.read_parquet (reference:
offline_data.py wraps ray.data the same way); each train() epoch reshuffles
block order and streams minibatches.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.core.learner import (
    adam,
    check_learner_device,
    host_floats,
    learner_device,
    optimizer_step,
    to_device,
)
from ray_tpu_torch.rllib.env._classic_control import make
from ray_tpu_torch.rllib.offline import batch_to_numpy, read_experiences


class _MarwilLearner:
    """Advantage-weighted BC update (beta=0 degrades to pure BC) on one
    device, the card unless built with ``device="cpu"``."""

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float = 1e-3,
                 beta: float = 1.0, vf_coeff: float = 1.0,
                 hidden=(64, 64), seed: int = 0, device=None):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule

        self.device = resolve_device(device)
        self.module = ActorCriticModule(obs_dim, num_actions, hidden, seed=seed).to(self.device)
        self.opt = adam(self.module.parameters(), lr, self.device)
        self.beta = beta
        self.vf_coeff = vf_coeff
        # running mean of squared advantages (reference: ma_adv_norm);
        # warm-started from the first batch — with a cold norm of 1 every
        # early weight saturates at the clip and the policy burns in on
        # uniformly-upweighted garbage before the normalizer catches up
        self.ma_adv_sq: Optional[float] = None

    def _loss(self, batch, adv_norm: float):
        import torch
        import torch.nn.functional as F

        logits, values = self.module(batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["action"].long()[:, None])[:, 0]
        adv = batch["return_to_go"] - values
        if self.beta > 0.0:
            w = torch.exp(self.beta * adv.detach() / adv_norm)
            # clip the exponential weights like the reference (1e8 cap
            # is its untuned default; 20 keeps fp32 sane)
            w = torch.clamp(w, max=20.0)
            vf_loss = torch.mean(adv ** 2)
        else:
            w = torch.ones_like(logp)
            vf_loss = torch.zeros((), device=logp.device)
        pi_loss = -torch.mean(w * logp)
        total = pi_loss + (self.vf_coeff * vf_loss if self.beta > 0.0 else 0.0)
        return total, {
            "pi_loss": pi_loss, "vf_loss": vf_loss,
            "mean_abs_adv": torch.mean(torch.abs(adv)),
            "mean_sq_adv": torch.mean(adv ** 2),
            "mean_weight": torch.mean(w),
            "mean_logp": torch.mean(logp),
        }

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        import torch

        dev = to_device(batch, self.device)
        if self.ma_adv_sq is None:
            # warm start: one norm-estimation pass that steps nothing
            with torch.no_grad():
                _, aux0 = self._loss(dev, 1e9)
            self.ma_adv_sq = max(float(aux0["mean_sq_adv"]), 1e-8)
        adv_norm = max(float(np.sqrt(self.ma_adv_sq)), 1e-4)
        aux = host_floats(optimizer_step(self.opt, *self._loss(dev, adv_norm)))
        # EMA of squared advantages, like the reference's moving-average
        # ma_adv_norm but fast enough to settle within a test-sized run
        self.ma_adv_sq += 0.05 * (aux["mean_sq_adv"] - self.ma_adv_sq)
        return aux

    def get_weights(self):
        from ray_tpu_torch.rllib.core.rl_module import flax_params

        return flax_params(self.module)


class MARWILConfig:
    _default_beta = 1.0  # 0 = BC

    def __init__(self):
        self.env_name: Optional[str] = None
        self.offline_path = None
        self.lr = 1e-3
        self.beta = type(self)._default_beta
        self.vf_coeff = 1.0
        self.train_batch_size = 512
        self.minibatches_per_iter = 32
        self.hidden = (64, 64)
        self.seed = 0
        self.num_gpus_per_learner = 1

    def environment(self, env: str):
        self.env_name = env
        return self

    def offline_data(self, path):
        """Parquet path(s) of recorded experiences (reference:
        config.offline_data(input_=...))."""
        self.offline_path = path
        return self

    def training(self, *, lr=None, beta=None, vf_coeff=None,
                 train_batch_size=None, minibatches_per_iter=None,
                 model_hidden=None):
        for name, val in [("lr", lr), ("beta", beta), ("vf_coeff", vf_coeff),
                          ("train_batch_size", train_batch_size),
                          ("minibatches_per_iter", minibatches_per_iter),
                          ("hidden", model_hidden)]:
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, *, num_gpus_per_learner=None):
        """GPUs of the learner, which runs in the driver (upstream's
        AlgorithmConfig.learners): 1, the default, puts it on the driver's
        card; 0 on the CPU."""
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def debugging(self, *, seed=None):
        if seed is not None:
            self.seed = seed
        return self

    def build(self):
        assert self.offline_path, "call .offline_data(path) first"
        assert self.env_name, "call .environment(env) first"
        return MARWIL(self)


class BCConfig(MARWILConfig):
    _default_beta = 0.0


class MARWIL:
    def __init__(self, config: MARWILConfig):
        check_learner_device(config.num_gpus_per_learner, remote=False)
        self.config = config
        self.dataset = read_experiences(config.offline_path)
        spec = make(config.env_name)
        obs_dim = int(np.prod(spec.observation_space.shape))
        num_actions = int(spec.action_space.n)
        spec.close()
        self.learner = _MarwilLearner(
            obs_dim, num_actions, lr=config.lr, beta=config.beta,
            vf_coeff=config.vf_coeff, hidden=config.hidden, seed=config.seed,
            device=learner_device(config.num_gpus_per_learner))
        self._iteration = 0
        self._epoch_iter = None
        # Dataset-level return statistics: the value head regresses the
        # STANDARDIZED return-to-go (raw CartPole-scale returns ~1e2 put a
        # ~1e4-scale vf gradient through the shared trunk and crush the
        # policy features; the reference's marwil keeps the scales sane via
        # its moving advantage norm — standardizing the target is the
        # batch-independent equivalent).
        if config.beta > 0:
            count, total, sq = 0, 0.0, 0.0
            for b in self.dataset.iter_batches(batch_size=4096):
                r = np.asarray(batch_to_numpy(b)["return_to_go"], np.float64)
                count += r.size
                total += float(r.sum())
                sq += float((r ** 2).sum())
            mu = total / max(count, 1)
            var = max(sq / max(count, 1) - mu * mu, 1e-6)
            self._rtg_stats = (mu, float(np.sqrt(var)))
        else:
            self._rtg_stats = (0.0, 1.0)

    def _next_batch(self):
        for _ in range(2):
            if self._epoch_iter is None:
                self._epoch_iter = self.dataset.random_shuffle(
                    seed=self.config.seed + self._iteration
                ).iter_batches(batch_size=self.config.train_batch_size)
            try:
                return next(self._epoch_iter)
            except StopIteration:
                self._epoch_iter = None
        raise RuntimeError("offline dataset is empty")

    def train(self) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        for _ in range(self.config.minibatches_per_iter):
            batch = batch_to_numpy(self._next_batch())
            mu, sigma = self._rtg_stats
            batch = {
                "obs": batch["obs"].astype(np.float32),
                "action": batch["action"].astype(np.int32),
                "return_to_go": (
                    (batch["return_to_go"].astype(np.float32) - mu) / sigma),
            }
            metrics = self.learner.update(batch)
        self._iteration += 1
        metrics["training_iteration"] = self._iteration
        return metrics

    def evaluate(self, num_episodes: int = 10, *, greedy: bool = True,
                 seed: int = 1000) -> Dict[str, float]:
        """Run the learned policy in the real env (reference: the
        evaluation workers offline algos attach for exactly this)."""
        from ray_tpu_torch.rllib.core._numpy_policy import numpy_forward

        params = self.learner.get_weights()
        env = make(self.config.env_name)
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=seed + ep)
            total, done = 0.0, False
            while not done:
                logits, _ = numpy_forward(params, np.asarray(obs)[None])
                if greedy:
                    action = int(np.argmax(logits[0]))
                else:
                    p = np.exp(logits[0] - logits[0].max())
                    action = int(np.random.choice(len(p), p=p / p.sum()))
                obs, reward, term, trunc, _ = env.step(action)
                total += float(reward)
                done = bool(term or trunc)
            returns.append(total)
        env.close()
        return {"episode_return_mean": float(np.mean(returns)),
                "episodes": num_episodes}

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        pass


class BC(MARWIL):
    """Behavior cloning = MARWIL with beta=0 (reference: bc.py subclasses
    MARWIL the same way)."""

    def __init__(self, config: BCConfig):
        super().__init__(config)
