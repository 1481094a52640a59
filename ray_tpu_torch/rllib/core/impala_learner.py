"""IMPALA learner: the V-trace off-policy actor-critic update, the port of
``ray_tpu/rllib/core/impala_learner.py``.

Reference: rllib/algorithms/impala/ (decoupled env runners stream
trajectories to a continuously-updating learner; staleness is corrected
with V-trace importance weighting, Espeholt et al. 2018). One update is the
forward over the (T, N) sequence batch, v-trace as a reverse loop over T on
the device, the gradients and one Adam step, on the learner's device. A dp
learner (``mesh_devices`` > 1, one rank per card) pads the env axis as the
JAX learner does and gives each rank its 1/d of the envs: v-trace runs
along T within an env, so the shards are independent, and the weighted
means divide by the whole padded batch's weight on every rank.
Importing this module loads no torch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.core.learner import (
    DataParallel,
    adam,
    host_floats,
    optimizer_step,
    to_device,
)


def vtrace(rho, rewards, discounts, values, bootstrap_v, c):
    """V-trace targets vs and policy-gradient advantages (all (T, N)
    tensors; ``bootstrap_v`` is (N,)).

    rho/c are the already-clipped importance ratios min(rho_bar, pi/mu) /
    min(c_bar, pi/mu)."""
    import torch

    next_values = torch.cat([values[1:], bootstrap_v[None]], dim=0)
    deltas = rho * (rewards + discounts * next_values - values)
    vs_minus_v = torch.empty_like(values)
    acc = torch.zeros_like(bootstrap_v)
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * c[t] * acc
        vs_minus_v[t] = acc
    vs = values + vs_minus_v
    vs_next = torch.cat([vs[1:], bootstrap_v[None]], dim=0)
    pg_adv = rho * (rewards + discounts * vs_next - values)
    return vs, pg_adv


def shard_time_major(batch: Dict[str, np.ndarray], dp: DataParallel, device):
    """A time-major (T, N) trajectory batch on ``device``, its env axis padded
    to a multiple of the rank count by repeating the last env, as the JAX
    learner pads it to its mesh (bootstrap_obs is (N, obs)), and this rank's
    shard of the envs; with the whole padded batch's weight ``wsum``
    (``valid`` summed, at least 1), which every rank's weighted means
    divide by."""
    import torch

    dev = to_device(batch, device)
    # env axis: 0 of bootstrap_obs (N, obs), 1 of every (T, N, ...) array
    dev = {k: dp.pad(v, 0 if k == "bootstrap_obs" else 1) for k, v in dev.items()}
    wsum = torch.clamp(torch.sum(dev["valid"]), min=1.0)
    dev = {k: dp.shard(v, 0 if k == "bootstrap_obs" else 1) for k, v in dev.items()}
    dev["wsum"] = wsum
    return dev


def time_major_forward(module, batch):
    """(log-softmax over actions (T, N, A), log-prob of the taken actions
    (T, N), values (T, N)) of ``module`` on a time-major batch."""
    import torch.nn.functional as F

    T, N = batch["actions"].shape
    obs = batch["obs"]
    logits, v = module(obs.reshape((T * N,) + tuple(obs.shape[2:])))
    logp_all = F.log_softmax(logits.reshape(T, N, -1), dim=-1)
    target_logp = logp_all.gather(-1, batch["actions"][..., None])[..., 0]
    return logp_all, target_logp, v.reshape(T, N)


class ImpalaLearner:
    """Owns the actor-critic and its optimizer on one device; one update per
    time-major trajectory batch from (possibly stale) behavior policies."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 lr: float = 5e-4, gamma: float = 0.99,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 rho_bar: float = 1.0, c_bar: float = 1.0,
                 hidden=(64, 64), seed: int = 0,
                 mesh_devices: Optional[int] = None, device=None):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule

        self.device = resolve_device(device)
        self.dp = DataParallel(mesh_devices, self.device)
        self.module = ActorCriticModule(obs_dim, num_actions, hidden, seed=seed).to(self.device)
        self.lr = lr
        self.opt = adam(self.module.parameters(), lr, self.device)
        self.gamma, self.vf_coeff, self.entropy_coeff = gamma, vf_coeff, entropy_coeff
        self.rho_bar, self.c_bar = rho_bar, c_bar

    def _loss(self, batch):
        import torch

        logp_all, target_logp, values = time_major_forward(self.module, batch)
        ratio = torch.exp(target_logp - batch["behavior_logp"])
        rho = torch.clamp(ratio, max=self.rho_bar)
        c = torch.clamp(ratio, max=self.c_bar)
        discounts = self.gamma * (1.0 - batch["dones"])
        with torch.no_grad():
            _, boot_v = self.module(batch["bootstrap_obs"])
            vs, pg_adv = vtrace(rho, batch["rewards"], discounts, values,
                                boot_v, c)
        # autoreset rows (action ignored by the env) carry zero weight
        w, wsum = batch["valid"], batch["wsum"]
        pi_loss = -torch.sum(w * target_logp * pg_adv) / wsum
        vf_loss = 0.5 * torch.sum(w * (values - vs) ** 2) / wsum
        entropy = -torch.sum(
            w * torch.sum(torch.exp(logp_all) * logp_all, dim=-1)) / wsum
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_rho": self.dp.mean(rho)}

    def update_from_trajectories(
        self, batch: Dict[str, np.ndarray]
    ) -> Dict[str, float]:
        """One v-trace gradient step on a time-major (T, N) batch."""
        batch = {k: v for k, v in batch.items() if k != "episode_returns"}
        dev = shard_time_major(batch, self.dp, self.device)
        return host_floats(optimizer_step(self.opt, *self._loss(dev), self.dp))

    def get_weights(self):
        from ray_tpu_torch.rllib.core.rl_module import flax_params

        return flax_params(self.module)

    def set_weights(self, weights):
        from ray_tpu_torch.rllib.core.rl_module import load_flax_params

        load_flax_params(self.module, weights)
        self.opt = adam(self.module.parameters(), self.lr, self.device)
        return True

    def num_devices(self) -> int:
        return self.dp.size
