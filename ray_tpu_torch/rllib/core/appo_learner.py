"""APPO learner: asynchronous PPO, the port of
``ray_tpu/rllib/core/appo_learner.py`` — IMPALA's decoupled engine with a
PPO-clipped surrogate computed against a periodically-synced target policy.

Reference: rllib/algorithms/appo/appo.py:277 + appo_torch_policy.py — APPO
runs IMPALA's async rollout plan, but the loss replaces the plain v-trace
policy gradient with the clipped surrogate: v-trace targets/advantages are
computed under the TARGET ("old") policy, the surrogate ratio is the
current/behavior ratio clamped through the old-policy importance ratio, and
an optional KL(old || current) regularizer bounds the policy lag. The
target network refreshes every `target_update_freq` updates
(reference: appo.py target_network_update_freq).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.core.impala_learner import (
    ImpalaLearner,
    time_major_forward,
    vtrace,
)


class AppoLearner(ImpalaLearner):
    def __init__(self, obs_dim: int, num_actions: int, *,
                 lr: float = 5e-4, gamma: float = 0.99,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 rho_bar: float = 1.0, c_bar: float = 1.0,
                 clip_param: float = 0.2,
                 use_kl_loss: bool = False, kl_coeff: float = 1.0,
                 target_update_freq: int = 8,
                 hidden=(64, 64), seed: int = 0,
                 mesh_devices: Optional[int] = None, device=None):
        super().__init__(obs_dim, num_actions, lr=lr, gamma=gamma,
                         vf_coeff=vf_coeff, entropy_coeff=entropy_coeff,
                         rho_bar=rho_bar, c_bar=c_bar, hidden=hidden,
                         seed=seed, mesh_devices=mesh_devices, device=device)
        self.target = copy.deepcopy(self.module).requires_grad_(False)
        self.clip_param, self.use_kl_loss, self.kl_coeff = clip_param, use_kl_loss, kl_coeff
        self.target_update_freq = max(1, int(target_update_freq))
        self._updates = 0

    def _loss(self, batch):
        import torch

        logp_all, cur_logp, cur_values = time_major_forward(self.module, batch)
        # Value estimates and the v-trace correction come from the TARGET
        # network (reference: appo_torch_policy target_model value_function
        # + old_policy_behaviour_logits).
        with torch.no_grad():
            old_logp_all, old_logp, old_values = time_major_forward(self.target, batch)
            _, boot_v = self.target(batch["bootstrap_obs"])
            old_ratio = torch.exp(old_logp - batch["behavior_logp"])
            rho = torch.clamp(old_ratio, max=self.rho_bar)
            c = torch.clamp(old_ratio, max=self.c_bar)
            discounts = self.gamma * (1.0 - batch["dones"])
            vs, pg_adv = vtrace(rho, batch["rewards"], discounts, old_values,
                                boot_v, c)

        # Clipped surrogate: current/behavior ratio routed through the
        # old-policy importance ratio (reference: appo_torch_policy
        # is_ratio clamp [0, 2] * exp(curr - prev)).
        is_ratio = torch.clamp(
            torch.exp(batch["behavior_logp"] - old_logp), 0.0, 2.0)
        logp_ratio = is_ratio * torch.exp(cur_logp - batch["behavior_logp"])
        surr1 = pg_adv * logp_ratio
        surr2 = pg_adv * torch.clamp(
            logp_ratio, 1.0 - self.clip_param, 1.0 + self.clip_param)
        w, wsum = batch["valid"], batch["wsum"]
        pi_loss = -torch.sum(w * torch.minimum(surr1, surr2)) / wsum
        # The value function trains on the v-trace targets with the CURRENT
        # params (the target net only supplies the targets).
        vf_loss = 0.5 * torch.sum(w * (cur_values - vs) ** 2) / wsum
        entropy = -torch.sum(
            w * torch.sum(torch.exp(logp_all) * logp_all, dim=-1)) / wsum
        kl = torch.sum(
            w * torch.sum(torch.exp(old_logp_all) * (old_logp_all - logp_all),
                          dim=-1)) / wsum
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        if self.use_kl_loss:
            total = total + self.kl_coeff * kl
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "kl": kl, "mean_rho": self.dp.mean(rho)}

    def update_from_trajectories(
        self, batch: Dict[str, np.ndarray]
    ) -> Dict[str, float]:
        aux = super().update_from_trajectories(batch)
        self._updates += 1
        if self._updates % self.target_update_freq == 0:
            self.target.load_state_dict(self.module.state_dict())
        return aux

    def set_weights(self, weights):
        super().set_weights(weights)
        self.target.load_state_dict(self.module.state_dict())
        return True
