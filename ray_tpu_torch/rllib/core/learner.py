"""TorchLearner + LearnerGroup: the port of ``ray_tpu/rllib/core/learner.py``
(``JaxLearner``, ``LearnerGroup``; reference: rllib/core/learner/learner.py:114,
learner_group.py:83, torch_learner.py:254).

A learner owns its module and ``torch.optim.Adam`` (optax's defaults: eps
1e-8, bias-corrected) on one device: the CUDA card unless it is built with
``device="cpu"``. A remote learner is an actor that leases
``{"CPU": 1, "GPU": num_gpus_per_learner}`` (upstream Ray's
``AlgorithmConfig.learners(num_gpus_per_learner=...)``, default 1; 0 is the
CPU). The JAX learner spans every local device as a dp mesh; here a
learner is one device, ``mesh_devices`` None or 1: a dp learner over NCCL
on several cards is ROADMAP item 10b.

Weights cross process boundaries as the JAX package's numpy pytree
(``rl_module.flax_params``), so runners and checkpoints see one format.
Importing this module loads no torch; a learner imports it when built.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch


def check_mesh_devices(mesh_devices: Optional[int]) -> None:
    if mesh_devices not in (None, 1):
        raise ValueError(
            f"mesh_devices={mesh_devices}: a learner of ray_tpu_torch runs on one "
            "device; a dp learner over several cards is ROADMAP item 10b")


def learner_device(num_gpus_per_learner: float) -> Optional[str]:
    """The ``device`` a learner is built with: ``None`` (the card, which
    raises without CUDA) for a learner with GPUs, ``"cpu"`` for 0."""
    return None if num_gpus_per_learner else "cpu"


def check_learner_device(num_gpus_per_learner: float, remote: bool) -> None:
    """Raise before an algorithm starts its runners where its learner cannot
    run: a remote learner asking for more GPUs than the cluster has (rather
    than wait for a lease that cannot come), a local one for a card that
    this process does not have."""
    if not num_gpus_per_learner:
        return
    if not remote:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"a local learner with num_gpus_per_learner={num_gpus_per_learner} "
                "runs on this process's CUDA card, and torch.cuda.is_available() "
                "is False here; to learn on the CPU, configure "
                ".learners(num_gpus_per_learner=0)")
        return
    have = ray_tpu_torch.cluster_resources().get("GPU", 0)
    if have < num_gpus_per_learner:
        raise RuntimeError(
            f"a learner with num_gpus_per_learner={num_gpus_per_learner} needs "
            f"that many GPUs and the cluster has {have}; to learn on the CPU, "
            "configure .learners(num_gpus_per_learner=0)")


def pad_rows(batch: Dict[str, Any], d: int) -> Dict[str, Any]:
    """Repeat the last row until the row count is a multiple of ``d`` (the
    JAX learner's pad to its mesh, learner.py:80-91)."""
    pad = (-len(batch["obs"])) % d
    if not pad:
        return batch
    import torch

    return {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])]) for k, v in batch.items()}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """Each array of a host batch as a tensor on ``device``: one host-to-
    device copy per array (from a host copy: an array read zero-copy from
    the object store is read-only)."""
    import torch

    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in batch.items()}


def adam(params, lr: float, device):
    """optax.adam(lr)'s update (b1 0.9, b2 0.999, eps 1e-8, bias-corrected);
    its step counter lives on the card there (``capturable``), so an update
    never waits for the host."""
    import torch

    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=device.type == "cuda")


def optimizer_step(opt, total, aux: Dict[str, Any]) -> Dict[str, Any]:
    """One step of ``opt`` on the gradient of the loss ``total``; returns
    ``aux`` and ``total_loss``, detached and still on the device."""
    opt.zero_grad(set_to_none=True)
    total.backward()
    opt.step()
    return {**{k: t.detach() for k, t in aux.items()}, "total_loss": total.detach()}


def host_floats(aux: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in aux.items()}


class TorchLearner:
    """Owns the actor-critic and its optimizer on one device; the PPO
    clipped-surrogate update, minibatch-stepped per epoch."""

    def __init__(self, obs_dim: int, num_actions: int, *,
                 lr: float = 3e-4, clip: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, hidden=(64, 64), seed: int = 0,
                 mesh_devices: Optional[int] = None, device=None):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.rllib.core.rl_module import ActorCriticModule

        check_mesh_devices(mesh_devices)
        self.device = resolve_device(device)
        self.module = ActorCriticModule(obs_dim, num_actions, hidden, seed=seed).to(self.device)
        self.lr = lr
        self.opt = adam(self.module.parameters(), lr, self.device)
        self.clip, self.vf_coeff, self.entropy_coeff = clip, vf_coeff, entropy_coeff

    def _loss(self, batch):
        import torch
        import torch.nn.functional as F

        logits, v = self.module(batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["actions"][:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv
        pi_loss = -torch.mean(torch.minimum(unclipped, clipped))
        vf_loss = torch.mean((v - batch["returns"]) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy}

    def update_from_batch(self, batch: Dict[str, np.ndarray], *,
                          num_epochs: int = 4, minibatch_size: int = 512,
                          seed: int = 0) -> Dict[str, float]:
        """Minibatch-SGD over the rollout batch (reference:
        Learner.update_from_batch :913): advantages normalised on the host,
        the rollout and every epoch's permutation copied to the device once,
        minibatches indexed there; the last minibatch of an epoch may be
        short. Returns the last minibatch's losses."""
        n = len(batch["obs"])
        adv = batch["advantages"]
        batch = dict(batch)
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        rng = np.random.default_rng(seed)
        perms = np.stack([rng.permutation(n) for _ in range(num_epochs)])
        dev = to_device({**batch, "perms": perms}, self.device)
        perms = dev.pop("perms")
        aux: Dict[str, Any] = {}
        for epoch in range(num_epochs):
            for i in range(0, n, minibatch_size):
                idx = perms[epoch, i:i + minibatch_size]
                mb = pad_rows({k: v[idx] for k, v in dev.items()}, self.num_devices())
                aux = optimizer_step(self.opt, *self._loss(mb))
        return host_floats(aux)

    def get_weights(self):
        from ray_tpu_torch.rllib.core.rl_module import flax_params

        return flax_params(self.module)

    def set_weights(self, weights):
        """Load a host-side weight pytree (checkpoint restore; the optimizer
        restarts fresh, as the reference's from_checkpoint on a new
        Learner)."""
        from ray_tpu_torch.rllib.core.rl_module import load_flax_params

        load_flax_params(self.module, weights)
        self.opt = adam(self.module.parameters(), self.lr, self.device)
        return True

    def num_devices(self) -> int:
        return 1


class LearnerGroup:
    """One learner, remote (an actor on its leased device) or local
    (reference: learner_group.py:83)."""

    def __init__(self, obs_dim: int, num_actions: int, *, config: dict,
                 remote: bool = True):
        num_gpus = config.get("num_gpus_per_learner", 1)
        kw = dict(
            lr=config.get("lr", 3e-4), clip=config.get("clip", 0.2),
            vf_coeff=config.get("vf_coeff", 0.5),
            entropy_coeff=config.get("entropy_coeff", 0.01),
            hidden=config.get("hidden", (64, 64)),
            seed=config.get("seed", 0), device=learner_device(num_gpus),
        )
        check_learner_device(num_gpus, remote)
        if remote:
            self._actor = ray_tpu_torch.remote(TorchLearner).options(
                num_cpus=1, num_gpus=num_gpus).remote(obs_dim, num_actions, **kw)
            self._local = None
        else:
            self._actor = None
            self._local = TorchLearner(obs_dim, num_actions, **kw)

    def update_from_batch(self, batch, **kw) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update_from_batch(batch, **kw)
        return ray_tpu_torch.get(
            self._actor.update_from_batch.remote(batch, **kw), timeout=300
        )

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._actor.get_weights.remote(), timeout=120)

    def set_weights(self, weights):
        if self._local is not None:
            return self._local.set_weights(weights)
        return ray_tpu_torch.get(self._actor.set_weights.remote(weights),
                                 timeout=120)

    def num_devices(self) -> int:
        if self._local is not None:
            return self._local.num_devices()
        return ray_tpu_torch.get(self._actor.num_devices.remote(), timeout=60)

    def shutdown(self):
        if self._actor is not None:
            try:
                ray_tpu_torch.kill(self._actor)
            except Exception:
                pass
