"""TorchLearner + LearnerGroup: the port of ``ray_tpu/rllib/core/learner.py``
(``JaxLearner``, ``LearnerGroup``; reference: rllib/core/learner/learner.py:114,
learner_group.py:83, torch_learner.py:254).

A learner owns its module and ``torch.optim.Adam`` (optax's defaults: eps
1e-8, bias-corrected) on one device: the CUDA card unless it is built with
``device="cpu"``. A remote learner is an actor that leases
``{"CPU": 1, "GPU": num_gpus_per_learner}`` (upstream Ray's
``AlgorithmConfig.learners(num_gpus_per_learner=...)``, default 1; 0 is the
CPU).

The JAX learner spans ``mesh_devices`` devices as a ``("dp",)`` mesh: the
batch padded to a multiple of the device count by repeating its last row,
sharded over ``dp``, the parameters replicated, XLA's psum of the
gradients. Here ``mesh_devices`` None or 1 is one device, and ``d > 1`` is
one learner process per card (:class:`DataParallel`): each rank gets the
whole batch, pads it exactly as the JAX learner does, keeps its 1/d of the
rows (IMPALA's: of the envs), and sums its contribution to every loss and
aux value with the others' in one all-reduce (NCCL on the card, gloo when
the learner is built with ``device="cpu"``) before the same optimizer step
on every rank; the weights are rank 0's. A plain mean is its shard's mean
over d (the shards are equal); a weighted mean divides by the whole padded
batch's weight, which every rank holds. :class:`LearnerGroup` starts the d
ranks as actors of one card each.

Weights cross process boundaries as the JAX package's numpy pytree
(``rl_module.flax_params``), so runners and checkpoints see one format.
Importing this module loads no torch; a learner imports it when built.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

import ray_tpu_torch


class DataParallel:
    """This process's place in a dp learner of ``mesh_devices`` ranks: the
    pad and split of a batch, and the one all-reduce of an update. At one
    rank every method is the identity, so a one-device learner computes
    exactly what it did before dp existed.

    ``d > 1`` needs the caller's ``torch.distributed`` group of exactly d
    ranks (:class:`LearnerGroup` starts one), over NCCL when ``device`` is
    the card (this rank's current card) and over gloo on the CPU; anything
    else raises before any step, never falling back to fewer ranks or to
    the CPU."""

    def __init__(self, mesh_devices: Optional[int], device):
        d = 1 if mesh_devices is None else int(mesh_devices)
        if d < 1:
            raise ValueError(f"mesh_devices={mesh_devices}: need at least one device")
        self.size, self.rank = d, 0
        if d == 1:
            return
        import torch
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                f"mesh_devices={d}: a dp learner is one process per card in a "
                f"torch.distributed group of {d} ranks, and this process has no "
                "group; LearnerGroup(config={'mesh_devices': d}) starts one")
        if dist.get_world_size() != d:
            raise RuntimeError(
                f"mesh_devices={d}, and this process's torch.distributed group "
                f"has {dist.get_world_size()} ranks")
        want = "nccl" if device.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise RuntimeError(
                f"a dp learner on {device.type} reduces over {want}; this "
                f"process's group is {dist.get_backend()}")
        if device.type == "cuda" and torch.cuda.device_count() < 1:
            raise RuntimeError("a dp learner rank on the card sees no CUDA card")
        self.rank = dist.get_rank()

    def pad(self, t, axis: int = 0):
        """``t`` with its ``axis`` padded to a multiple of the rank count by
        repeating its last entry (the JAX learner's ``_pad_to_devices``)."""
        pad = (-t.shape[axis]) % self.size
        if not pad:
            return t
        import torch

        last = t.narrow(axis, t.shape[axis] - 1, 1)
        shape = list(t.shape)
        shape[axis] = pad
        return torch.cat([t, last.expand(*shape)], dim=axis)

    def shard(self, t, axis: int = 0):
        """This rank's 1/d of an ``axis`` already padded to a multiple of d."""
        if self.size == 1:
            return t
        n = t.shape[axis] // self.size
        return t.narrow(axis, self.rank * n, n)

    def rows(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Every array of ``batch`` padded along its rows, then this rank's
        shard of them."""
        return {k: self.shard(self.pad(v)) for k, v in batch.items()}

    def mean(self, x):
        """This rank's share of the padded batch's mean of ``x``: the
        shards are equal, so the d shares sum to it."""
        import torch

        m = torch.mean(x)
        return m if self.size == 1 else m / self.size

    def all_sum(self, tensors):
        """Sum each tensor over the ranks, in place, in one all-reduce of
        one flat buffer."""
        if self.size == 1:
            return
        import torch
        import torch.distributed as dist

        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


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


def optimizer_step(opt, total, aux: Dict[str, Any],
                   dp: Optional[DataParallel] = None) -> Dict[str, Any]:
    """One step of ``opt`` on the gradient of the loss ``total``; returns
    ``aux`` and ``total_loss``, detached and still on the device. Under dp
    the gradients and the aux values are summed over the ranks first."""
    opt.zero_grad(set_to_none=True)
    total.backward()
    out = {**{k: t.detach() for k, t in aux.items()}, "total_loss": total.detach()}
    if dp is not None and dp.size > 1:
        import torch

        grads = [p.grad for g in opt.param_groups for p in g["params"]
                 if p.grad is not None]
        values = torch.stack(list(out.values()))
        dp.all_sum(grads + [values])
        out = dict(zip(out, values))
    opt.step()
    return out


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

        self.device = resolve_device(device)
        self.dp = DataParallel(mesh_devices, self.device)
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
        mean = self.dp.mean
        pi_loss = -mean(torch.minimum(unclipped, clipped))
        vf_loss = mean((v - batch["returns"]) ** 2)
        entropy = -mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy}

    def update_from_batch(self, batch: Dict[str, np.ndarray], *,
                          num_epochs: int = 4, minibatch_size: int = 512,
                          seed: int = 0) -> Dict[str, float]:
        """Minibatch-SGD over the rollout batch (reference:
        Learner.update_from_batch :913): advantages normalised on the host,
        the rollout and every epoch's permutation copied to the device once,
        minibatches indexed there; the last minibatch of an epoch may be
        short. Under dp every rank takes the same batch and seed, pads each
        minibatch and keeps its shard. Returns the last minibatch's losses
        (over the whole padded minibatch)."""
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
                mb = self.dp.rows({k: v[idx] for k, v in dev.items()})
                aux = optimizer_step(self.opt, *self._loss(mb), self.dp)
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
        return self.dp.size


class _LearnerRank:
    """One rank of a dp learner: an actor on its leased card (or CPU) that
    joins the ranks' ``torch.distributed`` group, then builds its learner."""

    def address(self) -> str:
        """A ``tcp://`` rendezvous on this worker's own address (never a
        ``gethostbyname`` of the host name) at a free port."""
        import socket

        from ray_tpu_torch._private.worker import get_global_worker

        host = get_global_worker().address[0]
        with socket.socket() as sock:
            sock.bind((host, 0))
            return f"tcp://{host}:{sock.getsockname()[1]}"

    def start(self, init_method: str, rank: int, world: int, backend: str,
              learner_cls, args, kwargs) -> bool:
        from datetime import timedelta

        import torch.distributed as dist

        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, timeout=timedelta(seconds=300))
        self.learner = learner_cls(*args, **kwargs)
        return True

    def call(self, method: str, *args, **kwargs):
        return getattr(self.learner, method)(*args, **kwargs)


_GROUP_KEYS = ("num_gpus_per_learner", "mesh_devices")


class LearnerGroup:
    """A learner, remote (an actor on its leased device) or local
    (reference: learner_group.py:83); with ``config["mesh_devices"] = d > 1``
    a dp learner of d remote ranks, one card each (``num_gpus_per_learner``
    1; 0 runs the ranks on CPUs over gloo), whose every call runs on each
    rank and answers with rank 0's result.

    ``learner_cls`` is :class:`TorchLearner` by default, built from the PPO
    keys of ``config``; another class (``DQNLearner``, ``ImpalaLearner``,
    ...) takes every key of ``config`` but the group's own as its keyword
    arguments, and its methods are reached through :meth:`call`."""

    def __init__(self, obs_dim: int, num_actions: int, *, config: dict,
                 remote: bool = True, learner_cls=None):
        num_gpus = config.get("num_gpus_per_learner", 1)
        d = config.get("mesh_devices") or 1
        if learner_cls is None:
            learner_cls = TorchLearner
            kw = dict(
                lr=config.get("lr", 3e-4), clip=config.get("clip", 0.2),
                vf_coeff=config.get("vf_coeff", 0.5),
                entropy_coeff=config.get("entropy_coeff", 0.01),
                hidden=config.get("hidden", (64, 64)),
                seed=config.get("seed", 0),
            )
        else:
            kw = {k: v for k, v in config.items() if k not in _GROUP_KEYS}
        kw["device"] = learner_device(num_gpus)
        self._local = self._actor = None
        self._ranks = []
        if d > 1:
            self._start_ranks(d, num_gpus, remote, learner_cls, (obs_dim, num_actions), kw)
            return
        check_learner_device(num_gpus, remote)
        if remote:
            self._actor = ray_tpu_torch.remote(learner_cls).options(
                num_cpus=1, num_gpus=num_gpus).remote(obs_dim, num_actions, **kw)
        else:
            self._local = learner_cls(obs_dim, num_actions, **kw)

    def _start_ranks(self, d: int, num_gpus: float, remote: bool, learner_cls,
                     args, kw) -> None:
        """d learner actors of ``num_gpus`` cards each in one group; raises,
        before any actor starts, where the cluster cannot hold them."""
        if not remote:
            raise ValueError(
                f"mesh_devices={d}: a dp learner is {d} learner actors, one card "
                "each (remote=True); a local learner is one process")
        if num_gpus and num_gpus != int(num_gpus):
            raise ValueError(
                f"mesh_devices={d} with num_gpus_per_learner={num_gpus}: NCCL "
                "places one rank on a card, so each rank leases whole cards")
        have = ray_tpu_torch.cluster_resources().get("GPU", 0)
        if num_gpus and have < d * num_gpus:
            raise RuntimeError(
                f"mesh_devices={d} needs {d} learner ranks of {num_gpus} GPU "
                f"each and the cluster has {have} GPUs; a dp learner never "
                "runs on fewer ranks or on the CPU in their place")
        kw = dict(kw, mesh_devices=d)
        cls = ray_tpu_torch.remote(_LearnerRank).options(num_cpus=1, num_gpus=num_gpus)
        self._ranks = [cls.remote() for _ in range(d)]
        init = ray_tpu_torch.get(self._ranks[0].address.remote(), timeout=300)
        backend = "gloo" if kw["device"] == "cpu" else "nccl"
        ray_tpu_torch.get([r.start.remote(init, i, d, backend, learner_cls, args, kw)
                           for i, r in enumerate(self._ranks)], timeout=600)

    def call(self, method: str, *args, timeout: float = 300, **kwargs):
        """``method`` of the learner (on every rank; rank 0's result)."""
        if self._local is not None:
            return getattr(self._local, method)(*args, **kwargs)
        if self._actor is not None:
            return ray_tpu_torch.get(getattr(self._actor, method).remote(*args, **kwargs),
                                     timeout=timeout)
        # one copy of each argument in the store, read by every rank
        refs = [ray_tpu_torch.put(a) for a in args]
        outs = ray_tpu_torch.get([r.call.remote(method, *refs, **kwargs)
                                  for r in self._ranks], timeout=timeout)
        return outs[0]

    def update_from_batch(self, batch, **kw) -> Dict[str, float]:
        return self.call("update_from_batch", batch, **kw)

    def get_weights(self):
        if self._ranks:
            return ray_tpu_torch.get(self._ranks[0].call.remote("get_weights"),
                                     timeout=120)
        return self.call("get_weights", timeout=120)

    def set_weights(self, weights):
        return self.call("set_weights", weights, timeout=120)

    def num_devices(self) -> int:
        return self.call("num_devices", timeout=60)

    def shutdown(self):
        for actor in [self._actor] + self._ranks:
            if actor is not None:
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:
                    pass
