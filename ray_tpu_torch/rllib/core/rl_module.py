"""RLModules: the policy, value and Q networks, as ``nn.Module``s.

The port of ``ray_tpu/rllib/core/rl_module.py``'s flax modules. Each layer
is an ``nn.Linear`` named as flax names its ``Dense`` (``Dense_0`` ...
``Dense_n``, ``pi``, ``vf``, ``q``, ``mean``, ``log_std``, ``q1_d0`` ...
``q2_out``), initialised as ``flax.linen.Dense`` is (a lecun-normal kernel
over the input width, a zero bias) from a ``torch.Generator`` seeded by
``seed``, so the learning runs start from the JAX modules' distribution;
the draws differ from JAX's, whose generator differs.

:func:`flax_params` and :func:`load_flax_params` carry weights across in
the JAX package's pytree: ``{name: {"kernel": (in, out), "bias": (out,)}}``
of numpy arrays, the format every learner's ``get_weights()`` returns and
the env runners' numpy policies (re-exported here) read.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.rllib.core._numpy_policy import (  # noqa: F401
    numpy_forward,
    numpy_gaussian_forward,
    numpy_q_forward,
    sample_actions,
    sample_squashed_actions,
)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # flax's lecun_normal, as ray_tpu_torch/models/_flax.py draws it (not
    # imported: that module loads torch.distributed, which a learner's
    # process does not need): a normal truncated at 2 std units, rescaled to
    # variance 1/fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class _FlaxDenseStack(nn.Module):
    """Children are ``nn.Linear``s under their flax names, in flax's order
    of creation, which is the order of the initialiser's draws."""

    def _add(self, name: str, fan_in: int, width: int) -> None:
        self.add_module(name, nn.Linear(fan_in, width))

    def _init(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for lin in self.children():
                _lecun_normal_(lin.weight, lin.weight.shape[1], gen)
                lin.bias.zero_()


class ActorCriticModule(_FlaxDenseStack):
    """Shared-nothing MLP actor-critic for discrete action spaces: tanh
    hidden layers, logits ``pi`` and value ``vf``."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), *, seed: int = 0):
        super().__init__()
        self.hidden = tuple(hidden)
        width = obs_dim
        for i, h in enumerate(self.hidden):
            self._add(f"Dense_{i}", width, h)
            width = h
        self._add("pi", width, num_actions)
        self._add("vf", width, 1)
        self._init(seed)

    def forward(self, obs):
        x = obs
        for i in range(len(self.hidden)):
            x = torch.tanh(getattr(self, f"Dense_{i}")(x))
        return self.pi(x), self.vf(x)[..., 0]


class QModule(_FlaxDenseStack):
    """MLP Q-network for discrete action spaces (DQN family): relu hidden
    layers, Q values ``q``."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), *, seed: int = 0):
        super().__init__()
        self.hidden = tuple(hidden)
        width = obs_dim
        for i, h in enumerate(self.hidden):
            self._add(f"Dense_{i}", width, h)
            width = h
        self._add("q", width, num_actions)
        self._init(seed)

    def forward(self, obs):
        x = obs
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return self.q(x)


class SquashedGaussianModule(_FlaxDenseStack):
    """Tanh-squashed Gaussian policy for continuous control (SAC's actor):
    relu hidden layers, ``mean`` and ``log_std`` clipped to [-20, 2]; the
    squashing correction lives in the learner."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256), *, seed: int = 0):
        super().__init__()
        self.hidden = tuple(hidden)
        width = obs_dim
        for i, h in enumerate(self.hidden):
            self._add(f"Dense_{i}", width, h)
            width = h
        self._add("mean", width, action_dim)
        self._add("log_std", width, action_dim)
        self._init(seed)

    def forward(self, obs):
        x = obs
        for i in range(len(self.hidden)):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return self.mean(x), torch.clamp(self.log_std(x), -20.0, 2.0)


class TwinQModule(_FlaxDenseStack):
    """Two independent Q(s, a) critics over ``concat(obs, act)`` (SAC's
    clipped double-Q): ``q1_d0`` ... ``q1_out``, then ``q2_*``."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256), *, seed: int = 0):
        super().__init__()
        self.hidden = tuple(hidden)
        for name in ("q1", "q2"):
            width = obs_dim + action_dim
            for i, h in enumerate(self.hidden):
                self._add(f"{name}_d{i}", width, h)
                width = h
            self._add(f"{name}_out", width, 1)
        self._init(seed)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        qs = []
        for name in ("q1", "q2"):
            h = x
            for i in range(len(self.hidden)):
                h = torch.relu(getattr(self, f"{name}_d{i}")(h))
            qs.append(getattr(self, f"{name}_out")(h)[:, 0])
        return qs[0], qs[1]


def flax_params(module: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    """The module's weights as the JAX package's numpy pytree: each
    ``Linear.weight`` (out, in) becomes a contiguous ``kernel`` (in, out)."""
    return {
        name: {"kernel": np.ascontiguousarray(lin.weight.detach().cpu().numpy().T),
               "bias": lin.bias.detach().cpu().numpy().copy()}
        for name, lin in module.named_children()
    }


def load_flax_params(module: nn.Module, params) -> nn.Module:
    """Copy a flax pytree (numpy or JAX arrays) into ``module`` in place;
    every layer of the module must be in ``params`` with its shape."""
    names = {name for name, _ in module.named_children()}
    if set(params) != names:
        raise ValueError(f"flax params {sorted(params)} do not match the "
                         f"module's layers {sorted(names)}")
    with torch.no_grad():
        for name, lin in module.named_children():
            kernel = torch.from_numpy(np.array(params[name]["kernel"]))
            bias = torch.from_numpy(np.array(params[name]["bias"]))
            if tuple(kernel.shape) != tuple(lin.weight.shape[::-1]):
                raise ValueError(f"{name}: kernel {tuple(kernel.shape)} against "
                                 f"the layer's (in, out) {tuple(lin.weight.shape[::-1])}")
            lin.weight.copy_(kernel.T)
            lin.bias.copy_(bias)
    return module
