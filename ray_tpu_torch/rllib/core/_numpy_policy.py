"""The numpy policies of the env runners: copies of ``numpy_forward``,
``numpy_q_forward``, ``sample_actions``, ``numpy_gaussian_forward`` and
``sample_squashed_actions`` from the JAX package's ``rllib/core/rl_module.py``.

They read the flax parameter pytree (``Dense_0`` ... ``Dense_n`` and the
heads, kernels (in, out)) that every learner's ``get_weights()`` returns.
This module imports numpy only: a runner process never imports torch, whose
import alone costs a GPU worker several seconds.
"""

from __future__ import annotations

import numpy as np


def numpy_forward(params, obs: np.ndarray):
    """Pure-numpy forward pass so CPU env runners act without importing
    torch (reference: env runners hold a lightweight policy copy).
    Mirrors ActorCriticModule's architecture exactly."""
    x = obs.astype(np.float32)
    # numeric sort: flax auto-names are Dense_0..Dense_N and 'Dense_10'
    # sorts lexicographically before 'Dense_2'
    layers = sorted((k for k in params if k.startswith("Dense_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for k in layers:
        x = np.tanh(x @ np.asarray(params[k]["kernel"])
                    + np.asarray(params[k]["bias"]))
    logits = x @ np.asarray(params["pi"]["kernel"]) + np.asarray(
        params["pi"]["bias"])
    v = x @ np.asarray(params["vf"]["kernel"]) + np.asarray(
        params["vf"]["bias"])
    return logits, v[:, 0]


def numpy_q_forward(params, obs: np.ndarray):
    """Numpy mirror of QModule for CPU env runners (relu hidden stack)."""
    x = obs.astype(np.float32)
    layers = sorted((k for k in params if k.startswith("Dense_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for k in layers:
        x = np.maximum(
            x @ np.asarray(params[k]["kernel"]) + np.asarray(params[k]["bias"]),
            0.0,
        )
    return x @ np.asarray(params["q"]["kernel"]) + np.asarray(
        params["q"]["bias"])


def sample_actions(rng: np.random.Generator, logits: np.ndarray):
    """Categorical sample + log-prob, numpy."""
    z = logits - logits.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    u = rng.random((len(p), 1))
    actions = (p.cumsum(axis=-1) > u).argmax(axis=-1)
    logp = np.log(p[np.arange(len(p)), actions] + 1e-12)
    return actions, logp


def numpy_gaussian_forward(params, obs: np.ndarray):
    """Numpy mirror of SquashedGaussianModule for CPU env runners."""
    x = obs.astype(np.float32)
    layers = sorted((k for k in params if k.startswith("Dense_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for k in layers:
        x = np.maximum(
            x @ np.asarray(params[k]["kernel"]) + np.asarray(params[k]["bias"]),
            0.0,
        )
    mean = x @ np.asarray(params["mean"]["kernel"]) + np.asarray(
        params["mean"]["bias"])
    log_std = x @ np.asarray(params["log_std"]["kernel"]) + np.asarray(
        params["log_std"]["bias"])
    return mean, np.clip(log_std, -20.0, 2.0)


def sample_squashed_actions(rng: np.random.Generator, mean, log_std,
                            low, high):
    """Sample tanh-squashed actions scaled into [low, high] (numpy)."""
    raw = mean + np.exp(log_std) * rng.standard_normal(mean.shape)
    squashed = np.tanh(raw)
    return low + (squashed + 1.0) * 0.5 * (high - low)
