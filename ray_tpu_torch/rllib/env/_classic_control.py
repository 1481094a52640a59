"""CartPole-v1 and Pendulum-v1 in numpy, and a sync vector env over them.

What the RL paths need from gymnasium, so that a machine without it runs
the ids the JAX package's configs name. Copies of gymnasium 1.2.2's
``gymnasium/envs/classic_control/cartpole.py`` (``CartPoleEnv``) and
``pendulum.py`` (``PendulumEnv``), with the ``TimeLimit`` of their
registrations (500 and 200 steps), the seeding of
``gymnasium.utils.seeding.np_random`` and ``SyncVectorEnv``'s default
NEXT_STEP autoreset. Given the same seeds and actions they return the same
bits as ``gymnasium.make`` / ``gymnasium.make_vec(..., "sync")``.

:func:`make` and :func:`make_vec` resolve these two ids to the copies,
always; any other id goes to gymnasium, imported inside the call, which
raises its ``ImportError`` where gymnasium is absent.

The copied environments are under gymnasium's licence:

    The MIT License

    Copyright (c) 2016 OpenAI
    Copyright (c) 2022 Farama Foundation

    Permission is hereby granted, free of charge, to any person obtaining a
    copy of this software and associated documentation files (the
    "Software"), to deal in the Software without restriction, including
    without limitation the rights to use, copy, modify, merge, publish,
    distribute, sublicense, and/or sell copies of the Software, and to
    permit persons to whom the Software is furnished to do so, subject to
    the following conditions:

    The above copyright notice and this permission notice shall be included
    in all copies or substantial portions of the Software.

    THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND, EXPRESS
    OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
    MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND NONINFRINGEMENT.
    IN NO EVENT SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE LIABLE FOR ANY
    CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION OF CONTRACT,
    TORT OR OTHERWISE, ARISING FROM, OUT OF OR IN CONNECTION WITH THE
    SOFTWARE OR THE USE OR OTHER DEALINGS IN THE SOFTWARE.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np


def np_random(seed: Optional[int] = None) -> np.random.Generator:
    """``gymnasium.utils.seeding.np_random``'s generator."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative python int, got {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


class Discrete:
    def __init__(self, n: int):
        self.n = np.int64(n)
        self.shape = ()


class Box:
    def __init__(self, low, high, shape=None, dtype=np.float32):
        shape = np.shape(low) if shape is None else tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, dtype), shape).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype), shape).copy()
        self.shape = shape
        self.dtype = np.dtype(dtype)


class _Env:
    """``gymnasium.Env``'s seeding: ``reset(seed=s)`` reseeds; a first
    ``reset()`` without a seed draws one from the OS."""

    _np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random()
        return self._np_random

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._np_random = np_random(seed)

    def close(self):
        pass


class CartPoleEnv(_Env):
    """gymnasium 1.2.2's ``CartPoleEnv`` (Barto, Sutton and Anderson's
    cart-pole; euler integration, reward 1 per step)."""

    def __init__(self):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5  # actually half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02  # seconds between state updates
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold_radians * 2, np.inf],
                        dtype=np.float32)
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.state: Optional[np.ndarray] = None
        self.steps_beyond_terminated = None

    def step(self, action):
        assert self.state is not None, "Call reset before using step method."
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (
            force + self.polemass_length * np.square(theta_dot) * sintheta
        ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length
            * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)

        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians
        )
        if not terminated:
            reward = 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0  # the pole just fell
            reward = 1.0
        else:
            if self.steps_beyond_terminated == 0:
                warnings.warn("step() called after terminated = True; call "
                              "reset() first: further steps are undefined")
            self.steps_beyond_terminated += 1
            reward = 0.0
        return np.array(self.state, dtype=np.float32), reward, terminated, False, {}

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self.state = self.np_random.uniform(low=-0.05, high=0.05, size=(4,))
        self.steps_beyond_terminated = None
        return np.array(self.state, dtype=np.float32), {}


def angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class PendulumEnv(_Env):
    """gymnasium 1.2.2's ``PendulumEnv`` (g = 10)."""

    def __init__(self, g: float = 10.0):
        self.max_speed = 8
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = g
        self.m = 1.0
        self.l = 1.0  # noqa: E741
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(low=-self.max_torque, high=self.max_torque,
                                shape=(1,), dtype=np.float32)
        self.observation_space = Box(low=-high, high=high, dtype=np.float32)

    def step(self, u):
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt  # noqa: E741
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        return self._get_obs(), -costs, False, False, {}

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        high = np.array([np.pi, 1.0])
        self.state = self.np_random.uniform(low=-high, high=high)
        return self._get_obs(), {}

    def _get_obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)


class TimeLimit:
    """Truncates an episode after ``max_episode_steps`` steps, as the
    registration's ``TimeLimit`` wrapper does."""

    def __init__(self, env: _Env, max_episode_steps: int):
        self.env = env
        self.max_episode_steps = max_episode_steps
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._elapsed_steps = None

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self.max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed: Optional[int] = None, options=None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)

    def close(self):
        self.env.close()


_REGISTRY = {"CartPole-v1": (CartPoleEnv, 500), "Pendulum-v1": (PendulumEnv, 200)}


class SyncVectorEnv:
    """``gymnasium.vector.SyncVectorEnv`` with its default NEXT_STEP
    autoreset: on the step after a sub-env's done, that sub-env ignores its
    action, resets, and returns the reset observation with reward 0."""

    def __init__(self, envs):
        self.envs = list(envs)
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space
        self._rewards = np.zeros(self.num_envs, np.float64)
        self._terminations = np.zeros(self.num_envs, np.bool_)
        self._truncations = np.zeros(self.num_envs, np.bool_)
        self._autoreset_envs = np.zeros(self.num_envs, np.bool_)
        self._env_obs = [None] * self.num_envs

    def reset(self, *, seed=None, options=None):
        """``seed`` None, an int ``s`` (sub-env i gets ``s + i``) or a list."""
        if seed is None:
            seed = [None] * self.num_envs
        elif isinstance(seed, int):
            seed = [seed + i for i in range(self.num_envs)]
        self._terminations[:] = False
        self._truncations[:] = False
        self._autoreset_envs[:] = False
        for i, (env, s) in enumerate(zip(self.envs, seed, strict=True)):
            self._env_obs[i], _ = env.reset(seed=s, options=options)
        return self._observations(), {}

    def step(self, actions):
        for i, (action, env) in enumerate(zip(actions, self.envs, strict=True)):
            if self._autoreset_envs[i]:
                self._env_obs[i], _ = env.reset()
                self._rewards[i] = 0.0
                self._terminations[i] = False
                self._truncations[i] = False
            else:
                (self._env_obs[i], self._rewards[i], self._terminations[i],
                 self._truncations[i], _) = env.step(action)
        self._autoreset_envs = np.logical_or(self._terminations, self._truncations)
        return (self._observations(), np.copy(self._rewards),
                np.copy(self._terminations), np.copy(self._truncations), {})

    def _observations(self) -> np.ndarray:
        return np.stack(self._env_obs).astype(self.single_observation_space.dtype)

    def close(self):
        for env in self.envs:
            env.close()


def make(name: str):
    """One environment with its time limit, as ``gymnasium.make(name)``."""
    if name not in _REGISTRY:
        import gymnasium as gym

        return gym.make(name)
    cls, limit = _REGISTRY[name]
    return TimeLimit(cls(), limit)


def make_vec(name: str, num_envs: int, vectorization_mode: str = "sync"):
    """``num_envs`` environments under one sync vector env, as
    ``gymnasium.make_vec(name, num_envs, vectorization_mode="sync")``."""
    if name not in _REGISTRY:
        import gymnasium as gym

        return gym.make_vec(name, num_envs=num_envs,
                            vectorization_mode=vectorization_mode)
    if vectorization_mode != "sync":
        raise ValueError(f"{name}: only vectorization_mode='sync' is copied here, "
                         f"got {vectorization_mode!r}")
    return SyncVectorEnv(make(name) for _ in range(num_envs))
