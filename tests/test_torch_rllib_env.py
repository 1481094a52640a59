"""The port's RL environments against gymnasium 1.2.2 and the JAX package.

``ray_tpu_torch.rllib.env._classic_control`` copies CartPole-v1 and
Pendulum-v1 with their time limits, the seeding and the sync vector env's
NEXT_STEP autoreset: given the same seeds and actions every observation,
reward, termination and truncation is bitwise gymnasium's (dtype and
bytes). The runs cross terminations, CartPole's 500-step truncation (with
``tests/test_offline_rl.py``'s expert) and the resets after them.
``MultiAgentCartPole`` over those copies is bitwise the JAX package's over
gymnasium. Also: other ids go to gymnasium, and importing the package and a
runner's modules loads neither torch nor gymnasium.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu.rllib.env.multi_agent import MultiAgentCartPole as JaxMultiAgentCartPole
from ray_tpu_torch.rllib.env import _classic_control as cc
from ray_tpu_torch.rllib.env.multi_agent import MultiAgentCartPole

REPO = Path(__file__).resolve().parents[1]


def expert_policy(obs):
    # tests/test_offline_rl.py:20: push right iff the pole is falling right
    return 1 if obs[2] + 0.5 * obs[3] > 0 else 0


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def actions_for(name, policy, obs, rng, n):
    if name == "Pendulum-v1":
        return rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)  # clipped by the env
    if policy == "expert":
        return np.array([expert_policy(o) for o in obs])
    return rng.integers(0, 2, n)


@pytest.mark.parametrize("name,policy,steps", [
    ("CartPole-v1", "random", 400), ("CartPole-v1", "expert", 1100),
    ("Pendulum-v1", "random", 450),
])
def test_sync_vector_env_is_gymnasiums_bitwise(name, policy, steps):
    ref = gym.make_vec(name, num_envs=4, vectorization_mode="sync")
    got = cc.make_vec(name, 4, vectorization_mode="sync")
    obs_r, _ = ref.reset(seed=7)
    obs_g, _ = got.reset(seed=7)
    same_bits(obs_g, obs_r)
    assert got.single_observation_space.shape == ref.single_observation_space.shape
    if name == "CartPole-v1":
        assert got.single_action_space.n == ref.single_action_space.n == 2
    else:
        same_bits(got.single_action_space.low, ref.single_action_space.low)
        same_bits(got.single_action_space.high, ref.single_action_space.high)
    rng = np.random.default_rng(0)
    terms = truncs = resets = 0
    for _ in range(steps):
        act = actions_for(name, policy, obs_r, rng, 4)
        out_r, out_g = ref.step(act), got.step(act)
        for a, b in zip(out_g[:4], out_r[:4]):
            same_bits(a, b)
        # the step after a done is a NEXT_STEP reset: reward 0, no done
        resets += int(((out_r[1] == 0) & ~out_r[2] & ~out_r[3]).sum())
        terms += int(out_r[2].sum())
        truncs += int(out_r[3].sum())
        obs_r = out_r[0]
    if name == "CartPole-v1" and policy == "random":
        assert terms > 20 and resets >= terms - 4
    elif name == "CartPole-v1":
        assert truncs >= 4 and terms == 0  # the expert balances to the 500-step limit
    else:
        assert truncs == 8 and terms == 0  # two 200-step episodes each


@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_single_env_is_gymnasiums_bitwise(name):
    ref, got = gym.make(name), cc.make(name)
    rng = np.random.default_rng(1)
    lengths = []
    for ep in range(3):
        obs_r, _ = ref.reset(seed=ep)
        obs_g, _ = got.reset(seed=ep)
        same_bits(obs_g, obs_r)
        done, n = False, 0
        while not done:
            if name == "CartPole-v1":
                act = expert_policy(obs_r) if ep < 2 else int(rng.integers(0, 2))
            else:
                act = rng.uniform(-2, 2, (1,)).astype(np.float32)
            r, g = ref.step(act), got.step(act)
            same_bits(g[0], r[0])
            assert g[1:4] == r[1:4] and type(g[1]) is type(r[1])
            obs_r, done, n = r[0], r[2] or r[3], n + 1
        lengths.append(n)
    assert lengths[:2] == ([500, 500] if name == "CartPole-v1" else [200, 200])
    # reset without a seed continues the generator, as gymnasium's does
    same_bits(got.reset()[0], ref.reset()[0])


def test_seeding_is_gymnasiums():
    from gymnasium.utils import seeding

    for seed in (0, 5, 1234):
        same_bits(cc.np_random(seed).random(8), seeding.np_random(seed)[0].random(8))


def test_other_ids_go_to_gymnasium(monkeypatch):
    env = cc.make("Acrobot-v1")
    assert isinstance(env, gym.Env)
    vec = cc.make_vec("Acrobot-v1", 2)
    assert vec.num_envs == 2
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    with pytest.raises(ImportError):
        cc.make("Acrobot-v1")
    assert cc.make("CartPole-v1").reset(seed=0)[0].shape == (4,)


def test_multi_agent_cartpole_is_the_jax_ones_bitwise():
    ref, got = JaxMultiAgentCartPole(num_agents=3), MultiAgentCartPole(num_agents=3)
    assert got.possible_agents == ref.possible_agents
    for aid in ref.possible_agents:
        assert got.observation_space_shape(aid) == ref.observation_space_shape(aid)
        assert got.action_space_n(aid) == ref.action_space_n(aid)
    obs_r, _ = ref.reset(seed=11)
    obs_g, _ = got.reset(seed=11)
    rng = np.random.default_rng(2)
    joint_resets = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(600):
            assert obs_g.keys() == obs_r.keys()
            for aid in obs_r:
                same_bits(obs_g[aid], obs_r[aid])
            acts = {aid: int(rng.integers(0, 2)) for aid in obs_r}
            r, g = ref.step(acts), got.step(acts)
            for a, b in zip(g[1:4], r[1:4]):
                assert a == b
            obs_r, obs_g = r[0], g[0]
            if r[2]["__all__"]:
                joint_resets += 1
                obs_r, _ = ref.reset()
                obs_g, _ = got.reset()
    assert joint_resets > 5


def test_rllib_and_runner_imports_load_neither_torch_nor_gymnasium():
    """A runner process imports the package and its runner's module: none of
    them may load torch (a GPU worker's import of it costs seconds) or
    gymnasium (the card machine has none)."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.rllib\n"
        "import ray_tpu_torch.rllib.env.env_runner, ray_tpu_torch.rllib.env.multi_agent\n"
        "import ray_tpu_torch.rllib.algorithms.dqn, ray_tpu_torch.rllib.algorithms.sac\n"
        "import ray_tpu_torch.rllib.offline\n"
        "from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner\n"
        "SingleAgentEnvRunner('CartPole-v1', 2, gamma=0.99, lambda_=0.95)\n"
        "import ray_tpu_torch as rt\n"
        "assert rt.rllib is ray_tpu_torch.rllib\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'gymnasium', 'jax', 'flax', 'ray_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
