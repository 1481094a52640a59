"""The port's dp learners (``mesh_devices`` > 1: one learner process per
device) against the JAX learners on a ``("dp",)`` mesh, on the CPU.

The JAX learners run at ``mesh_devices=2`` on two of the conftest's 8 XLA
host devices: each batch padded to a multiple of 2 by repeating its last
row (IMPALA: its last env), sharded over ``dp``, XLA's gradient psum. The
port's run as 2 gloo ranks spawned once for the module
(``tests/_torch_ranks.py``), each a ``TorchLearner`` / ``ImpalaLearner`` /
``DQNLearner`` / ``SACLearner`` built with ``mesh_devices=2,
device="cpu"``, from the JAX learner's initial weights, on the same
batches: PPO with minibatches of odd size (15 rows, so the pad shows),
IMPALA with 5 envs, DQN on 201-row minibatches with a target sync, SAC on
123 rows with the JAX learner's noise for the padded 124. Then the same
DQN updates through ``LearnerGroup(config={"mesh_devices": 2,
"num_gpus_per_learner": 0}, learner_cls=DQNLearner)`` on the port's
runtime (two learner actors in one gloo group), and the errors for more
cards than the cluster has, a local group and a fractional card.

Tolerances (PERF.md §2's convention, as tests/test_torch_rllib_learners.py):
losses and aux within 1e-5 relative; parameters within 1e-5 relative, or
within 2·lr where Adam's first steps turn a near-zero gradient (float32
rounding of another summation order) into ±lr, such elements under 1% of
the parameters. The two ranks end with bitwise equal parameters.
"""

import os
import pickle
import time

import numpy as np
import pytest

from _torch_ranks import Ranks
from _torch_runtime import port_env

REL = 1e-5
OUTLIER_SHARE = 0.01
WORLD = 2
PPO_KW = dict(num_epochs=1, minibatch_size=15, seed=4)   # 240 rows: 16 odd minibatches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def assert_aux_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= REL * abs(ref[k]) + 1e-7, (k, got[k], ref[k])


def assert_params_close(got, ref, lr):
    outliers = total = 0
    a_leaves, b_leaves = _leaves(got), _leaves(ref)
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        err = np.abs(a - b)
        assert err.max() <= 2 * lr + 1e-6, err.max()
        outliers += int((err > REL * np.abs(b) + 1e-7).sum())
        total += b.size
    assert outliers <= OUTLIER_SHARE * total, (outliers, total)


def assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.tobytes() == y.tobytes()


# ------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def jax_cases(ranks):
    """Every case's batches, initial weights and the JAX learner's results
    at mesh_devices=2, pickled (numpy only) for the ranks, which started
    first and wait for the file."""
    import jax

    from ray_tpu.rllib.algorithms import dqn as jax_dqn
    from ray_tpu.rllib.algorithms import sac as jax_sac
    from ray_tpu.rllib.core import impala_learner as jax_impala
    from ray_tpu.rllib.core import learner as jax_learner
    from ray_tpu_torch.rllib.algorithms import dqn, sac
    from ray_tpu_torch.rllib.env import env_runner

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    cases = {}
    runner = env_runner.SingleAgentEnvRunner("CartPole-v1", 5, gamma=0.99, lambda_=0.95,
                                             seed=11)
    ppo = jax_learner.JaxLearner(4, 2, lr=1e-3, seed=3, mesh_devices=WORLD)
    assert ppo.num_devices() == WORLD
    w0 = np_tree(ppo.get_weights())
    batch = runner.sample(w0, 50)
    batch.pop("episode_returns")
    assert len(batch["obs"]) % PPO_KW["minibatch_size"] == 0   # one compiled shape, padded
    aux = ppo.update_from_batch(batch, **PPO_KW)
    cases["ppo"] = dict(w0=w0, batch=batch, aux=aux, params=np_tree(ppo.get_weights()))

    traj = runner.sample_trajectory(w0, 30)
    assert traj["actions"].shape[1] % WORLD  # an odd env count
    imp = jax_impala.ImpalaLearner(4, 2, lr=5e-4, seed=0, mesh_devices=WORLD)
    iw0 = np_tree(imp.get_weights())
    auxes = [imp.update_from_trajectories(traj) for _ in range(2)]
    cases["impala"] = dict(w0=iw0, traj=traj, aux=auxes, params=np_tree(imp.get_weights()))

    q = jax_dqn.DQNLearner(4, 2, lr=1e-3, seed=0, mesh_devices=WORLD)
    qw0 = np_tree(q.get_weights())
    buf = dqn.ReplayBuffer(4096, 4)
    buf.add_batch(dqn.DQNEnvRunner("CartPole-v1", 8, seed=1).sample(qw0, 64, 0.5))
    rng = np.random.default_rng(0)
    mbs, auxes = [], []
    for i in range(3):
        mbs.append(buf.sample(rng, 201))
        auxes.append(q.update(mbs[-1]))
        if i == 1:
            q.sync_target()
    cases["dqn"] = dict(w0=qw0, mbs=mbs, aux=auxes, params=np_tree(q.get_weights()),
                        target=np_tree(q.get_target_weights()))

    sb = sac.SACEnvRunner("Pendulum-v1", 3, seed=2).sample(None, 41, random=True)
    sb.pop("episode_returns")
    rows = len(sb["obs"])
    assert rows % WORLD
    s = jax_sac.SACLearner(3, 1, [-2.0], [2.0], mesh_devices=WORLD, hidden=(32, 32), seed=3)
    s0 = dict(actor=np_tree(s.actor_params), critic=np_tree(s.critic_params),
              target=np_tree(s.target_params))
    # the JAX learner's noise (sac.py:174,208,290), drawn for the padded rows
    key, noise = jax.random.PRNGKey(3 + 2), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        shape = (rows + (-rows) % WORLD, 1)
        noise.append((np.asarray(jax.random.normal(k1, shape)),
                      np.asarray(jax.random.normal(k2, shape))))
    auxes = [s.update(sb) for _ in range(3)]
    cases["sac"] = dict(w0=s0, batch=sb, noise=noise, aux=auxes,
                        actor=np_tree(s.actor_params), critic=np_tree(s.critic_params),
                        target=np_tree(s.target_params), log_alpha=float(s.log_alpha))
    path = ranks.cases_path
    with open(f"{path}.tmp", "wb") as f:
        pickle.dump(cases, f)
    os.replace(f"{path}.tmp", path)
    return cases


# ------------------------------------------------------------- the ranks


def _dp_body(rank, world, path):
    """Each case's updates on this rank of a ``world``-rank dp learner, once
    the test process has written the cases to ``path``."""
    from ray_tpu_torch.rllib.algorithms import dqn, sac
    from ray_tpu_torch.rllib.core import impala_learner, learner
    from ray_tpu_torch.rllib.core.rl_module import flax_params, load_flax_params

    while not os.path.exists(path):   # the pool's deadline bounds the wait
        time.sleep(0.05)
    with open(path, "rb") as f:
        cases = pickle.load(f)
    c = cases["ppo"]
    lrn = learner.TorchLearner(4, 2, lr=1e-3, seed=9, mesh_devices=world, device="cpu")
    lrn.set_weights(c["w0"])
    aux = lrn.update_from_batch(c["batch"], **PPO_KW)
    yield "ppo", dict(aux=aux, params=lrn.get_weights(), n=lrn.num_devices())

    c = cases["impala"]
    lrn = impala_learner.ImpalaLearner(4, 2, lr=5e-4, seed=5, mesh_devices=world,
                                       device="cpu")
    lrn.set_weights(c["w0"])
    aux = [lrn.update_from_trajectories(c["traj"]) for _ in range(2)]
    yield "impala", dict(aux=aux, params=lrn.get_weights())

    c = cases["dqn"]
    lrn = dqn.DQNLearner(4, 2, lr=1e-3, seed=6, mesh_devices=world, device="cpu")
    lrn.set_weights(c["w0"])
    aux = []
    for i, mb in enumerate(c["mbs"]):
        aux.append(lrn.update(mb))
        if i == 1:
            lrn.sync_target()
    yield "dqn", dict(aux=aux, params=lrn.get_weights(), target=lrn.get_target_weights())

    c = cases["sac"]
    lrn = sac.SACLearner(3, 1, [-2.0], [2.0], hidden=(32, 32), seed=3, mesh_devices=world,
                         device="cpu")
    for name in ("actor", "critic", "target"):
        load_flax_params(getattr(lrn, name), c["w0"][name])
    aux = [lrn.update_with_noise(c["batch"], n1, n2) for n1, n2 in c["noise"]]
    yield "sac", dict(aux=aux, actor=flax_params(lrn.actor), critic=flax_params(lrn.critic),
                      target=flax_params(lrn.target),
                      log_alpha=float(lrn.log_alpha.detach()))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks start (and import torch) while the JAX learners compile."""
    work = tmp_path_factory.mktemp("dp_ranks")
    pool = Ranks(_dp_body, WORLD, work, (str(work / "cases.pkl"),))
    pool.cases_path = str(work / "cases.pkl")
    yield pool
    pool.close()


def both(ranks, key):
    got = [ranks.get(key, r) for r in range(WORLD)]
    for name in got[0]:
        if name != "aux":
            assert_bitwise(got[1][name], got[0][name])   # the ranks agree
    return got[0]


def test_ppo_dp_learner_matches_jax(jax_cases, ranks):
    ref = jax_cases["ppo"]
    got = both(ranks, "ppo")
    assert got["n"] == WORLD
    assert_aux_close(got["aux"], ref["aux"])
    assert_params_close(got["params"], ref["params"], 1e-3)


def test_impala_dp_learner_with_an_odd_env_count_matches_jax(jax_cases, ranks):
    ref = jax_cases["impala"]
    got = both(ranks, "impala")
    for g, r in zip(got["aux"], ref["aux"], strict=True):
        assert_aux_close(g, r)
    assert_params_close(got["params"], ref["params"], 5e-4)


def test_dqn_dp_learner_matches_jax(jax_cases, ranks):
    ref = jax_cases["dqn"]
    got = both(ranks, "dqn")
    for g, r in zip(got["aux"], ref["aux"], strict=True):
        assert_aux_close(g, r)
    assert_params_close(got["params"], ref["params"], 1e-3)
    assert_params_close(got["target"], ref["target"], 1e-3)


def test_sac_dp_learner_with_the_jax_noise_matches_jax(jax_cases, ranks):
    ref = jax_cases["sac"]
    got = both(ranks, "sac")
    for g, r in zip(got["aux"], ref["aux"], strict=True):
        assert_aux_close(g, r)
    for name in ("actor", "critic", "target"):
        assert_params_close(got[name], ref[name], 3e-4)
    assert abs(got["log_alpha"] - ref["log_alpha"]) <= 2 * 3e-4


# ---------------------------------------------- LearnerGroup on the runtime


@pytest.fixture(scope="module")
def port_runtime(ranks):
    import ray_tpu_torch

    ranks.close()   # the ranks' processes leave before the runtime starts
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        mp.setenv("RTPU_TORCH_num_gpus", "1")   # one card, faked
        ray_tpu_torch.init(num_cpus=4)
        try:
            yield ray_tpu_torch
        finally:
            ray_tpu_torch.shutdown()


def test_learner_group_of_two_ranks_matches_jax(jax_cases, port_runtime):
    """DQN through LearnerGroup: two learner actors in one gloo group (no
    card), every call on both, rank 0's answer."""
    from ray_tpu_torch.rllib.algorithms.dqn import DQNLearner
    from ray_tpu_torch.rllib.core.learner import LearnerGroup

    c = jax_cases["dqn"]
    q = LearnerGroup(4, 2, config=dict(mesh_devices=WORLD, num_gpus_per_learner=0,
                                       lr=1e-3, seed=6), learner_cls=DQNLearner)
    try:
        assert q.num_devices() == WORLD
        q.set_weights(c["w0"])
        for i, (mb, aux) in enumerate(zip(c["mbs"], c["aux"], strict=True)):
            assert_aux_close(q.call("update", mb), aux)
            if i == 1:
                q.call("sync_target")
        assert_params_close(q.get_weights(), c["params"], 1e-3)
        assert_params_close(q.call("get_target_weights"), c["target"], 1e-3)
    finally:
        q.shutdown()


def test_mesh_devices_above_the_cards_raises(port_runtime):
    from ray_tpu_torch.rllib.core.learner import LearnerGroup

    with pytest.raises(RuntimeError, match="cluster has 1.0 GPUs"):
        LearnerGroup(4, 2, config={"mesh_devices": 2})   # a card per rank, one card
    with pytest.raises(ValueError, match="remote=True"):
        LearnerGroup(4, 2, config={"mesh_devices": 2, "num_gpus_per_learner": 0},
                     remote=False)
    with pytest.raises(ValueError, match="whole cards"):
        LearnerGroup(4, 2, config={"mesh_devices": 2, "num_gpus_per_learner": 0.5})
