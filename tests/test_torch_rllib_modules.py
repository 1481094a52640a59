"""The port's RLModules against the JAX package's flax modules.

Each of ``ActorCriticModule``, ``QModule``, ``SquashedGaussianModule`` and
``TwinQModule``, loaded with flax's initial parameters through
``load_flax_params``, gives flax ``apply``'s outputs within 1e-5 (absolute
and relative, fp32: the JAX package's own numpy-forward tests use 1e-5);
``flax_params`` gives back the pytree bitwise; the port's own init has
flax's names and shapes and its distribution (lecun-normal kernels, zero
biases). The runners' numpy policies are the JAX package's, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.core import rl_module as jax_rl
from ray_tpu_torch.rllib.core import _numpy_policy
from ray_tpu_torch.rllib.core import rl_module as rl
from ray_tpu_torch.rllib.core.learner import TorchLearner

TOL = 1e-5

CASES = {
    "actor_critic": (lambda: jax_rl.ActorCriticModule(num_actions=3, hidden=(32, 16)),
                     lambda seed: rl.ActorCriticModule(5, 3, (32, 16), seed=seed), (5,)),
    "q": (lambda: jax_rl.QModule(num_actions=4, hidden=(32, 32, 16)),
          lambda seed: rl.QModule(5, 4, (32, 32, 16), seed=seed), (5,)),
    "gaussian": (lambda: jax_rl.SquashedGaussianModule(action_dim=2, hidden=(64, 64)),
                 lambda seed: rl.SquashedGaussianModule(3, 2, (64, 64), seed=seed), (3,)),
    "twin_q": (lambda: jax_rl.TwinQModule(hidden=(64, 64)),
               lambda seed: rl.TwinQModule(3, 2, (64, 64), seed=seed), (3, 2)),
}


def flax_init(name, seed=0):
    jmod, _, dims = CASES[name]
    return jax.tree.map(np.asarray, jmod().init_params(*dims, seed=seed))


def inputs(name, n=9):
    rng = np.random.default_rng(3)
    return [rng.normal(size=(n, d)).astype(np.float32) * 2 for d in CASES[name][2]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_from_flax_params_matches_flax_apply(name):
    jmod, tmod, _ = CASES[name]
    params = flax_init(name)
    xs = inputs(name)
    ref = jmod().apply({"params": params}, *[jnp.asarray(x) for x in xs])
    got = rl.load_flax_params(tmod(1), params)(*[torch.from_numpy(x) for x in xs])
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=TOL, atol=TOL)
    if name == "gaussian":  # log_std is clipped to [-20, 2]
        assert got[1].max() <= 2.0 and got[1].min() >= -20.0


@pytest.mark.parametrize("name", sorted(CASES))
def test_pytree_round_trip_is_exact(name):
    params = flax_init(name)
    back = rl.flax_params(rl.load_flax_params(CASES[name][1](0), params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        assert a.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_init_has_flax_names_shapes_and_distribution(name):
    ref = flax_init(name)
    mod = CASES[name][1](0)
    got = rl.flax_params(mod)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for layer in ref:
        assert got[layer]["kernel"].shape == ref[layer]["kernel"].shape
        assert not got[layer]["bias"].any()
    # same seed, same weights; another seed, others
    same = rl.flax_params(CASES[name][1](0))
    other = rl.flax_params(CASES[name][1](1))
    first = next(iter(ref))
    assert same[first]["kernel"].tobytes() == got[first]["kernel"].tobytes()
    assert other[first]["kernel"].tobytes() != got[first]["kernel"].tobytes()


def test_init_distribution_is_flax_lecun_normal():
    """A 256 x 256 kernel: truncated at 2 std units, variance 1 / fan_in,
    as flax's; the sample std of 65536 draws within 2% of flax's own."""
    jm = jax_rl.QModule(num_actions=2, hidden=(256, 256))
    ref = np.asarray(jm.init_params(256, seed=0)["Dense_1"]["kernel"])
    got = rl.flax_params(rl.QModule(256, 2, (256, 256), seed=0))["Dense_1"]["kernel"]
    want_std = np.sqrt(1.0 / 256)
    assert abs(got.std() / ref.std() - 1) < 0.02
    assert abs(got.std() / want_std - 1) < 0.02
    bound = 2 * want_std / 0.87962566103423978
    assert np.abs(got).max() <= bound and np.abs(ref).max() <= bound + 1e-6


def test_numpy_policies_are_the_jax_packages_bitwise():
    ac = flax_init("actor_critic")
    q = flax_init("q")
    ga = flax_init("gaussian")
    obs5 = inputs("actor_critic", 64)[0]
    obs3 = inputs("gaussian", 64)[0]
    for fn, params, obs in (("numpy_forward", ac, obs5), ("numpy_q_forward", q, obs5),
                            ("numpy_gaussian_forward", ga, obs3)):
        ref = getattr(jax_rl, fn)(params, obs)
        got = getattr(_numpy_policy, fn)(params, obs)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.tobytes() == b.tobytes()
        assert getattr(rl, fn) is getattr(_numpy_policy, fn)
    logits, _ = _numpy_policy.numpy_forward(ac, obs5)
    a, b = (m.sample_actions(np.random.default_rng(4), logits) for m in (_numpy_policy, jax_rl))
    assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
    mean, log_std = _numpy_policy.numpy_gaussian_forward(ga, obs3)
    low, high = np.float32([-2, -1]), np.float32([2, 1])
    a, b = (m.sample_squashed_actions(np.random.default_rng(5), mean, log_std, low, high)
            for m in (_numpy_policy, jax_rl))
    assert a.tobytes() == b.tobytes()


def test_load_rejects_a_foreign_tree():
    params = flax_init("q")
    with pytest.raises(ValueError, match="do not match"):
        rl.load_flax_params(rl.ActorCriticModule(5, 4, (32, 32, 16)), params)
    params["q"]["kernel"] = params["q"]["kernel"][:, :2]
    with pytest.raises(ValueError, match="kernel"):
        rl.load_flax_params(CASES["q"][1](0), params)


def test_learner_is_one_device():
    # eight devices are a dp learner of eight ranks: outside such a
    # torch.distributed group the learner raises, never one device instead
    with pytest.raises(RuntimeError, match="group of 8 ranks"):
        TorchLearner(4, 2, mesh_devices=8, device="cpu")
    assert TorchLearner(4, 2, mesh_devices=1, device="cpu").num_devices() == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchLearner(4, 2)
