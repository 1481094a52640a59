"""ray_tpu_torch.ops.moe and ray_tpu_torch.models.gpt2_moe against the JAX
package's, on the CPU.

Routing is compared exactly: the same probabilities (numpy, from a seed)
go through both ``top_k_routing``s, and the dispatch masks must be equal,
capacity drops and ties included; combine weights and the load-balance
loss to 1e-6 (fp32, one division apart). The MoE layer and the whole
GPT-2-MoE forward carry the flax weights across (``load_flax_params``):
fp32 outputs to 1e-4 absolute (summation order only), the aux loss to
1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2_moe as jm
from ray_tpu.ops import moe as jmoe
from ray_tpu_torch.models import gpt2_moe as tm
from ray_tpu_torch.ops import moe as tmoe

TOL = 1e-4
ROUTE_TOL = 1e-6
JCFG = jm.GPT2MoEConfig.tiny_moe(dtype=jnp.float32)
TCFG = tm.GPT2MoEConfig.tiny_moe(dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny CPU ops: one thread is fastest and steady, where eight threads
    on cores shared with other test workers stall on each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _probs(seed, shape=(2, 24, 4)):
    z = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _route(probs, k, capacity):
    jd, jc = jmoe.top_k_routing(jnp.asarray(probs), k, capacity)
    td, tc = tmoe.top_k_routing(torch.from_numpy(probs), k, capacity)
    return (np.asarray(jd), np.asarray(jc)), (td.numpy(), tc.numpy())


@pytest.mark.parametrize("k,capacity", [(1, 3), (1, 24), (2, 4), (2, 9), (2, 48),
                                        (3, 5)])
def test_top_k_routing_equals_jax(k, capacity):
    probs = _probs(k * 100 + capacity)
    (jd, jc), (td, tc) = _route(probs, k, capacity)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, atol=ROUTE_TOL, rtol=0)
    # every admitted token takes one slot of one expert, within capacity
    assert td.sum(axis=(1, 3)).max() <= capacity
    if capacity < 24 * k // 4:
        assert td.sum() < 2 * 24 * k          # some choices were dropped


def test_top_k_routing_breaks_ties_like_lax_top_k():
    # exact ties: lax.top_k takes the lower expert first. Odd rows tie all
    # four experts (0 and 1 win), even rows tie 2 and 3 for second place
    probs = np.full((1, 8, 4), 0.25, np.float32)
    probs[0, ::2] = [0.4, 0.1, 0.25, 0.25]
    (jd, jc), (td, tc) = _route(probs, 2, 8)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, atol=ROUTE_TOL, rtol=0)
    assert td[0, 1::2, :2].sum() == 8 and td[0, 1::2, 2:].sum() == 0
    assert td[0, ::2, 0].sum() == 4 and td[0, ::2, 2].sum() == 4
    assert td[0, ::2, 3].sum() == 0


def test_capacity_drops_keep_earlier_positions_and_first_choices():
    # every token prefers expert 0; capacity 2: positions 0 and 1 win
    probs = np.tile(np.array([0.6, 0.3, 0.1], np.float32), (1, 4, 1))
    (jd, _), (td, tc) = _route(probs, 2, 2)
    np.testing.assert_array_equal(td, jd)
    assert td[0, :2, 0].sum() == 2 and td[0, 2:, 0].sum() == 0
    # second choices (expert 1) of every position fill after all firsts
    assert td[0, :2, 1].sum() == 2 and td[0, 2:, 1].sum() == 0


@pytest.mark.parametrize("k,capacity", [(1, 6), (2, 12)])
def test_load_balance_loss_equals_jax(k, capacity):
    probs = _probs(7 + k)
    (jd, _), (td, _) = _route(probs, k, capacity)
    want = float(jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(jd)))
    got = tmoe.load_balance_loss(torch.from_numpy(probs), torch.from_numpy(td)).item()
    assert got == pytest.approx(want, rel=ROUTE_TOL)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_layer_matches_flax(capacity_factor):
    C, F, E = 16, 32, 4
    cfg = jmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=capacity_factor)
    layer = jmoe.MoE(d_model=C, d_ff=F, moe=cfg, dtype=jnp.float32)
    x = np.random.default_rng(5).standard_normal((2, 12, C)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(layer.init)(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want, state = jax.jit(lambda p, v: layer.apply({"params": p}, v, mutable=["losses"]))(
        params, jnp.asarray(x))
    want_aux = float(jax.tree.leaves(state["losses"])[0])

    tcfg = tmoe.MoEConfig(num_experts=E, top_k=2, capacity_factor=capacity_factor)
    tlayer = tmoe.MoE(C, F, tcfg, torch.float32, device="cpu")
    tm._flax.load_flax_params(tlayer, params)
    assert tlayer.capacity(12) == max(1, int(-(-2 * 12 * capacity_factor // E)))
    with torch.no_grad():
        got, aux = tlayer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert aux.item() == pytest.approx(want_aux, rel=ROUTE_TOL)


@pytest.fixture(scope="module")
def carried():
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jm.init_params(JCFG, key))(jax.random.PRNGKey(3)))
    model = tm.load_flax_params(tm.GPT2MoE(TCFG, device="cpu"), params)
    return params, model


def test_forward_with_aux_matches_flax(carried):
    params, model = carried
    idx = np.random.default_rng(0).integers(0, TCFG.vocab_size, (2, 16))
    logits, aux = jax.jit(lambda p, i: jm.forward_with_aux(JCFG, p, i))(
        params, jnp.asarray(idx, jnp.int32))
    with torch.inference_mode():
        got, got_aux = tm.forward_with_aux(TCFG, model, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=TOL, rtol=0)
    assert got_aux.item() == pytest.approx(float(aux), rel=ROUTE_TOL)
    tgt = np.roll(idx, -1, axis=1)
    want = float(jax.jit(lambda p, i, t: jm.moe_loss_fn(JCFG, p, i, t))(
        params, jnp.asarray(idx, jnp.int32), jnp.asarray(tgt, jnp.int32)))
    with torch.inference_mode():
        loss = tm.moe_loss_fn(TCFG, model, torch.from_numpy(idx), torch.from_numpy(tgt))
    assert loss.item() == pytest.approx(want, rel=1e-5)


def test_moe_every_places_the_moe_blocks_like_flax():
    jcfg = jm.GPT2MoEConfig.tiny_moe(n_layer=4, moe_every=2, dtype=jnp.float32)
    jp = jax.eval_shape(lambda k: jm.init_params(jcfg, k), jax.random.PRNGKey(0))
    model = tm.GPT2MoE(tm.GPT2MoEConfig.tiny_moe(n_layer=4, moe_every=2), device="cpu")
    kinds = [type(b).__name__ for b in model.h]
    assert kinds == ["DenseBlock", "MoEBlock", "DenseBlock", "MoEBlock"]
    assert ["moe" in jp[f"h_{i}"] for i in range(4)] == [k == "MoEBlock" for k in kinds]
    assert tm.GPT2MoEConfig().moe == tmoe.MoEConfig() and tm.GPT2MoEConfig().n_embd == 768


def test_init_matches_flax_initialiser_scales():
    # the expert stacks (E, in, out): flax counts E into lecun-normal's fan-in
    jparams = jax.tree.map(np.asarray, jax.jit(
        lambda key: jm.init_params(JCFG, key))(jax.random.PRNGKey(0)))
    model = tm.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    want = tm._flax.flax_tensors(model, jparams)
    for name, p in model.named_parameters():
        ref = want[name]
        if ref.std() == 0:
            assert torch.equal(p, ref), name
        else:
            assert p.std().item() == pytest.approx(ref.std().item(), rel=0.1), name
