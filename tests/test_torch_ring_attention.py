"""ray_tpu_torch.ops.ring_attention against ray_tpu.ops.ring_attention.

Eight gloo ranks (spawned once for the module, ``_torch_ranks``) run the
port's ring at sp = 2 (mesh dp 2, sp 2, tp 2) and sp = 4 (dp 2, sp 4), fp32,
on (B, T, H, D) = (2, 64, 4, 16) inputs drawn from a numpy seed; each rank
returns its chunk of the output and of the gradients of q, k and v (of
sum(out * dout), through the ring and back). The JAX side runs
``ring_attention_sharded`` on the same mesh of the 8 virtual CPU devices,
``jax.grad`` of the same sum, and ``causal_attention``; everything is held
to 2e-4 max-abs. At sp = 1 the port's ring is plain causal attention.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import Ranks
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.ring_attention import ring_attention_sharded, ring_causal_attention

TOL = 2e-4
SHAPE = (2, 64, 4, 16)
MESHES = {"sp2": {"dp": 2, "sp": 2, "tp": 2}, "sp4": {"dp": 2, "sp": 4}}


def _inputs():
    """q, k, v and the output's cotangent, fp32 (B, T, H, D)."""
    rng = np.random.default_rng(0)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


def _ring_body(rank, world):
    """Each mesh: this rank's (rows, positions), its output chunk and its
    chunks of dq, dk, dv."""
    from ray_tpu_torch.parallel.mesh import DATA_AXES, _block, make_mesh

    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    for name, axes in MESHES.items():
        mesh = make_mesh(axes, device="cpu")
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ring_attention_sharded(*leaves, mesh)
        rows = _block(mesh, DATA_AXES, SHAPE[0])
        cols = _block(mesh, ("sp",), SHAPE[1])
        (out * do[rows, cols]).sum().backward()
        grads = [x.grad[rows, cols].clone() for x in leaves]
        for x in leaves:
            x.grad[rows, cols] = 0.0
        yield name, {"rows": rows, "cols": cols, "out": out.detach().numpy(),
                     "grads": [g.numpy() for g in grads],
                     "elsewhere": max(float(x.grad.abs().max()) for x in leaves)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = Ranks(_ring_body, 8, tmp_path_factory.mktemp("ring_ranks"))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jax_refs():
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.attention import causal_attention as jcausal
    from ray_tpu.ops.ring_attention import ring_attention_sharded as jring
    from ray_tpu.parallel.mesh import make_mesh

    q, k, v, do = (jnp.asarray(a) for a in _inputs())
    refs = {"causal": np.asarray(jcausal(q, k, v))}
    for name, axes in MESHES.items():
        mesh = make_mesh(axes)
        fn = lambda q, k, v: jnp.sum(jring(q, k, v, mesh) * do)  # noqa: E731
        refs[name] = {"out": np.asarray(jring(q, k, v, mesh)),
                      "grads": [np.asarray(g) for g in
                                jax.jit(jax.grad(fn, argnums=(0, 1, 2)))(q, k, v)]}
    return refs


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ring_forward_matches_jax(ranks, jax_refs, name):
    for rank in range(8):
        got = ranks.get(name, rank)
        block = (got["rows"], got["cols"])
        np.testing.assert_allclose(got["out"], jax_refs[name]["out"][block],
                                   atol=TOL, rtol=0, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["out"], jax_refs["causal"][block],
                                   atol=TOL, rtol=0, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ring_gradients_match_jax_grad(ranks, jax_refs, name):
    for rank in range(8):
        got = ranks.get(name, rank)
        block = (got["rows"], got["cols"])
        for x, g, ref in zip("qkv", got["grads"], jax_refs[name]["grads"]):
            np.testing.assert_allclose(g, ref[block], atol=TOL, rtol=0,
                                       err_msg=f"d{x}, rank {rank}")
        # the gradient lands on the rank's own chunk only
        assert got["elsewhere"] == 0.0


def test_ring_of_one_rank_is_causal_attention():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs())
    outs, grads = [], []
    for fn in (ring_causal_attention, causal_attention):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        (out * do).sum().backward()
        outs.append(out.detach())
        grads.append([x.grad for x in leaves])
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
