"""The port's GPT-2-MoE on a mesh of dp, fsdp, tp, sp and ep against the JAX
TrainStep, on the CPU.

Eight gloo ranks (spawned once for the module, ``_torch_ranks``; they
never import JAX) train gpt2-moe-tiny (fp32, 4 experts, top-2, an MoE
block in each of its 2 layers, the einsum attention) for three steps at
lr 1e-3 from the JAX initial state of ``PRNGKey(0)``, carried across with
``load_flax_state``; each step draws a fresh (8, 64) batch from
``np.random.default_rng(0)``. Losses and grad_norms are held to 1e-4
relative of the JAX ``TrainStep``, and the parameters gathered with
``full_state`` to 2 * lr absolute (Adam's first steps move a weight by
about lr whatever its gradient). The JAX step is mesh-invariant for this
model: {dp 2, tp 2, ep 2} and {dp 2, sp 2, ep 2} are compared with the JAX
step on the same mesh of the 8 virtual CPU devices, the others with the
JAX one-device step.

Also: on {dp 2, ep 4} each rank holds 1 of the 4 experts of ``wi`` (and
of Adam's ``mu``), the sharded forward's logits and aux loss equal the JAX
one-device forward's (``tests/test_moe.py``'s limits, 2e-3 and 1e-4), and
ep over more ranks than experts raises ``ValueError``.
"""

import pickle
import types

import numpy as np
import pytest
import torch

from _torch_ranks import Ranks

LR = 1e-3
STEPS = 3
RTOL = 1e-4
MESHES = [{"dp": 2, "ep": 4}, {"dp": 2, "tp": 2, "ep": 2}, {"fsdp": 2, "ep": 4},
          {"dp": 2, "sp": 2, "ep": 2}, {"dp": 8}, {"dp": 2, "fsdp": 2, "tp": 2}]
SAME_MESH = [{"dp": 2, "tp": 2, "ep": 2}, {"dp": 2, "sp": 2, "ep": 2}]
FORWARD_MESH = {"dp": 2, "ep": 4}
FORWARD_BATCH = (4, 32)


def _key(axes) -> str:
    return ",".join(f"{a}{n}" for a, n in axes.items())


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        idx = rng.integers(0, 512, size=(8, 64)).astype(np.int32)
        out.append({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    return out


def _forward_idx():
    return np.random.default_rng(0).integers(0, 512, FORWARD_BATCH).astype(np.int32)


def _torch_cfg():
    from ray_tpu_torch.models.gpt2_moe import GPT2MoEConfig

    return GPT2MoEConfig.tiny_moe(use_flash_attention=False, dtype=torch.float32)


def _train_body(rank, world, init_path):
    """Every mesh on the 8 ranks; each rank yields what the tests read."""
    from ray_tpu_torch.models import _flax
    from ray_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from ray_tpu_torch.parallel._collectives import all_reduce_mean
    from ray_tpu_torch.parallel.train_step import TrainStep

    with open(init_path, "rb") as f:
        init = pickle.load(f)
    for axes in MESHES:
        ts = TrainStep(_torch_cfg(), make_mesh(axes, device="cpu"), learning_rate=LR,
                       telemetry=False)
        state = _flax.load_flax_state(ts, init)
        out = {}
        if axes == FORWARD_MESH:
            wi = dict(state["params"].named_parameters())["h.0.moe.wi"]
            mu = state["opt_state"]["mu"]["h.0.moe.wi"]
            out["experts"] = (tuple(wi.to_local().shape), tuple(mu.to_local().shape),
                              state["params"].h[0].moe.experts)
        metrics = []
        for b in _batches():
            state, m = ts.step(state, ts.shard_batch(b))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        full = _flax.full_state(ts, state)
        out["metrics"] = metrics
        out["params"] = ({k: v.numpy() for k, v in full["params"].items()}
                         if rank == 0 else None)
        yield _key(axes), out

    # the sharded forward of the initial weights on this rank's rows
    mesh = make_mesh(FORWARD_MESH, device="cpu")
    ts = TrainStep(_torch_cfg(), mesh, telemetry=False)
    model = _flax.load_flax_params(ts.new_model(), init["params"])
    idx = torch.as_tensor(_forward_idx())
    rows, cols = batch_sharding(mesh, idx.shape)
    with torch.no_grad():
        logits, aux = model(idx[rows, cols].long())
    yield "forward", {"rows": (rows.start, rows.stop), "logits": logits.numpy(),
                      "aux": all_reduce_mean(aux).item()}

    try:
        TrainStep(_torch_cfg(), make_mesh({"ep": 8}, device="cpu"))
    except ValueError as exc:
        yield "refused", str(exc)
    else:
        yield "refused", None


def _jax_cfg():
    import jax.numpy as jnp

    from ray_tpu.models.gpt2_moe import GPT2MoEConfig

    return GPT2MoEConfig.tiny_moe(use_flash_attention=False, dtype=jnp.float32)


def _jax_step(axes=None):
    import jax

    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.train_step import TrainStep

    mesh = make_mesh(axes) if axes else make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return TrainStep(_jax_cfg(), mesh, learning_rate=LR, telemetry=False)


@pytest.fixture(scope="module")
def jax_one():
    """The JAX one-device step and its initial state as numpy."""
    import jax

    ts = _jax_step()
    return ts, jax.tree.map(np.asarray, ts.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_init(jax_one):
    """The JAX initial state, picklable without JAX (the ranks import none)."""
    from ray_tpu_torch.models._flax import _adam_state

    state = jax_one[1]
    adam = _adam_state(state["opt_state"])
    return {"params": state["params"], "step": state["step"],
            "opt_state": types.SimpleNamespace(count=adam.count, mu=adam.mu, nu=adam.nu)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    # the state goes through a file: a large argument would hold each
    # spawn's start until the child had imported torch to read it
    workdir = tmp_path_factory.mktemp("moe_ranks")
    with open(workdir / "init.pkl", "wb") as f:
        pickle.dump(jax_init, f)
    pool = Ranks(_train_body, 8, workdir, (str(workdir / "init.pkl"),))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jax_runs(ranks, jax_one):
    """The JAX steps on one device and on the SAME_MESH meshes, each from the
    one initial state placed by the mesh's shardings: metrics and final
    parameters as numpy (run while the ranks train)."""
    import jax

    one, init = jax_one
    out = {}
    for axes in [None] + SAME_MESH:
        ts = one if axes is None else _jax_step(axes)
        state = jax.device_put(init, ts.state_shardings)
        metrics = []
        for b in _batches():
            state, m = ts.step(state, ts.shard_batch(b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[None if axes is None else _key(axes)] = {
            "metrics": metrics, "params": jax.tree.map(np.asarray, state["params"])}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("axes", MESHES, ids=[_key(m) for m in MESHES])
def test_moe_mesh_follows_the_jax_train_step(ranks, jax_runs, axes):
    got = ranks.get(_key(axes))
    ref = jax_runs[_key(axes) if axes in SAME_MESH else None]
    np.testing.assert_allclose(got["metrics"], ref["metrics"], rtol=RTOL, atol=0)
    want = _flat(ref["params"])
    assert set(got["params"]) == set(want)
    for path, p in got["params"].items():
        np.testing.assert_allclose(p, want[path], atol=2 * LR, rtol=0, err_msg=path)
    for rank in range(1, 8):   # every rank reports the same loss and norm
        assert ranks.get(_key(axes), rank)["metrics"] == got["metrics"]


def test_the_jax_step_is_mesh_invariant(jax_runs):
    """What lets the other meshes be held to the one-device run."""
    for key in map(_key, SAME_MESH):
        np.testing.assert_allclose(jax_runs[key]["metrics"], jax_runs[None]["metrics"],
                                   rtol=RTOL, atol=0)


def test_each_ep_rank_holds_its_own_experts(ranks):
    """{dp 2, ep 4}: wi (E, C, F) = (4, 128, 512) holds one expert per rank,
    ep rank r (global rank % 4) expert r, and Adam's mu alike."""
    for rank in range(8):
        wi, mu, experts = ranks.get(_key(FORWARD_MESH), rank)["experts"]
        assert wi == mu == (1, 128, 512)
        assert experts == (rank % 4, rank % 4 + 1)


def test_sharded_forward_matches_the_one_device_forward(ranks, jax_init):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.gpt2_moe import forward_with_aux

    logits, aux = jax.jit(lambda p, i: forward_with_aux(_jax_cfg(), p, i))(
        jax_init["params"], jnp.asarray(_forward_idx()))
    logits = np.asarray(logits)
    for rank in range(8):
        got = ranks.get("forward", rank)
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["logits"], logits[lo:hi], atol=2e-3, rtol=0)
        assert abs(got["aux"] - float(aux)) < 1e-4 and got["aux"] > 0


def test_ep_over_more_ranks_than_experts_is_refused(ranks):
    assert ranks.get("refused") == "ep = 8 does not divide num_experts = 4"
