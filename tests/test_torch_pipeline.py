"""The port's pipeline (``parallel/pipeline.py``) against the JAX
``PipelineTrainStep`` and ``pipeline_apply``, on the CPU.

Eight gloo ranks (spawned once for the module, ``_torch_ranks``; they
never import JAX) train ``tests/test_pipeline.py``'s ``_cfg()`` (vocab
128, block 32, 4 layers, 2 heads, width 32, fp32, the einsum attention)
for three steps at lr 1e-2 on one (8, 32) batch from
``np.random.RandomState(1)``, from the JAX initial state of
``PRNGKey(1)`` carried across with ``load_flax_state``. Losses and
grad_norms are held to 1e-4 relative of JAX, and the parameters gathered
with ``full_state`` to 2 * lr absolute. The JAX step gives the same
numbers on every mesh and microbatch count: {dp 2, pp 4} with 4
microbatches is compared with JAX on the same mesh of the 8 virtual CPU
devices, {dp 4, pp 2} with 2 with the JAX dp 1 x pp 1 run.

Also: ``forward`` against a sequential loop over the same blocks (2e-4,
as ``tests/test_pipeline.py``), ``pipeline_apply`` of an add-a-weight
block at {dp 2, pp 4}, the blocks split over pp, and JAX's messages for a
mesh without pp, layers that pp does not divide and a batch that the
microbatches do not divide.
"""

import pickle
import types

import numpy as np
import pytest
import torch

from _torch_ranks import Ranks

LR = 1e-2
STEPS = 3
RTOL = 1e-4
# (mesh, microbatches); None: the JAX run to compare with is dp 1 x pp 1
CASES = [({"dp": 4, "pp": 2}, 2, None), ({"dp": 2, "pp": 4}, 4, "same")]
ONE = ({"dp": 1, "pp": 1}, 2)
FORWARD = ({"dp": 2, "pp": 4}, 4)


def _key(axes, M) -> str:
    return ",".join(f"{a}{n}" for a, n in axes.items()) + f",M{M}"


def _batch(B=8):
    idx = np.random.RandomState(1).randint(0, 128, (B, 32)).astype(np.int32)
    return {"idx": idx, "targets": np.roll(idx, -1, 1)}


def _cfg_kw():
    return dict(vocab_size=128, block_size=32, n_layer=4, n_head=2, n_embd=32,
                use_flash_attention=False)


def _torch_cfg():
    from ray_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config(dtype=torch.float32, **_cfg_kw())


def _body(rank, world, init_path):
    """Every case on the 8 ranks; each rank yields what the tests read."""
    from ray_tpu_torch.models import _flax
    from ray_tpu_torch.models.gpt2 import Block
    from ray_tpu_torch.parallel import pipeline
    from ray_tpu_torch.parallel.mesh import make_mesh

    with open(init_path, "rb") as f:
        init = pickle.load(f)
    for axes, M, _ in CASES:
        pts = pipeline.PipelineTrainStep(_torch_cfg(), make_mesh(axes, device="cpu"),
                                         num_microbatches=M, learning_rate=LR)
        state = pipeline.load_flax_state(pts, init)
        blocks = (len(state["params"].blocks), state["params"].first_layer)
        metrics = []
        for _ in range(STEPS):
            state, m = pts.step(state, pts.shard_batch(_batch()))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        full = pipeline.full_state(pts, state)
        yield _key(axes, M), {
            "metrics": metrics, "blocks": blocks,
            "params": ({k: v.numpy() for k, v in full["params"].items()}
                       if rank == 0 else None)}

    # forward against a sequential loop over the same (gathered) blocks
    axes, M = FORWARD
    pts = pipeline.PipelineTrainStep(_torch_cfg(), make_mesh(axes, device="cpu"),
                                     num_microbatches=M)
    state = pipeline.load_flax_state(pts, init)
    idx = np.random.RandomState(0).randint(0, 128, (8, 32))
    local = pts.shard_batch({"idx": idx})["idx"]
    logits = pts.forward(state["params"], local)
    whole = pipeline.full_state(pts, state)["params"]
    model = state["params"]
    with torch.no_grad():
        h = model.embed(local)
        for i in range(pts.model_cfg.n_layer):
            block = Block(pts.model_cfg, "cpu")
            for name, p in block.named_parameters():
                path = "blocks/" + _flax.flax_path(block, name)
                t = whole[path][i]
                p.copy_(t.T if path.endswith("kernel") else t)
            h = block(h)
        want = model.head(h)
    yield "forward", (logits - want).abs().max().item()

    # pipeline_apply: 8 layers x + w_l over 4 stages, w_l = l
    mesh = make_mesh({"dp": 2, "pp": 4}, device="cpu")
    stage = mesh.get_local_rank("pp")
    w = torch.arange(8, dtype=torch.float32).reshape(8, 1, 1, 1)
    out = pipeline.pipeline_apply(mesh, lambda p, x: x + p, w[2 * stage:2 * stage + 2],
                                  torch.ones(4, 2, 4), num_micro=4)
    yield "apply", (out.min().item(), out.max().item(), tuple(out.shape))

    refused = {}
    for key, axes, M, B in (("no_pp", {"dp": 8}, 2, 8), ("layers", {"pp": 8}, 2, 8),
                            ("batch", {"dp": 2, "pp": 4}, 4, 6)):
        try:
            pts = pipeline.PipelineTrainStep(_torch_cfg(), make_mesh(axes, device="cpu"),
                                             num_microbatches=M)
            pts.step(pts.init(), pts.shard_batch(_batch(B)))
        except ValueError as exc:
            refused[key] = str(exc)
    yield "refused", refused


def _jax_step(axes, M):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.gpt2 import GPT2Config
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.pipeline import PipelineTrainStep

    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    return PipelineTrainStep(GPT2Config(dtype=jnp.float32, **_cfg_kw()), mesh,
                             num_microbatches=M, learning_rate=LR)


@pytest.fixture(scope="module")
def jax_one():
    """The JAX dp 1 x pp 1 step and its initial state as numpy."""
    import jax

    ts = _jax_step(*ONE)
    return ts, jax.tree.map(np.asarray, ts.init(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_one):
    from ray_tpu_torch.models._flax import _adam_state

    state = jax_one[1]
    adam = _adam_state(state["opt_state"])
    init = {"params": state["params"], "step": state["step"],
            "opt_state": types.SimpleNamespace(count=adam.count, mu=adam.mu, nu=adam.nu)}
    # the state goes through a file: a large argument would hold each
    # spawn's start until the child had imported torch to read it
    workdir = tmp_path_factory.mktemp("pipeline_ranks")
    with open(workdir / "init.pkl", "wb") as f:
        pickle.dump(init, f)
    pool = Ranks(_body, 8, workdir, (str(workdir / "init.pkl"),))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jax_runs(ranks, jax_one):
    """The JAX steps at ONE and on each "same" case's mesh, from the one
    initial state placed by the mesh's shardings (run while the ranks
    train)."""
    import jax

    one, init = jax_one
    out = {}
    for axes, M in [ONE] + [(a, m) for a, m, ref in CASES if ref == "same"]:
        ts = one if (axes, M) == ONE else _jax_step(axes, M)
        state = jax.device_put(init, ts.state_shardings)
        batch = ts.shard_batch(_batch())
        metrics = []
        for _ in range(STEPS):
            state, m = ts.step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[_key(axes, M)] = {"metrics": metrics,
                              "params": jax.tree.map(np.asarray, state["params"])}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("axes,M,ref", CASES, ids=[_key(a, m) for a, m, _ in CASES])
def test_pipeline_train_step_follows_jax(ranks, jax_runs, axes, M, ref):
    got = ranks.get(_key(axes, M))
    want = jax_runs[_key(axes, M) if ref == "same" else _key(*ONE)]
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=RTOL, atol=0)
    losses = [m[0] for m in got["metrics"]]
    assert losses[-1] < losses[0]
    params = _flat(want["params"])
    assert set(got["params"]) == set(params)
    for path, p in got["params"].items():
        np.testing.assert_allclose(p, params[path], atol=2 * LR, rtol=0, err_msg=path)
    for rank in range(1, 8):
        assert ranks.get(_key(axes, M), rank)["metrics"] == got["metrics"]


def test_the_jax_step_is_invariant_to_mesh_and_microbatches(jax_runs):
    for key, run in jax_runs.items():
        np.testing.assert_allclose(run["metrics"], jax_runs[_key(*ONE)]["metrics"],
                                   rtol=RTOL, atol=0, err_msg=key)


def test_block_parameters_stay_split_over_pp(ranks):
    """Each stage holds its n_layer / pp blocks, layers r * L/pp onwards
    (the mesh's last axis varies fastest: pp rank = rank % pp)."""
    for axes, M, _ in CASES:
        pp = axes["pp"]
        for rank in range(8):
            n, first = ranks.get(_key(axes, M), rank)["blocks"]
            assert (n, first) == (4 // pp, (rank % pp) * (4 // pp))


def test_forward_matches_the_sequential_blocks(ranks):
    for rank in range(8):
        assert ranks.get("forward", rank) < 2e-4


def test_pipeline_apply_adds_every_stage_weight(ranks):
    for rank in range(8):
        assert ranks.get("apply", rank) == (29.0, 29.0, (4, 2, 4))


def test_refusals_carry_the_jax_messages(ranks):
    want = {}
    for key, axes, M in (("no_pp", {"dp": 8}, 2), ("layers", {"pp": 8}, 2)):
        with pytest.raises(ValueError) as info:
            _jax_step(axes, M)
        want[key] = str(info.value)
    with pytest.raises(ValueError) as info:
        _jax_step({"dp": 2, "pp": 4}, 4).step(None, {"idx": np.zeros((6, 32), np.int32)})
    want["batch"] = str(info.value)
    assert ranks.get("refused") == want
