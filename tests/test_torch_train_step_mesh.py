"""The port's TrainStep on a mesh against the JAX TrainStep, on the CPU.

Eight gloo ranks (spawned once for the module, ``_torch_ranks``; they
never import JAX) train the fp32 tiny configs of the JAX package's tests,
GPT-2 on the nine meshes of ``tests/test_train_step.py`` ({"tp": 8} among
them: gpt2-tiny's 4 heads each computed by 2 tp ranks) and Llama (4 query
heads, 2 KV heads) on the five of
``tests/test_llama.py``, B = 8, T = 64, each from the JAX initial state
carried across with ``load_flax_state``, at the JAX tests' settings
(GPT-2 three steps at lr 1e-3, Llama four at 5e-3). Each mesh's losses
and grad_norms are held to 1e-4 relative of the JAX ``TrainStep``,
and the parameters gathered with ``full_state`` to 2 * lr absolute (Adam's
first steps move a weight by about lr whatever its gradient, so a
near-0 gradient whose sign differs moves it by up to 2 * lr). The meshes
{dp 2, fsdp 2, tp 2} and {dp 2, sp 2, tp 2} are compared with the JAX step
on the same mesh of the 8 virtual CPU devices, the others with the JAX
one-device step, which ``tests/test_train_step.py`` holds equal to every
mesh.

Also: vocabulary 509 over tp = 4 (uneven shards and vocab-parallel loss),
the shards of an fsdp x tp mesh, ``multi_step`` on a mesh, the refusals
JAX shares (12 heads over tp = 8, ep over more ranks than experts), and
the recorder's global token count.
"""

import dataclasses
import pickle
import types

import numpy as np
import pytest
import torch

from _torch_ranks import Ranks

# the JAX tests' learning rates and step counts (tests/test_train_step.py,
# tests/test_llama.py): over Llama's first three fresh batches the loss
# does not fall yet, in JAX as in the port
LR = {"gpt2": 1e-3, "llama": 5e-3}
STEPS = {"gpt2": 3, "llama": 4}
RTOL = 1e-4
GPT2_MESHES = [{"dp": 8}, {"fsdp": 8}, {"dp": 2, "fsdp": 4}, {"dp": 2, "tp": 4},
               {"sp": 8}, {"dp": 2, "sp": 4}, {"dp": 2, "fsdp": 2, "tp": 2},
               {"dp": 2, "sp": 2, "tp": 2}, {"tp": 8}]
LLAMA_MESHES = [{"dp": 8}, {"fsdp": 8}, {"tp": 4, "dp": 2}, {"sp": 4, "dp": 2},
                {"dp": 2, "fsdp": 2, "tp": 2}]
# (family, vocab) -> the meshes whose JAX reference runs on that same mesh
SAME_MESH = {("gpt2", 512): [{"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 2, "sp": 2, "tp": 2}],
             ("llama", 512): [{"dp": 2, "fsdp": 2, "tp": 2}]}
ODD_VOCAB = 509
ODD_MESH = {"dp": 2, "tp": 4}


def _key(axes) -> str:
    return ",".join(f"{a}{n}" for a, n in axes.items())


def _cases():
    """(name, family, vocab, mesh) of every training run."""
    out = [(f"gpt2:{_key(m)}", "gpt2", 512, m) for m in GPT2_MESHES]
    out += [(f"llama:{_key(m)}", "llama", 512, m) for m in LLAMA_MESHES]
    out.append((f"gpt2-v{ODD_VOCAB}:{_key(ODD_MESH)}", "gpt2", ODD_VOCAB, ODD_MESH))
    return out


def _batches(family, vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS[family]):
        idx = rng.integers(0, vocab, size=(8, 64)).astype(np.int32)
        out.append({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    return out


def _torch_cfg(family, vocab):
    from ray_tpu_torch.models import gpt2, llama

    cls = gpt2.GPT2Config if family == "gpt2" else llama.LlamaConfig
    return cls.tiny(use_flash_attention=False, dtype=torch.float32, vocab_size=vocab)


def _train_body(rank, world, inits_path):
    """Every case on the 8 ranks; each rank yields what the tests read."""
    from ray_tpu_torch.models import _flax, gpt2_moe
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.train_step import TrainStep

    with open(inits_path, "rb") as f:
        inits = pickle.load(f)
    for name, family, vocab, axes in _cases():
        ts = TrainStep(_torch_cfg(family, vocab), make_mesh(axes, device="cpu"),
                       learning_rate=LR[family])
        state = _flax.load_flax_state(ts, inits[(family, vocab)])
        metrics = []
        for b in _batches(family, vocab):
            state, m = ts.step(state, ts.shard_batch(b))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        full = _flax.full_state(ts, state)
        rec = ts.telemetry
        yield name, {"metrics": metrics,
                     "tokens": rec.tokens, "examples": rec.examples,
                     "params": ({k: v.numpy() for k, v in full["params"].items()}
                                if rank == 0 else None)}

    ts = TrainStep(_torch_cfg("gpt2", 512), make_mesh({"fsdp": 4, "tp": 2}, device="cpu"),
                   telemetry=False)
    state = ts.init()
    p = dict(state["params"].named_parameters())["h.0.attn.c_attn.weight"]
    mu = state["opt_state"]["mu"]["h.0.attn.c_attn.weight"]
    yield "sharded", {"local": p.to_local().numel(), "mu_local": mu.to_local().numel(),
                      "placements": (repr(p.placements), repr(mu.placements)),
                      "meshes": (p.device_mesh == mu.device_mesh)}

    # three stacked batches in one multi_step call against three step calls
    ts = TrainStep(_torch_cfg("gpt2", 512), make_mesh(SAME_MESH["gpt2", 512][0], device="cpu"),
                   learning_rate=LR["gpt2"], telemetry=False)
    raw = _batches("gpt2", 512)
    a, b = ts.init(), ts.init()
    singles = [ts.step(a, ts.shard_batch(x))[1] for x in raw]
    _, multi = ts.multi_step(b, ts.shard_batch(
        {k: np.stack([x[k] for x in raw]) for k in raw[0]}), STEPS["gpt2"])
    yield "multi_step", {k: (multi[k].tolist(), [m[k].item() for m in singles])
                         for k in ("loss", "grad_norm")}

    refused = {}
    twelve_heads = dataclasses.replace(_torch_cfg("gpt2", 512), n_head=12, n_embd=96)
    moe = gpt2_moe.GPT2MoEConfig.tiny_moe(use_flash_attention=False, dtype=torch.float32)
    for key, axes, cfg in (("tp8", {"tp": 8}, twelve_heads), ("ep", {"ep": 8}, moe)):
        try:
            TrainStep(cfg, make_mesh(axes, device="cpu"))
        except (ValueError, NotImplementedError) as exc:
            refused[key] = (type(exc).__name__, str(exc))
    yield "refused", refused


def _numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _jax_cfg(family, vocab):
    import jax.numpy as jnp

    from ray_tpu.models.gpt2 import GPT2Config
    from ray_tpu.models.llama import LlamaConfig

    cls = GPT2Config if family == "gpt2" else LlamaConfig
    return cls.tiny(use_flash_attention=False, dtype=jnp.float32, vocab_size=vocab)


def _jax_step(family, vocab, axes=None):
    import jax

    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.train_step import TrainStep

    mesh = make_mesh(axes) if axes else make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return TrainStep(_jax_cfg(family, vocab), mesh, learning_rate=LR[family],
                     telemetry=False)


@pytest.fixture(scope="module")
def jax_inits():
    """The JAX initial state of each (family, vocab) as picklable numpy."""
    import jax

    from ray_tpu_torch.models._flax import _adam_state

    out = {}
    for key in {(family, vocab) for _, family, vocab, _ in _cases()}:
        state = _numpy(_jax_step(*key).init(jax.random.PRNGKey(0)))
        adam = _adam_state(state["opt_state"])
        out[key] = {"params": state["params"], "step": state["step"],
                    "opt_state": types.SimpleNamespace(count=adam.count, mu=adam.mu,
                                                       nu=adam.nu)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_inits):
    # the states go through a file: a large argument would hold each
    # spawn's start until the child had imported torch to read it
    workdir = tmp_path_factory.mktemp("train_ranks")
    with open(workdir / "inits.pkl", "wb") as f:
        pickle.dump(jax_inits, f)
    pool = Ranks(_train_body, 8, workdir, (str(workdir / "inits.pkl"),))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jax_runs(ranks):
    """The JAX steps (STEPS) per reference: the one-device step of each (family,
    vocab) and the same-mesh steps; metrics and final params as numpy."""
    import jax

    out = {}
    refs = [(key, None) for key in {(f, v) for _, f, v, _ in _cases()}]
    refs += [(key, _key(m)) for key, meshes in SAME_MESH.items() for m in meshes]
    for key, mesh_key in refs:
        axes = next((m for m in SAME_MESH.get(key, []) if _key(m) == mesh_key), None)
        ts = _jax_step(*key, axes)
        state = ts.init(jax.random.PRNGKey(0))
        metrics = []
        for b in _batches(*key):
            state, m = ts.step(state, ts.shard_batch(b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[key, mesh_key] = {"metrics": metrics, "params": _numpy(state["params"])}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("name,family,vocab,axes", _cases(), ids=[c[0] for c in _cases()])
def test_mesh_follows_the_jax_train_step(ranks, jax_runs, name, family, vocab, axes):
    got = ranks.get(name)
    same = axes in SAME_MESH.get((family, vocab), [])
    ref = jax_runs[(family, vocab), _key(axes) if same else None]
    np.testing.assert_allclose(got["metrics"], ref["metrics"], rtol=RTOL, atol=0)
    losses = [m[0] for m in got["metrics"]]
    assert losses[-1] < losses[0]
    want = _flat(ref["params"])
    assert set(got["params"]) == set(want)
    for path, p in got["params"].items():
        np.testing.assert_allclose(p, want[path], atol=2 * LR[family], rtol=0,
                                   err_msg=path)
    for rank in range(1, 8):   # every rank reports the same loss and norm
        assert ranks.get(name, rank)["metrics"] == got["metrics"]


def test_recorder_books_the_global_batch(ranks):
    """Two steps after the compile step, the global (8, 64) batch each."""
    assert STEPS["gpt2"] == 3
    for rank in range(8):
        got = ranks.get("gpt2:dp2,sp2,tp2", rank)
        assert (got["tokens"], got["examples"]) == (2 * 8 * 64, 2 * 8)


def test_state_is_sharded(ranks):
    """fsdp 4 x tp 2: each rank holds 1/8 of c_attn's elements, and Adam's mu
    has the same placement on the same mesh."""
    C = 128
    for rank in range(8):
        got = ranks.get("sharded", rank)
        assert got["local"] * 8 == C * 3 * C
        assert got["mu_local"] == got["local"]
        assert got["placements"][0] == got["placements"][1] and got["meshes"]
        assert "Shard(dim=1)" in got["placements"][0]


def test_multi_step_on_a_mesh_matches_repeated_step(ranks):
    for rank in range(8):
        for key, (multi, singles) in ranks.get("multi_step", rank).items():
            assert multi == singles, key


def test_refuses_what_the_mesh_cannot_take(ranks):
    refused = ranks.get("refused")
    kind, msg = refused["tp8"]
    assert kind == "ValueError" and "12 heads do not split over tp = 8" in msg
    kind, msg = refused["ep"]
    assert kind == "ValueError" and msg == "ep = 8 does not divide num_experts = 4"
