"""The port's main paths on its runtime, against the JAX package, on the CPU.

  - An actor builds ``build_adapter("gpt2-tiny", ..., device="cpu")`` with
    the JAX zoo's weights (``load_flax_params``) and serves greedy streams
    through the port's ``LLMEngine``; they equal the JAX ``LLMEngine``'s
    streams on the JAX adapter, computed in the test process (the scenario
    of tests/test_torch_serve_llm.py: four requests, one a prefix-cache
    hit).
  - A task runs the port's ``TrainStep`` (``device="cpu"``, gpt2-tiny,
    fp32) for 3 steps from the JAX initial state (``load_flax_state``) on
    the same batches: losses and grad_norms within 1e-4 relative of the
    JAX ``TrainStep``'s (fp32; the summation order differs).

The weights and states cross into the workers as numpy through the object
store; the workers import torch and the port, never JAX.
"""

import sys
from types import SimpleNamespace

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh import make_mesh
from ray_tpu.parallel.train_step import TrainStep as JTrainStep
from ray_tpu.serve.llm import adapters as jadapters
from ray_tpu.serve.llm import engine as jengine

RTOL = 1e-4
LR = 1e-3
TINY = {"n_layer": 2, "n_embd": 64, "n_head": 4, "vocab_size": 96, "block_size": 64}
PROMPTS = [[5, 9, 17, 3], list(range(1, 20)), [7, 7, 7, 7, 7, 7, 1, 2]]


def _plain(tree):
    """Nested plain dicts of numpy arrays (flax containers and jax arrays
    stay behind: the workers never import JAX)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.array(tree)


def _drive(engine_mod, adapter):
    eng = engine_mod.LLMEngine(adapter, num_blocks=64, block_size=4, max_batch=4)
    sp = engine_mod.SamplingParams(max_tokens=8)
    rids = [eng.submit(p, sp) for p in PROMPTS]
    eng.step()                                   # prompt 2's blocks indexed
    rids.append(eng.submit(PROMPTS[1] + [4, 4], sp))   # prefix-cache hit
    eng.run_until_drained()
    eng.cache.assert_no_leaks()
    return [eng.pull(r) for r in rids], eng.cache.prefix_hit_tokens


def _batches(n, B=4, T=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, TINY["vocab_size"], size=(B, T)).astype(np.int32)
        out.append({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    return out


@pytest.fixture(scope="module")
def cluster():
    """The module's helpers travel by value: a worker that imported this
    module by name would import JAX with it."""
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=2)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
            cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


def test_actor_serves_the_jax_engines_streams(cluster):
    jad = jadapters.build_adapter(
        "gpt2-tiny", {**TINY, "use_flash_attention": False}, seed=0)
    want = _drive(jengine, jad)

    @ray_tpu_torch.remote
    class Server:
        def __init__(self, params):
            import torch

            from ray_tpu_torch.models import gpt2
            from ray_tpu_torch.serve.llm import adapters

            torch.set_num_threads(1)
            self.adapter = adapters.build_adapter(
                "gpt2-tiny", TINY, seed=0, device="cpu")
            gpt2.load_flax_params(self.adapter.model, params)

        def serve(self):
            from ray_tpu_torch.ops import attention
            from ray_tpu_torch.serve.llm import engine

            before = attention.FLASH_FWD_LAUNCHES
            streams = _drive(engine, self.adapter)
            return (streams, attention.FLASH_FWD_LAUNCHES - before,
                    "jax" in sys.modules)

    server = Server.remote(ray_tpu_torch.put(_plain(jad.p)))
    got, launches, jax_in_worker = ray_tpu_torch.get(server.serve.remote(),
                                                     timeout=120)
    assert not jax_in_worker
    assert got == want
    assert got[1] > 0                            # the hit path ran
    assert all(done and len(t) == 8 for t, done, _ in got[0])
    assert launches == 0                         # CPU: the plain path only


def test_task_trains_three_steps_like_the_jax_train_step(cluster):
    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, n_layer=2)
    ts = JTrainStep(cfg, make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    learning_rate=LR, telemetry=False)
    state = ts.init(jax.random.PRNGKey(3))
    adam = next(s for s in jax.tree.leaves(
        state["opt_state"], is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    init = {"params": _plain(state["params"]), "step": np.array(state["step"]),
            "opt_state": SimpleNamespace(count=np.array(adam.count),
                                         mu=_plain(adam.mu), nu=_plain(adam.nu))}
    batches = _batches(3)
    want = []
    for b in batches:
        state, m = ts.step(state, ts.shard_batch(b))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    @ray_tpu_torch.remote
    def train(init, batches):
        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.parallel.train_step import TrainStep

        torch.set_num_threads(1)
        cfg = gpt2.GPT2Config.tiny(dtype=torch.float32, n_layer=2)
        ts = TrainStep(cfg, device="cpu", telemetry=False, learning_rate=LR)
        state = gpt2.load_flax_state(ts, init)
        out = []
        for b in batches:
            state, m = ts.step(state, ts.shard_batch(b))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, "jax" in sys.modules

    got, jax_in_worker = ray_tpu_torch.get(train.remote(init, batches),
                                           timeout=120)
    assert not jax_in_worker
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL, atol=0)
