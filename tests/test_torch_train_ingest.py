"""The trainer's ingest: ``TorchTrainer(datasets=...)`` against the JAX
package's ``split_blocks`` and ``TrainStep``.

A dataset of token rows (``np.random.default_rng(0)``, T + 1 tokens a
row), mapped by a task into ``idx`` / ``targets``, shuffled with seed 0 and
cut into 4 equal blocks, is built under ``ray_tpu`` and each of its
``split_blocks(2)`` shards read in batches of B / 2 rows; then the same
program builds it under ``ray_tpu_torch`` (never both runtimes at once)
and ``TorchTrainer`` with two gloo workers trains GPT-2 tiny in fp32 on
``make_mesh({"dp": 2})`` from the JAX initial state of ``PRNGKey(0)``
(``load_flax_state``), each rank reading its shard through
``get_dataset_shard("train").iter_torch_batches(device="cpu")``. Each
rank's rows must equal its JAX shard's bitwise, and the losses and
grad_norms the JAX one-device ``TrainStep``'s on the global batches (rank
0's rows, then rank 1's) within 1e-5 relative.
"""

import os
import pickle
import sys
import types

import cloudpickle
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtime import port_env

LR = 1e-3
STEPS, B, T = 3, 8, 32
WORKERS = 2
RTOL = 1e-5


def _dataset(rd, vocab):
    tokens = np.random.default_rng(0).integers(
        0, vocab, size=(STEPS * B, T + 1)).astype(np.int32)
    return (rd.from_numpy(tokens, column="tokens", override_num_blocks=4)
            .map_batches(lambda b: {"idx": b["tokens"][:, :-1],
                                    "targets": b["tokens"][:, 1:]})
            .random_shuffle(seed=0)
            .repartition(4))


def _gpt2_tiny_vocab():
    from ray_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config.tiny().vocab_size


@pytest.fixture(scope="module")
def jax_side():
    """Each rank's rows from the JAX package's split_blocks(2), then the JAX
    one-device run on the global batches (the runtime is down by then), and
    its initial state as picklable numpy."""
    import jax
    import jax.numpy as jnp

    from ray_tpu import data as rd
    from ray_tpu.models.gpt2 import GPT2Config
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.train_step import TrainStep
    from ray_tpu_torch.models._flax import _adam_state

    cfg = GPT2Config.tiny(use_flash_attention=False, dtype=jnp.float32)
    assert cfg.vocab_size == _gpt2_tiny_vocab()
    ray_tpu.init(num_cpus=4)
    try:
        shards = _dataset(rd, cfg.vocab_size).split_blocks(WORKERS)
        rows = [[{k: np.asarray(v) for k, v in b.items()}
                 for b in shard.iter_batches(batch_size=B // WORKERS)]
                for shard in shards]
    finally:
        ray_tpu.shutdown()
    ts = TrainStep(cfg, make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                   learning_rate=LR, telemetry=False)
    state = ts.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    adam = _adam_state(init["opt_state"])
    metrics = []
    for step in range(STEPS):
        batch = {k: np.concatenate([rows[r][step][k] for r in range(WORKERS)])
                 for k in ("idx", "targets")}
        state, m = ts.step(state, ts.shard_batch(batch))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"rows": rows, "metrics": metrics,
            "init": {"params": init["params"], "step": init["step"],
                     "opt_state": types.SimpleNamespace(
                         count=adam.count, mu=adam.mu, nu=adam.nu)}}


def _ingest_loop(config):
    """Three steps on this rank's shard, every row and metric written to
    ``config["out"]``."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import _flax
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.train_step import TrainStep

    torch.set_num_threads(1)
    ctx = train.get_context()
    cfg = GPT2Config.tiny(use_flash_attention=False, dtype=torch.float32)
    ts = TrainStep(cfg, make_mesh({"dp": ctx.get_world_size()}, device="cpu"),
                   learning_rate=LR)
    state = _flax.load_flax_state(ts, config["init"])
    rows, metrics, kinds = [], [], set()
    for b in train.get_dataset_shard("train").iter_torch_batches(
            batch_size=B // ctx.get_world_size(), device="cpu",
            dtypes={"idx": torch.long, "targets": torch.long}):
        kinds |= {(str(v.dtype), v.device.type) for v in b.values()}
        rows.append({k: v.numpy().astype(np.int32) for k, v in b.items()})
        state, m = ts.step(state, b)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    with open(os.path.join(config["out"], f"rank{ctx.get_world_rank()}.pkl"), "wb") as f:
        pickle.dump({"rows": rows, "metrics": metrics, "kinds": sorted(kinds)}, f)
    train.report({"loss": metrics[-1][0]})


@pytest.fixture(scope="module")
def port_side(jax_side, tmp_path_factory):
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import RunConfig, ScalingConfig
    from ray_tpu_torch.train.torch import TorchTrainer

    out = tmp_path_factory.mktemp("ingest")
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        with pytest.MonkeyPatch.context() as mp:
            port_env(mp)
            ray_tpu_torch.init(num_cpus=6)
            try:
                result = TorchTrainer(
                    _ingest_loop,
                    train_loop_config={"init": jax_side["init"], "out": str(out)},
                    scaling_config=ScalingConfig(num_workers=WORKERS, use_gpu=False),
                    run_config=RunConfig(storage_path=str(out), name="ingest"),
                    datasets={"train": _dataset(rd, _gpt2_tiny_vocab())},
                ).fit()
            finally:
                ray_tpu_torch.shutdown()
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    ranks = []
    for r in range(WORKERS):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return result, ranks


@pytest.mark.timeout(170)
def test_each_rank_reads_the_jax_split_blocks_shard_bitwise(jax_side, port_side):
    _, ranks = port_side
    for r, rank in enumerate(ranks):
        assert rank["kinds"] == [("torch.int64", "cpu")]
        ref = jax_side["rows"][r]
        assert len(rank["rows"]) == len(ref) == STEPS
        for got, want in zip(rank["rows"], ref):
            assert set(got) == set(want) == {"idx", "targets"}
            for k in want:
                assert got[k].shape == (B // WORKERS, T)
                assert np.array_equal(got[k], want[k]), (r, k)
    every = np.concatenate([b["idx"] for rank in ranks for b in rank["rows"]])
    assert len({row.tobytes() for row in every}) == STEPS * B   # disjoint shards


def test_the_ingest_trains_as_the_jax_step(jax_side, port_side):
    result, ranks = port_side
    np.testing.assert_allclose(ranks[0]["metrics"], jax_side["metrics"], rtol=RTOL, atol=0)
    assert ranks[1]["metrics"] == ranks[0]["metrics"]   # one mean over the mesh
    assert result.metrics["loss"] == ranks[0]["metrics"][-1][0]


def test_get_dataset_shard_outside_a_worker_and_unknown_name():
    from ray_tpu_torch import train
    from ray_tpu_torch.train import _session
    from ray_tpu_torch.train._session import TrainContext

    with pytest.raises(RuntimeError, match="outside a train worker"):
        train.get_dataset_shard("train")
    ctx = TrainContext(world_rank=0, world_size=1, local_rank=0, local_world_size=1,
                       node_ip="", experiment_name="x")
    _session.init_session(ctx, None, {"train": "shard"})
    try:
        assert train.get_dataset_shard("train") == "shard"
        with pytest.raises(KeyError, match="no dataset 'eval'"):
            train.get_dataset_shard("eval")
    finally:
        _session.shutdown_session()
