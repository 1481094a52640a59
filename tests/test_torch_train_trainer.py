"""The port's trainer (``ray_tpu_torch.train``) on the CPU.

``TorchTrainer(...).fit()`` against the JAX package's ``TrainStep``: GPT-2
tiny and Llama tiny in fp32 train three steps from the JAX initial state of
``PRNGKey(0)`` (carried across with ``load_flax_state``, passed to the loop
as numpy arrays in its config) on batches from ``np.random.default_rng(0)``,
inside one worker (``train.torch.get_device()``, the CPU) and inside two
gloo workers (``make_mesh({"dp": 2}, device="cpu")`` takes the group the
trainer brought up; each rank its half of the global batch). Loss and
grad_norm are held to 1e-5 relative of the JAX one-device step, the
parameters to 2 * lr (Adam's first steps move a weight by about lr whatever
its gradient), and the two ranks to each other bitwise.

Also copies of tests/test_train.py's cases (report rounds and context,
checkpoint save and restore, worker errors, group restart, the pipelined
checkpoint ack) and of tests/test_torch_trainer.py's three (DDP sync,
``prepare_data_loader`` sharding, one worker with no process group), with
``TorchTrainer``; ``use_gpu`` workers leasing distinct cards of a
``num_gpus=2`` cluster; and a device-trace window opened in a worker,
registered with the GCS where ``profiling.list_registered`` finds it. One module cluster; the module's
helpers travel to the workers by value, so no worker imports JAX.
"""

import json
import os
import pickle
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch
from _torch_runtime import port_env
from ray_tpu_torch import train
from ray_tpu_torch.train import (
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer

REPO = Path(__file__).resolve().parents[1]
LR = {"gpt2": 1e-3, "llama": 5e-3}
STEPS, B, T = 3, 8, 32
RTOL = 1e-5


@pytest.fixture(scope="module")
def cluster():
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=8, num_gpus=2)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()
            cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


@pytest.fixture
def storage(tmp_path):
    return str(tmp_path)


# ------------------------------------------------- parity with the JAX step


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        idx = rng.integers(0, vocab, size=(B, T)).astype(np.int32)
        out.append({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """Per family: the JAX initial state as picklable numpy (Adam's state
    as a namespace: an optax tuple would need optax in the worker), and the
    one-device run's metrics and final parameters."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models.gpt2 import GPT2Config
    from ray_tpu.models.llama import LlamaConfig
    from ray_tpu.parallel.mesh import make_mesh
    from ray_tpu.parallel.train_step import TrainStep
    from ray_tpu_torch.models._flax import _adam_state

    out = {}
    for family, cls in (("gpt2", GPT2Config), ("llama", LlamaConfig)):
        cfg = cls.tiny(use_flash_attention=False, dtype=jnp.float32)
        ts = TrainStep(cfg, make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                       learning_rate=LR[family], telemetry=False)
        state = ts.init(jax.random.PRNGKey(0))
        init = jax.tree.map(np.asarray, state)
        adam = _adam_state(init["opt_state"])
        metrics = []
        for b in _batches(cfg.vocab_size):
            state, m = ts.step(state, ts.shard_batch(b))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[family] = {
            "init": {"params": init["params"], "step": init["step"],
                     "opt_state": types.SimpleNamespace(
                         count=adam.count, mu=adam.mu, nu=adam.nu)},
            "metrics": metrics,
            "params": _flat(jax.tree.map(np.asarray, state["params"])),
        }
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _parity_loop(config):
    """Each family's three steps from the JAX initial state; every rank
    writes its metrics and gathered parameters to ``config["out"]``."""
    import torch

    from ray_tpu_torch.models import _flax, gpt2, llama
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.train_step import TrainStep

    torch.set_num_threads(1)
    ctx = train.get_context()
    world = ctx.get_world_size()
    out = {}
    for family, cls in (("gpt2", gpt2.GPT2Config), ("llama", llama.LlamaConfig)):
        cfg = cls.tiny(use_flash_attention=False, dtype=torch.float32)
        if world > 1:
            ts = TrainStep(cfg, make_mesh({"dp": world}, device="cpu"),
                           learning_rate=LR[family])
        else:
            ts = TrainStep(cfg, device=train.torch.get_device(),
                           learning_rate=LR[family])
        state = _flax.load_flax_state(ts, config["inits"][family])
        metrics = []
        for b in _batches(cfg.vocab_size):
            state, m = ts.step(state, ts.shard_batch(b))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        params = _flax.full_state(ts, state)["params"]
        out[family] = {"metrics": metrics,
                       "params": {k: v.numpy() for k, v in params.items()}}
    with open(os.path.join(config["out"], f"rank{ctx.get_world_rank()}.pkl"), "wb") as f:
        pickle.dump(out, f)
    train.report({f"{family}_loss": run["metrics"][-1][0] for family, run in out.items()})


@pytest.fixture(scope="module")
def parity_fits(cluster, jax_runs, tmp_path_factory):
    """One fit per worker count, run when a test first asks for it."""
    fits = {}

    def fit(workers):
        if workers not in fits:
            out = tmp_path_factory.mktemp(f"parity{workers}")
            inits = {family: run["init"] for family, run in jax_runs.items()}
            result = TorchTrainer(
                _parity_loop,
                train_loop_config={"inits": inits, "out": str(out)},
                scaling_config=ScalingConfig(num_workers=workers, use_gpu=False),
                run_config=RunConfig(storage_path=str(out), name=f"parity{workers}"),
            ).fit()
            ranks = []
            for r in range(workers):
                with open(out / f"rank{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            fits[workers] = (result, ranks)
        return fits[workers]

    return fit


@pytest.mark.timeout(150)
@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_trainer_follows_the_jax_train_step(parity_fits, jax_runs, workers, family):
    result, ranks = parity_fits(workers)
    ref = jax_runs[family]
    got = ranks[0][family]
    np.testing.assert_allclose(got["metrics"], ref["metrics"], rtol=RTOL, atol=0)
    assert result.metrics[f"{family}_loss"] == got["metrics"][-1][0]
    assert set(got["params"]) == set(ref["params"])
    for path, p in got["params"].items():
        np.testing.assert_allclose(p, ref["params"][path], atol=2 * LR[family],
                                   rtol=0, err_msg=path)
    for other in ranks[1:]:       # every rank holds the same run, bitwise
        assert other[family]["metrics"] == got["metrics"]
        for path, p in got["params"].items():
            assert np.array_equal(other[family]["params"][path], p), path


# --------------------------------------------- copies of tests/test_train.py


def test_report_rounds_and_context(cluster, storage):
    def loop(config):
        ctx = train.get_context()
        assert ctx.get_world_size() == 2
        for step in range(3):
            train.report({"step": step, "rank": ctx.get_world_rank(),
                          "lr": config["lr"]})

    trainer = TorchTrainer(
        loop,
        train_loop_config={"lr": 0.1},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=storage, name="ctx"),
    )
    result = trainer.fit()
    assert result.metrics["step"] == 2
    assert result.metrics["rank"] == 0  # rank-0 metrics win
    assert len(result.metrics_history) == 3


def test_checkpoint_save_and_restore(cluster, storage):
    def loop(config):
        ctx = train.get_context()
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                start = json.load(f)["step"] + 1
        for step in range(start, start + 2):
            if ctx.get_world_rank() == 0:
                d = tempfile.mkdtemp()
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump({"step": step}, f)
                train.report({"step": step}, checkpoint=Checkpoint(d))
            else:
                train.report({"step": step})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(
            storage_path=storage, name="ckpt",
            checkpoint_config=CheckpointConfig(num_to_keep=2),
        ),
    )
    result = trainer.fit()
    assert result.metrics["step"] == 1
    assert result.checkpoint is not None

    # resume: picks up where the checkpoint left off
    trainer2 = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=storage, name="ckpt2"),
        resume_from_checkpoint=result.checkpoint,
    )
    result2 = trainer2.fit()
    assert result2.metrics["step"] == 3


def test_worker_error_surfaces(cluster, storage):
    def loop(config):
        ctx = train.get_context()
        train.report({"ok": True})
        if ctx.get_world_rank() == 1:
            raise ValueError("boom at rank 1")
        train.report({"ok": True})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(storage_path=storage, name="err"),
    )
    with pytest.raises(train.TrainingFailedError, match="boom at rank 1"):
        trainer.fit()


def test_group_restart_on_failure(cluster, storage):
    marker = os.path.join(storage, "died_once")

    def loop(config):
        ctx = train.get_context()
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "s.json")) as f:
                start = json.load(f)["step"] + 1
        for step in range(start, 4):
            if ctx.get_world_rank() == 0:
                d = tempfile.mkdtemp()
                with open(os.path.join(d, "s.json"), "w") as f:
                    json.dump({"step": step}, f)
                train.report({"step": step}, checkpoint=Checkpoint(d))
            else:
                train.report({"step": step})
            if step == 1 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                os._exit(1)  # hard-kill the worker process

    trainer = TorchTrainer(
        loop,
        train_loop_config={"marker": marker},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(
            storage_path=storage, name="restart",
            failure_config=FailureConfig(max_failures=1),
        ),
    )
    result = trainer.fit()
    assert result.metrics["step"] == 3


def test_pipelined_checkpoint_report_blocks_until_ack():
    """With pipeline_depth > 1, a checkpoint report must not return before
    the driver acked it (the checkpoint dir may be deleted right after
    report() returns — reference train/_internal/session.py:667 persists
    before returning). Metrics-only reports stay pipelined."""
    import threading
    import time

    from ray_tpu_torch.train._session import TrainContext, _Session

    ctx = TrainContext(0, 1, 0, 1, "127.0.0.1")
    s = _Session(ctx, None, pipeline_depth=8)

    # metrics-only reports return immediately (no ack yet)
    for i in range(4):
        s.report({"step": i}, None)

    state = {"returned": False}

    def ckpt_report():
        s.report({"step": 4}, Checkpoint("/tmp"))
        state["returned"] = True

    t = threading.Thread(target=ckpt_report, daemon=True)
    t.start()
    time.sleep(0.2)
    assert not state["returned"], "checkpoint report returned before ack"
    # driver consumes+acks the first 4 rounds: still not this report's turn
    s.ack(4)
    time.sleep(0.2)
    assert not state["returned"]
    s.ack(1)  # ack the checkpoint round itself
    t.join(timeout=5)
    assert state["returned"]


# -------------------------------------- copies of tests/test_torch_trainer.py


def test_torch_ddp_trains_and_syncs(cluster, tmp_path):
    """2-rank DDP regression fit: loss must descend and both ranks must end
    with identical weights (the DDP allreduce contract)."""

    def loop(config):
        import torch
        import torch.distributed as dist
        import torch.nn as nn

        from ray_tpu_torch.train.torch import prepare_model

        ctx = train.get_context()
        assert dist.is_initialized()
        assert dist.get_world_size() == 2
        assert dist.get_rank() == ctx.get_world_rank()

        torch.manual_seed(1234 + ctx.get_world_rank())
        model = prepare_model(nn.Linear(4, 1))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        g = torch.Generator().manual_seed(ctx.get_world_rank())
        x = torch.randn(64, 4, generator=g)
        y = x @ torch.tensor([[1.0], [2.0], [-1.0], [0.5]]) + 0.1

        first = last = None
        for step in range(30):
            opt.zero_grad()
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            if first is None:
                first = float(loss)
            last = float(loss)
            if step % 10 == 9:
                train.report({"loss": last, "rank": ctx.get_world_rank()})
        w = model.module.weight.detach().numpy().copy()
        train.report({"loss": last, "final_w": w.tolist(), "first": first})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="torch_ddp", storage_path=str(tmp_path)),
        torch_config=TorchConfig(backend="gloo"),
    )
    result = trainer.fit()
    assert result.metrics["loss"] < result.metrics["first"] * 0.2
    w = np.asarray(result.metrics["final_w"]).ravel()
    np.testing.assert_allclose(w, [1.0, 2.0, -1.0, 0.5], atol=0.25)


def test_prepare_data_loader_shards(cluster, tmp_path):
    def loop(config):
        import torch.utils.data as tud

        from ray_tpu_torch.train.torch import prepare_data_loader

        ds = list(range(100))
        loader = tud.DataLoader(ds, batch_size=10)
        sharded = prepare_data_loader(loader)
        seen = [int(x) for batch in sharded for x in batch]
        train.report({"n": len(seen),
                      "rank": train.get_context().get_world_rank()})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="torch_shard", storage_path=str(tmp_path)),
    )
    result = trainer.fit()
    assert result.metrics["n"] == 50  # half of the dataset per rank


def test_single_worker_no_dist(cluster, tmp_path):
    def loop(config):
        import torch.distributed as dist
        import torch.nn as nn

        from ray_tpu_torch.train.torch import prepare_model

        assert not dist.is_initialized()
        m = prepare_model(nn.Linear(2, 1))
        assert isinstance(m, nn.Linear)  # no DDP wrap for world_size 1
        train.report({"ok": 1})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="torch_single", storage_path=str(tmp_path)),
    )
    assert trainer.fit().metrics["ok"] == 1


# ------------------------------------------------------------- the port's own


def test_worker_resources_and_actor_options():
    from ray_tpu_torch.train._worker_group import _to_actor_options

    assert ScalingConfig().worker_resources() == {"GPU": 1, "CPU": 1}
    assert ScalingConfig(use_gpu=False).worker_resources() == {"CPU": 1}
    assert ScalingConfig(resources_per_worker={"CPU": 2}
                         ).worker_resources() == {"CPU": 2}
    assert _to_actor_options({"GPU": 1, "CPU": 1, "memory": 5, "x": 2}) == {
        "num_cpus": 1, "num_gpus": 1, "memory": 5, "resources": {"x": 2}}
    with pytest.raises(ValueError, match="use GPU"):
        _to_actor_options({"TPU": 1})
    # datasets= is taken (ray_tpu_torch.data); the shard is read in a worker
    assert TorchTrainer(lambda: None, datasets={"train": [1]})._datasets == {"train": [1]}
    with pytest.raises(RuntimeError, match="outside a train worker"):
        train.get_dataset_shard()


def test_gpu_workers_lease_distinct_cards(cluster, tmp_path):
    """``use_gpu``: two workers on a ``num_gpus=2`` cluster lease distinct
    cards, each its own ``CUDA_VISIBLE_DEVICES`` equal to its accelerator
    ids; ``get_device()`` then refuses to fall back to the CPU in a process
    that sees no CUDA. (gloo: there is no card for NCCL here.)"""

    def loop(config):
        ctx = train.get_context()
        ids = ray_tpu_torch.get_runtime_context().get_accelerator_ids()["GPU"]
        try:
            train.torch.get_device()
            err = ""
        except RuntimeError as e:
            err = str(e)
        rec = {"ids": ids, "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "err": err}
        with open(os.path.join(config["out"], f"rank{ctx.get_world_rank()}.json"), "w") as f:
            json.dump(rec, f)
        train.report({"ok": 1})

    TorchTrainer(
        loop,
        train_loop_config={"out": str(tmp_path)},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=True),
        run_config=RunConfig(name="gpus", storage_path=str(tmp_path)),
        torch_config=TorchConfig(backend="gloo"),
    ).fit()
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert sorted(r["visible"] for r in recs) == ["0", "1"]
    assert all(r["ids"] == [r["visible"]] for r in recs)
    assert all("torch.cuda.is_available() is False" in r["err"] for r in recs)


def test_worker_device_trace_is_registered(cluster, tmp_path):
    """A ``request_device_trace(1)`` window opened in a train worker (forced
    on the CPU) registers with the GCS, where the dashboard's reader
    (``profiling.list_registered(gcs, "device_trace")``) lists it."""

    def loop(config):
        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.parallel.train_step import TrainStep
        from ray_tpu_torch.train import _telemetry

        os.environ["RTPU_TORCH_device_trace_force"] = "1"
        ts = TrainStep(gpt2.GPT2Config.tiny(use_flash_attention=False,
                                            dtype=torch.float32, n_layer=1),
                       device=train.torch.get_device())
        state = ts.init(torch.Generator().manual_seed(0))
        batch = ts.shard_batch(_batches(ts.model_cfg.vocab_size)[0])
        assert _telemetry.request_device_trace(1, config["trace"])
        state, _ = ts.step(state, batch)
        train.report({"trace": ts.telemetry.device_trace.last_trace})

    trace = str(tmp_path / "window")
    result = TorchTrainer(
        loop,
        train_loop_config={"trace": trace},
        scaling_config=ScalingConfig(use_gpu=False),
        run_config=RunConfig(name="trace", storage_path=str(tmp_path)),
    ).fit()
    assert result.metrics["trace"] == os.path.join(trace, "trace.json")
    from ray_tpu_torch._private import profiling
    from ray_tpu_torch._private import worker as worker_mod

    listed = profiling.list_registered(worker_mod.global_worker.gcs, "device_trace")
    assert any(e["path"] == trace and e["steps"] == 1 for e in listed), listed


def test_driver_keeps_the_run_gauges(parity_fits):
    """``fit()`` re-publishes the last report's ``telemetry/*`` keys as the
    ``ray_tpu_train_*`` gauges from the driver, which outlives the workers:
    they reach the GCS under the run's name."""
    from ray_tpu_torch._private import worker as worker_mod

    result, _ = parity_fits(1)
    assert result.metrics["telemetry/tokens_per_s"] > 0
    worker_mod.global_worker.flush_user_metrics_sync()
    records = worker_mod.global_worker.gcs.call(
        "GetUserMetrics", {"prefix": "ray_tpu_train_"})["records"]
    gauges = {r["name"]: r["value"] for r in records
              if r["kind"] == "gauge" and r["labels"].get("run") == "parity1"}
    assert gauges["ray_tpu_train_tokens_per_second"] == pytest.approx(
        result.metrics["telemetry/tokens_per_s"])
    assert {"ray_tpu_train_goodput_ratio", "ray_tpu_train_last_step_seconds"} <= set(gauges)


def test_the_trial_actor_never_imports_torch(cluster, tmp_path):
    """``fit()``'s trial actor holds no card and drives the workers only:
    its process never maps torch (the loop and the trainer unpickle there
    without it)."""

    class Probe(TorchTrainer):
        def _on_group_start(self, group):
            with open(os.path.join(self._probe_dir, "trial.json"), "w") as f:
                json.dump({"torch": "torch" in sys.modules, "pid": os.getpid()}, f)
            TorchTrainer._on_group_start(self, group)

    def loop(config):
        train.report({"pid": os.getpid(), "torch": "torch" in sys.modules})

    trainer = Probe(loop, scaling_config=ScalingConfig(use_gpu=False),
                    run_config=RunConfig(name="probe", storage_path=str(tmp_path)))
    trainer._probe_dir = str(tmp_path)
    result = trainer.fit()
    trial = json.loads((tmp_path / "trial.json").read_text())
    assert trial == {"torch": False, "pid": trial["pid"]}
    assert result.metrics["pid"] != trial["pid"]


def test_train_and_tune_imports_leave_torch_out_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        "import ray_tpu_torch.train, ray_tpu_torch.tune\n"
        "from ray_tpu_torch import train, tune\n"
        "train.TorchTrainer, train.TorchConfig, train.ScalingConfig, train.report\n"
        "train.torch.get_device, train.torch.prepare_model\n"
        "tune.Tuner, tune.ASHAScheduler, tune.TPESearcher\n"
        "from ray_tpu_torch.train import _session, _storage, _worker_group\n"
        "from ray_tpu_torch.tune import controller\n"
        "from ray_tpu_torch.util import placement_group\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
