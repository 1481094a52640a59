"""The port's runtime against ``ray_tpu`` where no cluster is needed.

  - ids: the binary layout and hex of every id type, built the same way in
    both packages, are equal;
  - ``normalize_resources`` and ``ResourceSet`` arithmetic give the JAX
    results with GPU in place of TPU (``num_gpus`` for ``num_tpus``);
  - the flag table: every flag of the JAX runtime but its two TPU flags,
    with the JAX default, read from ``RTPU_TORCH_<name>``; explicit
    ``apply_system_config`` > environment > default;
  - GPU detection: ``RTPU_TORCH_num_gpus``, then ``CUDA_VISIBLE_DEVICES``,
    then the driver's files and ``nvidia-smi``, never importing torch (in a
    fresh interpreter); lease ids mapped through the node's own
    ``CUDA_VISIBLE_DEVICES``;
  - ``.bind()`` builds the port's DAG nodes (``ray_tpu_torch.dag``) on
    functions, actor classes and actor methods, and their eager
    ``execute()`` gives the values ``.remote()`` gives.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from ray_tpu._private import config as jconfig
from ray_tpu._private import ids as jids
from ray_tpu._private import task_spec as jts
from ray_tpu._private.raylet import resources as jres
from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private import config as tconfig
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import task_spec as tts
from ray_tpu_torch._private.raylet import resources as tres

from _torch_runtime import ray_start_2_cpus  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------- ids

_ID_TYPES = ["JobID", "NodeID", "WorkerID", "PlacementGroupID", "ActorID",
             "TaskID", "ObjectID"]


@pytest.mark.parametrize("name", _ID_TYPES)
def test_id_binary_layout_and_hex_equal_jax(name):
    J, T = getattr(jids, name), getattr(tids, name)
    assert J.SIZE == T.SIZE
    raw = bytes(range(7, 7 + J.SIZE))
    j, t = J(raw), T(raw)
    assert j.binary() == t.binary() == raw and j.hex() == t.hex()
    assert T.from_hex(j.hex()).binary() == raw
    assert J.nil().binary() == T.nil().binary() and T.nil().is_nil()


def test_derived_ids_equal_jax():
    job_j, job_t = jids.JobID.from_int(0x1234), tids.JobID.from_int(0x1234)
    assert job_j.binary() == job_t.binary() and job_t.int_value() == 0x1234
    actor_raw = tids.ActorID.of(job_t).binary()
    assert actor_raw.endswith(job_t.binary())
    actor_j, actor_t = jids.ActorID(actor_raw), tids.ActorID(actor_raw)
    assert actor_j.job_id().binary() == actor_t.job_id().binary()
    assert (jids.TaskID.for_actor_creation(actor_j).binary()
            == tids.TaskID.for_actor_creation(actor_t).binary())
    task_raw = tids.TaskID.for_task(job_t).binary()
    task_j, task_t = jids.TaskID(task_raw), tids.TaskID(task_raw)
    assert task_t.job_id().binary() == job_t.binary()
    for index in (0, 1, 7, 2**20):
        oj, ot = jids.ObjectID.from_task(task_j, index), tids.ObjectID.from_task(task_t, index)
        assert oj.binary() == ot.binary() and ot.return_index() == oj.return_index()
        assert ot.task_id().binary() == task_raw
        assert (jids.ObjectID.for_put(task_j, index).binary()
                == tids.ObjectID.for_put(task_t, index).binary())


# ---------------------------------------------------------------- resources

_RESOURCE_CASES = [
    dict(),
    dict(num_cpus=2, accel=1),
    dict(num_cpus=0.5, accel=0.25, memory=1e9, resources={"custom": 2}),
    dict(num_cpus=0, accel=4, resources={}),
    dict(num_cpus=None, accel=0, resources={"a": 0, "b": 1.5}, default_cpus=0),
]


def _normalize(mod, accel_kw, case):
    case = dict(case)
    accel = case.pop("accel", None)
    return mod.normalize_resources(**case, **{accel_kw: accel})


@pytest.mark.parametrize("case", range(len(_RESOURCE_CASES)))
def test_normalize_resources_equals_jax_with_gpu_for_tpu(case):
    case = _RESOURCE_CASES[case]
    want = _normalize(jts, "num_tpus", case)
    want = {("GPU" if k == "TPU" else k): v for k, v in want.items()}
    assert _normalize(tts, "num_gpus", case) == want


@pytest.mark.parametrize("key", ["CPU", "memory", "accel"])
def test_normalize_resources_rejects_dedicated_keys_like_jax(key):
    with pytest.raises(ValueError, match="dedicated option"):
        jts.normalize_resources(resources={("TPU" if key == "accel" else key): 1})
    with pytest.raises(ValueError, match="dedicated option"):
        tts.normalize_resources(resources={("GPU" if key == "accel" else key): 1})


def test_resource_set_arithmetic_equals_jax():
    def run(mod, accel):
        node = mod.ResourceSet({"CPU": 4, accel: 4, "memory": 1e9})
        out = []
        leases = [{"CPU": 1, accel: 2}, {"CPU": 0.5, accel: 0.25},
                  {"CPU": 1, accel: 2}, {accel: 0.75}, {"CPU": 3}]
        held = []
        for demand in leases:
            d = mod.ResourceSet(demand)
            ok = node.acquire(d)
            if ok:
                held.append(d)
            out.append((ok, node.to_dict(), node.fits(mod.ResourceSet({accel: 1}))))
        for _ in range(10):              # fixed point: no drift on cycles
            d = mod.ResourceSet({"CPU": 0.1, accel: 0.1})
            node.acquire(d)
            node.release(d)
        out.append(node.to_dict())
        for d in held:
            node.release(d)
        node.subtract_capped(mod.ResourceSet({accel: 9}))
        out.append((node.to_dict(), node.get(accel), node.is_empty()))
        return out

    def rename(x):
        if isinstance(x, dict):
            return {("GPU" if k == "TPU" else k): v for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rename(v) for v in x)
        return x

    assert run(tres, "GPU") == rename(run(jres, "TPU"))


# -------------------------------------------------------------------- flags


def test_flag_table_is_the_jax_table_with_num_gpus_for_the_tpu_flags():
    want = {k: v for k, v in jconfig._FLAGS.items()
            if k not in ("num_tpu_chips", "tpu_pod_type")}
    got = dict(tconfig._FLAGS)
    assert got.pop("num_gpus") == -1
    # the perf gate's ledger: the port's own, never the JAX package's file
    assert got.pop("perf_history_path") == "PERF_HISTORY_TORCH.jsonl"
    assert want.pop("perf_history_path") == "PERF_HISTORY.jsonl"
    assert got == want


def test_flag_precedence_explicit_then_env_then_default(monkeypatch):
    cfg = tconfig._Config()
    assert cfg.task_max_retries_default == 3
    monkeypatch.setenv("RTPU_TORCH_task_max_retries_default", "7")
    monkeypatch.setenv("RTPU_task_max_retries_default", "9")   # the JAX flag
    monkeypatch.setenv("RTPU_TORCH_direct_channels", "0")
    monkeypatch.setenv("RTPU_TORCH_scheduler_spread_threshold", "0.25")
    assert cfg.task_max_retries_default == 7
    assert cfg.direct_channels is False
    assert cfg.scheduler_spread_threshold == 0.25
    cfg.apply_system_config('{"task_max_retries_default": 1}')
    assert cfg.task_max_retries_default == 1
    assert cfg.dump()["task_max_retries_default"] == 1
    with pytest.raises(ValueError, match="Unknown config flag"):
        cfg.apply_system_config({"num_tpu_chips": 4})
    with pytest.raises(AttributeError):
        cfg.num_tpu_chips


# ---------------------------------------------------------------- detection


@pytest.fixture
def no_cards(monkeypatch):
    """Detection on a host without the NVIDIA driver's files or tool."""
    monkeypatch.delenv("RTPU_TORCH_num_gpus", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(accelerators, "_proc_names", lambda: [])
    monkeypatch.setattr(accelerators, "_smi_names", lambda: [])


def test_detection_order(no_cards, monkeypatch):
    assert accelerators.num_gpus() == 0
    assert accelerators.node_resources_and_labels() == ({}, {})
    monkeypatch.setattr(accelerators, "_smi_names", lambda: ["NVIDIA H100 80GB HBM3"] * 2)
    assert accelerators.node_resources_and_labels() == (
        {"GPU": 2.0}, {"rtpu.io/gpu-name": "NVIDIA H100 80GB HBM3"})
    monkeypatch.setattr(accelerators, "_proc_names", lambda: ["A", "B", "C"])
    assert accelerators.num_gpus() == 3                 # the driver's files first
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert accelerators.num_gpus() == 2                 # the process's view next
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert accelerators.num_gpus() == 0                 # an empty view hides all
    monkeypatch.setenv("RTPU_TORCH_num_gpus", "5")
    assert accelerators.num_gpus() == 5                 # the flag wins


def test_lease_ids_map_through_the_node_view(no_cards, monkeypatch):
    env = accelerators.visible_gpu_env
    assert env([0, 2]) == {"CUDA_VISIBLE_DEVICES": "0,2"}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3,5")
    assert env([0]) == {"CUDA_VISIBLE_DEVICES": "2"}
    assert env([1, 2]) == {"CUDA_VISIBLE_DEVICES": "3,5"}


def test_proc_driver_files_give_the_name(tmp_path, monkeypatch):
    card = tmp_path / "0000:00:04.0"
    card.mkdir()
    (card / "information").write_text(
        "Model: \t\t NVIDIA H100 80GB HBM3\nIRQ:  1\n")
    monkeypatch.setattr(accelerators.glob, "glob",
                        lambda pattern: [str(card)])
    assert accelerators._proc_names() == ["NVIDIA H100 80GB HBM3"]


def test_detection_reads_the_flag_without_cuda_in_a_fresh_interpreter():
    code = (
        "import sys\n"
        "from ray_tpu_torch._private import accelerators as a\n"
        "print(a.node_resources_and_labels()[0], 'torch' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), RTPU_TORCH_num_gpus="3")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "{'GPU': 3.0} False"


def test_bind_raises_until_the_dag_is_ported(ray_start_2_cpus):
    """``.bind()`` builds a DAG node in ``ray_tpu``, and now in the port:
    a ``FunctionNode``, a ``ClassNode`` and a ``ClassMethodNode`` of
    ``ray_tpu_torch.dag``, whose eager ``execute()`` runs the task, creates
    the actor and calls its method."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import ClassNode, FunctionNode
    from ray_tpu_torch.dag.node import ClassMethodNode

    def f(x):
        return x + 1

    class A:
        def __init__(self, k):
            self.k = k

        def m(self, x):
            return x * self.k

    fn = ray_tpu_torch.remote(f).bind(1)
    assert type(fn) is FunctionNode
    assert ray_tpu_torch.get(fn.execute(), timeout=60) == 2
    cls = ray_tpu_torch.remote(A).bind(3)
    assert type(cls) is ClassNode
    handle = cls.execute()
    assert isinstance(handle, ray_tpu_torch.ActorHandle)
    for meth in (handle.m.bind(5), cls.m.bind(5)):
        assert type(meth) is ClassMethodNode
        assert ray_tpu_torch.get(meth.execute(), timeout=60) == 15
    assert cls.execute() is handle  # one actor per ClassNode
