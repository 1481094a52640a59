"""The public names of ``ray_tpu`` against ``ray_tpu_torch``, on the CPU.

Every module of the JAX package has a port module of the same path; this
file holds the port to the names inside them. The name walk parses both
trees (top-level functions and classes and their methods, public names
only) and fails on a name of ``ray_tpu`` that resolves nowhere at the same
path of ``ray_tpu_torch`` (a def, a re-export or an inherited method) and
is not one of ``RENAMES``. Then the names the walk once flagged, each
against the JAX package on the same inputs:

  - Llama's ``loss_fn`` and ``num_params`` (weights carried across with
    ``load_flax_params``): the count equal, the loss of the same logits to
    LOSS_TOL relative (both take an fp32 log-softmax of the same numbers),
    the loss of each model's own fp32 logits to MODEL_LOSS_TOL absolute
    (``test_torch_llama.py`` holds those logits to 1e-4 absolute, and a
    mean of log-softmax differences moves no more than twice that);
  - ``publish_report_summary``: the same ``ray_tpu_train_*`` gauge records
    (name, help, labels, value) in each package's metric table;
  - ``DeploymentHandle.close`` on a one-replica CPU deployment under each
    runtime in turn: the same observations, and in the port the handle's
    subscription to the process's one long-poll released.
"""

import ast
import importlib
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_runtime import port_env
from ray_tpu.models import llama as jl
from ray_tpu.train import _telemetry as jtel
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import _telemetry as ttel
from ray_tpu_torch.util import metrics as tmetrics

ROOT = Path(__file__).resolve().parent.parent
LOSS_TOL = 1e-6
MODEL_LOSS_TOL = 2e-4

# JAX-package names whose port counterpart has another name, as
# {(module path, name): (module path, port name)}, each with the reason.
RENAMES = {
    # the TPU probes: the port's node holds NVIDIA cards
    ("_private/accelerators.py", "num_tpu_chips"): ("_private/accelerators.py", "num_gpus"),
    ("_private/accelerators.py", "tpu_pod_type"): ("_private/accelerators.py", "gpu_name"),
    ("_private/accelerators.py", "visible_chip_env"):
        ("_private/accelerators.py", "visible_gpu_env"),
    # a TPU slice's name and a host's rank in it label multi-host slices;
    # the port's node labels carry the card's name, and one host's cards
    # are leased together with num_gpus=n
    ("_private/accelerators.py", "tpu_slice_name"):
        ("_private/accelerators.py", "node_resources_and_labels"),
    ("_private/accelerators.py", "tpu_worker_id"):
        ("_private/accelerators.py", "node_resources_and_labels"),
    # JAX in the name: the torch trainer, backend, learner and batches
    # (the trainer and its backend config at upstream Ray's ray.train.torch)
    ("train/_trainer.py", "JaxTrainer"): ("train/torch.py", "TorchTrainer"),
    ("train/_config.py", "JaxConfig"): ("train/torch.py", "TorchConfig"),
    ("data/dataset.py", "Dataset.iter_jax_batches"):
        ("data/dataset.py", "Dataset.iter_torch_batches"),
    ("rllib/core/learner.py", "JaxLearner"): ("rllib/core/learner.py", "TorchLearner"),
    ("rllib/core/learner.py", "JaxLearner.get_weights"):
        ("rllib/core/learner.py", "TorchLearner.get_weights"),
    ("rllib/core/learner.py", "JaxLearner.set_weights"):
        ("rllib/core/learner.py", "TorchLearner.set_weights"),
    ("rllib/core/learner.py", "JaxLearner.num_devices"):
        ("rllib/core/learner.py", "TorchLearner.num_devices"),
    ("rllib/core/learner.py", "JaxLearner.update_from_batch"):
        ("rllib/core/learner.py", "TorchLearner.update_from_batch"),
    # the plain XLA attention: the port's plain attention, same layout
    ("ops/attention.py", "xla_causal_attention"):
        ("ops/attention.py", "plain_causal_attention"),
    # flax modules return their parameter tree from init_params; a port
    # module draws its weights in its constructor from seed=, and
    # flax_params gives that tree
    ("rllib/core/rl_module.py", "ActorCriticModule.init_params"):
        ("rllib/core/rl_module.py", "flax_params"),
    ("rllib/core/rl_module.py", "QModule.init_params"):
        ("rllib/core/rl_module.py", "flax_params"),
    ("rllib/core/rl_module.py", "SquashedGaussianModule.init_params"):
        ("rllib/core/rl_module.py", "flax_params"),
    ("rllib/core/rl_module.py", "TwinQModule.init_params"):
        ("rllib/core/rl_module.py", "flax_params"),
    # pytree shardings: the port places a module's parameters by the same
    # rules when it builds a mesh rank's shard (tp in model_for_mesh, fsdp
    # through fully_shard's placement)
    ("parallel/mesh.py", "ShardingRules.tree_shardings"):
        ("parallel/train_step.py", "TrainStep.new_model"),
    ("parallel/mesh.py", "filtered_tree_specs"):
        ("parallel/mesh.py", "filter_spec_for_mesh"),
    ("parallel/mesh.py", "filtered_tree_shardings"):
        ("parallel/train_step.py", "TrainStep.new_model"),
    ("parallel/mesh.py", "shard_tree"): ("parallel/train_step.py", "TrainStep.new_model"),
    # one long-poll per process over every deployment (the port's fault 5)
    ("serve/_controller.py", "ServeController.poll_replica_names"):
        ("serve/_controller.py", "ServeController.poll_replica_sets"),
}


def _public_names(package: Path):
    """{module path: public top-level def and class names, and
    ``Class.method`` for each public method}, from the source alone."""
    out = {}
    for path in sorted(package.rglob("*.py")):
        rel = path.relative_to(package).as_posix()
        names = set()
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names.update(f"{node.name}.{m.name}" for m in node.body
                                 if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                                 and not m.name.startswith("_"))
        out[rel] = names
    return out


def _resolves(rel: str, name: str) -> bool:
    """Whether ``name`` is an attribute of the port module at ``rel``:
    defined there, imported into it, or inherited by its class."""
    module = "ray_tpu_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__")
    obj = importlib.import_module(module)
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.fixture(scope="module")
def name_diff():
    """{(module path, name)} of the JAX package with no def or class of the
    same name at the same path of the port."""
    jax_names = _public_names(ROOT / "ray_tpu")
    port_names = _public_names(ROOT / "ray_tpu_torch")
    return {(rel, n) for rel, names in jax_names.items()
            for n in names - port_names.get(rel, set())}


@pytest.mark.timeout(60)
def test_every_public_name_has_a_port_counterpart(name_diff):
    missing = sorted((rel, n) for rel, n in name_diff
                     if (rel, n) not in RENAMES and not _resolves(rel, n))
    assert not missing, f"public names of ray_tpu with no port counterpart: {missing}"


@pytest.mark.timeout(60)
def test_every_rename_is_needed_and_resolves(name_diff):
    stale = sorted(set(RENAMES) - name_diff)
    assert not stale, f"RENAMES entries the port now has under their own name: {stale}"
    broken = sorted(v for v in RENAMES.values() if not _resolves(*v))
    assert not broken, f"RENAMES targets missing from the port: {broken}"


# ------------------------------------------------------ Llama's loss and count

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def llama_pair():
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jl.init_params(JCFG, key))(jax.random.PRNGKey(5)))
    return params, tl.load_flax_params(tl.Llama(TCFG, device="cpu"), params)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kw", [{}, {"n_kv_head": 4}, {"intermediate": 200, "n_layer": 3}],
                         ids=["gqa", "mha", "mlp200"])
def test_llama_num_params_matches_jax(kw):
    params = jax.eval_shape(lambda: jl.init_params(jl.LlamaConfig.tiny(**kw)))
    model = tl.Llama(tl.LlamaConfig.tiny(**kw), device="cpu")
    assert tl.num_params(model) == jl.num_params(params) > 0


@pytest.mark.timeout(60)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_loss_fn_matches_jax_on_the_same_logits(dtype):
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((2, 16, TCFG.vocab_size))).astype(np.float32)
    targets = rng.integers(0, TCFG.vocab_size, (2, 16))
    want = float(jl.loss_fn(jnp.asarray(logits, getattr(jnp, dtype)), jnp.asarray(targets)))
    got = tl.loss_fn(torch.from_numpy(logits).to(getattr(torch, dtype)),
                     torch.from_numpy(targets)).item()
    assert abs(got - want) <= LOSS_TOL * abs(want)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("pos_offset", [0, 5])
def test_llama_loss_fn_matches_jax_on_each_models_logits(llama_pair, pos_offset):
    params, model = llama_pair
    idx = np.random.default_rng(pos_offset).integers(0, TCFG.vocab_size, (2, 17))
    x, y = idx[:, :-1], idx[:, 1:]
    want = float(jax.jit(lambda p: jl.loss_fn(jl.forward(JCFG, p, x, pos_offset), y))(params))
    with torch.no_grad():
        got = tl.loss_fn(tl.forward(TCFG, model, torch.from_numpy(x), pos_offset),
                         torch.from_numpy(y)).item()
    assert abs(got - want) <= MODEL_LOSS_TOL


# ------------------------------------------------------ publish_report_summary

@pytest.fixture
def drained(monkeypatch):
    """Both metric tables empty for the test, and put back afterwards: one
    xdist worker runs many files, and a gauge that an earlier test set
    keeps its count and the help text it was first set with, which a
    drain does not reset."""
    for m in (jmetrics, tmetrics):
        monkeypatch.setattr(m, "_records", {})


def _gauges(m, run):
    return sorted((r for r in m.drain_records() if r["labels"].get("run") == run),
                  key=lambda r: r["name"])


REPORTS = {
    "every_key": {"telemetry/goodput": 0.75, "telemetry/tokens_per_s": 12345.5,
                  "telemetry/examples_per_s": 24.25, "telemetry/mfu": 0.41,
                  "telemetry/compile_time_s": 3.5, "telemetry/step_time_s": 0.2,
                  "telemetry/hbm_bytes_in_use": 7 << 30, "telemetry/steps": 9,
                  "loss": 1.5},
    "unset_and_foreign_keys": {"telemetry/goodput": None, "telemetry/mfu": "n/a",
                               "telemetry/tokens_per_s": 10, "tokens_per_s": 99.0},
    "no_telemetry": {"loss": 2.0},
}


@pytest.mark.timeout(60)
@pytest.mark.parametrize("run_name", ["", "api-parity"])
@pytest.mark.parametrize("report", sorted(REPORTS))
def test_publish_report_summary_writes_the_jax_gauges(drained, report, run_name):
    last = {**REPORTS[report], "telemetry/step_time_s": 0.25}
    for publish in (jtel.publish_report_summary, ttel.publish_report_summary):
        publish(REPORTS[report], run_name=run_name)
        publish(last, run_name=run_name)
    got = _gauges(tmetrics, run_name)
    assert got == _gauges(jmetrics, run_name)
    assert all(r["kind"] == "gauge" and r["labels"] == {"run": run_name} for r in got)
    # gauges outlive a drain, so earlier cases' series may be there too
    values = {r["name"]: r["value"] for r in got}
    want = {n: float(last[k]) for k, n in jtel._REPORT_GAUGES.items()
            if isinstance(last.get(k), (int, float))}
    assert want and {n: values.get(n) for n in want} == want


# ------------------------------------------------------ DeploymentHandle.close

def _wait_for(cond, deadline_s: float = 20.0) -> bool:
    end = time.time() + deadline_s
    while not cond():
        if time.time() > end:
            return False
        time.sleep(0.05)
    return True


@pytest.mark.timeout(120)
@pytest.mark.parametrize("package", ["ray_tpu", "ray_tpu_torch"])
def test_handle_close_behaves_as_the_reference(package, monkeypatch):
    """A closed handle ends its long-poll (once the poll in flight answers:
    a scale-up wakes it) and starts none again; a call on it still routes,
    from the set it last saw; a new handle subscribes and serves."""
    rt = importlib.import_module(package)
    serve = importlib.import_module(package + ".serve")
    port = package == "ray_tpu_torch"
    if port:
        port_env(monkeypatch)
    # an earlier file's poll thread may still be waiting out its timeout
    before = set(threading.enumerate())

    def polls() -> int:
        return sum(t.name.startswith("serve-poll") and t not in before
                   for t in threading.enumerate())

    def holders():
        """The port's count of open handles following the deployment."""
        if not port:
            return None
        from ray_tpu_torch.serve._handle import _replica_set

        return _replica_set("close#Echo").holders

    rt.init(num_cpus=4)
    try:
        @serve.deployment
        class Echo:
            def __call__(self, x):
                return x

        h = serve.run(Echo.bind(), name="close", route_prefix=None)
        seen = [h.remote(1).result(timeout=30), polls(), holders()]
        h.close()
        seen.append(holders())
        serve.run(Echo.options(num_replicas=2).bind(), name="close", route_prefix=None)
        seen.append(_wait_for(lambda: polls() == 0))
        seen += [h.remote(2).result(timeout=30), polls(), holders()]
        fresh = serve.get_app_handle("close")
        seen += [fresh.remote(3).result(timeout=30), polls(), holders()]
        fresh.close()
        h.close()   # a second close changes nothing
        seen.append(holders())
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    want = [1, 1, 1, 0, True, 2, 0, 0, 3, 1, 1, 0]
    if not port:
        want = [None if i in (2, 3, 7, 10, 11) else v for i, v in enumerate(want)]
    assert seen == want
