"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention, on the CPU.

The port's CPU path is the plain PyTorch version of the hand-written CUDA
kernel; it is held here against the JAX package's Pallas kernel in
interpret mode (o and lse) and its XLA path, on the same seeded numpy
inputs, fp32, to 1e-5 (summation order only). The kernel itself runs on the
card only and is held against this plain version by ``chip_smoke.py``.
Also here: the port imports nothing of JAX or of the JAX package (checked
in a fresh interpreter, since this process already imported JAX), and the
build step's failure modes.
"""

import ast
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import _cuda
from ray_tpu_torch.ops import attention as tattn

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,block_q,block_k", [
    ((1, 2, 128, 32), 64, 32),
    ((1, 2, 64, 64), None, None),
])
def test_flash_fwd_matches_pallas_interpret(shape, block_q, block_k):
    q, k, v = _qkv(shape)
    b, h, t, d = shape
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o_ref = np.asarray(jattn.flash_causal_attention(
        jq, jk, jv, block_q=block_q, block_k=block_k, interpret=True))
    bq = block_q or jattn._pick_block(t)
    bk = block_k or jattn._pick_block(t)
    _, lse_ref = jattn._flash_fwd(
        jq.reshape(b * h, t, d), jk.reshape(b * h, t, d),
        jv.reshape(b * h, t, d), block_q=bq, block_k=bk, interpret=True)

    o, lse = tattn.flash_causal_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)))
    assert o.shape == shape and o.dtype == torch.float32
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref).reshape(b, h, t),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        tattn.flash_causal_attention(*(torch.from_numpy(x) for x in (q, k, v))).numpy(),
        o_ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [1, 7, 33, 64])
def test_causal_attention_btHd_matches_jax(t):
    shape = (2, t, 3, 32)                          # (B, T, H, D)
    q, k, v = _qkv(shape, seed=t)
    ref = np.asarray(jattn.causal_attention(*(jnp.asarray(x) for x in (q, k, v))))
    got = tattn.causal_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [1, 7, 50])
def test_plain_causal_attention_matches_xla(t):
    shape = (1, 2, t, 64)                          # (B, H, T, D)
    q, k, v = _qkv(shape, seed=100 + t)
    ref = np.asarray(jattn.xla_causal_attention(*(jnp.asarray(x) for x in (q, k, v))))
    got = tattn.plain_causal_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)


def test_cpu_tensors_never_count_as_launches():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 2, 16, 32)))
    before = tattn.FLASH_FWD_LAUNCHES
    tattn.flash_causal_attention_fwd(q, k, v)
    tattn.flash_causal_attention(q, k, v)
    tattn.causal_attention(q, k, v)
    assert tattn.FLASH_FWD_LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no causal attention"):
        tattn.flash_causal_attention_fwd(q, q, q)


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError),
    ("head_dim_48", ValueError),
    ("not_contiguous", ValueError),
    ("shape_mismatch", ValueError),
    ("rank_3", ValueError),
    ("misaligned", ValueError),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    q = torch.zeros((1, 2, 8, 64))
    k = v = q
    if case == "float16":
        q = k = v = q.half()
    elif case == "head_dim_48":
        q = k = v = torch.zeros((1, 2, 8, 48))
    elif case == "not_contiguous":
        q = torch.zeros((1, 8, 2, 64)).transpose(1, 2)
    elif case == "shape_mismatch":
        k = torch.zeros((1, 2, 9, 64))
    elif case == "rank_3":
        q = k = v = torch.zeros((2, 8, 64))
    elif case == "misaligned":   # contiguous, 4 bytes past a 16-byte boundary
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(exc):
        tattn._check_kernel_inputs(q, k, v)


# ---------------------------------------------------------- head dims


@pytest.mark.parametrize("d,size", [
    (1, 32), (16, 32), (32, 32), (33, 64), (48, 64), (64, 64), (80, 128),
    (96, 128), (128, 128), (129, None),
])
def test_kernel_head_dim_pads_to_the_next_kernel_size(d, size):
    """The kernels are built for head dims 32, 64 and 128; every other head
    dim up to 128 runs at the next of those, and above 128 nothing does."""
    if size is None:
        with pytest.raises(ValueError, match="up to 128"):
            tattn.kernel_head_dim(d)
    else:
        assert tattn.kernel_head_dim(d) == size


def _kernels_on_the_cpu(monkeypatch):
    """Dispatch as on the card, with each kernel wrapper replaced by its
    plain version on the CPU; returns the head dims the wrappers saw."""
    seen = []
    monkeypatch.setattr(tattn, "_device_of", lambda q: "cuda")
    monkeypatch.setattr(tattn, "_kernel_fwd", lambda q, k, v: (
        seen.append(("fwd", q.shape[-1])), tattn.plain_causal_attention_fwd(q, k, v))[1])
    monkeypatch.setattr(tattn, "_kernel_bwd", lambda q, k, v, o, lse, do: (
        seen.append(("bwd", q.shape[-1])),
        tattn.plain_causal_attention_bwd(q, k, v, o, lse, do))[1])
    return seen


@pytest.mark.parametrize("d", [16, 48, 80])
def test_padded_head_dims_take_the_kernels_with_jax_values(monkeypatch, d):
    """On the card a head dim the kernels are not built for is zero-padded
    to the next kernel size, q scaled by sqrt(d_pad / d) and dq by the same
    factor: the forward and all three gradients equal the JAX function's,
    with no plain call. Checked with the kernels' plain versions standing
    in for the kernels, on the padded tensors the kernels would get."""
    seen = _kernels_on_the_cpu(monkeypatch)
    q, k, v = _qkv((2, 9, 3, d), seed=d)
    w = np.random.default_rng(d + 1).standard_normal(q.shape).astype(np.float32)
    plain_calls = tattn.PLAIN_ATTENTION_CALLS
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.causal_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(w))

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    ref = np.asarray(jattn.causal_attention(jq, jk, jv))
    jgrads = jax.grad(lambda *a: jnp.sum(jattn.causal_attention(*a) * w),
                      argnums=(0, 1, 2))(jq, jk, jv)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=0)
    for name, g, r in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.shape == q.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0,
                                   err_msg=name)
    size = tattn.kernel_head_dim(d)
    assert seen == [("fwd", size), ("bwd", size)]
    assert tattn.PLAIN_ATTENTION_CALLS == plain_calls


@pytest.mark.parametrize("d,dtype,exc", [
    (160, torch.float32, ValueError), (64, torch.float16, TypeError),
    (48, torch.float64, TypeError),
])
def test_the_card_raises_on_what_the_kernels_cannot_take(monkeypatch, d, dtype, exc):
    """No silent fallback: a head dim above 128 or a type other than fp32
    or bf16 raises on the card before any launch."""
    monkeypatch.setattr(tattn, "_device_of", lambda q: "cuda")
    monkeypatch.setattr(tattn, "_kernel", lambda: pytest.fail("built a kernel"))
    q = torch.zeros((1, 2, 8, d), dtype=dtype)
    launches = tattn.FLASH_FWD_LAUNCHES
    with pytest.raises(exc):
        tattn.flash_causal_attention_fwd(q, q, q)
    assert tattn.FLASH_FWD_LAUNCHES == launches


@pytest.mark.parametrize("d", [16, 48])
def test_the_einsum_path_equals_jax_and_counts_only_on_the_card(monkeypatch, d):
    """``use_flash_attention`` off takes einsum_causal_attention, the
    counterpart of xla_causal_attention; on the CPU, as every CPU call,
    it counts neither as a launch nor as a plain call on the card."""
    calls = []
    plain = tattn.plain_causal_attention
    monkeypatch.setattr(tattn, "plain_causal_attention",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    q, k, v = _qkv((2, 9, 3, d), seed=d)
    counters = (tattn.FLASH_FWD_LAUNCHES, tattn.PLAIN_ATTENTION_CALLS)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.einsum_causal_attention(*leaves)
    out.sum().backward()
    ref = np.asarray(jattn.causal_attention(*(jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL, rtol=0)
    assert calls == [(2, 3, 9, d)] and all(x.grad is not None for x in leaves)
    assert (tattn.FLASH_FWD_LAUNCHES, tattn.PLAIN_ATTENTION_CALLS) == counters
    assert tattn.attention_for(types.SimpleNamespace(use_flash_attention=False)) \
        is tattn.einsum_causal_attention
    assert tattn.attention_for(types.SimpleNamespace(use_flash_attention=True)) \
        is tattn.causal_attention


def test_large_batch_heads_are_launched_in_aligned_chunks():
    """B * H above the grid's 65535 is launched in chunks of at most 65535
    (b, h) slices; every chunk of fp32 lse rows starts 16-byte aligned."""
    assert tattn._chunks(12) == [(0, 12)]
    assert tattn._chunks(65544) == [(0, 65532), (65532, 12)]
    assert tattn._chunks(3 * 65532) == [(i * 65532, 65532) for i in range(3)]
    assert all(n <= 65535 for _, n in tattn._chunks(200_001))
    for t in (1, 7, 16):
        lse = torch.zeros((65544, 1, t))
        part = tattn._slices(lse, 65532, 12)
        assert part.shape == (12, t) and part.data_ptr() % 16 == 0
        assert part.data_ptr() - lse.data_ptr() == 65532 * t * 4
    q = torch.zeros((5462, 12, 1, 32))        # B * H = 65544 > 65535
    tattn._check_kernel_inputs(q, q, q)       # the kernels take it, chunked


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build(["flash_attn_fwd"])


def test_failed_compile_raises_with_nvcc_output(monkeypatch, tmp_path):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "broken.cu").write_text("this is not C++\n")
    fake_nvcc = tmp_path / "nvcc"
    fake_nvcc.write_text("#!/bin/sh\necho 'broken.cu(1): error: expected a declaration'\nexit 2\n")
    fake_nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda, "CSRC", src_dir)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: str(fake_nvcc))
    with pytest.raises(RuntimeError, match="expected a declaration"):
        _cuda.build()
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-built


def test_build_is_keyed_by_source_hash(monkeypatch, tmp_path):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    src = src_dir / "k.cu"
    monkeypatch.setattr(_cuda, "CSRC", src_dir)
    src.write_text("// one\n")
    first = _cuda._library_path(src)
    src.write_text("// two\n")
    second = _cuda._library_path(src)
    assert second != first and second.name.startswith("k-")
    (src_dir / "common.cuh").write_text("// header\n")
    assert _cuda._library_path(src) != second      # headers count too


# ---------------------------------------------------------------- isolation

_BANNED = ("jax", "jaxlib", "flax", "ray_tpu")


def test_port_imports_nothing_of_jax_in_a_fresh_interpreter():
    """Every module of the port (the runtime's too: the GCS, the raylet,
    the workers, the dashboard agent; the trainer, Tune and placement
    groups; the data package; RLlib; the Cluster and the rest of util; the
    compiled graphs, their channels and workflows; the head, job submission,
    the autoscaler, the CLI, the perf gate and the lint) imports without JAX and without side
    effects: no thread, no child process, no signal handler."""
    code = (
        "import importlib, multiprocessing, pkgutil, signal, sys, threading\n"
        "import ray_tpu_torch, chip_smoke\n"
        "handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}\n"
        "names = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'ray_tpu_torch.api', 'ray_tpu_torch._private.raylet.main',\n"
        "        'ray_tpu_torch._private.gcs.server', 'ray_tpu_torch._private.worker',\n"
        "        'ray_tpu_torch._private.workers.fork_server',\n"
        "        'ray_tpu_torch._native.plasma', 'ray_tpu_torch.dashboard.agent',\n"
        "        'ray_tpu_torch.train.torch', 'ray_tpu_torch.train._trainer',\n"
        "        'ray_tpu_torch.train._worker_group', 'ray_tpu_torch.tune.controller',\n"
        "        'ray_tpu_torch.tune.tuner', 'ray_tpu_torch.util.placement_group',\n"
        "        'ray_tpu_torch.data', 'ray_tpu_torch.data.block',\n"
        "        'ray_tpu_torch.data.backpressure', 'ray_tpu_torch.data._streaming',\n"
        "        'ray_tpu_torch.data._exchange', 'ray_tpu_torch.data.dataset',\n"
        "        'ray_tpu_torch.data.preprocessors', 'ray_tpu_torch.rllib',\n"
        "        'ray_tpu_torch.rllib.env._classic_control', 'ray_tpu_torch.rllib.env.env_runner',\n"
        "        'ray_tpu_torch.rllib.env.multi_agent', 'ray_tpu_torch.rllib.core._numpy_policy',\n"
        "        'ray_tpu_torch.rllib.core.rl_module', 'ray_tpu_torch.rllib.core.learner',\n"
        "        'ray_tpu_torch.rllib.core.impala_learner', 'ray_tpu_torch.rllib.core.appo_learner',\n"
        "        'ray_tpu_torch.rllib.algorithms.ppo', 'ray_tpu_torch.rllib.algorithms.impala',\n"
        "        'ray_tpu_torch.rllib.algorithms.appo', 'ray_tpu_torch.rllib.algorithms.dqn',\n"
        "        'ray_tpu_torch.rllib.algorithms.sac', 'ray_tpu_torch.rllib.algorithms.multi_agent_ppo',\n"
        "        'ray_tpu_torch.rllib.algorithms.bc', 'ray_tpu_torch.rllib.offline',\n"
        "        'ray_tpu_torch.cluster_utils', 'ray_tpu_torch.util.broadcast',\n"
        "        'ray_tpu_torch.util.state', 'ray_tpu_torch.util.actor_pool',\n"
        "        'ray_tpu_torch.util.queue', 'ray_tpu_torch.util.multiprocessing',\n"
        "        'ray_tpu_torch.util.collective', 'ray_tpu_torch.util.check_serialize',\n"
        "        'ray_tpu_torch.util.client', 'ray_tpu_torch.util.client.common',\n"
        "        'ray_tpu_torch.util.client.server', 'ray_tpu_torch.util.loadgen',\n"
        "        'ray_tpu_torch.dag', 'ray_tpu_torch.dag.node', 'ray_tpu_torch.dag.compiled',\n"
        "        'ray_tpu_torch.experimental', 'ray_tpu_torch.experimental.channel',\n"
        "        'ray_tpu_torch.workflow', 'ray_tpu_torch.workflow.virtual_actor',\n"
        "        'ray_tpu_torch.scripts', 'ray_tpu_torch._version',\n"
        "        'ray_tpu_torch.dashboard.head', 'ray_tpu_torch.dashboard.grafana',\n"
        "        'ray_tpu_torch.job_submission', 'ray_tpu_torch.job_submission._manager',\n"
        "        'ray_tpu_torch.autoscaler', 'ray_tpu_torch.autoscaler.autoscaler',\n"
        "        'ray_tpu_torch.autoscaler.scheduler', 'ray_tpu_torch.autoscaler.node_provider',\n"
        "        'ray_tpu_torch.autoscaler.launcher', 'ray_tpu_torch.autoscaler.gcp_tpu',\n"
        "        'ray_tpu_torch._private.perf_gate', 'ray_tpu_torch._private.microbench',\n"
        "        'ray_tpu_torch._private.lint', 'ray_tpu_torch._private.lint.core',\n"
        "        'ray_tpu_torch._private.lint.contracts', 'ray_tpu_torch._private.lint.blocking',\n"
        "        'ray_tpu_torch._private.lint.shard_safety'} <= set(names)\n"
        "ray_tpu_torch.tune, ray_tpu_torch.cluster_utils, ray_tpu_torch.util.ActorPool\n"
        "ray_tpu_torch.dag, ray_tpu_torch.workflow, ray_tpu_torch.experimental\n"
        "ray_tpu_torch.autoscaler, ray_tpu_torch.job_submission\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not multiprocessing.active_children()\n"
        "assert handlers == {s: signal.getsignal(s) for s in handlers}\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_BANNED!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_nothing_of_jax():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] in _BANNED]
    assert len(files) > 10 and not offenders, offenders
