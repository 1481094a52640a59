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
from pathlib import Path

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
    with pytest.raises(exc):
        tattn._check_kernel_inputs(q, k, v)


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
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(ray_tpu_torch.__path__, 'ray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
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
