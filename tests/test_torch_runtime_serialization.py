"""Serialization-layer unit tests of the port (no cluster needed).

A copy of tests/test_serialization.py run against ``ray_tpu_torch``; then
the wire format held against ``ray_tpu`` (a blob one package writes, the
other reads, for numpy arrays, nested containers and exceptions; the magic
number), and torch tensors: CUDA-free round trips of every dtype and
layout, bitwise, bf16 carried as an int16 view, and the probe that leaves
torch unimported in a process that never imported it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu._private import serialization as jser
from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef

REPO = Path(__file__).resolve().parent.parent


def roundtrip(value):
    p, bufs, refs = serialization.serialize(value)
    out, out_refs = serialization.deserialize(p, bufs)
    return out


def test_primitives():
    for v in [1, 2.5, "s", b"b", None, True, [1, 2], {"a": 1}, (1, 2), {1, 2}]:
        assert roundtrip(v) == v


def test_numpy_out_of_band():
    arr = np.random.rand(100, 100)
    p, bufs, _ = serialization.serialize(arr)
    assert len(bufs) >= 1  # buffer went out-of-band, not into the pickle
    out, _ = serialization.deserialize(p, bufs)
    assert np.array_equal(out, arr)


def test_object_ref_capture():
    ref = ObjectRef(ObjectID.from_random(), ("127.0.0.1", 1234), skip_refcount=True)
    p, bufs, refs = serialization.serialize({"nested": [ref]})
    assert refs == [ref]
    out, out_refs = serialization.deserialize(p, bufs)
    assert out["nested"][0] == ref
    assert out_refs[0] == ref
    assert out_refs[0].owner_address == ("127.0.0.1", 1234)


def test_blob_roundtrip():
    value = {"arr": np.arange(10000), "meta": "x"}
    blob = serialization.serialize_to_blob(value)
    out, _ = serialization.read_blob(memoryview(blob))
    assert np.array_equal(out["arr"], value["arr"])
    assert out["meta"] == "x"


def test_blob_buffer_alignment():
    arr = np.arange(1000, dtype=np.float64)
    p, bufs, _ = serialization.serialize(arr)
    blob = bytearray(serialization.blob_size(p, bufs))
    serialization.write_blob(memoryview(blob), p, bufs)
    out, _ = serialization.read_blob(memoryview(bytes(blob)))
    assert np.array_equal(out, arr)


def test_closure_function():
    x = 42

    def f(y):
        return x + y

    g = roundtrip(f)
    assert g(1) == 43


def test_inline_roundtrip():
    msg, refs = serialization.serialize_inline([1, np.ones(5)])
    out, _ = serialization.deserialize_inline(msg)
    assert out[0] == 1 and np.array_equal(out[1], np.ones(5))


def test_serialize_keeps_buffers_raw():
    """serialize() must hand back the protocol-5 buffers RAW — views that
    alias the source array, never bytes copies (the zero-copy put path
    depends on it)."""
    arr = np.arange(4096, dtype=np.float64)
    p, bufs, _ = serialization.serialize(arr)
    assert len(bufs) == 1
    assert not isinstance(bufs[0], (bytes, bytearray))
    alias = np.frombuffer(memoryview(bufs[0]).cast("B"), dtype=np.uint8)
    assert np.shares_memory(alias, arr.view(np.uint8))


def test_blob_zero_length_buffer():
    """Empty arrays still emit an out-of-band buffer; the blob format must
    round-trip length-0 buffers (header + 0 payload bytes)."""
    value = {"empty": np.array([], dtype=np.float64),
             "also": np.zeros((0, 3), dtype=np.int32), "x": 1}
    blob = serialization.serialize_to_blob(value)
    out, _ = serialization.read_blob(memoryview(blob))
    assert out["x"] == 1
    assert out["empty"].shape == (0,) and out["empty"].dtype == np.float64
    assert out["also"].shape == (0, 3) and out["also"].dtype == np.int32


def test_blob_alignment_mixed_dtypes():
    """Every buffer in the blob sits on a 64-byte boundary regardless of
    the (odd-sized) buffers before it, so numpy/jax can map them directly."""
    value = {
        "i8": np.arange(7, dtype=np.int8),        # 7 bytes, breaks alignment
        "f64": np.arange(5, dtype=np.float64),
        "u16": np.arange(3, dtype=np.uint16),     # 6 bytes
        "empty": np.array([], dtype=np.float32),  # 0 bytes
        "f32": np.arange(9, dtype=np.float32),
    }
    p, bufs, _ = serialization.serialize(value)
    blob = serialization.serialize_to_blob(value)
    # parse offsets by hand and check alignment of every buffer start
    import struct

    src = memoryview(blob).cast("B")
    _, plen = struct.unpack_from("<II", src, 0)
    off = 8 + plen
    (nbuf,) = struct.unpack_from("<I", src, off)
    off += 4
    assert nbuf == len(bufs)
    for _ in range(nbuf):
        (blen,) = struct.unpack_from("<Q", src, off)
        off += 8
        off = (off + 63) & ~63
        assert off % 64 == 0
        off += blen
    out, _ = serialization.read_blob(memoryview(blob))
    for k, v in value.items():
        assert np.array_equal(out[k], v), k
        assert out[k].dtype == v.dtype


def test_blob_roundtrip_multi_chunk_sized():
    """An object larger than several object_manager_chunk_size units
    round-trips byte-for-byte (the transfer path slices the blob at chunk
    boundaries; the content must be boundary-agnostic)."""
    from ray_tpu_torch._private.config import CONFIG

    chunk = CONFIG.object_manager_chunk_size
    n = 3 * chunk + 12345  # 3 full chunks + ragged tail
    rng = np.random.default_rng(7)
    value = rng.integers(0, 255, size=n, dtype=np.uint8)
    blob = serialization.serialize_to_blob(value)
    assert len(blob) > 3 * chunk
    # reassemble from chunk-sized slices like the transfer endpoints do
    reassembled = bytearray(len(blob))
    for off in range(0, len(blob), chunk):
        piece = memoryview(blob)[off:off + chunk]
        reassembled[off:off + piece.nbytes] = piece
    out, _ = serialization.read_blob(memoryview(reassembled))
    assert np.array_equal(out, value)


def test_serialize_to_blob_no_final_copy():
    """serialize_to_blob returns the exact-size bytearray it wrote into —
    no trailing bytes() copy of the whole object."""
    value = np.arange(10000)
    blob = serialization.serialize_to_blob(value)
    assert isinstance(blob, bytearray)
    assert len(blob) == serialization.blob_size(
        *serialization.serialize(value)[:2])


def test_read_blob_buffer_wrapper():
    """read_blob's buffer_wrapper sees every out-of-band buffer (and only
    those) — the worker relies on it to pin plasma memory."""
    wrapped = []

    def wrapper(mv):
        wrapped.append(mv.nbytes)
        return mv

    value = {"a": np.arange(100, dtype=np.float64), "b": "no-buffer"}
    blob = serialization.serialize_to_blob(value)
    out, _ = serialization.read_blob(memoryview(blob), buffer_wrapper=wrapper)
    assert np.array_equal(out["a"], value["a"]) and out["b"] == "no-buffer"
    assert wrapped == [800]

    # no out-of-band buffers -> wrapper never called
    wrapped.clear()
    blob = serialization.serialize_to_blob({"just": "strings"})
    out, _ = serialization.read_blob(memoryview(blob), buffer_wrapper=wrapper)
    assert wrapped == []


# ----------------------------------------------------- wire format vs ray_tpu


def _cross_values():
    rng = np.random.default_rng(0)
    return {
        "array": rng.standard_normal((64, 33)),
        "int_array": np.arange(1000, dtype=np.int32).reshape(10, 100),
        "empty": np.zeros((0, 3), dtype=np.float16),
        "nested": {"a": [1, 2.5, "s", b"b", None], "t": (True, {3, 4}),
                   "arrays": [np.ones(7, np.uint8), rng.random(300)]},
        "error": ValueError("boom", 3),
        "key_error": KeyError("k"),
    }


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, BaseException):
        return type(a) is type(b) and a.args == b.args
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("name", sorted(_cross_values()))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_blob_written_by_one_package_reads_in_the_other(name, direction):
    value = _cross_values()[name]
    write, read = (jser, serialization) if direction == "jax_to_port" else (
        serialization, jser)
    blob = write.serialize_to_blob(value)
    out, refs = read.read_blob(memoryview(bytes(blob)))
    assert refs == [] and _equal(value, out)
    # the inline (RPC) form too
    msg, _ = write.serialize_inline(value)
    out, _ = read.deserialize_inline(msg)
    assert _equal(value, out)


def test_blobs_are_byte_equal_and_the_magic_unchanged():
    assert serialization._MAGIC == jser._MAGIC == 0x52545055
    assert serialization._ALIGN == jser._ALIGN == 64
    for name, value in _cross_values().items():
        if isinstance(value, BaseException):
            continue            # pickled by reference to the same class
        assert bytes(serialization.serialize_to_blob(value)) == bytes(
            jser.serialize_to_blob(value)), name


# ------------------------------------------------------------ torch tensors

_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    return t.contiguous().view(_WIDTH[t.element_size()])


def _tensor_cases():
    gen = torch.Generator().manual_seed(0)
    base = torch.randn(6, 10, generator=gen)
    return {
        "float32": base,
        "bfloat16": base.to(torch.bfloat16),
        "float16": base.to(torch.float16),
        "float64": base.double(),
        "int64": torch.randint(-2**62, 2**62, (6, 10), generator=gen),
        "int8": torch.randint(-128, 127, (6, 10), generator=gen, dtype=torch.int8),
        "bool": base > 0,
        "float32_transposed": base.t(),
        "bfloat16_sliced": base.to(torch.bfloat16)[::2, 1::3],
        "int64_expanded": torch.arange(5).expand(4, 5),
        "scalar": torch.tensor(3.5, dtype=torch.bfloat16),
        "empty": torch.zeros(0, 4, dtype=torch.bfloat16),
        "float8": base.to(torch.float8_e4m3fn),
    }


@pytest.mark.parametrize("name", sorted(_tensor_cases()))
def test_tensor_roundtrip_bitwise(name):
    t = _tensor_cases()[name]
    out = serialization.read_blob(
        memoryview(bytes(serialization.serialize_to_blob(t))))[0]
    assert out.dtype == t.dtype and out.shape == t.shape
    assert out.device.type == "cpu" and out.is_contiguous()
    assert torch.equal(_bits(out), _bits(t))
    msg, _ = serialization.serialize_inline(t)
    out = serialization.deserialize_inline(msg)[0]
    assert out.dtype == t.dtype and torch.equal(_bits(out), _bits(t))


def test_tensor_buffers_go_out_of_band():
    """A tensor's bytes leave the pickle as one raw protocol-5 buffer (bf16
    as its int16 view), as a numpy array's do."""
    t = torch.randn(256, 256).to(torch.bfloat16)
    p, bufs, _ = serialization.serialize(t)
    assert len(bufs) == 1 and memoryview(bufs[0]).nbytes == t.numel() * 2
    assert len(p) < 512
    alias = np.frombuffer(memoryview(bufs[0]).cast("B"), dtype=np.int16)
    assert np.array_equal(alias, t.view(torch.int16).numpy().ravel())


def test_nested_tensors_parameters_and_grad_flags():
    p = torch.nn.Parameter(torch.randn(3, 4))
    g = torch.randn(2, requires_grad=True)
    value = {"state": {"w": p, "b": torch.zeros(4, dtype=torch.bfloat16)},
             "list": [g, torch.arange(3)], "n": 1}
    out = serialization.read_blob(
        memoryview(bytes(serialization.serialize_to_blob(value))))[0]
    assert isinstance(out["state"]["w"], torch.nn.Parameter)
    assert torch.equal(out["state"]["w"], p) and out["state"]["w"].requires_grad
    assert out["list"][0].requires_grad and out["list"][0].is_leaf
    assert torch.equal(out["list"][0], g) and out["n"] == 1
    assert out["state"]["b"].dtype == torch.bfloat16


def test_rebuilt_tensor_owns_its_memory():
    t = torch.arange(1000, dtype=torch.float32)
    blob = serialization.serialize_to_blob(t)
    out = serialization.read_blob(memoryview(blob))[0]
    out.add_(1)
    again = serialization.read_blob(memoryview(blob))[0]
    assert torch.equal(again, t)


def test_to_host_leaves_cpu_values_alone():
    t = torch.ones(3)
    assert serialization._to_host(t) is t
    arr = np.ones(3)
    assert serialization._to_host(arr) is arr


def test_serialize_does_not_import_torch_in_a_process_without_it():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from ray_tpu_torch._private import serialization as s\n"
        "blob = s.serialize_to_blob({'a': np.arange(10), 'b': [1, 'x']})\n"
        "out = s.read_blob(memoryview(blob))[0]\n"
        "assert out['b'] == [1, 'x']\n"
        "print('torch' in sys.modules)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"
