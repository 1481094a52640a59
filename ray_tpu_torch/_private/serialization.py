"""Serialization of task args/returns and stored objects.

Mirrors the reference's SerializationContext
(reference: python/ray/_private/serialization.py): cloudpickle for arbitrary
Python, pickle protocol-5 out-of-band buffers for zero-copy numpy/arrow, and
interception of ObjectRefs nested inside values so the runtime can track
borrowed references and resolve dependencies.

Wire format (RPC-inline): {"p": pickle_bytes, "b": [buffer_bytes...], "r": [ref_info...]}
Store format (plasma): a single contiguous byte string:
    [u32 magic][u32 pickle_len][pickle][u32 nbuf]([u64 buf_len][pad to 64][buf])*
Buffers are 64-byte aligned inside the blob so numpy can map them directly.

Torch tensors travel as numpy arrays (CUDA tensors via the host) and come
back as CPU tensors with their dtype, bf16 included.

Copy discipline: `serialize()` returns the protocol-5 out-of-band buffers RAW
(pickle.PickleBuffer views aliasing the caller's arrays). Store-bound paths
must keep them raw and stream them with `write_blob` straight into the mapped
destination — one copy total. Only `inline_payload()` materializes buffer
bytes, and only because msgpack frames require real `bytes`.
"""

from __future__ import annotations

import io
import pickle
import struct
from typing import Any, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef

_MAGIC = 0x52545055  # 'RTPU'
_ALIGN = 64


def _torch():
    """torch if this process imported it, else None. Probes sys.modules
    instead of importing: if torch was never imported here the value cannot
    be a tensor, and a cold `import torch` costs seconds — a nasty surprise
    on a first put() in a process that never touched torch."""
    import sys

    torch = sys.modules.get("torch")
    # getattr guard: another thread may be mid-`import torch`, in which case
    # sys.modules already holds a partially initialized module
    return torch if getattr(torch, "Tensor", None) is not None else None


def _to_host(value):
    """Move a CUDA tensor to host memory as a CPU tensor (device memory
    can't be pickled) — the port's counterpart of the JAX runtime's
    jax.Array -> numpy. Nested tensors are moved by the pickler
    (``_Pickler.reducer_override``)."""
    torch = _torch()
    if torch is not None and isinstance(value, torch.Tensor) and value.is_cuda:
        return value.detach().cpu()
    return value


# Element types numpy has no dtype for travel as a same-width integer view
# (bf16 as int16, the fp8 types as int8) and get their dtype back on load.
_INT_OF_WIDTH = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def _reduce_tensor(torch, t):
    """A dense tensor as (numpy array, dtype name, requires_grad, is
    Parameter). The array is C-contiguous, so protocol 5 hands its bytes
    out of band: a large tensor rides the 64-byte-aligned buffer path into
    plasma like a numpy array does, not torch's in-band storage pickling."""
    host = t.detach()
    if host.is_cuda:
        host = host.cpu()
    host = host.contiguous()
    dtype = str(host.dtype).split(".")[-1]
    try:
        arr = host.numpy()
    except TypeError:
        width = _INT_OF_WIDTH[host.element_size()]
        arr = host.view(getattr(torch, width)).numpy()
    return _rebuild_tensor, (arr, dtype, t.requires_grad,
                             isinstance(t, torch.nn.Parameter))


def _rebuild_tensor(arr, dtype, requires_grad, is_param):
    import warnings

    import torch

    # The buffer aliases the shared store (plasma) or an RPC frame; torch
    # tensors are mutated in place freely, so the tensor owns a copy: an
    # in-place op on it must not change the stored object for other readers.
    # torch's copy runs on all its threads (numpy's on one). A read-only
    # frame makes from_numpy warn; the view is only read, by the clone.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr).clone()
    want = getattr(torch, dtype)
    if t.dtype != want:
        t = t.view(want)
    if is_param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


class _Pickler(cloudpickle.CloudPickler):
    """CloudPickler that collects out-of-band buffers and nested ObjectRefs,
    and sends dense torch tensors (CUDA ones via the host) as numpy."""

    def __init__(self, file, buffers: list, refs: list):
        super().__init__(file, protocol=5, buffer_callback=buffers.append)
        self._refs = refs

    def persistent_id(self, obj):
        if isinstance(obj, ObjectRef):
            self._refs.append(obj)
            return ("rtpu_ref", obj.object_id().binary(), obj.owner_address)
        return None

    def reducer_override(self, obj):
        torch = _torch()
        if (torch is not None and isinstance(obj, torch.Tensor)
                and obj.layout == torch.strided and not obj.is_quantized
                and type(obj) in (torch.Tensor, torch.nn.Parameter)):
            return _reduce_tensor(torch, obj)
        return super().reducer_override(obj)


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, buffers, refs_out: list):
        super().__init__(file, buffers=buffers)
        self._refs_out = refs_out

    def persistent_load(self, pid):
        tag, id_bytes, owner = pid
        if tag != "rtpu_ref":
            raise pickle.UnpicklingError(f"unknown persistent id {tag}")
        ref = ObjectRef(ObjectID(id_bytes), owner)
        self._refs_out.append(ref)
        return ref


_PLAIN = (bytes, bytearray, str, int, float, bool, type(None))


def _fast_safe(value, depth: int = 3) -> bool:
    """True if value is a composition of plain types the C pickler handles
    identically to cloudpickle (no functions/classes/refs — those need
    by-value pickling or persistent ids). Exact type checks: subclasses may
    carry custom __reduce__."""
    t = type(value)
    if t in _PLAIN:
        return True
    if t.__module__ == "numpy":
        import numpy as np

        if t is np.ndarray:
            # hasobject also catches object fields nested in structured
            # dtypes, which plain `dtype != object` misses
            return not value.dtype.hasobject
        return isinstance(value, np.generic)  # numpy scalar
    if depth:
        if t in (list, tuple, set):
            return all(_fast_safe(v, depth - 1) for v in value)
        if t is dict:
            return all(
                type(k) in _PLAIN and _fast_safe(v, depth - 1)
                for k, v in value.items()
            )
    return False


def serialize(value: Any) -> Tuple[bytes, List, List[ObjectRef]]:
    """Returns (pickle_bytes, buffers, contained_refs)."""
    value = _to_host(value)
    buffers: List = []
    if _fast_safe(value):
        # C pickler: ~20x faster than the pure-Python CloudPickler for the
        # small control-plane payloads that dominate task/actor-call rates;
        # protocol-5 buffer_callback still gives zero-copy numpy.
        return (
            pickle.dumps(value, protocol=5, buffer_callback=buffers.append),
            buffers,
            [],
        )
    refs: List[ObjectRef] = []
    f = io.BytesIO()
    _Pickler(f, buffers, refs).dump(value)
    return f.getvalue(), buffers, refs


def deserialize(
    pickle_bytes: bytes, buffers: Optional[List] = None
) -> Tuple[Any, List[ObjectRef]]:
    """Returns (value, contained_refs)."""
    refs: List[ObjectRef] = []
    f = io.BytesIO(pickle_bytes)
    value = _Unpickler(f, buffers or [], refs).load()
    return value, refs


# ---------------------------------------------------------------------------
# Inline (RPC) representation
# ---------------------------------------------------------------------------


def buffers_nbytes(buffers: List) -> int:
    """Total payload bytes across raw out-of-band buffers (no copies)."""
    return sum(memoryview(b).nbytes for b in buffers)


def inline_payload(p: bytes, bufs: List) -> dict:
    """Materialize raw buffers into the msgpack-safe inline dict. This is
    the ONLY place out-of-band buffers become `bytes`; plasma-bound values
    must bypass it and ride write_blob instead."""
    return {"p": p, "b": [bytes(b) for b in bufs]}


def serialize_inline(value: Any):
    p, bufs, refs = serialize(value)
    return inline_payload(p, bufs), refs


def deserialize_inline(msg) -> Tuple[Any, List[ObjectRef]]:
    return deserialize(msg["p"], [memoryview(b) for b in msg["b"]])


# ---------------------------------------------------------------------------
# Contiguous blob representation (for the shared-memory store)
# ---------------------------------------------------------------------------

_HDR = struct.Struct("<II")
_BUFHDR = struct.Struct("<Q")


def _aligned(off: int) -> int:
    return (off + _ALIGN - 1) & ~(_ALIGN - 1)


def blob_size(pickle_bytes: bytes, buffers: List) -> int:
    size = _HDR.size + len(pickle_bytes) + 4
    for b in buffers:
        size += _BUFHDR.size
        size = _aligned(size)
        size += memoryview(b).nbytes
    return size


def write_blob(dest: memoryview, pickle_bytes: bytes, buffers: List) -> int:
    """Write the store format into dest; returns bytes written."""
    off = 0
    _HDR.pack_into(dest, off, _MAGIC, len(pickle_bytes))
    off += _HDR.size
    dest[off : off + len(pickle_bytes)] = pickle_bytes
    off += len(pickle_bytes)
    struct.pack_into("<I", dest, off, len(buffers))
    off += 4
    for b in buffers:
        mv = memoryview(b)
        # cast("B") rejects empty views ("zeros in shape"); a 0-byte buffer
        # is just its header
        nbytes = mv.nbytes
        _BUFHDR.pack_into(dest, off, nbytes)
        off += _BUFHDR.size
        off = _aligned(off)
        if nbytes:
            dest[off : off + nbytes] = mv.cast("B")
            off += nbytes
    return off


def serialize_to_blob(value: Any) -> bytearray:
    """Store-format blob as a bytearray sized exactly to content — callers
    (spill files, socket channels) write it out directly; no bytes() copy."""
    p, bufs, _refs = serialize(value)
    out = bytearray(blob_size(p, bufs))
    n = write_blob(memoryview(out), p, bufs)
    assert n == len(out), f"blob_size mismatch: wrote {n} of {len(out)}"
    return out


def read_blob(
    src: memoryview, buffer_wrapper=None
) -> Tuple[Any, List[ObjectRef]]:
    """Deserialize the store format; buffers alias src (zero-copy).

    ``buffer_wrapper(mv)``, when given, wraps each out-of-band buffer view
    before it reaches the unpickler — the worker uses it to tie plasma pins
    to buffer lifetime (worker._pinned_buffer). It is not called when the
    blob has no out-of-band buffers, so callers can release src immediately
    if nothing was wrapped.
    """
    src = memoryview(src).cast("B")
    off = 0
    magic, plen = _HDR.unpack_from(src, off)
    if magic != _MAGIC:
        raise ValueError("corrupt object blob")
    off += _HDR.size
    pickle_bytes = bytes(src[off : off + plen])
    off += plen
    (nbuf,) = struct.unpack_from("<I", src, off)
    off += 4
    buffers = []
    for _ in range(nbuf):
        (blen,) = _BUFHDR.unpack_from(src, off)
        off += _BUFHDR.size
        off = _aligned(off)
        mv = src[off : off + blen]
        buffers.append(mv if buffer_wrapper is None else buffer_wrapper(mv))
        off += blen
    return deserialize(pickle_bytes, buffers)
