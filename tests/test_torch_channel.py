"""The port's compiled-DAG channels (``ray_tpu_torch.experimental.channel``)
against the JAX package's (``ray_tpu.experimental.channel``).

Most tests build the shared-memory ``Channel`` over a process-local buffer
(a ``bytearray`` holding the header and the body, as a plasma object
would), so they need no runtime and run each case under both packages:
- the same writes leave the two buffers byte for byte equal (the header
  ``"<QQII" + "Q" * 8``, its flags, the serialized body) and the readers
  get equal values;
- a write blocks until every reader acked the last value, and raises
  ``TimeoutError`` at its timeout (one and three readers);
- ``close`` on either side turns the other's blocked call into
  ``ChannelClosed``; an error written with ``is_error`` reaches the reader
  as ``_PropagatedError`` around the same exception; a value over the
  buffer raises ``ChannelFull`` and leaves the channel usable.
``SocketChannel`` (the edge between nodes) gets the same cases over
localhost. The port alone: CPU torch tensors in fp32 and bf16 round-trip
bitwise (as CPU tensors of the same dtype) through both kinds; and, on
the port's runtime, a channel in plasma written by the driver and read by
an actor process, whose object is gone from the store after ``destroy``.
Tolerance: none; every comparison is exact.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu.experimental.channel as jchannel
import ray_tpu_torch.experimental.channel as tchannel

from _torch_runtime import port_env

PACKAGES = [pytest.param(jchannel, id="jax"), pytest.param(tchannel, id="port")]


def local_channel(mod, n_readers: int, size: int = 1 << 16):
    """A channel of ``mod`` over a process-local buffer: the buffer, the
    writer end and ``n_readers`` reader ends."""
    buf = bytearray(mod._HEADER.size + size)
    view = memoryview(buf)
    view[:mod._HEADER.size] = mod._HEADER.pack(0, 0, 0, n_readers,
                                               *([0] * mod.MAX_READERS))
    oid = b"c" * 20
    writer = mod.Channel(oid, view, None, n_readers)
    readers = [mod.Channel(oid, view, r, n_readers) for r in range(n_readers)]
    return buf, writer, readers


def socket_channel(mod, n_readers: int):
    writer = mod.SocketChannel.create(n_readers)
    readers = [mod.SocketChannel.attach(writer.descriptor(), r) for r in range(n_readers)]
    return writer, readers


def values(seed: int):
    rng = np.random.default_rng(seed)
    return [7, "seven", {"a": [1, 2.5]},
            rng.normal(size=(33, 5)).astype(np.float32),
            rng.integers(0, 50257, (4, 512)).astype(np.int64)]


def assert_same(got, want):
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert got == want


def test_header_layout_and_bytes_match_jax():
    assert tchannel._HEADER.format == jchannel._HEADER.format == "<QQII" + "Q" * 8
    assert (tchannel.MAX_READERS, tchannel._FLAG_ERROR, tchannel._FLAG_CLOSED,
            tchannel.DEFAULT_BUFFER_SIZE) == (jchannel.MAX_READERS, jchannel._FLAG_ERROR,
                                              jchannel._FLAG_CLOSED,
                                              jchannel.DEFAULT_BUFFER_SIZE)
    jbuf, jw, jrs = local_channel(jchannel, 2)
    tbuf, tw, trs = local_channel(tchannel, 2)
    for v in values(0):
        jw.write(v, timeout=5)
        tw.write(v, timeout=5)
        assert bytes(tbuf) == bytes(jbuf)
        for jr, tr in zip(jrs, trs):
            got, want = tr.read(timeout=5), jr.read(timeout=5)
            assert_same(got, want)
            assert_same(got, v)
        assert bytes(tbuf) == bytes(jbuf)  # the acks, in their slots
    jw.write(ValueError("boom"), is_error=True)
    tw.write(ValueError("boom"), is_error=True)
    assert bytes(tbuf[:tchannel._HEADER.size]) == bytes(jbuf[:jchannel._HEADER.size])
    seq, size, flags, n = tchannel._HEADER.unpack_from(tbuf, 0)[:4]
    assert (seq, flags, n) == (len(values(0)) + 1, tchannel._FLAG_ERROR, 2) and size > 0


@pytest.mark.parametrize("mod", PACKAGES)
@pytest.mark.parametrize("n_readers", [1, 3])
def test_write_blocks_until_every_reader_acked(mod, n_readers):
    _, w, rs = local_channel(mod, n_readers)
    w.write(1, timeout=1)
    for r in rs[:-1]:   # all but the last reader take the value
        assert r.read(timeout=1) == 1
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        w.write(2, timeout=0.3)
    assert time.monotonic() - t0 >= 0.3
    # a reader that acks releases a writer blocked in its wait
    done = []
    t = threading.Thread(target=lambda: done.append(w.write(2, timeout=10)))
    t.start()
    time.sleep(0.1)
    assert t.is_alive()
    assert rs[-1].read(timeout=1) == 1
    t.join(timeout=5)
    assert done == [None]
    assert [r.read(timeout=1) for r in rs] == [2] * n_readers
    with pytest.raises(TimeoutError):
        rs[0].read(timeout=0.2)   # nothing new


@pytest.mark.parametrize("mod", PACKAGES)
def test_close_raises_channel_closed_on_both_sides(mod):
    _, w, (r,) = local_channel(mod, 1)
    got = []

    def blocked_read():
        try:
            r.read(timeout=10)
        except mod.ChannelClosed as e:
            got.append(e)

    t = threading.Thread(target=blocked_read)
    t.start()
    time.sleep(0.1)
    w.close()   # the writer's close wakes the blocked reader
    t.join(timeout=5)
    assert len(got) == 1 and not t.is_alive()
    _, w, (r,) = local_channel(mod, 1)
    w.write(1)
    r.close()   # the reader's close ends the writer's wait for its ack
    with pytest.raises(mod.ChannelClosed):
        w.write(2, timeout=10)


@pytest.mark.parametrize("mod", PACKAGES)
def test_error_flag_and_full_buffer(mod):
    _, w, (r,) = local_channel(mod, 1, size=4096)
    w.write(ValueError("boom"), is_error=True)
    with pytest.raises(mod._PropagatedError) as info:
        r.read(timeout=1)
    assert isinstance(info.value.inner, ValueError) and str(info.value.inner) == "boom"
    with pytest.raises(mod.ChannelFull, match="buffer_size_bytes"):
        w.write(np.zeros(8192, np.uint8), timeout=1)
    w.write(3, timeout=1)   # still usable, nothing was published
    assert r.read(timeout=1) == 3


@pytest.mark.parametrize("mod", PACKAGES)
@pytest.mark.parametrize("n_readers", [1, 3])
def test_socket_channel_same_protocol(mod, n_readers):
    w, rs = socket_channel(mod, n_readers)
    try:
        for v in values(1):
            w.write(v, timeout=10)
            for r in rs:
                assert_same(r.read(timeout=10), v)
        w.write(1, timeout=10)
        for r in rs[:-1]:
            r.read(timeout=10)
        with pytest.raises(TimeoutError):
            w.write(2, timeout=0.3)   # the last reader has not acked
        assert rs[-1].read(timeout=10) == 1
        w.write(ValueError("far"), timeout=10, is_error=True)
        for r in rs:
            with pytest.raises(mod._PropagatedError, match="far"):
                r.read(timeout=10)
        w.close()
        for r in rs:
            with pytest.raises(mod.ChannelClosed):
                r.read(timeout=10)
    finally:
        w.close()
        for r in rs:
            r.close()


def tensors(seed: int):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(4, 512, 96, generator=g),
            torch.randn(3, 7, generator=g).to(torch.bfloat16),
            {"h": torch.randn(2, 768, generator=g).to(torch.bfloat16), "step": 3}]


def assert_tensors_bitwise(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_tensors_bitwise(got[k], want[k])
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16) if got.dtype == torch.bfloat16 else got,
                           want.view(torch.int16) if want.dtype == torch.bfloat16 else want)
    else:
        assert got == want


def test_torch_tensors_round_trip_bitwise():
    _, w, rs = local_channel(tchannel, 2, size=1 << 21)
    sw, srs = socket_channel(tchannel, 2)
    try:
        for v in tensors(0):
            w.write(v, timeout=5)
            sw.write(v, timeout=10)
            for r in rs:
                assert_tensors_bitwise(r.read(timeout=5), v)
            for r in srs:
                assert_tensors_bitwise(r.read(timeout=10), v)
    finally:
        sw.close()
        for r in srs:
            r.close()


@pytest.fixture(scope="module")
def port_runtime():
    import ray_tpu_torch

    mp = pytest.MonkeyPatch()
    port_env(mp)
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()
        mp.undo()


def test_plasma_channel_between_processes(port_runtime):
    """Created in plasma by the driver, attached by an actor in another
    process as reader 0 through ``attach_channel``; the tensors arrive
    bitwise, and ``destroy`` takes the object out of the store."""
    rt = port_runtime
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.worker import get_global_worker

    class Reader:
        def read(self, desc, n):
            from ray_tpu_torch.experimental import channel

            ch = channel.attach_channel(desc, 0)
            try:
                return [ch.read(timeout=30) for _ in range(n)]
            finally:
                ch.release()

    ch = tchannel.Channel.create(1, 1 << 21)
    reader = rt.remote(Reader).remote()
    want = tensors(1)
    ref = reader.read.remote(ch.descriptor(), len(want))
    for v in want:
        ch.write(v, timeout=30)
    got = rt.get(ref, timeout=60)
    for g, v in zip(got, want):
        assert_tensors_bitwise(g, v)
    plasma = get_global_worker().plasma
    assert plasma.contains(ObjectID(ch.descriptor()["oid"]))
    ch.destroy()
    assert not plasma.contains(ObjectID(ch.descriptor()["oid"]))
    token = b"t" * 8
    assert tchannel.register_channel(token, tchannel.Channel.create(1, 4096)) == token
    tchannel.close_registered(token)
    assert token not in tchannel._registry
    rt.kill(reader)
