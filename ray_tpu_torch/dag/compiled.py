"""Compiled actor DAGs, the port of ``ray_tpu/dag/compiled.py``: static
graphs executed through preallocated shared-memory channels with
persistent per-actor exec loops.

Reference architecture: python/ray/dag/compiled_dag_node.py:391 (CompiledDAG,
do_exec_tasks :84, execute :1408) + shared_memory_channel.py:147. Channels
are in-place-mutated plasma objects on the node's store (one memcpy handoff,
no per-step task submission); an edge between nodes rides a socket stream.
numpy arrays and torch tensors ride the serializer's out-of-band buffers: a
stage that returns a CUDA tensor has it copied to the host once when its
output is written (``.cpu()`` waits for the work queued on the tensor's
stream), and the next stage reads a CPU tensor, which it moves to its own
card.

Usage::

    with InputNode() as inp:
        x = a.f.bind(inp)
        y = b.g.bind(x)
    dag = y.experimental_compile(buffer_size_bytes=16 << 20)
    for step in range(1000):
        ref = dag.execute(step)        # no task submission per step
        out = ref.get()
    dag.teardown()

Constraints (same as the reference's aDAG v1): every bound method must be an
actor method (plain tasks cannot host a persistent loop) and the graph is
static. A serialized value larger than ``buffer_size_bytes`` (4 MiB by
default) raises ``ChannelFull``: in ``execute`` for the input, at the
driver's ``get()`` for a stage's output.

Each actor's loop runs on a thread of its own (``rtpu-dag-exec``). torch
keeps the current CUDA device per thread: the loop takes the device that
was current where it was started (the actor's executor thread), so a stage's
CUDA work runs on its lease's card.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag.node import (
    ClassMethodNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
    _AttrProxy,
)
from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelClosed,
    ChannelFull,
    SocketChannel,
    _PropagatedError,
    attach_channel,
    close_registered,
    register_channel,
)


class _FROM_CHANNEL:
    """Sentinel marking a positional arg fed by a channel read. A class is
    pickled by reference, so identity survives the __ray_call__ hop."""


class CompiledDAGRef:
    """Result handle for one execute(); reads the output channels."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value = None
        self._consumed = False

    def get(self, timeout: Optional[float] = 60.0):
        return self._dag._read_output(self, timeout)


def _exec_loop(self, tasks: List[dict], cuda_device: Optional[int] = None):
    """Runs inside the actor (shipped via __ray_call__): read inputs, call
    the bound method, write the output — forever, until teardown closes a
    channel. This is the reference's do_exec_tasks. An output too large for
    its channel goes downstream as the ``ChannelFull`` error, so the loop
    lives on; the channels it attached are released when it ends."""
    if cuda_device is not None:
        import torch

        torch.cuda.set_device(cuda_device)
    attached: Dict[bytes, Channel] = {}

    def chan(desc, reader_index):
        # keyed by reader slot too: two tasks on one actor consuming the
        # same upstream own distinct slots and must ack independently
        key = (desc.get("oid") or desc["token"], reader_index)
        if key not in attached:
            attached[key] = attach_channel(desc, reader_index)
        return attached[key]

    try:
        while True:
            for t in tasks:
                # One read per channel per task-tick: a method consuming the
                # same upstream twice (f.bind(x, x)) must not double-read.
                # Per-task (not per-tick): each task owns a distinct reader
                # slot and must perform its own read to ack it.
                tick_cache: Dict[bytes, Any] = {}
                args = []
                error = None
                for desc, ridx, unpack in t["reads"]:
                    key = desc.get("oid") or desc["token"]
                    if key in tick_cache:
                        v = tick_cache[key]
                    else:
                        try:
                            v = chan(desc, ridx).read()
                        except _PropagatedError as e:
                            v = e
                        tick_cache[key] = v
                    if isinstance(v, _PropagatedError):
                        error = v
                        args.append(None)  # placeholder; error short-circuits
                    elif unpack is None:
                        args.append(v)
                    else:
                        args.append(v[unpack])
                out_chan = chan(t["write"], None)
                if error is not None:
                    out_chan.write(error.inner, is_error=True)
                    continue
                it = iter(args)
                bound = [next(it) if s is _FROM_CHANNEL else s
                         for s in t["static_args"]]
                try:
                    result = getattr(self, t["method"])(*bound, **t["kwargs"])
                except Exception as e:
                    out_chan.write(e, is_error=True)
                    continue
                try:
                    out_chan.write(result)
                except ChannelFull as e:
                    out_chan.write(e, is_error=True)
    except ChannelClosed:
        return None
    finally:
        for ch in attached.values():
            # a shm view pins its plasma object until released
            getattr(ch, "release", ch.close)()


def _current_cuda_device() -> Optional[int]:
    """This thread's CUDA device where this process already uses CUDA, else
    None (a process that never imported torch does not import it here)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device()


def _start_exec_loop(self, tasks: List[dict]):
    t = threading.Thread(
        target=_exec_loop, args=(self, tasks, _current_cuda_device()),
        daemon=True, name="rtpu-dag-exec",
    )
    t.start()
    return True


def _get_node_id(self):
    import ray_tpu_torch

    return ray_tpu_torch.get_runtime_context().get_node_id()


def _remote_create_shm_channel(self, n_readers: int, buffer_size: int):
    """Create a shared-memory channel in THIS actor's process (its node's
    plasma) and register it for driver-directed teardown."""
    from ray_tpu_torch.experimental.channel import Channel, register_channel

    ch = Channel.create(n_readers, buffer_size)
    desc = ch.descriptor()
    desc["token"] = desc["oid"]
    register_channel(desc["token"], ch)
    return desc


def _remote_create_socket_channel(self, n_readers: int, buffer_size: int):
    """Create a cross-node socket channel with THIS actor's process as the
    writer end."""
    from ray_tpu_torch.experimental.channel import SocketChannel, register_channel

    ch = SocketChannel.create(n_readers)
    desc = ch.descriptor()
    register_channel(desc["token"], ch)
    return desc


def _remote_close_channel(self, token: bytes):
    from ray_tpu_torch.experimental.channel import close_registered

    close_registered(token)
    return True


class CompiledDAG:
    def __init__(self, output_node: DAGNode,
                 buffer_size_bytes: int = 4 * 1024 * 1024):
        self._buffer_size = buffer_size_bytes
        self._torn_down = False
        self._seq = 0
        self._next_read_seq = 1
        self._in_flight: List[CompiledDAGRef] = []
        self._lock = threading.Lock()
        self._compile(output_node)

    # ------------------------------------------------------------- compile

    def _compile(self, output_node: DAGNode):
        if isinstance(output_node, MultiOutputNode):
            outputs = list(output_node._nodes)
        else:
            outputs = [output_node]
        for n in outputs:
            if not isinstance(n, ClassMethodNode):
                raise ValueError(
                    "compiled DAGs support actor-method nodes only "
                    "(reference: compiled_dag_node.py NotImplementedError)"
                )

        # Topological collection (args before consumers).
        order: List[ClassMethodNode] = []
        seen = set()
        self._input_node: Optional[InputNode] = None

        def visit(n):
            if id(n) in seen:
                return
            seen.add(id(n))
            if isinstance(n, InputNode):
                self._input_node = n
                return
            if isinstance(n, _AttrProxy):
                visit(n._base)
                return
            if not isinstance(n, ClassMethodNode):
                if isinstance(n, DAGNode):
                    raise ValueError(
                        f"unsupported node type in compiled DAG: {type(n)}"
                    )
                return
            for a in list(n._bound_args) + list(n._bound_kwargs.values()):
                if isinstance(a, DAGNode):
                    visit(a)
            order.append(n)

        for n in outputs:
            visit(n)
        if not order:
            raise ValueError("empty DAG")

        # Reader bookkeeping: channel per producing node + the input channel.
        # Consumer lists are UNIQUE per node: a method consuming the same
        # upstream twice still occupies one reader slot (the exec loop reads
        # each channel once per tick), and every allocated slot must have a
        # live reader or the writer's all-acked wait never completes.
        consumers: Dict[int, List] = {id(n): [] for n in order}
        input_consumers: List = []
        for n in order:
            seen_bases = set()
            for a in n._bound_args:
                base = a._base if isinstance(a, _AttrProxy) else a
                if id(base) in seen_bases:
                    continue
                seen_bases.add(id(base))
                if isinstance(base, InputNode):
                    input_consumers.append(n)
                elif isinstance(base, ClassMethodNode):
                    consumers[id(base)].append(n)
        out_reader_idx: Dict[int, int] = {}
        for n in outputs:
            consumers[id(n)].append("driver")

        # Resolve actors and their nodes first: channel placement follows
        # the node topology — a same-node edge rides shared memory, a
        # cross-node edge rides a socket stream (the DCN hop; reference GPU
        # analogue torch_tensor_nccl_channel.py:191).
        import ray_tpu_torch

        my_node = ray_tpu_torch.get_runtime_context().get_node_id()
        handle_of: Dict[int, Any] = {}
        for n in order:
            handle_of[id(n)] = n._class_node._ensure_actor()
        uniq_handles = {id(h): h for h in handle_of.values()}
        node_refs = {
            hid: h.__ray_call__.remote(_get_node_id)
            for hid, h in uniq_handles.items()
        }
        node_of_handle = {hid: ray_tpu_torch.get(r) for hid, r in node_refs.items()}
        node_of = {
            nid: node_of_handle[id(h)] for nid, h in handle_of.items()
        }

        self._local_channels: List[Any] = []
        self._remote_tokens: List[tuple] = []  # (actor handle, token)

        def make_channel(writer_nid, reader_nodes, n_readers):
            """Allocate a channel in the writer's process. writer_nid is
            id(node) for an actor writer, None for the driver."""
            writer_node = my_node if writer_nid is None else node_of[writer_nid]
            cross = any(rn != writer_node for rn in reader_nodes)
            n_readers = max(1, n_readers)
            if writer_nid is None:
                ch = (SocketChannel.create(n_readers) if cross
                      else Channel.create(n_readers, self._buffer_size))
                desc = ch.descriptor()
                if "token" not in desc:
                    desc["token"] = desc["oid"]
                self._local_channels.append(ch)
                return ch, desc
            h = handle_of[writer_nid]
            fn = (_remote_create_socket_channel if cross
                  else _remote_create_shm_channel)
            desc = ray_tpu_torch.get(
                h.__ray_call__.remote(fn, n_readers, self._buffer_size)
            )
            self._remote_tokens.append((h, desc["token"]))
            return None, desc

        # Reader indices.
        input_rix: Dict[int, int] = {}
        for i, c in enumerate(input_consumers):
            input_rix.setdefault(id(c), i)
        node_rix: Dict[int, Dict[int, int]] = {}
        for n in order:
            node_rix[id(n)] = {}
            for i, c in enumerate(consumers[id(n)]):
                if c == "driver":
                    out_reader_idx[id(n)] = i
                else:
                    node_rix[id(n)][id(c)] = i

        # Allocate: the input channel is written by the driver; each node's
        # output channel is written by its actor.
        self._input_channel = None
        input_desc = None
        if input_consumers:
            self._input_channel, input_desc = make_channel(
                None, [node_of[id(c)] for c in input_consumers],
                len(input_consumers),
            )
        node_desc: Dict[int, dict] = {}
        for n in order:
            reader_nodes = [
                my_node if c == "driver" else node_of[id(c)]
                for c in consumers[id(n)]
            ]
            _, node_desc[id(n)] = make_channel(
                id(n), reader_nodes, len(consumers[id(n)])
            )

        # Build per-actor task descriptors.
        by_actor: Dict[Any, List[dict]] = {}
        self._actors = []
        for n in order:
            handle = handle_of[id(n)]
            reads = []
            static_args = []
            kwargs = {}
            for a in n._bound_args:
                unpack = None
                base = a
                if isinstance(a, _AttrProxy):
                    unpack = a._key
                    base = a._base
                if isinstance(base, InputNode):
                    reads.append((input_desc, input_rix[id(n)], unpack))
                    static_args.append(_FROM_CHANNEL)
                elif isinstance(base, ClassMethodNode):
                    reads.append((node_desc[id(base)],
                                  node_rix[id(base)][id(n)], unpack))
                    static_args.append(_FROM_CHANNEL)
                else:
                    static_args.append(base)
            for k, v in n._bound_kwargs.items():
                if isinstance(v, DAGNode):
                    raise ValueError("DAG deps must be positional args")
                kwargs[k] = v
            by_actor.setdefault(handle, []).append({
                "method": n._method_name,
                "reads": reads,
                "static_args": static_args,
                "kwargs": kwargs,
                "write": node_desc[id(n)],
            })

        # Launch exec loops.
        started = [
            handle.__ray_call__.remote(_start_exec_loop, tasks)
            for handle, tasks in by_actor.items()
        ]
        ray_tpu_torch.get(started)
        self._actors = list(by_actor)
        self._output_readers = [
            attach_channel(node_desc[id(n)], out_reader_idx[id(n)])
            for n in outputs
        ]
        self._multi_output = isinstance(output_node, MultiOutputNode)

    # ------------------------------------------------------------- execute

    def execute(self, *args, timeout: Optional[float] = 60.0):
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        with self._lock:
            self._seq += 1
            ref = CompiledDAGRef(self, self._seq)
            self._in_flight.append(ref)
        if self._input_channel is not None:
            value = args[0] if len(args) == 1 else args
            self._input_channel.write(value, timeout=timeout)
        return ref

    def _read_output(self, ref: CompiledDAGRef, timeout: Optional[float]):
        with self._lock:
            if ref._consumed:
                return ref._value
            # Channel reads are strictly ordered; service older refs first.
            for pending in list(self._in_flight):
                if pending._seq > ref._seq:
                    break
                outs = []
                err = None
                for rd in self._output_readers:
                    try:
                        outs.append(rd.read(timeout=timeout))
                    except _PropagatedError as e:
                        err = e.inner
                        outs.append(None)
                pending._consumed = True
                if err is not None:
                    pending._value = err
                    pending._error = True
                else:
                    pending._value = (
                        outs if self._multi_output else outs[0]
                    )
                    pending._error = False
                self._in_flight.remove(pending)
            if getattr(ref, "_error", False):
                raise ref._value
            return ref._value

    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        import ray_tpu_torch

        for ch in self._local_channels:
            try:
                ch.destroy()
            except Exception:
                pass
        for rd in self._output_readers:
            try:
                rd.close()
            except Exception:
                pass
            # shm readers pin the 4 MiB channel segment via plasma.get at
            # attach; drop the pin or every compile/teardown cycle leaks it
            release = getattr(rd, "release", None)
            if release is not None:
                try:
                    release()
                except Exception:
                    pass
        closes = []
        for handle, token in self._remote_tokens:
            try:
                closes.append(
                    handle.__ray_call__.remote(_remote_close_channel, token)
                )
            except Exception:
                pass
        for ref in closes:
            try:
                ray_tpu_torch.get(ref, timeout=10)
            except Exception:
                pass


