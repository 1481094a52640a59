"""Plasma-backed submit ring: syscall-free task submission.

The RPC submit path costs one socket write per PushTask frame; at
many-drivers-storm scale those writes (plus the per-frame reactor wakeups
on the receiving side) dominate tiny-task throughput. This module gives a
driver a fixed-size shared-memory ring — one sealed plasma object used as
a mailbox — into which it memcpys serialized task specs. The raylet
drains the ring in batches per loop tick; the only RPC left on the hot
path is a single doorbell notify on every empty→non-empty transition.

The ring rides the same mapped-shm discipline as the zero-copy data
plane (serialization.write_blob): the producer writes payload bytes
straight into a slice of the plasma arena mmap; nothing is ever
re-pickled or staged through a socket. Sealing the object here only
*publishes* the region — both sides hold a plasma pin so the store cannot
reclaim it, and both sides map it read-write (the arena mapping is always
RW; see _native/plasma.PlasmaClient).

Layout (all cursors 8-byte aligned; little-endian)::

    [0:8)    tail   producer write cursor, bytes, monotonically increasing
    [8:16)   head   consumer read cursor,  bytes, monotonically increasing
    [16:24)  consumer heartbeat, float64 wall-clock seconds (liveness)
    [24:32)  flags  (FLAG_CLOSED = producer detached cleanly)
    [32:40)  magic
    [40:64)  reserved
    [64:...] data region; entries are [u32 length][payload] padded to a
             4-byte boundary and never wrap — a u32 SKIP marker burns the
             tail of the region when an entry would cross the end.

Concurrency contract: strict SPSC. Exactly one producer thread (the
driver's io loop) advances ``tail``; exactly one consumer thread (the
raylet's loop) advances ``head``. Each 8-byte cursor store is a single
aligned write — atomic on every platform this runs on — and each side
publishes its cursor only AFTER the bytes it covers are written (producer)
or copied out (consumer), so the peer can never observe a torn entry.

Doorbell rule (who wakes the consumer): after publishing ``tail`` the
producer re-reads ``head``; if ``head`` equals the pre-push tail the ring
was drained empty at publish time, meaning the consumer either is asleep
or is about to sleep — exactly then a doorbell RPC is required. Any other
interleaving guarantees the consumer will still observe the new entry on
its way to the empty check, so no doorbell is needed.

Failure semantics: the ring is an *optimization*, never a source of
truth. A full ring, a missing ring, or a dead consumer all fall back to
the RPC submit path. The consumer heartbeats the header every drain tick;
a producer whose doorbell connection drops or whose consumer heartbeat
goes stale resubmits every not-yet-replied spec via RPC (the raylet that
died took its undispatched backlog — and the workers that would have run
it — with it, so resubmission cannot double-execute those; an executed
task whose reply was lost retries under the same at-least-once contract
as the ordinary worker-crash path).
"""

from __future__ import annotations

import struct
from typing import List, Optional

HEADER_BYTES = 64
# Sizing hint: RTPU_TORCH_submit_ring_slots is a slot COUNT; each slot budgets
# this many bytes (a tiny-task spec packs to a few hundred bytes).
SLOT_HINT_BYTES = 1024

MAGIC = 0x52494E47  # "RING"
FLAG_CLOSED = 1
_SKIP = 0xFFFFFFFF

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")

_OFF_TAIL = 0
_OFF_HEAD = 8
_OFF_BEAT = 16
_OFF_FLAGS = 24
_OFF_MAGIC = 32


class RingCorrupt(Exception):
    pass


def ring_bytes(slots: int) -> int:
    """Total object size for a ring of ``slots`` budgeted entries."""
    return HEADER_BYTES + max(1, int(slots)) * SLOT_HINT_BYTES


class _RingBase:
    def __init__(self, view: memoryview, init: bool = False):
        view = view if isinstance(view, memoryview) else memoryview(view)
        if view.nbytes < HEADER_BYTES + 64:
            raise ValueError(f"ring backing too small: {view.nbytes}")
        self._mv = view.cast("B") if view.format != "B" else view
        # capacity must stay a multiple of 4 so entry slots always align
        self._cap = (view.nbytes - HEADER_BYTES) & ~3
        if init:
            self._mv[:HEADER_BYTES] = bytes(HEADER_BYTES)
            self._put_u64(_OFF_MAGIC, MAGIC)
        elif self._get_u64(_OFF_MAGIC) != MAGIC:
            raise RingCorrupt("bad ring magic")

    # -- header accessors (single aligned stores; see module docstring) --

    def _get_u64(self, off: int) -> int:
        return _U64.unpack_from(self._mv, off)[0]

    def _put_u64(self, off: int, value: int):
        _U64.pack_into(self._mv, off, value)

    @property
    def capacity(self) -> int:
        return self._cap

    def used_bytes(self) -> int:
        return self._get_u64(_OFF_TAIL) - self._get_u64(_OFF_HEAD)

    def empty(self) -> bool:
        return self.used_bytes() == 0

    def closed(self) -> bool:
        return bool(self._get_u64(_OFF_FLAGS) & FLAG_CLOSED)

    def consumer_beat(self) -> float:
        return _F64.unpack_from(self._mv, _OFF_BEAT)[0]


class RingProducer(_RingBase):
    """Driver side: enqueue serialized specs with one memcpy each."""

    def try_push(self, payload) -> Optional[bool]:
        """Enqueue one entry. Returns None when the ring lacks room (the
        caller falls back to the RPC path), else whether the ring
        transitioned empty→non-empty (the caller rings the doorbell)."""
        payload = payload if isinstance(payload, (bytes, bytearray)) \
            else bytes(payload)
        need = 4 + len(payload)
        need += (-need) % 4  # keep every slot 4-byte aligned
        if need > self._cap:
            return None
        tail = self._get_u64(_OFF_TAIL)
        head = self._get_u64(_OFF_HEAD)
        used = tail - head
        pos = tail % self._cap
        room_to_end = self._cap - pos
        if room_to_end < need:
            # entries never wrap: burn the region tail with a SKIP marker
            if used + room_to_end + need > self._cap:
                return None
            _U32.pack_into(self._mv, HEADER_BYTES + pos, _SKIP)
            tail += room_to_end
            pos = 0
        elif used + need > self._cap:
            return None
        base = HEADER_BYTES + pos
        _U32.pack_into(self._mv, base, len(payload))
        self._mv[base + 4:base + 4 + len(payload)] = payload
        orig_tail = self._get_u64(_OFF_TAIL)
        # publish: the entry bytes above are fully written before the
        # cursor store makes them visible
        self._put_u64(_OFF_TAIL, tail + need)
        # doorbell rule: empty at publish time ⇒ the consumer is (about to
        # go) asleep and needs a wakeup; see module docstring for why this
        # read must happen AFTER the tail store
        return self._get_u64(_OFF_HEAD) == orig_tail

    def close(self):
        """Mark a clean producer detach; the consumer reclaims the ring."""
        self._put_u64(_OFF_FLAGS, self._get_u64(_OFF_FLAGS) | FLAG_CLOSED)


class RingConsumer(_RingBase):
    """Raylet side: drain batches of entries per tick."""

    def drain(self, max_items: int = 256) -> List[bytes]:
        """Pop up to ``max_items`` entries. Payloads are copied out BEFORE
        the head cursor is published, so the producer can never overwrite
        bytes a drained entry still aliases."""
        out: List[bytes] = []
        head = self._get_u64(_OFF_HEAD)
        tail = self._get_u64(_OFF_TAIL)
        while head < tail and len(out) < max_items:
            pos = head % self._cap
            base = HEADER_BYTES + pos
            (length,) = _U32.unpack_from(self._mv, base)
            if length == _SKIP:
                head += self._cap - pos
                continue
            if length > self._cap - 4 or pos + 4 + length > self._cap:
                raise RingCorrupt(f"entry length {length} out of bounds")
            out.append(bytes(self._mv[base + 4:base + 4 + length]))
            adv = 4 + length
            head += adv + (-adv) % 4
        self._put_u64(_OFF_HEAD, head)
        return out

    def beat(self, now: float):
        """Liveness heartbeat, written every drain tick — producers treat
        a stale beat as a dead consumer and fall back to RPC."""
        _F64.pack_into(self._mv, _OFF_BEAT, now)
