"""GCS table persistence: a msgpack-framed append log with replay/compaction.

The reference persists GCS tables to Redis so the control plane can restart
without losing cluster state (reference: src/ray/gcs/store_client/
redis_store_client.h, gcs_table_storage.h). We keep the same recovery
contract with a much smaller mechanism: every table mutation appends one
framed msgpack record to ``<session_dir>/gcs.log``; on restart the log is
replayed last-write-wins into the in-memory tables and then compacted into a
snapshot so the log never grows unboundedly.

Record layout: 4-byte little-endian length, then ``[kind, data]`` msgpack.
Kinds:
    "kv"    -> [ns, key, value_or_None]           (None = delete)
    "job"   -> job record dict
    "actor" -> actor record dict (incl. creation_spec, for rescheduling)
    "named" -> [ns, name, actor_id_or_None]       (None = released)
    "pg"    -> placement-group record dict (sans ready_event)
    "node"  -> node record dict
A torn tail frame (crash mid-append) is detected by the length prefix and
discarded; everything before it replays.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

import msgpack

_LEN = struct.Struct("<I")
_MAX_RECORD = 1 << 30


class GcsLog:
    """Append-only persistence log for GCS tables."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = None

    def _open(self):
        if self._f is None:
            self._f = open(self.path, "ab")
        return self._f

    def append(self, kind: str, data) -> None:
        body = msgpack.packb([kind, data], use_bin_type=True)
        f = self._open()
        f.write(_LEN.pack(len(body)) + body)
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())

    def replay(self) -> Iterator[Tuple[str, object]]:
        """Yield (kind, data) for every intact record; stop at a torn tail."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            while True:
                header = f.read(_LEN.size)
                if len(header) < _LEN.size:
                    return
                (length,) = _LEN.unpack(header)
                if length > _MAX_RECORD:
                    return
                body = f.read(length)
                if len(body) < length:
                    return  # torn tail: crash mid-append
                try:
                    kind, data = msgpack.unpackb(
                        body, raw=False, strict_map_key=False
                    )
                except Exception:
                    return
                yield kind, data

    @staticmethod
    def pack(records: List[Tuple[str, object]]) -> bytes:
        """Serialize records to the framed on-disk form (caller's thread)."""
        out = []
        for kind, data in records:
            body = msgpack.packb([kind, data], use_bin_type=True)
            out.append(_LEN.pack(len(body)) + body)
        return b"".join(out)

    def compact_packed(self, blob: bytes) -> None:
        """Atomically replace the log with pre-packed snapshot bytes.

        Safe to run in a worker thread: the caller packs on the event loop
        (point-in-time consistent), only the write+fsync happens here.
        """
        self.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def compact(self, records: List[Tuple[str, object]]) -> None:
        """Atomically replace the log with a snapshot of current state."""
        self.compact_packed(self.pack(records))

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self):
        if self._f is not None:
            try:
                self._f.close()
            except Exception:
                pass
            self._f = None
