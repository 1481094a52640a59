"""Unique identifiers for jobs, tasks, actors, objects, nodes and workers.

Design notes
------------
The reference runtime derives task-scoped object ids from the parent task id plus a
return-index suffix (reference: src/ray/common/id.h). We keep that property — an
ObjectID embeds the TaskID that produced it — because the owner of a task can then
pre-compute the ids of its returns before the task runs, which is what makes
owner-side bookkeeping (pending returns, lineage) possible without a round trip.

Sizes (bytes): JobID=4, ActorID=12, TaskID=16, ObjectID=20 (TaskID + 4-byte index),
NodeID/WorkerID/PlacementGroupID=14.
"""

from __future__ import annotations

import os
import random
import threading

# ID generation is on the task-submission hot path; os.urandom costs ~80 µs
# per call (syscall), a seeded Mersenne ~1 µs. Seed from the OS and reseed
# after fork so fork-server worker children never repeat the parent's stream.
_rng = random.Random(os.urandom(16))
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=lambda: _rng.seed(os.urandom(16)))


def _rand_bytes(n: int) -> bytes:
    return _rng.randbytes(n)


_JOB_ID_SIZE = 4
_ACTOR_ID_SIZE = 12
_TASK_ID_SIZE = 16
_OBJECT_ID_SIZE = 20
_UNIQUE_ID_SIZE = 14


class BaseID:
    # _hash caches hash(_bytes): IDs key dicts all over the submit path
    # (leases, pending tasks, refcounts) — hashing the bytes each lookup
    # was a measurable share of driver io-thread time.
    __slots__ = ("_bytes", "_hash")
    SIZE = _UNIQUE_ID_SIZE

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash(self._bytes)

    @classmethod
    def from_random(cls):
        return cls(_rand_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int):
        return cls(value.to_bytes(cls.SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._bytes, "little")


class NodeID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class WorkerID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID):
        return cls(_rand_bytes(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE :])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_task(cls, job_id: JobID):
        return cls(_rand_bytes(cls.SIZE - JobID.SIZE) + job_id.binary())

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID):
        pad = cls.SIZE - ActorID.SIZE
        return cls(b"\x00" * pad + actor_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE :])


class ObjectID(BaseID):
    SIZE = _OBJECT_ID_SIZE

    @classmethod
    def from_task(cls, task_id: TaskID, index: int):
        """The i-th return of a task; index starts at 1 (0 = the put-counter space)."""
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int):
        # Puts live in the same id-space, distinguished by the high bit of the suffix.
        return cls(task_id.binary() + (put_index | 0x80000000).to_bytes(4, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[TaskID.SIZE :], "little")


_local = threading.local()


def _hex_to_id(kind, hex_str):
    return kind.from_hex(hex_str)
