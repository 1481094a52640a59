"""Public exception types (mirrors reference python/ray/exceptions.py surface)."""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    pass


class TaskError(RayTpuError):
    """A task raised; re-raised at every `get` of its returns.

    Carries the remote traceback like the reference's RayTaskError
    (reference: python/ray/exceptions.py RayTaskError).
    """

    def __init__(self, cause: Exception, remote_tb: str, task_name: str = ""):
        self.cause = cause
        self.remote_traceback = remote_tb
        self.task_name = task_name
        super().__init__(f"task {task_name} failed:\n{remote_tb}")

    def as_instanceof_cause(self):
        return self


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly."""


class ActorDiedError(RayTpuError):
    def __init__(self, actor_id=None, msg="actor died"):
        self.actor_id = actor_id
        super().__init__(msg)

    def __reduce__(self):
        # Exception pickling replays __init__ with self.args, which holds
        # only (msg,) — without this the death cause would land in actor_id
        # and the message reset to the default after any serialization hop.
        return (type(self), (self.actor_id, str(self)))


class ActorUnavailableError(RayTpuError):
    pass


class OwnerDiedError(RayTpuError):
    """The owner process of an object is gone; its value is unrecoverable."""


class ObjectLostError(RayTpuError):
    """All copies of a plasma object were lost and reconstruction failed."""


class ObjectFreedError(RayTpuError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__("task was cancelled")

    def __reduce__(self):
        return (type(self), (self.task_id,))


class PendingCallsLimitExceeded(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class OutOfMemoryError(RayTpuError):
    pass


class PlacementGroupUnschedulableError(RayTpuError):
    pass


def format_exception(e: Exception) -> str:
    return "".join(traceback.format_exception(type(e), e, e.__traceback__))
