"""Serializability inspection
(reference: python/ray/util/check_serialize.py inspect_serializability —
walk an object that fails to cloudpickle and report WHICH nested member is
the culprit, instead of an opaque pickling error)."""

from __future__ import annotations

import inspect
from typing import Any, List, Set, Tuple

import cloudpickle


class FailureTuple:
    def __init__(self, obj: Any, name: str, parent: str):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return f"FailureTuple({self.name!r} inside {self.parent!r})"


def _serializable(obj: Any) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:
        return False


def _children(obj: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    if inspect.isfunction(obj):
        if obj.__closure__:
            names = obj.__code__.co_freevars
            for name, cell in zip(names, obj.__closure__):
                try:
                    out.append((name, cell.cell_contents))
                except ValueError:
                    pass
        out.extend((k, v) for k, v in (obj.__globals__ or {}).items()
                   if k in obj.__code__.co_names
                   and not inspect.ismodule(v))
    elif isinstance(obj, dict):
        out.extend((str(k), v) for k, v in obj.items())
    elif isinstance(obj, (list, tuple, set)):
        out.extend((f"[{i}]", v) for i, v in enumerate(obj))
    elif hasattr(obj, "__dict__") and not inspect.isclass(obj):
        out.extend(obj.__dict__.items())
    return out


def _inspect(obj: Any, name: str, parent: str, depth: int,
             seen: Set[int]) -> List[FailureTuple]:
    """Failures under obj; each names its enclosing container correctly.
    A child with no identifiable failing members IS the culprit."""
    failures: List[FailureTuple] = []
    if depth > 0:
        for child_name, child in _children(obj):
            if id(child) in seen:
                continue
            seen.add(id(child))
            if not _serializable(child):
                deeper = _inspect(child, child_name, name, depth - 1, seen)
                failures.extend(deeper)
    if not failures:
        failures.append(FailureTuple(obj, name, parent))
    return failures


def inspect_serializability(obj: Any, name: str = None, *,
                            print_failures: bool = True
                            ) -> Tuple[bool, List[FailureTuple]]:
    """Returns (is_serializable, failures). Each failure names the deepest
    non-serializable member found and the container holding it."""
    name = name or getattr(obj, "__name__", type(obj).__name__)
    if _serializable(obj):
        return True, []
    failures = _inspect(obj, name, name, depth=3, seen={id(obj)})
    if print_failures:
        for f in failures:
            print(f"  !!! {f.name!r} (inside {f.parent!r}) is not "
                  f"serializable: {type(f.obj)}")
    return False, failures


check_serializability = inspect_serializability
