"""DAG nodes for lazy task/actor graphs (reference: python/ray/dag/).

``fn.bind(...)`` builds a DAGNode graph; ``.execute()`` walks it submitting
tasks/actor calls; ``experimental_compile()`` (ray_tpu_torch.dag.compiled) turns a
static actor DAG into a channel-connected pipeline.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


class DAGNode:
    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def _resolve(self, value, input_value):
        if isinstance(value, DAGNode):
            return value.execute(input_value)
        return value

    def _resolved_args(self, input_value):
        args = [self._resolve(a, input_value) for a in self._bound_args]
        kwargs = {k: self._resolve(v, input_value) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def execute(self, input_value=None):
        raise NotImplementedError

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, **kwargs)

    # __getitem__ projects an element of this node's (tuple/dict) output;
    # __iter__=None keeps that from turning nodes into infinite sequences.
    __iter__ = None

    def __getitem__(self, key):
        return _AttrProxy(self, key)


class InputNode(DAGNode):
    """Placeholder for the value fed at execute() time."""

    _current = None

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        InputNode._current = self
        return self

    def __exit__(self, *a):
        InputNode._current = None

    def execute(self, input_value=None):
        return input_value


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def execute(self, input_value=None):
        args, kwargs = self._resolved_args(input_value)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """A bound actor constructor; method calls on it create ClassMethodNodes."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._handle = None

    def _ensure_actor(self):
        if self._handle is None:
            args, kwargs = self._resolved_args(None)
            self._handle = self._actor_cls.remote(*args, **kwargs)
        return self._handle

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _ClassMethodBinder(self, item)

    def execute(self, input_value=None):
        return self._ensure_actor()


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def execute(self, input_value=None):
        handle = self._class_node._ensure_actor()
        args, kwargs = self._resolved_args(input_value)
        method = getattr(handle, self._method_name)
        return method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    def __init__(self, nodes: List[DAGNode]):
        super().__init__(tuple(nodes), {})
        self._nodes = nodes

    def execute(self, input_value=None):
        return [n.execute(input_value) for n in self._nodes]


class _LiveActorNode:
    """ClassNode stand-in wrapping an already-created actor handle, so
    ``handle.method.bind(...)`` composes with ClassMethodNode."""

    def __init__(self, handle):
        self._handle = handle

    def _ensure_actor(self):
        return self._handle


class _AttrProxy(DAGNode):
    """x[i] projection of an upstream node's output (``inp[0]``-style).

    One level only: nested projections (x[0][1]) are rejected — the compiled
    path unwraps exactly one level, and one level covers the tuple-return
    idiom the reference supports.
    """

    # Explicitly non-iterable: without this, __getitem__ would make every
    # node an infinite sequence under tuple-unpack / list() / iteration.
    __iter__ = None

    def __init__(self, base: DAGNode, key):
        super().__init__((), {})
        if isinstance(base, _AttrProxy):
            raise ValueError(
                "nested projections (node[i][j]) are not supported; "
                "project once and index inside the consuming method"
            )
        if not isinstance(key, (int, str)):
            raise TypeError(f"projection key must be int or str, got {key!r}")
        self._base = base
        self._key = key

    def execute(self, input_value=None):
        from ray_tpu_torch._private.object_ref import ObjectRef

        v = self._base.execute(input_value)
        if isinstance(v, ObjectRef):
            import ray_tpu_torch

            v = ray_tpu_torch.get(v)
        return v[self._key]
