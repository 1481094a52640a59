"""Shard-safety / thread-ownership analyzer.

The sharded RPC reactor (rpc.py) holds one invariant by
construction: handler coroutines hop to the server's HOME loop unless the
method was opted in via ``set_shard_safe({...})``, in which case the
handler runs on whichever shard thread owns the connection — concurrently
with the home loop and with every other shard. That opt-in is a claim of
thread safety that nothing verified until now. Two directions:

``shard-safe-unresolved``
    every name passed to ``set_shard_safe({...})`` must resolve to a
    ``handle_<name>`` method of the enclosing class. A typo'd name is not
    an error at runtime — the method silently keeps hopping home, which is
    *correct but quietly defeats the optimization* (RpcServer also raises
    at registration now; this catches it at lint time, before a cluster
    boots).

``shard-unsafe-mutation``
    the body of a shard-safe handler may mutate ``self`` state only
    lexically inside a ``with self.<lock>:`` block (any attribute/name
    whose final component contains "lock"), or on fields the module
    declares thread-safe in a module-level ``_SHARD_SAFE_FIELDS = {...}``
    set (documented natively-locked state, e.g. the plasma store's
    in-segment mutex). Flagged mutations: ``self.x = / += / del``,
    ``self.x[k] =``, and mutating method calls (append/add/pop/update/
    clear/remove/extend/insert/discard/setdefault/...) on a direct self
    attribute. Aliased mutation (``rec = self._recv[k]; rec[...] = v``)
    is out of scope for a lexical pass — keep shard-safe handlers simple
    enough that this analyzer can read them, that is the discipline.

``shard-home-loop-bypass``
    inside rpc.py itself, a registered handler must only ever be *called*
    from the ``_run_handler`` choke point (which implements the hop).
    Any other call site of a name bound from ``self._handlers`` would
    execute an arbitrary, possibly non-shard-safe handler on the shard
    thread — exactly the bug class the hop exists to prevent.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ray_tpu_torch._private.lint.core import Finding, SourceFile, const_str

_MUTATORS = {
    "append", "appendleft", "add", "pop", "popleft", "popitem", "update",
    "clear", "remove", "extend", "insert", "discard", "setdefault",
    "push", "put_nowait", "sort", "reverse",
}


def _literal_names(node) -> Optional[List[ast.Constant]]:
    """Constant elements of a set/list/tuple/dict-literal argument."""
    if isinstance(node, (ast.Set, ast.List, ast.Tuple)):
        elts = node.elts
    elif isinstance(node, ast.Dict):
        elts = node.keys
    else:
        return None
    out = []
    for e in elts:
        if const_str(e) is None:
            return None  # dynamic registration: out of scope
        out.append(e)
    return out


def _self_attr(node) -> Optional[str]:
    """'x' when node is ``self.x`` (or a subscript/chain rooted there)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_lock_expr(expr) -> bool:
    """``with self._lock:`` / ``with some_lock:`` — the guard we accept."""
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    elif isinstance(expr, ast.Call):
        return _is_lock_expr(expr.func)  # e.g. self._lock() factories
    return name is not None and "lock" in name.lower()


class _HandlerChecker(ast.NodeVisitor):
    """Walk one handler body tracking lexical lock depth."""

    def __init__(self, sf: SourceFile, handler: str, safe_fields: Set[str]):
        self.sf = sf
        self.handler = handler
        self.safe_fields = safe_fields
        self.lock_depth = 0
        self.findings: List[Finding] = []

    def _flag(self, attr: str, line: int, what: str):
        self.findings.append(Finding(
            "shard-unsafe-mutation", self.sf.rel, line,
            f"shard-safe handler '{self.handler}' {what} 'self.{attr}' "
            "outside a held lock (shard handlers run concurrently with "
            "the home loop; guard with `with self.<lock>:`, add the field "
            "to _SHARD_SAFE_FIELDS, or drop the set_shard_safe opt-in)",
            self.sf.snippet(line)))

    def _check_write(self, target, line: int, what: str):
        if self.lock_depth > 0:
            return
        attr = _self_attr(target)
        if attr is not None and attr not in self.safe_fields:
            self._flag(attr, line, what)

    def visit_With(self, node: ast.With):
        locked = any(_is_lock_expr(i.context_expr) for i in node.items)
        if locked:
            self.lock_depth += 1
        self.generic_visit(node)
        if locked:
            self.lock_depth -= 1

    def visit_Assign(self, node: ast.Assign):
        for t in node.targets:
            self._check_write(t, node.lineno, "assigns")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check_write(node.target, node.lineno, "mutates")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._check_write(node.target, node.lineno, "assigns")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for t in node.targets:
            self._check_write(t, node.lineno, "deletes")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        if self.lock_depth == 0 and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                attr = _self_attr(node.func.value)
                if attr is not None and attr not in self.safe_fields:
                    self._flag(attr, node.lineno,
                               f"calls .{node.func.attr}() on")
        self.generic_visit(node)

    # nested defs get their own execution context (executors, callbacks) —
    # don't attribute their writes to the handler's shard thread
    def visit_FunctionDef(self, node):
        pass

    def visit_AsyncFunctionDef(self, node):
        pass

    def visit_Lambda(self, node):
        pass


def _module_safe_fields(sf: SourceFile) -> Set[str]:
    for node in sf.tree.body if isinstance(sf.tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "_SHARD_SAFE_FIELDS"
            for t in node.targets
        ):
            names = _literal_names(node.value)
            if names is not None:
                return {n.value for n in names}
    return set()


def _analyze_class(sf: SourceFile, cls: ast.ClassDef,
                   safe_fields: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    methods: Dict[str, ast.AST] = {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    registrations: List[ast.Call] = []
    for node in ast.walk(cls):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "set_shard_safe"
            and node.args
        ):
            registrations.append(node)
    for call in registrations:
        names = _literal_names(call.args[0])
        if names is None:
            continue
        for name_node in names:
            method = "handle_" + name_node.value
            fn = methods.get(method)
            if fn is None:
                findings.append(Finding(
                    "shard-safe-unresolved", sf.rel, name_node.lineno,
                    f"set_shard_safe('{name_node.value}') does not resolve "
                    f"to a method '{method}' on class {cls.name} — a typo "
                    "here silently keeps the handler hopping home",
                    sf.snippet(name_node.lineno)))
                continue
            checker = _HandlerChecker(sf, method, safe_fields)
            for stmt in fn.body:
                checker.visit(stmt)
            findings.extend(checker.findings)
    return findings


def _analyze_rpc_choke_point(sf: SourceFile) -> List[Finding]:
    """Inside rpc.py: direct calls of self._handlers-bound names anywhere
    but _run_handler."""
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name == "_run_handler":
            continue
        bound: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, (ast.Call, ast.Subscript)
            ):
                src = sub.value
                target = src.func.value if (
                    isinstance(src, ast.Call)
                    and isinstance(src.func, ast.Attribute)
                    and src.func.attr == "get"
                ) else (src.value if isinstance(src, ast.Subscript) else None)
                if _self_attr(target) == "_handlers":
                    bound.update(
                        t.id for t in sub.targets if isinstance(t, ast.Name)
                    )
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                direct = (
                    isinstance(sub.func, ast.Name) and sub.func.id in bound
                )
                via_subscript = (
                    isinstance(sub.func, ast.Subscript)
                    and _self_attr(sub.func.value) == "_handlers"
                )
                if direct or via_subscript:
                    findings.append(Finding(
                        "shard-home-loop-bypass", sf.rel, sub.lineno,
                        f"registered handler called directly in "
                        f"{node.name}() — only _run_handler may invoke "
                        "handlers (it implements the home-loop hop that "
                        "keeps non-shard-safe state single-threaded)",
                        sf.snippet(sub.lineno)))
    return findings


def analyze(files: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        safe_fields = _module_safe_fields(sf)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_analyze_class(sf, node, safe_fields))
        if sf.rel.endswith("_private/rpc.py") or sf.rel == "rpc.py":
            findings.extend(_analyze_rpc_choke_point(sf))
    return findings
