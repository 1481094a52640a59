"""Blocking-call-in-coroutine detector for the control-plane event loops.

One synchronous call inside an ``async def`` on the rpc/raylet/GCS/worker/
serve loops silently re-serializes everything behind that loop — on a
1-core CI box the tests still pass, which is why this must be a static
check (Podracer-scale TPU systems live and die by single-threaded-loop
discipline, arXiv 2104.06272; the reactor sharding is worthless if a
shard blocks). Three rules, applied only to ``async def`` bodies (nested
sync ``def``s reset the context — they run in executors or callbacks):

``blocking-call-in-async``
    ``time.sleep``, ``subprocess.run/call/check_call/check_output/
    getoutput/getstatusoutput``, ``os.system/os.popen/os.waitpid``,
    ``socket.create_connection/getaddrinfo/gethostbyname``,
    ``requests.*``, ``urllib.request.urlopen``. Use ``asyncio.sleep`` /
    ``run_in_executor`` / the async client instead.

``blocking-io-in-async``
    synchronous file/socket handle work: builtin ``open()`` and un-awaited
    ``.accept()/.connect()/.recv()/.recv_into()/.sendall()`` calls. Small
    local-file opens (markers, snapshots) are routinely accepted via the
    baseline or an inline ``# lint: allow(blocking-io-in-async)`` — the
    rule exists so each one is a *decision*, not an accident.

``sync-lock-in-async``
    un-awaited acquisition of a lock-ish object (final name containing
    lock/mutex/cond/sem): ``with self._lock:`` or a bare ``.acquire()``
    that is not awaited. A threading lock held across an await point — or
    merely contended — stalls the whole loop; use ``asyncio.Lock`` with
    ``async with``, or keep the critical section in sync helper methods
    called from one thread.

Scope: within the ray_tpu_torch package only the control-plane modules are
checked (``_private/rpc.py``, ``_private/worker.py``, ``_private/raylet/``,
``_private/gcs/``, ``serve/``); files linted from OUTSIDE the package
(test fixtures) are always in scope so the rules stay testable.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_tpu_torch._private.lint.core import Finding, SourceFile, call_name

_CONTROL_PLANE_PARTS = (
    "ray_tpu_torch/_private/rpc.py",
    "ray_tpu_torch/_private/worker.py",
    "ray_tpu_torch/_private/raylet/",
    "ray_tpu_torch/_private/gcs/",
    "ray_tpu_torch/serve/",
)

_BLOCKING_CALLS = {
    "time.sleep", "_time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.getoutput",
    "subprocess.getstatusoutput",
    "os.system", "os.popen", "os.waitpid",
    "socket.create_connection", "socket.getaddrinfo",
    "socket.gethostbyname",
    "requests.get", "requests.post", "requests.put", "requests.delete",
    "requests.head", "requests.request",
    "urlopen", "urllib.request.urlopen",
}

_BLOCKING_SOCKET_METHODS = {"accept", "connect", "recv", "recv_into",
                            "sendall"}

_LOCKISH = ("lock", "mutex", "cond", "sem")


def in_scope(rel: str) -> bool:
    """Control-plane modules inside the package; everything outside it."""
    if rel.startswith("ray_tpu_torch/") or rel.startswith("ray_tpu_torch\\"):
        norm = rel.replace("\\", "/")
        return any(part in norm for part in _CONTROL_PLANE_PARTS)
    return True


def _final_name(expr) -> Optional[str]:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _lockish(expr) -> bool:
    name = _final_name(expr)
    return name is not None and any(t in name.lower() for t in _LOCKISH)


class _AsyncScanner(ast.NodeVisitor):
    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.findings: List[Finding] = []
        self.async_depth = 0
        self.awaited: set = set()  # id() of Call nodes under an Await

    def _find(self, rule: str, line: int, message: str):
        self.findings.append(
            Finding(rule, self.sf.rel, line, message, self.sf.snippet(line)))

    def visit_AsyncFunctionDef(self, node):
        self.async_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self.async_depth -= 1

    def visit_FunctionDef(self, node):
        saved = self.async_depth
        self.async_depth = 0
        for stmt in node.body:
            self.visit(stmt)
        self.async_depth = saved

    def visit_Lambda(self, node):
        saved = self.async_depth
        self.async_depth = 0
        self.visit(node.body)
        self.async_depth = saved

    def visit_Await(self, node: ast.Await):
        if isinstance(node.value, ast.Call):
            self.awaited.add(id(node.value))
        self.generic_visit(node)

    def visit_With(self, node: ast.With):
        if self.async_depth:
            for item in node.items:
                ctx = item.context_expr
                # `with open(...)` is handled by the Call visitor; here we
                # catch sync acquisition of lock-ish context managers
                if not isinstance(ctx, ast.Call) and _lockish(ctx):
                    self._find(
                        "sync-lock-in-async", node.lineno,
                        f"sync `with {_final_name(ctx)}:` inside a "
                        "coroutine blocks the event loop while contended — "
                        "use asyncio.Lock with `async with`, or hop the "
                        "work off the loop")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        if self.async_depth:
            name = call_name(node)
            leaf = name.rsplit(".", 1)[-1]
            if name in _BLOCKING_CALLS:
                self._find(
                    "blocking-call-in-async", node.lineno,
                    f"blocking call {name}() inside a coroutine stalls "
                    "this control-plane event loop — use the asyncio "
                    "equivalent or run_in_executor")
            elif name == "open":
                self._find(
                    "blocking-io-in-async", node.lineno,
                    "sync open() inside a coroutine performs filesystem "
                    "IO on the event loop — acceptable only for small "
                    "local files (baseline/allow it) else use "
                    "run_in_executor")
            elif (
                leaf in _BLOCKING_SOCKET_METHODS
                and id(node) not in self.awaited
                and isinstance(node.func, ast.Attribute)
                and not _lockish(node.func.value)
            ):
                recv = _final_name(node.func.value) or ""
                if any(t in recv.lower() for t in ("sock", "conn", "sk")):
                    self._find(
                        "blocking-io-in-async", node.lineno,
                        f"sync socket {recv}.{leaf}() inside a coroutine "
                        "blocks the event loop — use the loop.sock_* "
                        "coroutines or asyncio streams")
            elif (
                leaf == "acquire"
                and id(node) not in self.awaited
                and isinstance(node.func, ast.Attribute)
                and _lockish(node.func.value)
            ):
                self._find(
                    "sync-lock-in-async", node.lineno,
                    f"un-awaited {_final_name(node.func.value)}.acquire() "
                    "inside a coroutine blocks the event loop while "
                    "contended — await an asyncio primitive instead")
        self.generic_visit(node)


def analyze(files: List[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if not in_scope(sf.rel):
            continue
        scanner = _AsyncScanner(sf)
        # pre-pass: Await marking must happen before Call checks, and
        # ast.walk order doesn't guarantee it — collect awaited calls first
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
                scanner.awaited.add(id(node.value))
        scanner.visit(sf.tree)
        findings.extend(scanner.findings)
    return findings
