"""Distributed tracing: spans that follow tasks/actors across processes.

Counterpart of the reference's opt-in tracing
(reference: python/ray/util/tracing/tracing_helper.py — remote calls are
wrapped to open spans and the context travels in an injected
``_ray_trace_ctx`` kwarg). Here tracing is runtime-native: when enabled,
task specs carry a ``trace_ctx`` field, the executor restores it before
user code runs, and spans are buffered with the task events and flushed to
the GCS — so ``ray_tpu_torch.timeline()`` renders user spans and task spans in
one Chrome trace, correlated by trace id. No OpenTelemetry dependency; the
span model (trace_id / span_id / parent) is wire-compatible with it.

Usage:
    from ray_tpu_torch.util import tracing
    tracing.enable()              # on the driver, before submitting work
    with tracing.span("preprocess", {"rows": 100}):
        ...
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import uuid
from typing import Dict, Optional

_ENABLED_KV_KEY = b"__tracing_enabled__"

# Current trace context in this thread/task: {"trace_id", "span_id"}.
_current: contextvars.ContextVar[Optional[Dict[str, str]]] = contextvars.ContextVar(
    "rtpu_trace_ctx", default=None
)
_local_enabled: Optional[bool] = None  # cached flag; re-read after TTL
_checked_at: float = 0.0
_CACHE_TTL_S = 5.0


def _worker():
    from ray_tpu_torch._private import worker as worker_mod

    return worker_mod.global_worker


def enable():
    """Turn tracing on cluster-wide (flag in the GCS KV; every process
    re-reads it within the cache TTL)."""
    global _local_enabled, _checked_at
    w = _worker()
    if w is None:
        raise RuntimeError("ray_tpu_torch is not initialized")
    w.gcs.kv_put("", _ENABLED_KV_KEY, b"1")
    _local_enabled, _checked_at = True, time.time()


def disable():
    global _local_enabled, _checked_at
    w = _worker()
    if w is not None:
        w.gcs.kv_del("", _ENABLED_KV_KEY)
    _local_enabled, _checked_at = False, time.time()


def is_enabled() -> bool:
    """TTL-cached KV read: both enable() AND disable() propagate to every
    process within ~_CACHE_TTL_S, not just until the first cache fill."""
    global _local_enabled, _checked_at
    now = time.time()
    if _local_enabled is not None and now - _checked_at < _CACHE_TTL_S:
        return _local_enabled
    w = _worker()
    if w is None:
        return False
    try:
        _local_enabled = bool(w.gcs.kv_exists("", _ENABLED_KV_KEY))
        _checked_at = now
    except Exception:
        return bool(_local_enabled)
    return _local_enabled


def _mark_enabled():
    """Executor-side fast path: a spec carrying trace_ctx (its ``enabled``
    bit) proves tracing was on at submission — adopt that immediately
    instead of waiting out the KV cache TTL, so a fresh worker's first
    task records its spans from the first instruction."""
    global _local_enabled, _checked_at
    _local_enabled, _checked_at = True, time.time()


def current_context() -> Optional[Dict[str, str]]:
    return _current.get()

def set_context(ctx: Optional[Dict[str, str]]):
    _current.set(ctx)


def new_context() -> Dict[str, str]:
    return {"trace_id": uuid.uuid4().hex, "span_id": uuid.uuid4().hex[:16]}


def context_for_spec() -> Optional[Dict[str, str]]:
    """Called at task submission: the ctx to embed in the spec (the current
    span becomes the remote task's parent). A submission with no open span
    roots a fresh one-off trace — it is NOT installed as the caller's
    context, so unrelated submissions don't collapse into one giant trace
    hanging off a never-recorded synthetic parent.

    The ctx carries an explicit ``enabled`` bit: the executing worker
    treats a spec-borne context as proof tracing is on and marks its local
    cache (``_mark_enabled``) instead of waiting out the GCS-KV cache TTL —
    without it, a freshly started worker (or one holding a stale
    disabled-cache) silently dropped the task's early spans for up to
    ``_CACHE_TTL_S`` seconds."""
    if not is_enabled():
        return None
    ctx = _current.get()
    if ctx is None:
        ctx = new_context()
    return {**ctx, "enabled": True}


@contextlib.contextmanager
def span(name: str, attributes: Optional[dict] = None):
    """Record a named span; nests under the current task/span context."""
    if not is_enabled():
        yield None
        return
    parent = _current.get() or new_context()
    ctx = {
        "trace_id": parent["trace_id"],
        "span_id": uuid.uuid4().hex[:16],
        "parent_span_id": parent.get("span_id"),
    }
    token = _current.set(ctx)
    start = time.time()
    error = ""
    try:
        yield ctx
    except BaseException as e:
        error = repr(e)[:200]
        raise
    finally:
        end = time.time()
        _current.reset(token)
        w = _worker()
        if w is not None:
            w.task_events.record_span(
                name, start, end, ctx, attributes or {}, error
            )
        _export_span(name, start, end, ctx, attributes or {}, error)


# ------------------------------------------------------------ span export
# Pluggable exporter seam (reference: util/tracing/tracing_helper.py wires
# OpenTelemetry when installed). The runtime-native sink (task events →
# timeline) always records; an exporter additionally receives each
# finished span as a dict — set_span_exporter(fn) for custom sinks, or
# enable_otel_export() to bridge into an installed opentelemetry SDK.

_exporter = None


def set_span_exporter(fn) -> None:
    """fn({name, start, end, trace_id, span_id, parent_span_id,
    attributes, error}) called per finished span in-process."""
    global _exporter
    _exporter = fn


def _export_span(name, start, end, ctx, attributes, error):
    if _exporter is None:
        return
    try:
        _exporter({
            "name": name, "start": start, "end": end,
            "trace_id": ctx.get("trace_id"),
            "span_id": ctx.get("span_id"),
            "parent_span_id": ctx.get("parent_span_id"),
            "attributes": attributes, "error": error,
        })
    except Exception:
        pass  # an exporter bug must never fail user code


def enable_otel_export(tracer_name: str = "ray_tpu_torch") -> bool:
    """Bridge spans into an installed OpenTelemetry SDK (no-op False when
    opentelemetry is absent — the framework carries no hard dependency)."""
    try:
        from opentelemetry import trace as otel_trace
    except ImportError:
        return False
    tracer = otel_trace.get_tracer(tracer_name)

    def export(span_dict):
        otel_span = tracer.start_span(
            span_dict["name"],
            start_time=int(span_dict["start"] * 1e9),
            attributes={
                **{str(k): str(v)
                   for k, v in span_dict["attributes"].items()},
                "rtpu.trace_id": span_dict["trace_id"] or "",
                "rtpu.parent_span_id": span_dict["parent_span_id"] or "",
            },
        )
        if span_dict["error"]:
            otel_span.set_attribute("error", span_dict["error"])
        otel_span.end(end_time=int(span_dict["end"] * 1e9))

    set_span_exporter(export)
    return True
