"""Prometheus-format metrics: registry, text rendering, HTTP endpoint.

Counterpart of the reference's stats pipeline
(reference: src/ray/stats/metric.h + metric_defs.cc ~48 OpenCensus metrics
exported through the per-node MetricsAgent to a Prometheus scrape endpoint,
python/ray/_private/metrics_agent.py:483). Here each control-plane process
(GCS, raylet) serves its own /metrics directly from one tiny asyncio HTTP
listener; user-defined metrics (ray_tpu_torch.util.metrics) are pushed to the GCS
and exported from its endpoint.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Dict, List, Optional, Tuple

# sample: (name, labels-dict, value)
Sample = Tuple[str, Dict[str, str], float]


def render_prometheus(
    samples: List[Sample], help_text: Optional[Dict[str, str]] = None
) -> str:
    """Render samples in the Prometheus text exposition format."""
    help_text = help_text or {}
    by_name: Dict[str, List[Sample]] = {}
    for s in samples:
        by_name.setdefault(s[0], []).append(s)
    out = []
    for name in sorted(by_name):
        if name in help_text:
            out.append(f"# HELP {name} {help_text[name]}")
        out.append(f"# TYPE {name} gauge")
        for _, labels, value in by_name[name]:
            if labels:
                inner = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
                )
                out.append(f"{name}{{{inner}}} {value}")
            else:
                out.append(f"{name} {value}")
    return "\n".join(out) + "\n"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


async def start_metrics_http_server(
    host: str, collect: Callable[[], str], port: int = 0
) -> Tuple[asyncio.AbstractServer, int]:
    """Serve GET /metrics (and anything else) with the collector's output."""

    async def _handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            # Read and discard the request head; we serve one document.
            try:
                await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 5.0)
            except Exception:
                return
            try:
                body = collect().encode()
                status = b"200 OK"
            except Exception as e:
                body = f"collector error: {e}".encode()
                status = b"500 Internal Server Error"
            writer.write(
                b"HTTP/1.1 " + status + b"\r\n"
                b"Content-Type: text/plain; version=0.0.4; charset=utf-8\r\n"
                + f"Content-Length: {len(body)}\r\n".encode()
                + b"Connection: close\r\n\r\n"
                + body
            )
            await writer.drain()
        finally:
            try:
                writer.close()
            except Exception:
                pass

    server = await asyncio.start_server(_handle, host, port)
    return server, server.sockets[0].getsockname()[1]
