"""Node: process supervisor that boots and monitors cluster services.

Counterpart of the reference's Node
(reference: python/ray/_private/node.py — start_head_processes :1353,
start_gcs_server :1150, start_raylet :1181). A head node starts the GCS then a
raylet; worker nodes start only a raylet pointed at an existing GCS. Service
ports are communicated back through port files (the reference uses the same
trick via redis/GCS registration).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Dict, Optional

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import NodeID


def _wait_port_file(path: str, proc: subprocess.Popen, timeout: float = 30.0) -> int:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"process exited with code {proc.returncode} before publishing port "
                f"(see logs next to {path})"
            )
        if os.path.exists(path):
            with open(path) as f:
                content = f.read().strip()
            if content:
                return int(content)
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {path}")


def new_session_dir(base: Optional[str] = None) -> str:
    base = base or os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    session = os.path.join(base, f"session_{time.strftime('%Y-%m-%d_%H-%M-%S')}_{os.getpid()}_{uuid.uuid4().hex[:6]}")
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    return session


class Node:
    """Starts/monitors gcs_server and raylet subprocesses on this machine."""

    def __init__(
        self,
        head: bool = False,
        gcs_address: Optional[str] = None,
        host: str = "127.0.0.1",
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
        session_dir: Optional[str] = None,
        node_name: str = "",
        gcs_port: int = 0,
    ):
        if not head and not gcs_address:
            raise ValueError("worker node requires gcs_address")
        self.head = head
        self.host = host
        self.session_dir = session_dir or new_session_dir()
        self.node_id = NodeID.from_random()
        self.node_name = node_name or self.node_id.hex()[:8]
        self.resources = dict(resources or {})
        self.labels = dict(labels or {})
        self.object_store_memory = object_store_memory
        self.processes: Dict[str, subprocess.Popen] = {}
        self.gcs_address = gcs_address
        self.raylet_port: Optional[int] = None
        self.gcs_port: Optional[int] = None
        self._shutting_down = False
        self._gcs_monitor: Optional[threading.Thread] = None
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        if head:
            self._start_gcs(port=gcs_port)
            self._gcs_monitor = threading.Thread(
                target=self._monitor_gcs, name="gcs-monitor", daemon=True
            )
            self._gcs_monitor.start()
        self._start_raylet()

    def _log_files(self, name: str):
        log_dir = os.path.join(self.session_dir, "logs")
        return (
            open(os.path.join(log_dir, f"{name}.out"), "ab"),
            open(os.path.join(log_dir, f"{name}.err"), "ab"),
        )

    def _env(self):
        env = dict(os.environ)
        from ray_tpu_torch._private import repo_root as _repo_root

        repo_root = _repo_root()
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        return env

    def _start_gcs(self, port: int = 0):
        port_file = os.path.join(self.session_dir, f"gcs_port_{self.node_name}")
        # Always clear the stale port file: on a fixed-port restart a
        # leftover file would make _wait_port_file report success even when
        # the new GCS died at startup.
        if os.path.exists(port_file):
            os.remove(port_file)
        out, err = self._log_files("gcs_server")
        proc = subprocess.Popen(
            [
                sys.executable, "-m", "ray_tpu_torch._private.gcs.server",
                f"--host={self.host}",
                f"--port={port}",
                f"--session-dir={self.session_dir}",
                f"--port-file={port_file}",
            ],
            stdout=out, stderr=err, env=self._env(), start_new_session=True,
        )
        self.processes["gcs_server"] = proc
        self.gcs_port = _wait_port_file(port_file, proc)
        self.gcs_address = f"{self.host}:{self.gcs_port}"

    def _monitor_gcs(self):
        """Restart the GCS if it dies unexpectedly (same port, same log).

        The GCS replays <session_dir>/gcs.log on startup and the cluster
        resumes: raylets/workers retry their connections and re-register
        (reference: GCS fault tolerance via Redis persistence + client-side
        gcs_rpc_server_reconnect_timeout_s).
        """
        backoff = 0.5
        while not self._shutting_down:
            proc = self.processes.get("gcs_server")
            if proc is not None and proc.poll() is not None and not self._shutting_down:
                try:
                    self._start_gcs(port=self.gcs_port or 0)
                    backoff = 0.5
                except Exception:
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 10.0)
                    continue
                if self._shutting_down:
                    # shutdown() raced our restart; don't leak the new GCS.
                    try:
                        self.processes["gcs_server"].kill()
                    except Exception:
                        pass
            time.sleep(0.2)

    def _start_raylet(self):
        port_file = os.path.join(self.session_dir, f"raylet_port_{self.node_name}")
        # a node of the same name earlier in the session (Cluster names a
        # node after the count of live ones) left its port here
        try:
            os.unlink(port_file)
        except FileNotFoundError:
            pass
        out, err = self._log_files(f"raylet_{self.node_name}")
        cmd = [
            sys.executable, "-m", "ray_tpu_torch._private.raylet.main",
            f"--host={self.host}",
            f"--gcs-address={self.gcs_address}",
            f"--node-id={self.node_id.hex()}",
            f"--resources={json.dumps(self.resources)}",
            f"--labels={json.dumps(self.labels)}",
            f"--session-dir={self.session_dir}",
            f"--port-file={port_file}",
        ]
        if self.head:
            cmd.append("--is-head")
        if self.object_store_memory:
            cmd.append(f"--object-store-memory={self.object_store_memory}")
        proc = subprocess.Popen(
            cmd, stdout=out, stderr=err, env=self._env(), start_new_session=True
        )
        self.processes[f"raylet_{self.node_name}"] = proc
        self.raylet_port = _wait_port_file(port_file, proc)

    @property
    def raylet_address(self):
        return (self.host, self.raylet_port)

    def kill_raylet(self):
        """Fault-injection: kill this node's raylet (chaos testing)."""
        for name, proc in self.processes.items():
            if name.startswith("raylet"):
                proc.kill()

    def kill_gcs(self):
        """Fault-injection: kill -9 the GCS (the monitor restarts it)."""
        proc = self.processes.get("gcs_server")
        if proc is not None:
            proc.kill()

    def shutdown(self):
        self._shutting_down = True
        had_raylet = any(name.startswith("raylet") for name in self.processes)
        if self._gcs_monitor is not None and self._gcs_monitor.is_alive():
            # Let an in-flight restart finish (and self-reap) before we
            # sweep self.processes, so no freshly-spawned GCS escapes.
            self._gcs_monitor.join(timeout=5.0)
        for proc in self.processes.values():
            try:
                proc.terminate()
            except Exception:
                pass
        deadline = time.time() + 3
        for proc in self.processes.values():
            try:
                proc.wait(max(0.1, deadline - time.time()))
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass
        self.processes.clear()
        if had_raylet:
            # A raylet unlinks its store's segment on SIGTERM; one killed
            # outright (kill_raylet, a crash) leaves it in /dev/shm.
            try:
                os.unlink(f"/dev/shm/rtpu_torch_plasma_{self.node_id.hex()[:12]}")
            except OSError:
                pass
