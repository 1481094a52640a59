"""Node providers: the pluggable "launch me a node" backend.

Counterpart of the reference's NodeProvider plugin API
(reference: python/ray/autoscaler/node_provider.py:13) and the fake
multi-node provider used for cloud-free autoscaler e2e tests
(reference: autoscaler/_private/fake_multi_node/node_provider.py).
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional


class NodeProvider:
    """Minimal provider contract: launch/terminate/list, by node type."""

    def create_node(self, node_type: str, count: int = 1) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, provider_node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> Dict[str, str]:
        """provider_node_id -> node_type"""
        raise NotImplementedError


class FakeMultiNodeProvider(NodeProvider):
    """Launches REAL raylet processes on this machine, one per 'node'
    (reference: fake_multi_node/node_provider.py — autoscaler e2e without a
    cloud). Each created node joins the target cluster's GCS with the node
    type's resources/labels.
    """

    def __init__(self, gcs_address: str, node_types: Dict[str, dict], session_dir: str = ""):
        self.gcs_address = gcs_address
        self.node_types = node_types
        self.session_dir = session_dir
        self._nodes: Dict[str, dict] = {}  # provider id -> {"node": Node, "type": str}
        self._lock = threading.Lock()

    def create_node(self, node_type: str, count: int = 1) -> List[str]:
        from ray_tpu_torch._private.node import Node

        cfg = self.node_types[node_type]
        created = []
        for _ in range(count):
            pid = f"fake-{node_type}-{uuid.uuid4().hex[:6]}"
            node = Node(
                head=False,
                gcs_address=self.gcs_address,
                resources=dict(cfg.get("resources", {})),
                labels={**cfg.get("labels", {}), "node_type": node_type},
                session_dir=self.session_dir or None,
                node_name=pid,
            )
            with self._lock:
                self._nodes[pid] = {"node": node, "type": node_type}
            created.append(pid)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            rec = self._nodes.pop(provider_node_id, None)
        if rec is not None:
            rec["node"].shutdown()

    def non_terminated_nodes(self) -> Dict[str, str]:
        with self._lock:
            return {pid: rec["type"] for pid, rec in self._nodes.items()}

    def raylet_node_id(self, provider_node_id: str) -> Optional[bytes]:
        with self._lock:
            rec = self._nodes.get(provider_node_id)
        return rec["node"].node_id.binary() if rec else None

    def shutdown(self):
        with self._lock:
            nodes, self._nodes = list(self._nodes.values()), {}
        for rec in nodes:
            rec["node"].shutdown()


class CommandNodeProvider(NodeProvider):
    """Generic on-prem/provisioner provider: nodes launch and terminate
    via user-configured shell commands (reference: the local/on-prem
    provider and ssh updater stack, autoscaler/_private/local/ +
    command_runner.py — the cloud-SDK providers are that machinery with
    vendor APIs swapped in).

    Per node type:
        {"up": "ssh host1 ray-tpu-torch start --address $gcs_address",
         "down": "ssh host1 pkill -f raylet"}   # optional

    Placeholders use $-substitution ($gcs_address, $node_type,
    $provider_node_id) so shell/JSON braces in commands never need
    escaping. The "up" command must start a node that joins the cluster
    (e.g. the `ray-tpu-torch start --address` CLI); "down" tears it down.
    Commands run synchronously; the autoscaler's view of cluster
    membership comes from GCS node records as usual.
    """

    def __init__(self, gcs_address: str, node_types: Dict[str, dict],
                 command_timeout_s: float = 120.0):
        self.gcs_address = gcs_address
        self.node_types = node_types
        self.command_timeout_s = command_timeout_s
        self._nodes: Dict[str, str] = {}  # provider id -> node type
        self._lock = threading.Lock()

    def _run(self, template: str, node_type: str, pid: str):
        import string
        import subprocess

        cmd = string.Template(template).safe_substitute(
            gcs_address=self.gcs_address, node_type=node_type,
            provider_node_id=pid,
        )
        try:
            r = subprocess.run(
                cmd, shell=True, capture_output=True, text=True,
                timeout=self.command_timeout_s,
            )
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                f"provider command failed ({cmd!r}): timed out after "
                f"{self.command_timeout_s}s — NOTE: only the shell was "
                "killed; a grandchild provisioner may still be running "
                "and its node could join the cluster unrecorded"
            )
        if r.returncode != 0:
            raise RuntimeError(
                f"provider command failed ({cmd!r}):\n{r.stdout[-1000:]}"
                f"\n{r.stderr[-1000:]}"
            )

    def create_node(self, node_type: str, count: int = 1) -> List[str]:
        cfg = self.node_types[node_type]
        created = []
        for _ in range(count):
            pid = f"cmd-{node_type}-{uuid.uuid4().hex[:6]}"
            self._run(cfg["up"], node_type, pid)
            with self._lock:
                self._nodes[pid] = node_type
            created.append(pid)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        with self._lock:
            node_type = self._nodes.pop(provider_node_id, None)
        if node_type is None:
            return
        down = self.node_types.get(node_type, {}).get("down")
        if down:
            try:
                self._run(down, node_type, provider_node_id)
            except Exception:
                pass  # best effort — GCS health marks the node dead anyway

    def non_terminated_nodes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._nodes)


class RecordingNodeProvider(NodeProvider):
    """Test double that only records launch/terminate calls."""

    def __init__(self, node_types: Optional[Dict[str, dict]] = None):
        self.node_types = node_types or {}
        self.launches: List[str] = []
        self.terminations: List[str] = []
        self._nodes: Dict[str, str] = {}

    def create_node(self, node_type: str, count: int = 1) -> List[str]:
        out = []
        for _ in range(count):
            pid = f"rec-{node_type}-{len(self.launches)}"
            self.launches.append(node_type)
            self._nodes[pid] = node_type
            out.append(pid)
        return out

    def terminate_node(self, provider_node_id: str) -> None:
        self.terminations.append(provider_node_id)
        self._nodes.pop(provider_node_id, None)

    def non_terminated_nodes(self) -> Dict[str, str]:
        return dict(self._nodes)
