"""GCP TPU-VM node provider: create/terminate/list real TPU slices.

Counterpart of the reference's GCPNodeProvider + GCPTPUNode machinery
(reference: python/ray/autoscaler/_private/gcp/node_provider.py:63,
gcp/node.py GCPTPUNode — the reference drives the TPU REST API via
googleapiclient). This image has no cloud SDK and zero egress, so the
provider shells out to the ``gcloud compute tpus tpu-vm`` CLI instead —
the command builder is pure and the executor is injectable, which is also
how the tests record command shapes without a cloud (the reference tests
mock the discovery client the same way, gcp/test_gcp_node_provider.py).

Slice awareness: one TPU pod slice = one gcloud resource but MANY hosts.
``slice_hosts`` expands a created/listed node into its per-host network
endpoints so the launcher can bootstrap every host of a v5e-64 the way the
reference's TPUPodType handling does (gcp/config.py _get_num_tpu_visible_
chips_per_host).
"""

from __future__ import annotations

import json
import subprocess
import uuid
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

CLUSTER_LABEL = "rtpu-cluster"
TYPE_LABEL = "rtpu-node-type"


def _default_runner(argv: List[str], timeout: float) -> str:
    out = subprocess.run(argv, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(
            f"gcloud failed ({' '.join(argv[:6])}...): {out.stderr.strip()}"
        )
    return out.stdout


class GcpTpuNodeProvider(NodeProvider):
    """Provider config (cluster YAML ``provider:`` section):

        type: gcp-tpu
        project: my-project
        zone: us-central2-b

    Node types (``tpu_node_types:``) map a logical type to TPU-VM create
    arguments:

        head:   {accelerator_type: v5litepod-8, version: tpu-ubuntu2204-base}
        worker: {accelerator_type: v5litepod-16, version: tpu-ubuntu2204-base,
                 spot: true, network: default}
    """

    def __init__(self, project: str, zone: str, cluster_name: str,
                 node_types: Dict[str, dict],
                 runner: Optional[Callable[[List[str], float], str]] = None,
                 timeout_s: float = 900.0):
        self.project = project
        self.zone = zone
        self.cluster_name = cluster_name
        self.node_types = node_types
        self._run = runner or _default_runner
        self.timeout_s = timeout_s

    # ------------------------------------------------------- command builders

    def _base(self, verb: str) -> List[str]:
        return ["gcloud", "compute", "tpus", "tpu-vm", verb,
                "--project", self.project, "--zone", self.zone]

    def _create_argv(self, name: str, node_type: str) -> List[str]:
        cfg = self.node_types[node_type]
        argv = self._base("create") + [
            name,
            "--accelerator-type", cfg["accelerator_type"],
            "--version", cfg.get("version", "tpu-ubuntu2204-base"),
            "--labels",
            f"{CLUSTER_LABEL}={self.cluster_name},{TYPE_LABEL}={node_type}",
        ]
        if cfg.get("network"):
            argv += ["--network", cfg["network"]]
        if cfg.get("spot"):
            argv += ["--spot"]
        for extra in cfg.get("extra_args", []):
            argv.append(str(extra))
        return argv

    # ---------------------------------------------------------- provider API

    def create_node(self, node_type: str, count: int = 1) -> List[str]:
        created = []
        for _ in range(count):
            name = (f"{self.cluster_name}-{node_type}-"
                    f"{uuid.uuid4().hex[:6]}")
            self._run(self._create_argv(name, node_type), self.timeout_s)
            created.append(name)
        return created

    def terminate_node(self, provider_node_id: str) -> None:
        self._run(self._base("delete") + [provider_node_id, "--quiet"],
                  self.timeout_s)

    def non_terminated_nodes(self) -> Dict[str, str]:
        out = self._run(
            self._base("list")
            + ["--filter", f"labels.{CLUSTER_LABEL}={self.cluster_name}",
               "--format", "json"],
            self.timeout_s,
        )
        nodes = {}
        for rec in json.loads(out or "[]"):
            state = rec.get("state", "")
            if state in ("DELETING", "TERMINATED", "PREEMPTED"):
                continue
            name = rec["name"].rsplit("/", 1)[-1]
            nodes[name] = rec.get("labels", {}).get(TYPE_LABEL, "")
        return nodes

    # -------------------------------------------------------- slice expansion

    def describe(self, provider_node_id: str) -> dict:
        out = self._run(
            self._base("describe")
            + [provider_node_id, "--format", "json"],
            self.timeout_s,
        )
        return json.loads(out)

    def slice_hosts(self, provider_node_id: str,
                    internal: bool = True) -> List[str]:
        """Per-host IPs of one TPU slice, in worker order. A v5litepod-16 is
        one gcloud resource with 4 networkEndpoints; every host runs a
        raylet (the reference reaches them via GCPTPUNode.get_internal_ip
        per worker index)."""
        rec = self.describe(provider_node_id)
        ips = []
        for ep in rec.get("networkEndpoints", []):
            if internal:
                ips.append(ep.get("ipAddress"))
            else:
                access = ep.get("accessConfig") or {}
                ips.append(access.get("externalIp") or ep.get("ipAddress"))
        return [ip for ip in ips if ip]

    def wait_ready(self, provider_node_id: str, poll_s: float = 10.0,
                   timeout_s: float = 900.0) -> dict:
        """Poll describe until the slice is READY (reference:
        gcp/node.py is_running / _get_node polling)."""
        import time

        deadline = time.monotonic() + timeout_s
        while True:
            rec = self.describe(provider_node_id)
            if rec.get("state") == "READY":
                return rec
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"TPU {provider_node_id} not READY after {timeout_s}s "
                    f"(state={rec.get('state')})")
            time.sleep(poll_s)


def cluster_ips(provider: GcpTpuNodeProvider, config: dict) -> tuple:
    """Launcher glue: ensure the configured fleet exists and return
    (head_ip, [worker_ips...]) covering EVERY host of every slice. The
    head is host 0 of the head slice."""
    want_head = config["provider"].get("head_type", "head")
    want_workers: Dict[str, int] = dict(
        config["provider"].get("worker_types", {}))
    have = provider.non_terminated_nodes()
    head_ids = [pid for pid, t in have.items() if t == want_head]
    if not head_ids:
        head_ids = provider.create_node(want_head, 1)
    by_type: Dict[str, List[str]] = {}
    for pid, t in provider.non_terminated_nodes().items():
        by_type.setdefault(t, []).append(pid)
    for wtype, count in want_workers.items():
        missing = count - len(by_type.get(wtype, []))
        if missing > 0:
            by_type.setdefault(wtype, []).extend(
                provider.create_node(wtype, missing))
    provider.wait_ready(head_ids[0])
    head_hosts = provider.slice_hosts(head_ids[0])
    workers: List[str] = head_hosts[1:]  # extra hosts of the head slice
    for wtype in want_workers:
        for pid in by_type.get(wtype, []):
            provider.wait_ready(pid)
            workers.extend(provider.slice_hosts(pid))
    return head_hosts[0], workers


def teardown(provider: GcpTpuNodeProvider) -> List[str]:
    """Delete every slice carrying this cluster's label."""
    gone = []
    for pid in provider.non_terminated_nodes():
        provider.terminate_node(pid)
        gone.append(pid)
    return gone
