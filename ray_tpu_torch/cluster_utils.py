"""Multi-node-on-one-machine test cluster.

Counterpart of the reference's ray.cluster_utils.Cluster
(reference: python/ray/cluster_utils.py:135) — the single highest-leverage
test asset: N raylets as real separate processes on one machine, each
pretending to be a node, sharing one GCS. Used by multi-node scheduling,
spillback, object-transfer and failure tests without real machines.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch._private.node import Node, new_session_dir


class Cluster:
    def __init__(
        self,
        initialize_head: bool = True,
        connect: bool = False,
        head_node_args: Optional[dict] = None,
    ):
        self.session_dir = new_session_dir()
        self.nodes: List[Node] = []
        self.head_node: Optional[Node] = None
        self.gcs_address: Optional[str] = None
        if initialize_head:
            self.head_node = Node(
                head=True, session_dir=self.session_dir, node_name="head",
                **(head_node_args or {}),
            )
            self.nodes.append(self.head_node)
            self.gcs_address = self.head_node.gcs_address
            if connect:
                self.connect()

    @property
    def address(self) -> str:
        return self.gcs_address

    def connect(self):
        import ray_tpu_torch

        ray_tpu_torch.init(address=self.gcs_address)

    def add_node(
        self,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_memory: Optional[int] = None,
        node_name: str = "",
        **kwargs,
    ) -> Node:
        node = Node(
            head=False,
            gcs_address=self.gcs_address,
            resources=resources,
            labels=labels,
            object_store_memory=object_store_memory,
            session_dir=self.session_dir,
            node_name=node_name or f"node{len(self.nodes)}",
        )
        self.nodes.append(node)
        return node

    def remove_node(self, node: Node, allow_graceful: bool = True):
        node.shutdown()
        if node in self.nodes:
            self.nodes.remove(node)

    def wait_for_nodes(self, timeout: float = 30.0):
        """Block until every started node is ALIVE in the GCS."""
        from ray_tpu_torch._private.gcs.client import GcsClient

        gcs = GcsClient.from_address(self.gcs_address)
        deadline = time.time() + timeout
        want = len(self.nodes)
        while time.time() < deadline:
            alive = [n for n in gcs.get_all_node_info() if n["state"] == "ALIVE"]
            if len(alive) >= want:
                return
            time.sleep(0.1)
        raise TimeoutError(f"only {len(alive)}/{want} nodes alive after {timeout}s")

    def shutdown(self):
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        for node in self.nodes:
            node.shutdown()
        self.nodes.clear()
