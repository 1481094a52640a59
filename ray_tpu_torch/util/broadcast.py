"""Broadcast a plasma object to many nodes with tree fan-out pushes.

Reference: the object-store broadcast scalability envelope
(release/benchmarks/README.md:19 — 1 GiB to 50+ nodes) is served by the
object manager's push path (object_manager/object_manager.cc:339,
push_manager.h). Here the owner orchestrates a binary fan-out: every round,
every node that already holds a copy pushes to one node that doesn't, so a
broadcast to N nodes takes ceil(log2 N) rounds and the transfer load
spreads across holders instead of N serial pulls from the primary.

Each push rides the zero-copy transfer path: the holding raylet slices its
plasma view directly into out-of-band RPC frames (rpc.py MSG_REQUEST_OOB)
and the receiver streams the chunks from the socket straight into its
pre-created plasma buffer — no Python bytes materialization of the object
anywhere in the fan-out (raylet handle_PushObject / _receive_chunk_sink).
"""

from __future__ import annotations

import asyncio
from typing import List, Optional, Tuple

from ray_tpu_torch._private.object_ref import ObjectRef


def broadcast_object(
    ref: ObjectRef,
    node_ids: Optional[List[bytes]] = None,
    timeout: float = 300.0,
) -> dict:
    """Replicate `ref`'s plasma object onto `node_ids` (default: every
    alive node). Returns {"rounds", "transfers": [(src_node, dst_node)...],
    "nodes": final holder set}. The object must be plasma-resident (large
    object); inline objects don't need broadcasting.
    """
    from ray_tpu_torch._private.worker import get_global_worker

    worker = get_global_worker()
    return worker.io.run(
        _broadcast(worker, ref, node_ids, timeout), timeout=timeout + 30
    )


async def _broadcast(worker, ref, node_ids, timeout):
    oid = ref.object_id()
    # holder set + owner address from the owner's directory
    owner_addr = (
        list(ref.owner_address) if ref.owner_address else list(worker.address)
    )
    if tuple(owner_addr) == worker.address:
        entry = worker.memory_store.get_if_exists(oid)
        locations = set(getattr(entry, "locations", set()))
        locations |= worker._object_locations.get(oid.binary(), set())
    else:
        owner = await worker.pool.get(owner_addr[0], owner_addr[1])
        status = await owner.call(
            "GetObjectStatus", {"object_id": oid.binary(), "wait": True},
            timeout=30,
        )
        locations = set(status.get("plasma", {}).get("locations", []))
    if not locations:
        raise ValueError(
            f"object {oid.hex()[:12]} has no plasma copies — only "
            "plasma-resident (large) objects can be broadcast"
        )

    nodes = await worker.gcs_aio.get_all_node_info()
    alive = {n["node_id"]: n for n in nodes if n.get("state", "ALIVE") == "ALIVE"}
    targets = [
        n for n in (node_ids if node_ids is not None else list(alive))
        if n in alive and n not in locations
    ]

    sources = [loc for loc in locations if loc in alive]
    if not sources:
        raise ValueError("no alive holder for the object")
    transfers: List[Tuple[bytes, bytes]] = []
    rounds = 0
    pending = list(targets)
    while pending:
        rounds += 1
        wave = []
        # every current holder feeds one new target this round
        for src in list(sources):
            if not pending:
                break
            dst = pending.pop(0)
            wave.append((src, dst))

        async def push(src, dst):
            info = alive[src]
            client = await worker.pool.get(info["ip"], info["raylet_port"])
            for attempt in range(4):
                r = await client.call(
                    "PushObject",
                    {"object_id": oid.binary(), "target": dst,
                     "owner_addr": owner_addr},
                    timeout=timeout,
                )
                if r.get("ok"):
                    return dst
                # a concurrent pull/push for the same object on the target
                # is transient — let it finish and re-check
                if "progress" in str(r.get("error", "")) or "transfer" in str(
                    r.get("error", "")
                ):
                    await asyncio.sleep(0.5 * (attempt + 1))
                    continue
                break
            raise RuntimeError(
                f"push {src.hex()[:8]}->{dst.hex()[:8]} failed: "
                f"{r.get('error')}"
            )

        done = await asyncio.gather(*(push(s, d) for s, d in wave))
        transfers.extend(wave)
        sources.extend(done)
    return {
        "rounds": rounds,
        "transfers": [(s, d) for s, d in transfers],
        "nodes": sorted(set(sources)),
    }
