"""ray_tpu_torch.dashboard — the per-node agent (``agent.py``) that the
raylet spawns. The HTTP head (``ray_tpu/dashboard/head.py``) comes to the
port with ROADMAP item 11d (the operator half of 11c)."""
