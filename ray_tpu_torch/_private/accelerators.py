"""Accelerator (GPU) detection and resource shaping.

The port's counterpart of ``ray_tpu/_private/accelerators.py``, with NVIDIA
GPUs where the JAX runtime has TPU chips (reference:
python/ray/_private/accelerators/nvidia_gpu.py). A node contributes

  - ``GPU``: the cards this node may hand out,
  - the node label ``rtpu.io/gpu-name``: the first card's name.

The TPU pod-head resource (``TPU-<pod_type>-head``) and the slice labels
have no counterpart: a pod slice spans hosts, and the cards of one host need
no gang head to be leased together (ask for ``num_gpus=n``).

Detection must not import torch or call into CUDA: the raylet runs it, and
the fork server forks every worker, so a CUDA context made here would be
inherited by children that then cannot use CUDA at all. It reads, in order,
``RTPU_TORCH_num_gpus``, the process's ``CUDA_VISIBLE_DEVICES``, the
driver's ``/proc/driver/nvidia/gpus/*`` entries and ``nvidia-smi -L``.
"""

from __future__ import annotations

import glob
import os
import subprocess
from typing import Dict, List, Optional, Tuple

VISIBLE_ENV = "CUDA_VISIBLE_DEVICES"


def _visible_list() -> Optional[List[str]]:
    """The entries of this process's ``CUDA_VISIBLE_DEVICES``, or None when
    it is unset. An empty value hides every card."""
    env = os.environ.get(VISIBLE_ENV)
    if env is None:
        return None
    return [x.strip() for x in env.split(",") if x.strip()]


def _smi_names() -> List[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=10,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    # "GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-...)"
    return [
        line.split(":", 1)[1].split("(UUID")[0].strip()
        for line in out.splitlines() if line.startswith("GPU ")
    ]


def _proc_names() -> List[str]:
    names = []
    for d in sorted(glob.glob("/proc/driver/nvidia/gpus/*")):
        name = ""
        try:
            with open(os.path.join(d, "information")) as f:
                for line in f:
                    if line.startswith("Model:"):
                        name = line.split(":", 1)[1].strip()
                        break
        except OSError:
            pass
        names.append(name)
    return names


def num_gpus() -> int:
    """Cards this process may use, counted without CUDA."""
    from ray_tpu_torch._private.config import CONFIG

    if CONFIG.num_gpus >= 0:
        return int(CONFIG.num_gpus)
    visible = _visible_list()
    if visible is not None:
        return len(visible)
    n = len(_proc_names())
    return n if n else len(_smi_names())


def gpu_name() -> str:
    names = _proc_names()
    if not any(names):
        names = _smi_names()
    return names[0] if names and names[0] else ""


def node_resources_and_labels() -> Tuple[Dict[str, float], Dict[str, str]]:
    resources: Dict[str, float] = {}
    labels: Dict[str, str] = {}
    n = num_gpus()
    if n > 0:
        resources["GPU"] = float(n)
        name = gpu_name()
        if name:
            labels["rtpu.io/gpu-name"] = name
    return resources, labels


def visible_gpu_env(indices) -> Dict[str, str]:
    """Env vars limiting a worker to the node's GPUs ``indices`` (0..n-1),
    mapped through the node's own ``CUDA_VISIBLE_DEVICES``: a node that
    sees ``"2,3"`` hands out ``"2"`` for index 0 (reference:
    CUDA_VISIBLE_DEVICES in nvidia_gpu.py)."""
    visible = _visible_list()
    ids = [str(int(i)) if visible is None else visible[int(i)] for i in indices]
    return {VISIBLE_ENV: ",".join(ids)}
