"""Fixtures of the port's runtime tests (``tests/test_torch_runtime*.py``).

The counterparts of ``ray_start_regular``, ``ray_start_2_cpus`` and
``shutdown_only`` in ``tests/conftest.py``, for ``ray_tpu_torch``: a test
file imports the ones it uses. Each sets the port's flags that the conftest
sets for the JAX runtime (``RTPU_TORCH_VALIDATE_RPC=1``: every RPC payload
is checked against the wire contracts; ``RTPU_TORCH_dashboard_agent=0``: no
agent process per raylet) before ``init``, and shuts down what it started.
The two runtimes are never up at once in one process.
"""

import pytest

import ray_tpu_torch


def port_env(mp: pytest.MonkeyPatch) -> None:
    mp.setenv("RTPU_TORCH_VALIDATE_RPC", "1")
    mp.setenv("RTPU_TORCH_dashboard_agent", "0")


@pytest.fixture
def ray_start_regular(monkeypatch):
    port_env(monkeypatch)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_2_cpus(monkeypatch):
    port_env(monkeypatch)
    ray_tpu_torch.init(num_cpus=2)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def shutdown_only(monkeypatch):
    port_env(monkeypatch)
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
