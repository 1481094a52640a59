"""The port's client: drive a cluster from an outside process.

A copy of ``tests/test_client.py`` (reference: python/ray/util/client/ +
tests/test_client.py) against ``ray_tpu_torch``. The server runs as ``python
-m ray_tpu_torch.util.client.server`` in a subprocess hosting its own
single-node cluster, with the port's test flags; this test process never
calls ray_tpu_torch.init — everything goes over the client proxy."""

import os
import subprocess
import sys
import time

import pytest

from ray_tpu_torch.util import client as rc


@pytest.fixture(scope="module")
def client_server():
    env = dict(os.environ, RTPU_TORCH_VALIDATE_RPC="1", RTPU_TORCH_dashboard_agent="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.util.client.server",
         "--port", "0", "--num-cpus", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
    )
    port = None
    deadline = time.time() + 60
    while time.time() < deadline:
        line = proc.stdout.readline()
        if "client server listening on" in line:
            port = int(line.strip().rsplit(" ", 1)[1])
            break
        if proc.poll() is not None:
            raise RuntimeError("client server died: " + proc.stdout.read())
    assert port, "server did not come up"
    yield f"127.0.0.1:{port}"
    proc.terminate()
    proc.wait(timeout=20)


@pytest.fixture()
def ctx(client_server):
    c = rc.connect(client_server)
    yield c
    c.disconnect()


def test_ping_and_cluster_info(ctx):
    info = ctx.cluster_info()
    assert info["nodes"] >= 1
    assert info["resources"]["CPU"] >= 4


def test_put_get(ctx):
    ref = ctx.put({"a": [1, 2, 3]})
    assert ctx.get(ref) == {"a": [1, 2, 3]}


def test_task_roundtrip(ctx):
    def double(x):
        return x * 2

    f = ctx.remote(double)
    assert ctx.get(f.remote(21)) == 42
    # refs as args resolve server-side
    r1 = f.remote(10)
    r2 = f.remote(r1)
    assert ctx.get(r2) == 40


def test_task_with_put_arg(ctx):
    ref = ctx.put(5)

    def add(a, b):
        return a + b

    f = ctx.remote(add)
    assert ctx.get(f.remote(ref, 7)) == 12


def test_wait(ctx):
    import time as _t

    def slow(x):
        _t.sleep(x)
        return x

    f = ctx.remote(slow)
    fast, slow_ref = f.remote(0), f.remote(5)
    ready, pending = ctx.wait([fast, slow_ref], num_returns=1, timeout=30)
    assert ready == [fast] and pending == [slow_ref]


def test_actor_lifecycle(ctx):
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    A = ctx.remote(Counter)
    a = A.remote(10)
    assert ctx.get(a.incr.remote()) == 11
    assert ctx.get(a.incr.remote(5)) == 16
    ctx.kill(a)


def test_named_actor(ctx):
    class Holder:
        def value(self):
            return "named!"

    H = ctx.remote(Holder)
    h = H.options(name="client_named").remote()
    assert ctx.get(h.value.remote()) == "named!"
    h2 = ctx.get_actor("client_named")
    assert ctx.get(h2.value.remote()) == "named!"
    ctx.kill(h)


def test_options_resources(ctx):
    def cpu_heavy():
        return "ok"

    f = ctx.remote(cpu_heavy).options(num_cpus=2)
    assert ctx.get(f.remote()) == "ok"
