"""The port's serve deployments on its runtime: copies of the 11 tests of
tests/test_serve.py (deployments, replicas, pow-2 routing, the HTTP proxy,
composition, recovery, batching, redeploy, autoscaling, request metrics and
the error counter), run on ``ray_tpu_torch.init(num_cpus=8)``.

The metrics test reads the ``/api/serve`` summary through the port's own
``DashboardHead`` (``ray_tpu_torch/dashboard/head.py``) over the port's GCS
client.

Every test carries its own deadline, below the conftest's 180 s default, and
the fixture's teardown is bounded (``tests/_torch_runtime.py``).
"""

import json
import os
import time
import urllib.request

import pytest

from _torch_runtime import serve_cluster  # noqa: F401


@pytest.mark.timeout(90)
def test_function_deployment(serve_cluster):
    serve = serve_cluster

    @serve.deployment
    def square(x):
        return x * x

    handle = serve.run(square.bind(), name="sq", route_prefix="/sq")
    assert handle.remote(7).result(timeout=30) == 49


@pytest.mark.timeout(90)
def test_class_deployment_two_replicas(serve_cluster):
    serve = serve_cluster

    @serve.deployment(num_replicas=2)
    class Worker:
        def __call__(self, x):
            return (os.getpid(), x + 1)

    handle = serve.run(Worker.bind(), name="w", route_prefix="/w")
    pids = set()
    for i in range(30):
        pid, val = handle.remote(i).result(timeout=30)
        assert val == i + 1
        pids.add(pid)
    assert len(pids) == 2  # pow-2 routing spreads across both replicas


@pytest.mark.timeout(90)
def test_composition(serve_cluster):
    serve = serve_cluster

    @serve.deployment
    class Preprocessor:
        def __call__(self, x):
            return x * 10

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            stage1 = self.pre.remote(x).result(timeout=30)
            return stage1 + 1

    handle = serve.run(Model.bind(Preprocessor.bind()), name="comp",
                       route_prefix="/comp")
    assert handle.remote(4).result(timeout=30) == 41


@pytest.mark.timeout(90)
def test_http_proxy(serve_cluster):
    serve = serve_cluster

    @serve.deployment
    def echo(payload=None):
        if payload is None:
            return {"hello": "world"}
        return {"got": payload}

    serve.run(echo.bind(), name="echo", route_prefix="/echo")
    port = serve.start()

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/echo", timeout=30) as r:
        assert json.loads(r.read()) == {"hello": "world"}

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/echo",
        data=json.dumps({"x": 1}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read()) == {"got": {"x": 1}}

    # Unknown route -> 404.
    try:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=30)
        assert False, "expected 404"
    except urllib.error.HTTPError as e:
        assert e.code == 404


@pytest.mark.timeout(90)
def test_replica_recovery(serve_cluster):
    import ray_tpu_torch

    serve = serve_cluster

    @serve.deployment
    class Fragile:
        def __call__(self):
            return os.getpid()

        def die(self):
            os._exit(1)

    handle = serve.run(Fragile.bind(), name="fragile", route_prefix="/fragile")
    pid1 = handle.remote().result(timeout=30)
    try:
        handle.die.remote().result(timeout=30)
    except Exception:
        pass  # the replica just died mid-call
    # The controller's reconcile loop replaces the dead replica.
    deadline = time.time() + 60
    pid2 = None
    while time.time() < deadline:
        try:
            pid2 = handle.remote().result(timeout=10)
            break
        except Exception:
            time.sleep(0.5)
    assert pid2 is not None and pid2 != pid1


@pytest.mark.timeout(90)
def test_batching(serve_cluster):
    serve = serve_cluster

    @serve.deployment(max_ongoing_requests=16)
    class Batcher:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.2)
        async def __call__(self, items):
            return [("batch", len(items), x) for x in items]

    handle = serve.run(Batcher.bind(), name="batch", route_prefix="/batch")
    responses = [handle.remote(i) for i in range(8)]
    results = [r.result(timeout=30) for r in responses]
    assert {r[2] for r in results} == set(range(8))
    # At least some calls were coalesced into a batch > 1.
    assert max(r[1] for r in results) > 1


@pytest.mark.timeout(90)
def test_redeploy_rolls_out_new_version(serve_cluster):
    serve = serve_cluster

    @serve.deployment(name="V")
    def v1():
        return "one"

    handle = serve.run(v1.bind(), name="app", route_prefix="/v")
    assert handle.remote().result(timeout=30) == "one"

    @serve.deployment(name="V")
    def v2():
        return "two"

    handle = serve.run(v2.bind(), name="app", route_prefix="/v")
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            if handle.remote().result(timeout=10) == "two":
                break
        except Exception:
            pass
        time.sleep(0.3)
    assert handle.remote().result(timeout=30) == "two"


@pytest.mark.timeout(90)
def test_autoscaling_scale_up(serve_cluster):
    import ray_tpu_torch

    serve = serve_cluster

    @serve.deployment(
        max_ongoing_requests=4,
        autoscaling_config={
            "min_replicas": 1,
            "max_replicas": 3,
            "target_ongoing_requests": 1,
            "upscale_delay_s": 0.5,
            "downscale_delay_s": 60.0,
        },
    )
    class Slow:
        def __call__(self):
            time.sleep(1.0)
            return os.getpid()

    handle = serve.run(Slow.bind(), name="slow", route_prefix="/slow")
    controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
    assert len(ray_tpu_torch.get(controller.get_replica_names.remote("slow#Slow"))) == 1

    # Sustained concurrent load >> target_ongoing_requests per replica.
    deadline = time.time() + 45
    grew = False
    pending = []
    while time.time() < deadline and not grew:
        pending = [p for p in pending if not _done(p)][:16]
        while len(pending) < 8:
            pending.append(handle.remote())
        names = ray_tpu_torch.get(controller.get_replica_names.remote("slow#Slow"))
        grew = len(names) > 1
        time.sleep(0.3)
    assert grew, "autoscaler never added a replica under load"


def _done(resp):
    try:
        resp.result(timeout=0.01)
        return True
    except Exception:
        return False


@pytest.mark.timeout(90)
@pytest.mark.fast
def test_request_metrics_and_latency_histogram_export(serve_cluster):
    """Serve telemetry: per-deployment request counters, queue/in-flight
    gauges and latency histograms flow replica -> worker metrics flush ->
    GCS -> Prometheus /metrics, and /api/serve summarizes them."""
    serve = serve_cluster

    @serve.deployment
    def tick(x):
        time.sleep(0.01)
        return x

    handle = serve.run(tick.bind(), name="metrics", route_prefix="/metrics-app")
    for i in range(6):
        assert handle.remote(i).result(timeout=30) == i

    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    port = w.gcs.ping()["metrics_port"]
    deadline = time.time() + 30
    text = ""
    while time.time() < deadline:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            text = r.read().decode()
        if ("ray_tpu_serve_request_latency_seconds_bucket" in text
                and "ray_tpu_serve_handle_latency_seconds_bucket" in text
                # the gauges can land one metrics flush behind the
                # histograms (RTPU_metrics_report_period_ms rate-limits
                # the push) — wait for every asserted series
                and "ray_tpu_serve_queue_depth" in text
                and "ray_tpu_serve_inflight_requests" in text):
            break
        time.sleep(0.5)
    # replica-side series, labeled by deployment
    assert 'ray_tpu_serve_requests_total{' in text
    assert 'deployment="metrics#tick"' in text
    assert "ray_tpu_serve_request_latency_seconds_bucket" in text
    assert "ray_tpu_serve_request_latency_seconds_count" in text
    # caller-side end-to-end histogram (flushed by the driver worker)
    assert "ray_tpu_serve_handle_latency_seconds_bucket" in text
    # gauges ride the replica's 0.5s push loop
    assert "ray_tpu_serve_queue_depth" in text
    assert "ray_tpu_serve_inflight_requests" in text

    # structured summary over the same series
    from ray_tpu_torch.dashboard.head import DashboardHead

    head = DashboardHead(w.gcs.address)
    head._gcs = w.gcs      # this process's GCS client
    status, payload = head._serve_api()
    assert status == 200
    dep = payload["deployments"]["metrics#tick"]
    assert dep["requests_total"] >= 6
    assert dep["errors_total"] == 0
    assert dep["replicas"] >= 1
    lat = dep["latency_seconds"]
    assert lat["count"] >= 6
    assert lat["mean"] >= 0.01 * 0.5
    assert lat["p50"] is not None


@pytest.mark.timeout(90)
@pytest.mark.fast
def test_request_error_counter(serve_cluster):
    serve = serve_cluster

    @serve.deployment
    def boom():
        raise ValueError("nope")

    handle = serve.run(boom.bind(), name="errs", route_prefix="/errs")
    for _ in range(2):
        try:
            handle.remote().result(timeout=30)
            assert False, "expected error"
        except Exception:
            pass

    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    deadline = time.time() + 30
    recs = []
    while time.time() < deadline:
        recs = [
            r for r in w.gcs.call(
                "GetUserMetrics",
                {"prefix": "ray_tpu_serve_request_errors_total"},
            )["records"]
            if r["labels"].get("deployment") == "errs#boom"
        ]
        if recs and sum(r["value"] for r in recs) >= 2:
            break
        time.sleep(0.5)
    assert recs and sum(r["value"] for r in recs) >= 2
