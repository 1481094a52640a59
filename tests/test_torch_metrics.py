"""ray_tpu_torch.util.metrics and ray_tpu_torch._private.flight_recorder
against the JAX package's modules, on the CPU.

Both are copies: the same calls on both packages must leave equal records
(``drain_records``) and equal rings (``dump``, ``format_tail`` with the
times masked, overflow, ``flush_to_file`` and ``read_tail_file``), and the
two modules have the same public surface. Each test drains the
process-global metric tables it touches before and after (putting back
what it found) and restores any recorder, signal handler or atexit hook it
changes, since one xdist worker runs many files in turn.

The runtime half, on a cluster of the port's runtime: a task's metrics
reach the GCS through the worker's flush and its Prometheus endpoint
renders them; the driver's ring holds the runtime's ``task.*`` and
``obj.put`` events; the raylet's ``DumpFlightRecorder`` RPC returns its
own ``lease.*`` / ``worker.*`` events and its workers' ``task.running``.
"""

import atexit
import json
import re
import signal
import time
import urllib.request

import pytest

import ray_tpu_torch
from _torch_runtime import ray_start_regular  # noqa: F401

from ray_tpu._private import flight_recorder as jfr
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch._private import flight_recorder as tfr
from ray_tpu_torch.util import metrics as tmetrics

PACKAGES = {"jax": jmetrics, "port": tmetrics}


@pytest.fixture
def clean_tables():
    """Both metric tables drained for the test; their earlier deltas put
    back afterwards."""
    saved = {k: m.drain_records() for k, m in PACKAGES.items()}
    yield
    for k, m in PACKAGES.items():
        m.drain_records()
        m.restore_records(saved[k])


def _ops_counter(m, name):
    c = m.Counter(name, "a counter", tag_keys=("route", "code"))
    c.set_default_tags({"route": "/a"})
    c.inc()
    c.inc(2.5, tags={"code": "200"})
    c.inc(0.0, tags={"route": "/b", "code": "500"})
    c.inc(1, tags={"code": "200"})


def _ops_gauge(m, name):
    g = m.Gauge(name, "a gauge", tag_keys=("node",))
    g.set(3, tags={"node": "n1"})
    g.set(-1.25, tags={"node": "n1"})
    g.set(7, tags={"node": "n2"})


def _ops_histogram(m, name):
    h = m.Histogram(name, "a histogram", boundaries=(0.5, 0.1, 2.0),
                    tag_keys=("run",))
    for x in (0.05, 0.1, 0.3, 0.5, 1.9, 2.0, 2.1, 100.0):
        h.observe(x, tags={"run": "r"})
    h.observe(0.2)


OPS = {"counter": _ops_counter, "gauge": _ops_gauge, "histogram": _ops_histogram}


def _mine(records, name):
    return sorted((r for r in records if r["name"] == name),
                  key=lambda r: sorted(r["labels"].items()))


@pytest.mark.parametrize("kind", sorted(OPS))
def test_records_equal_jax(clean_tables, kind):
    name = f"test_torch_metrics_{kind}"
    drained = {}
    for key, m in PACKAGES.items():
        OPS[kind](m, name)
        drained[key] = _mine(m.drain_records(), name)
    assert drained["port"] == drained["jax"] and drained["port"]
    # a second drain: counters and histograms were reset to deltas, gauges kept
    again = {key: _mine(m.drain_records(), name) for key, m in PACKAGES.items()}
    assert again["port"] == again["jax"]
    assert bool(again["port"]) == (kind == "gauge")


def test_restore_records_merges_deltas_like_jax(clean_tables):
    name = "test_torch_metrics_restore"
    out = {}
    for key, m in PACKAGES.items():
        _ops_counter(m, name)
        _ops_histogram(m, name + "_h")
        first = m.drain_records()
        # a failed flush: the deltas go back, stamped labels stripped
        for r in first:
            r["labels"] = {**r["labels"], "WorkerId": "w", "JobId": "j"}
        m.restore_records(first)
        _ops_counter(m, name)
        out[key] = (_mine(m.drain_records(), name),
                    _mine(m.drain_records(), name + "_h"))
    assert out["port"] == out["jax"]
    a200 = next(r for r in out["port"][0]
                if r["labels"] == {"route": "/a", "code": "200"})
    assert (a200["value"], a200["count"]) == (2 * (2.5 + 1), 4)


@pytest.mark.parametrize("case", ["undeclared_tag", "negative_inc",
                                  "no_boundaries", "no_name"])
def test_tag_and_argument_rules_equal_jax(clean_tables, case):
    errors = {}
    for key, m in PACKAGES.items():
        with pytest.raises(ValueError) as ei:
            if case == "undeclared_tag":
                m.Gauge("test_torch_metrics_tags", tag_keys=("a",)).set(
                    1, tags={"b": "x"})
            elif case == "negative_inc":
                m.Counter("test_torch_metrics_neg").inc(-1)
            elif case == "no_boundaries":
                m.Histogram("test_torch_metrics_nob")
            else:
                m.Counter("")
        errors[key] = str(ei.value)
    assert errors["port"] == errors["jax"]


# ------------------------------------------------------------ flight recorder


EVENTS = [("llm.admit", b"", "seq-3 prompt=9 hit=0 kv=0.25"),
          ("train.step", b"", "1x 0.1250s compile"),
          ("llm.prefix_hit", b"\x00\xab", 12),
          ("llm.spec_verify", b"", 0.1234567891),
          ("llm.finish", bytearray(b"\x01\x02"), "seq-3 reason=length tokens=8")]


def _feed(rec, events, times=1):
    for i in range(times):
        for ev, a, b in events:
            rec.record(ev, a, f"{b}#{i}" if times > 1 else b)


def _masked(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def _mask_times(text):
    return re.sub(r"\[\d+\.\d{3}\]", "[T]", text)


@pytest.mark.parametrize("size,times", [(64, 1), (16, 9), (100, 40)])
def test_recorder_dump_and_overflow_equal_jax(size, times):
    j, t = jfr.FlightRecorder(size), tfr.FlightRecorder(size)
    _feed(j, EVENTS, times)
    _feed(t, EVENTS, times)
    assert len(t.snapshot()) == len(j.snapshot()) == min(
        max(16, size), len(EVENTS) * times)
    assert _masked(t.dump()) == _masked(j.dump())
    assert _masked(t.dump(limit=3)) == _masked(j.dump(limit=3))
    assert _mask_times(tfr.format_tail(t.dump())) == _mask_times(
        jfr.format_tail(j.dump()))
    # the tail survives, in order
    seqs = [e["seq"] for e in t.dump()]
    assert seqs == sorted(seqs) and seqs[-1] == len(EVENTS) * times


def test_flush_to_file_and_read_tail_equal_jax(tmp_path):
    out = {}
    for key, mod in (("jax", jfr), ("port", tfr)):
        rec = mod.FlightRecorder(32)
        path = str(tmp_path / f"flight_{key}.jsonl")
        assert rec.flush_to_file() == 0            # no path: nothing written
        _feed(rec, EVENTS[:2])
        first = rec.flush_to_file(path)
        _feed(rec, EVENTS[2:])
        second = rec.flush_to_file(path)
        third = rec.flush_to_file(path)            # nothing new
        lines = [json.loads(line) for line in open(path)]
        tail = mod.read_tail_file(path, limit=2)
        missing = mod.read_tail_file(str(tmp_path / "absent.jsonl"))
        out[key] = (first, second, third, _masked(lines), _masked(tail), missing,
                    _mask_times(mod.format_tail(tail)))
    assert out["port"] == out["jax"]
    assert out["port"][:3] == (2, 3, 0)


def test_null_recorder_when_the_flag_is_off(monkeypatch):
    monkeypatch.setattr(tfr, "_recorder", None)
    monkeypatch.setenv("RTPU_TORCH_flight_recorder", "0")
    assert not tfr.enabled()
    rec = tfr.get_recorder()
    assert isinstance(rec, tfr._NullRecorder)
    tfr.record("llm.admit", b"", "x")
    assert tfr.dump() == [] and tfr.flush_to_file("/nonexistent") == 0
    # the JAX package's flag does not reach the port; the port's size flag does
    monkeypatch.setattr(tfr, "_recorder", None)
    monkeypatch.delenv("RTPU_TORCH_flight_recorder")
    monkeypatch.setenv("RTPU_flight_recorder", "0")
    monkeypatch.setenv("RTPU_TORCH_flight_recorder_size", "20")
    rec = tfr.get_recorder()
    assert isinstance(rec, tfr.FlightRecorder) and rec._ring.maxlen == 20


def test_install_exit_dump_flushes_on_sigterm_and_chains(monkeypatch, tmp_path):
    monkeypatch.setattr(tfr, "_recorder", tfr.FlightRecorder(32))
    chained = []
    before = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda signum, frame: chained.append(signum))
    path = str(tmp_path / "flight.jsonl")
    try:
        tfr.install_exit_dump(path)
        handler = signal.getsignal(signal.SIGTERM)
        tfr.record("llm.finish", b"", "seq-1 reason=eos tokens=3")
        handler(signal.SIGTERM, None)
    finally:
        atexit.unregister(tfr.flush_now)
        signal.signal(signal.SIGTERM, before)
    assert chained == [signal.SIGTERM]
    assert [e["event"] for e in tfr.read_tail_file(path)] == ["llm.finish"]
    assert tfr.get_recorder().dump_path == path


# ------------------------------------------------------------ public surface


@pytest.mark.parametrize("pair", ["metrics", "flight_recorder"])
def test_public_surface_equals_jax(pair):
    jmod, tmod = {"metrics": (jmetrics, tmetrics),
                  "flight_recorder": (jfr, tfr)}[pair]

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and getattr(vars(mod)[n], "__module__", mod.__name__) == mod.__name__}

    assert public(tmod) == public(jmod)


# ------------------------------------------------------------ runtime half


def _fetch(port) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
        return r.read().decode()


def test_worker_flush_reaches_the_gcs_endpoint(ray_start_regular):
    from ray_tpu_torch._private import worker as worker_mod

    @ray_tpu_torch.remote
    def instrumented():
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        c = Counter("port_app_requests_total", "requests", tag_keys=("route",))
        c.inc(3, tags={"route": "/infer"})
        Gauge("port_app_queue_depth", "queue").set(7)
        h = Histogram("port_app_latency_s", "latency", boundaries=[0.1, 1.0])
        h.observe(0.05)
        h.observe(0.5)
        return 1

    assert ray_tpu_torch.get(instrumented.remote()) == 1
    port = worker_mod.global_worker.gcs.ping()["metrics_port"]
    deadline = time.time() + 20  # flushed on the 1 s task-event cadence
    text = ""
    while time.time() < deadline:
        text = _fetch(port)
        if "port_app_requests_total" in text:
            break
        time.sleep(0.5)
    assert "port_app_requests_total" in text and 'route="/infer"' in text
    assert "port_app_queue_depth" in text
    assert "port_app_latency_s_count" in text and "port_app_latency_s_bucket" in text
    assert 'ray_tpu_gcs_nodes{state="ALIVE"} 1' in text


def test_runtime_events_and_the_dump_rpc(ray_start_regular):
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.rpc import IoThread, RpcClient

    @ray_tpu_torch.remote
    def f(x):
        return x + 1

    seq = max((e["seq"] for e in tfr.dump()), default=-1)
    assert ray_tpu_torch.get([f.remote(i) for i in range(3)]) == [1, 2, 3]
    ray_tpu_torch.put(b"x" * (1 << 20))
    names = {e["event"] for e in tfr.dump() if e["seq"] > seq}
    assert {"task.pending", "task.submitted", "obj.put"} <= names
    node = worker_mod.global_worker.gcs.get_all_node_info()[0]

    async def dump():
        client = RpcClient(node["ip"], node["raylet_port"])
        await client.connect()
        try:
            return await client.call("DumpFlightRecorder", {
                "limit": 500, "include_workers": True}, timeout=30)
        finally:
            await client.close()

    reply = IoThread.current().run(dump(), timeout=40)
    raylet_names = {e["event"] for e in reply["events"]}
    assert {"lease.grant", "worker.spawn"} & raylet_names
    assert reply["workers"], "no worker rings collected"
    worker_names = {e["event"] for w in reply["workers"] for e in w["events"]}
    assert "task.running" in worker_names
