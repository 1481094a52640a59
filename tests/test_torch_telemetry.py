"""ray_tpu_torch.train._telemetry against ray_tpu.train._telemetry, on the
CPU.

The same step sequences, under one injected clock, go through both
packages' ``StepRecorder``: the slow-step and compile-storm flags, the
``ray_tpu_train_*`` records, the span each step call builds, the report
keys and ``publish_report_summary`` must be equal. Then the port's own
wiring: a forced ``DeviceTraceController`` window over two CPU
``TrainStep`` steps writes a Chrome trace, and ``TrainStep`` makes its
recorder current and leaves ``train.step`` events in the flight recorder.
On the port's runtime: the recorder hands each span to this process's
runtime worker as the JAX recorder hands it to its own, and a task's train
steps reach the cluster timeline. Each test drains the metric tables and
restores the current recorders it touches.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_runtime import ray_start_regular  # noqa: F401
from ray_tpu._private import worker as jworker
from ray_tpu_torch._private import worker as tworker
from ray_tpu.train import _telemetry as jtel
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch._private import flight_recorder as tfr
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.parallel.train_step import TrainStep
from ray_tpu_torch.train import _telemetry as ttel
from ray_tpu_torch.util import metrics as tmetrics

TINY = tgpt2.GPT2Config.tiny(dtype=torch.float32, n_layer=1, n_embd=64, n_head=2,
                             vocab_size=96, block_size=32)


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def isolated():
    """Both metric tables drained (earlier deltas put back afterwards) and
    both packages' current recorders restored."""
    saved = {m: m.drain_records() for m in (jmetrics, tmetrics)}
    current = (jtel.current_recorder(), ttel.current_recorder())
    yield
    for m, records in saved.items():
        m.drain_records()
        m.restore_records(records)
    jtel.set_current_recorder(current[0])
    ttel.set_current_recorder(current[1])


def _pair(clock, **kw):
    """(JAX recorder, port recorder) on one clock, without devices."""
    j = jtel.StepRecorder(clock=clock, wall_clock=clock, devices=[], n_devices=1, **kw)
    t = ttel.StepRecorder(clock=clock, wall_clock=clock, **kw)
    return j, t


# (duration, record_step keywords) sequences
STEADY_THEN_SLOW = ([(0.1, {})] * 9 + [(0.45, {})] + [(0.1, {})] * 6
                    + [(0.31, {}), (0.29, {})])
MULTI = [(0.8, dict(steps=8))] * 2 + [(0.4, dict(steps=4)), (5.0, dict(steps=2))]
STORM = ([(2.0, dict(compile_step=True))] + [(0.1, {})] * 5
         + [(1.0, dict(compile_step=True))] * 4)
SPREAD_STORM = ([(0.1, {})] * 6 + [(1.0, dict(compile_step=True)), (50.0, {}),
                                  (1.0, dict(compile_step=True)), (80.0, {}),
                                  (1.0, dict(compile_step=True))])


@pytest.mark.parametrize("seq", [STEADY_THEN_SLOW, MULTI, STORM, SPREAD_STORM],
                         ids=["slow", "multi", "storm", "spread"])
@pytest.mark.parametrize("factor", ["2", "3"])
def test_flags_match_the_jax_recorder(isolated, monkeypatch, seq, factor):
    for prefix in ("RTPU_", "RTPU_TORCH_"):
        monkeypatch.setenv(prefix + "profile_slow_step_factor", factor)
        monkeypatch.setenv(prefix + "perf_compile_storm_window_s", "60")
    clk = FakeClock()
    j, t = _pair(clk, emit_metrics=False, emit_spans=False)
    raised = []
    for dt, kw in seq:
        clk.t += dt
        for rec in (j, t):
            rec.record_step(dt, **kw)
        flags = [(rec.pop_slow_step(), rec.pop_compile_storm()) for rec in (j, t)]
        assert flags[1] == flags[0]
        raised += [f for f in flags[1] if f]
        assert t.seconds_since_last_step() == j.seconds_since_last_step() == 0.0
    clk.t += 2.5
    assert t.seconds_since_last_step() == j.seconds_since_last_step() == 2.5
    assert t.summary() == j.summary()
    if seq is STORM:
        assert any("compiles" in f for f in raised)
    if seq is STEADY_THEN_SLOW:   # 0.45 s against a 0.1 s median
        assert any("ratio" in f for f in raised)


def _records(m, run):
    return sorted((r for r in m.drain_records() if r["labels"].get("run") == run),
                  key=lambda r: (r["name"], sorted(r["labels"].items())))


def test_publish_writes_the_jax_series(isolated):
    clk = FakeClock()
    kw = dict(flops_per_token=6e6, peak_flops=1e12, run_name="parity",
              emit_spans=False, publish_interval_s=0.5)
    j, t = _pair(clk, **kw)
    calls = [(2.0, dict(compile_step=True)),
             (0.25, dict(tokens=1024, examples=8)),
             (0.2, dict(tokens=1024, examples=8)),     # inside the interval
             (0.7, dict(tokens=2048, examples=16)),
             (1.0, dict(steps=4, tokens=4096, examples=32))]
    for dt, extra in calls:
        clk.t += dt
        for rec in (j, t):
            rec.record_step(dt, **extra)
        got, want = _records(tmetrics, "parity"), _records(jmetrics, "parity")
        assert got == want and got
    names = {r["name"] for r in got}
    assert {"ray_tpu_train_steps_total", "ray_tpu_train_step_seconds",
            "ray_tpu_train_goodput_ratio", "ray_tpu_train_mfu_ratio",
            "ray_tpu_train_tokens_per_second",
            "ray_tpu_train_compile_seconds"} <= names


def test_step_timer_and_span_match_the_jax_recorder(isolated, monkeypatch):
    spans = []
    fake = SimpleNamespace(task_events=SimpleNamespace(
        record_span=lambda *args: spans.append(args)))
    monkeypatch.setattr(jworker, "global_worker", fake)
    clk = FakeClock()
    j, t = _pair(clk, emit_metrics=False)
    built = []
    real = t._emit_step_span
    monkeypatch.setattr(t, "_emit_step_span",
                        lambda *a: built.append(real(*a)) or built[-1])
    for rec in (j, t):
        with rec.step_timer() as st:
            st.tokens, st.compile_step = 512, True
            clk.t += 1.5
        clk.t -= 1.5
    clk.t += 1.5
    for rec in (j, t):
        rec.record_step(0.5, steps=2, tokens=64)
    assert len(spans) == len(built) == 2
    for want, got in zip(spans, built):
        assert got[0] == want[0] and got[1:3] == want[1:3] and got[4] == want[4]
        assert set(got[3]) == set(want[3]) and got[3]["parent_span_id"] == ""
    assert [s[0] for s in built] == ["train_step.compile", "train_step"]
    assert t.summary() == j.summary()


def test_report_keys_and_summary_gauges_match_jax(isolated):
    clk = FakeClock()
    j, t = _pair(clk, flops_per_token=6e6, peak_flops=1e12, emit_metrics=False,
                 emit_spans=False)
    jtel.set_current_recorder(None)
    ttel.set_current_recorder(None)
    assert ttel.auto_report_metrics() == jtel.auto_report_metrics() == {}
    assert ttel.request_device_trace(1) is jtel.request_device_trace(1) is False
    jtel.set_current_recorder(j)
    ttel.set_current_recorder(t)
    for dt, kw in [(2.0, dict(compile_step=True)), (0.5, dict(tokens=256, examples=4))]:
        clk.t += dt
        j.record_step(dt, **kw)
        t.record_step(dt, **kw)
    report = ttel.auto_report_metrics()
    assert report == jtel.auto_report_metrics()
    assert "telemetry/mfu" in report and "telemetry/goodput" in report
    report["user_loss"] = 1.5
    jtel.publish_report_summary(report, run_name="report-parity")
    ttel.publish_report_summary(report, run_name="report-parity")
    got = _records(tmetrics, "report-parity")
    assert got == _records(jmetrics, "report-parity") and len(got) >= 5
    assert ttel.get_or_create_recorder() is t


def test_forced_device_trace_window_over_two_cpu_steps(isolated, monkeypatch, tmp_path):
    monkeypatch.setenv("RTPU_TORCH_device_trace_force", "1")
    ts = TrainStep(TINY, device="cpu")
    assert ttel.current_recorder() is ts.telemetry
    state = ts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(0).integers(0, TINY.vocab_size, (2, 16))
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    ctl = ts.telemetry.device_trace
    assert ttel.request_device_trace(2, str(tmp_path / "window"))
    ts.step(state, batch)
    assert ctl._active and ctl.last_trace is None      # open over step 1
    ts.multi_step(state, batch, 2)
    assert not ctl._active                             # closed after call 2
    assert ctl.last_trace == str(tmp_path / "window" / "trace.json")
    with open(ctl.last_trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    read = ttel.read_device_trace(ctl.last_trace)
    assert read["window_us"] > 0 and read["busy_us"] == 0.0   # no device here
    ts.step(state, batch)                              # disarmed again
    assert not ctl._active and os.listdir(tmp_path) == ["window"]


def test_device_trace_is_a_no_op_without_cuda_or_force(isolated, monkeypatch):
    monkeypatch.delenv("RTPU_TORCH_device_trace_force", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctl = ttel.DeviceTraceController()
    assert not ctl.supported()
    ctl.request(1)
    ctl.on_step_begin()
    ctl.on_step_end()
    assert not ctl._active and ctl.last_trace is None and not ctl._armed


def test_read_device_trace_sums_kernels_and_merges_busy_intervals(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 25, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMalloc", "ts": 2, "dur": 6},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMalloc", "ts": 50, "dur": 3},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]}))
    read = ttel.read_device_trace(str(path))
    assert read["kernel_us"] == {"gemm": 35.0} and read["copy_us"] == 10.0
    assert (read["window_us"], read["busy_us"]) == (100.0, 40.0)
    assert read["busy_share"] == pytest.approx(0.4)
    assert read["runtime_us"] == {"cudaMalloc": 9.0}
    assert read["runtime_calls"] == {"cudaMalloc": 2}
    assert (read["lead_us"], read["gap_us"], read["tail_us"]) == (10.0, 20.0, 30.0)


def _train_events(after):
    return [e["b"] for e in tfr.dump() if e["seq"] > after and e["event"] == "train.step"]


def _last_seq():
    snap = tfr.get_recorder().snapshot()
    return snap[-1][0] if snap else 0


@pytest.mark.parametrize("telemetry", [True, False])
def test_train_step_records_train_step_events(isolated, telemetry):
    ts = TrainStep(TINY, device="cpu", telemetry=telemetry)
    assert (ts.telemetry is not None) == telemetry
    if telemetry:
        assert ttel.current_recorder() is ts.telemetry
    state = ts.init(torch.Generator().manual_seed(0))
    idx = np.random.default_rng(1).integers(0, TINY.vocab_size, (2, 16))
    batch = ts.shard_batch({"idx": idx, "targets": np.roll(idx, -1, axis=1)})
    before = _last_seq()
    ts.step(state, batch)
    ts.step(state, batch)
    ts.multi_step(state, batch, 3)
    got = _train_events(before)
    if telemetry:
        assert [g.split(" ")[0] for g in got] == ["1x", "1x", "3x"]
        assert got[0].endswith(" compile") and not got[1].endswith(" compile")
        drained = _records(tmetrics, "")
        steps = [r for r in drained if r["name"] == "ray_tpu_train_steps_total"]
        assert sum(r["value"] for r in steps) == 5
    else:
        assert got == ["trace+compile", "dispatch", "multi_step x3"]


def test_spans_go_to_the_runtime_worker_like_jax(isolated, monkeypatch):
    sent = {"jax": [], "port": []}
    for mod, key in ((jworker, "jax"), (tworker, "port")):
        monkeypatch.setattr(mod, "global_worker", SimpleNamespace(
            task_events=SimpleNamespace(
                record_span=lambda *a, key=key: sent[key].append(a))))
    clk = FakeClock()
    j, t = _pair(clk, emit_metrics=False)
    for rec in (j, t):
        rec.record_step(0.5, steps=2, tokens=64, compile_step=True)
        rec.record_step(0.25, steps=1, tokens=32)
    assert len(sent["jax"]) == len(sent["port"]) == 2
    for want, got in zip(sent["jax"], sent["port"]):
        assert got[0] == want[0] and got[1:3] == want[1:3] and got[4] == want[4]
        assert set(got[3]) == set(want[3])


def test_task_train_steps_reach_the_cluster_timeline(isolated, ray_start_regular):
    import time

    @ray_tpu_torch.remote
    def steps():
        from ray_tpu_torch.train import _telemetry

        rec = _telemetry.StepRecorder(emit_metrics=False)
        rec.record_step(0.01, steps=1, tokens=8, compile_step=True)
        rec.record_step(0.01, steps=1, tokens=8)
        return rec.steps

    assert ray_tpu_torch.get(steps.remote()) == 2
    deadline = time.time() + 20  # flushed on the 1 s task-event cadence
    names = set()
    while time.time() < deadline and not {"train_step", "train_step.compile"} <= names:
        names = {e.get("name") for e in ray_tpu_torch.timeline()}
        time.sleep(0.5)
    assert {"train_step", "train_step.compile"} <= names
