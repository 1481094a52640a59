"""The port's perf regression plane: comparator + ledger + storm detection
+ analysis, a copy of ``tests/test_perf_gate.py`` over ``ray_tpu_torch``
(its ``bench.py`` cases stay with the JAX package, whose bench it is), plus
the comparator, the report and the bands held against the JAX package's on
the same inputs, and the port's own ledger.

Contracts under test:
  - a synthetically injected 2x slowdown in one microbench metric trips the
    gate; in-band jitter (inside the documented noise bands) passes;
  - the ledger round-trips: append -> load_baseline/load_history -> compare;
  - `ray-tpu perf compare` (the CI A/B path) accepts both microbench.v1 and
    the legacy plain {metric: value} format and exits 1 on regression;
  - the StepRecorder flags a post-warmup jit-compile storm and the watchdog
    promotes it to a jit_cache_miss_storm GCS incident;
  - incident auto-analysis extracts top stacks / compile share / scheduling
    delay from an attached merged-profile capture and writes a
    human-readable summary into the incident record;
  - tier-1 smoke: `ray-tpu perf check --only ... --quick` runs the real
    microbench subset end-to-end and appends to the ledger.
"""

import json
import os

import pytest

from ray_tpu_torch._private import perf_analysis as pa
from ray_tpu_torch._private import perf_gate as pg


# ------------------------------------------------------------- comparator


@pytest.mark.fast
def test_synthetic_regression_trips_gate():
    base = {"single_client_tasks_sync": 1000.0}
    cur = {"single_client_tasks_sync": 500.0}  # injected 2x slowdown
    report = pg.compare(base, cur, base_reps=3, cur_reps=3)
    assert report["status"] == "fail"
    assert report["regressions"] == ["single_client_tasks_sync"]
    row = report["metrics"]["single_client_tasks_sync"]
    assert row["status"] == "regression" and row["ratio"] == 0.5
    # even the widest single-rep band catches a 2x collapse
    report1 = pg.compare(base, cur, base_reps=1, cur_reps=1)
    assert report1["status"] == "fail"


@pytest.mark.fast
def test_in_band_jitter_passes():
    base = {"single_client_tasks_sync": 1000.0,
            "multi_client_tasks_async": 3000.0}
    # -20% on a 25%-band metric, -30% on a 35%-band (multi-process) metric
    cur = {"single_client_tasks_sync": 800.0,
           "multi_client_tasks_async": 2100.0}
    report = pg.compare(base, cur, base_reps=3, cur_reps=3)
    assert report["status"] == "pass", report
    assert not report["regressions"]
    # the same -30% on the tighter default band IS a regression: the bands
    # are per-metric, not one global number
    report2 = pg.compare({"single_client_tasks_sync": 1000.0},
                         {"single_client_tasks_sync": 700.0},
                         base_reps=3, cur_reps=3)
    assert report2["status"] == "fail"


@pytest.mark.fast
def test_band_selection_and_statuses():
    # band widens when either side is single-rep (min of the two)
    assert pg.noise_band("single_client_tasks_sync", 3) < pg.noise_band(
        "single_client_tasks_sync", 1)
    assert pg.noise_band("multi_client_tasks_async", 3) > pg.noise_band(
        "single_client_tasks_sync", 3)
    report = pg.compare({"a": 100.0, "gone": 50.0},
                        {"a": 300.0, "fresh": 10.0},
                        base_reps=3, cur_reps=3)
    # out-of-band rises are flagged as improvements, not silently passed
    assert report["metrics"]["a"]["status"] == "improved"
    assert "a" in report["improvements"]
    # metric coverage changes are informational, never failures
    assert report["metrics"]["fresh"]["status"] == "new"
    assert report["metrics"]["gone"]["status"] == "missing"
    assert report["status"] == "pass"


@pytest.mark.fast
def test_band_scale_env_override(monkeypatch):
    base = pg.noise_band("single_client_tasks_sync", 3)
    monkeypatch.setenv("RTPU_TORCH_perf_band_scale", "2.0")
    assert pg.noise_band("single_client_tasks_sync", 3) == pytest.approx(
        2.0 * base)


# ----------------------------------------------------------------- ledger


@pytest.mark.fast
def test_ledger_append_compare_roundtrip(tmp_path):
    path = str(tmp_path / "hist.jsonl")
    assert pg.load_history(path=path) == []
    assert pg.load_baseline(path=path) is None
    pg.append_history({"m": 100.0}, path=path, reps=3, note="r1")
    pg.append_history({"m": 104.0, "k": 7.0}, path=path, reps=3, note="r2")
    entries = pg.load_history(path=path)
    assert [e["note"] for e in entries] == ["r1", "r2"]
    base = pg.load_baseline(path=path)
    assert base["metrics"] == {"m": 104.0, "k": 7.0} and base["reps"] == 3
    report = pg.compare(entries[0]["metrics"], entries[1]["metrics"],
                        entries[0]["reps"], entries[1]["reps"])
    assert report["status"] == "pass"
    assert report["metrics"]["m"]["status"] == "pass"
    # a torn line must not brick the ledger
    with open(path, "a") as f:
        f.write('{"metrics": {"m": 99')
    assert len(pg.load_history(path=path)) == 2


@pytest.mark.fast
def test_load_result_formats(tmp_path):
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({
        "schema": "microbench.v1", "reps": 3,
        "metrics": {"m": {"value": 10.0, "min": 9.0, "median": 10.0,
                          "max": 11.0, "reps": 3}},
    }))
    metrics, reps = pg.load_result(str(v1))
    assert metrics == {"m": 10.0} and reps == 3
    legacy = tmp_path / "legacy.json"
    legacy.write_text('{"m": 5.5}\n')
    metrics, reps = pg.load_result(str(legacy))
    assert metrics == {"m": 5.5} and reps == 1


@pytest.mark.fast
def test_perf_compare_cli_gates_regression(tmp_path, capsys):
    from ray_tpu_torch import scripts

    base = tmp_path / "base.json"
    head = tmp_path / "head.json"
    base.write_text(json.dumps({
        "schema": "microbench.v1", "reps": 3,
        "metrics": {"single_client_tasks_sync": {"value": 1000.0}}}))
    head.write_text('{"single_client_tasks_sync": 400.0}')  # legacy format
    out_file = tmp_path / "delta.json"
    with pytest.raises(SystemExit) as e:
        scripts.main(["perf", "compare", str(base), str(head),
                      "-o", str(out_file)])
    assert e.value.code == 1
    report = json.loads(out_file.read_text())
    assert report["status"] == "fail"
    assert "single_client_tasks_sync" in report["regressions"]
    assert "regression" in capsys.readouterr().out.lower()
    # passing pair exits cleanly
    head.write_text('{"single_client_tasks_sync": 950.0}')
    scripts.main(["perf", "compare", str(base), str(head)])


@pytest.mark.fast
def test_load_result_entry_carries_host_cpus(tmp_path):
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({
        "schema": "microbench.v1", "reps": 3, "host": {"cpus": 8},
        "metrics": {"m": {"value": 10.0}}}))
    entry = pg.load_result_entry(str(v1))
    assert entry["metrics"] == {"m": 10.0}
    assert entry["reps"] == 3 and entry["cpus"] == 8
    legacy = tmp_path / "legacy.json"
    legacy.write_text('{"m": 5.5}\n')
    entry = pg.load_result_entry(str(legacy))
    assert entry["cpus"] is None  # predates host.cpus: unknown, not wrong


@pytest.mark.fast
def test_perf_compare_annotates_core_count_mismatch(monkeypatch, tmp_path,
                                                    capsys):
    """A 1-core measurement compared against a multi-core one must never
    silently gate: the report is annotated, and --skip-noisy skips it.
    (is_noisy_runner is pinned False so the single-core skip path of the
    box running this test doesn't shadow the mismatch path.)"""
    from ray_tpu_torch import scripts

    monkeypatch.setattr(pg, "is_noisy_runner", lambda: False)
    base = tmp_path / "base.json"
    head = tmp_path / "head.json"
    base.write_text(json.dumps({
        "schema": "microbench.v1", "reps": 3, "host": {"cpus": 8},
        "metrics": {"multi_client_tasks_async": {"value": 20000.0}}}))
    head.write_text(json.dumps({
        "schema": "microbench.v1", "reps": 3, "host": {"cpus": 1},
        "metrics": {"multi_client_tasks_async": {"value": 3000.0}}}))
    out_file = tmp_path / "delta.json"
    # annotated (and still gating) without --skip-noisy
    with pytest.raises(SystemExit) as e:
        scripts.main(["perf", "compare", str(base), str(head),
                      "-o", str(out_file)])
    assert e.value.code == 1
    report = json.loads(out_file.read_text())
    assert report["host_mismatch"] == {"baseline_cpus": 8, "current_cpus": 1}
    assert "cpus" in capsys.readouterr().out
    # --skip-noisy: cross-core-count comparison skipped cleanly (exit 0)
    scripts.main(["perf", "compare", str(base), str(head), "--skip-noisy",
                  "-o", str(out_file)])
    report = json.loads(out_file.read_text())
    assert report["status"] == "skipped"
    assert "core-count mismatch" in report["reason"]
    # same-core-count comparisons are untouched by the new path
    head.write_text(json.dumps({
        "schema": "microbench.v1", "reps": 3, "host": {"cpus": 8},
        "metrics": {"multi_client_tasks_async": {"value": 19000.0}}}))
    scripts.main(["perf", "compare", str(base), str(head)])


@pytest.mark.fast
def test_perf_check_advisory_on_host_mismatch(monkeypatch, tmp_path):
    """`perf check` against a ledger head recorded on a different core
    count demotes regressions to advisory (the 1-core-CI-vs-multi-core
    guard), unless --strict."""
    from ray_tpu_torch import scripts

    hist = tmp_path / "hist.jsonl"
    entry = {"time": 1.0, "reps": 1, "host": {"cpus": 64},
             "metrics": {"single_client_tasks_sync": 1_000_000.0}}
    hist.write_text(json.dumps(entry) + "\n")
    monkeypatch.setattr(pg, "run_microbench", lambda only=None, quick=True: {
        "schema": "microbench.v1", "reps": 1,
        "host": {"cpus": os.cpu_count()},
        "metrics": {"single_client_tasks_sync": {"value": 10.0}}})
    monkeypatch.setattr(pg, "is_noisy_runner", lambda: False)
    # huge drop, but measured on a different box shape: advisory exit 0
    scripts.main(["perf", "check", "--history", str(hist)])
    # --strict restores the hard failure
    with pytest.raises(SystemExit) as e:
        scripts.main(["perf", "check", "--history", str(hist), "--strict"])
    assert e.value.code == 1


@pytest.mark.fast
def test_perf_check_advisory_on_noisy_runner(monkeypatch, tmp_path):
    """Cross-time ledger comparisons on a single-core box can't tell
    co-tenant load from a code regression: `perf check` downgrades to
    advisory (exit 0 + flagged report) there unless --strict; multi-core
    boxes and the CI A/B path stay strict."""
    from ray_tpu_torch import scripts

    ledger = str(tmp_path / "h.jsonl")
    pg.append_history({"m": 1000.0}, path=ledger, reps=3)
    canned = {"schema": "microbench.v1", "reps": 1,
              "metrics": {"m": {"value": 100.0}}}
    monkeypatch.setattr(pg, "run_microbench", lambda **kw: canned)
    monkeypatch.setattr(pg, "is_noisy_runner", lambda: True)
    scripts.main(["perf", "check", "--history", ledger,
                  "-o", str(tmp_path / "r.json")])  # no SystemExit
    rep = json.loads((tmp_path / "r.json").read_text())
    assert rep["status"] == "fail" and rep["advisory"] is True
    with pytest.raises(SystemExit) as e:
        scripts.main(["perf", "check", "--history", ledger, "--strict"])
    assert e.value.code == 1
    monkeypatch.setattr(pg, "is_noisy_runner", lambda: False)
    with pytest.raises(SystemExit) as e:
        scripts.main(["perf", "check", "--history", ledger])
    assert e.value.code == 1


# ------------------------------------------------- compile-storm detection


def _manual_clock():
    t = {"now": 1000.0}

    def clock():
        return t["now"]

    return t, clock


def _recorder(clock):
    from ray_tpu_torch.train._telemetry import StepRecorder

    return StepRecorder(emit_metrics=False, emit_spans=False, clock=clock,
                        wall_clock=clock, device="cpu")


@pytest.mark.fast
def test_compile_storm_detection_after_warmup():
    t, clock = _manual_clock()
    rec = _recorder(clock)
    # warmup: the first compile is expected and never counted
    rec.record_step(1.0, compile_step=True)
    for _ in range(6):
        t["now"] += 0.1
        rec.record_step(0.1)
    assert rec.pop_compile_storm() is None
    # three post-warmup recompiles inside the window (default K=3, 120s)
    for _ in range(3):
        t["now"] += 1.0
        rec.record_step(0.5, compile_step=True)
    storm = rec.pop_compile_storm()
    assert storm is not None and storm["compiles"] >= 3
    assert storm["step"] == rec.steps
    assert rec.pop_compile_storm() is None  # cleared on read


@pytest.mark.fast
def test_compile_storm_respects_window():
    t, clock = _manual_clock()
    rec = _recorder(clock)
    rec.record_step(1.0, compile_step=True)
    for _ in range(6):
        t["now"] += 0.1
        rec.record_step(0.1)
    # compiles spread far wider than the 120s window never accumulate
    for _ in range(4):
        t["now"] += 200.0
        rec.record_step(0.5, compile_step=True)
    assert rec.pop_compile_storm() is None


class _StubGcs:
    def __init__(self):
        self.calls = []

    def call(self, method, payload, timeout=None):
        self.calls.append((method, payload))
        return {"ok": True}

    def get_all_node_info(self):
        return []


class _StubCore:
    mode = "driver"
    node_id = None
    is_shutdown = False
    worker_id = b"\x01" * 16
    tasks_completed = 0
    _pending_tasks = {}
    session_dir = ""

    def __init__(self):
        self.gcs = _StubGcs()


def test_watchdog_promotes_storm_to_incident(monkeypatch):
    # incident publishing must not depend on a live cluster capture
    monkeypatch.setenv("RTPU_TORCH_profile_on_incident", "0")
    from ray_tpu_torch._private.watchdog import StallWatchdog
    from ray_tpu_torch.train import _telemetry

    t, clock = _manual_clock()
    rec = _recorder(clock)
    rec.record_step(1.0, compile_step=True)
    for _ in range(6):
        t["now"] += 0.1
        rec.record_step(0.1)
    for _ in range(3):
        t["now"] += 1.0
        rec.record_step(0.5, compile_step=True)
    prev = _telemetry.current_recorder()
    _telemetry.set_current_recorder(rec)
    try:
        core = _StubCore()
        wd = StallWatchdog(core)
        wd.check()
        incidents = [p["incident"] for m, p in core.gcs.calls
                     if m == "ReportIncident"]
        storms = [i for i in incidents if i["kind"] == "jit_cache_miss_storm"]
        assert storms, incidents
        inc = storms[0]
        assert inc["compile_storm"]["compiles"] >= 3
        assert "retraced" in inc["detail"]
        # rate-limited: an immediate second storm does not refire
        rec.record_step(0.5, compile_step=True)
        rec.record_step(0.5, compile_step=True)
        rec.record_step(0.5, compile_step=True)
        wd.check()
        incidents2 = [p["incident"] for m, p in core.gcs.calls
                      if m == "ReportIncident"
                      and p["incident"]["kind"] == "jit_cache_miss_storm"]
        assert len(incidents2) == 1
    finally:
        _telemetry.set_current_recorder(prev)


# ------------------------------------------------------ incident analysis


def _synthetic_trace():
    node = {"pid": "node:aa", "tid": "cpu:worker:1:MainThread"}
    return {"traceEvents": [
        {"cat": "cpu_sample", "ph": "X", "ts": 0.0, "dur": 600_000.0,
         "name": "compile",
         "args": {"stack": "MainThread;train;jax;pxla;backend_compile",
                  "samples": 60}, **node},
        {"cat": "cpu_sample", "ph": "X", "ts": 0.0, "dur": 400_000.0,
         "name": "read_batch",
         "args": {"stack": "MainThread;input;read_batch", "samples": 40},
         **node},
        {"cat": "span", "ph": "X", "ts": 0.0, "dur": 500_000.0,
         "name": "train_step.compile", **node},
        {"cat": "span", "ph": "X", "ts": 500_000.0, "dur": 500_000.0,
         "name": "train_step", **node},
        {"cat": "task_flow", "ph": "s", "id": "t1", "ts": 0.0, **node},
        {"cat": "task_flow", "ph": "f", "id": "t1", "ts": 250_000.0, **node},
        {"cat": "task", "ph": "X", "ts": 250_000.0, "dur": 750_000.0,
         "name": "f", **node},
    ]}


@pytest.mark.fast
def test_analyze_trace_extracts_shares():
    a = pa.analyze_trace(_synthetic_trace())
    assert a["cpu_seconds"] == pytest.approx(1.0)
    assert a["top_stacks"][0]["stack"].endswith("backend_compile")
    assert a["top_stacks"][0]["share"] == pytest.approx(0.6)
    assert a["compile_share"] == pytest.approx(0.6)
    assert a["compile_span_share"] == pytest.approx(0.5)
    assert a["sched_delay"]["count"] == 1
    assert a["sched_delay"]["max_ms"] == pytest.approx(250.0)
    assert a["sched_delay"]["share"] == pytest.approx(0.25)


@pytest.mark.fast
def test_attach_analysis_writes_summary_into_incident(tmp_path):
    path = tmp_path / "capture.json"
    path.write_text(json.dumps(_synthetic_trace()))
    inc = {"kind": "jit_cache_miss_storm", "profile_path": str(path)}
    assert pa.attach_analysis(inc)
    summary = inc["analysis"]["summary"]
    assert "compile" in summary and "scheduling delay" in summary
    assert "recompilation" in summary  # storm-specific hint
    assert inc["analysis"]["top_stacks"]
    # no capture / unreadable capture leaves the incident untouched
    assert not pa.attach_analysis({"kind": "slow_step"})
    assert not pa.attach_analysis(
        {"kind": "slow_step", "profile_path": str(tmp_path / "gone.json")})


def test_watchdog_incident_carries_analysis(monkeypatch, tmp_path):
    """The full wiring: the watchdog's publish path attaches the analysis
    derived from the incident's capture before it reaches the GCS."""
    monkeypatch.setenv("RTPU_TORCH_profile_on_incident", "0")
    from ray_tpu_torch._private.watchdog import StallWatchdog

    path = tmp_path / "capture.json"
    path.write_text(json.dumps(_synthetic_trace()))
    core = _StubCore()
    wd = StallWatchdog(core)
    incident = {"kind": "slow_step", "detail": "x", "status": "open",
                "profile_path": str(path)}
    wd._publish(incident, b"")
    sent = [p["incident"] for m, p in core.gcs.calls
            if m == "ReportIncident"][0]
    assert "analysis" in sent
    assert "compile" in sent["analysis"]["summary"]


# ------------------------------------------------------- dashboard surface


@pytest.mark.fast
def test_dashboard_perf_api_serves_ledger_and_delta(monkeypatch, tmp_path):
    path = str(tmp_path / "hist.jsonl")
    pg.append_history({"m": 100.0}, path=path, reps=3, note="r1")
    pg.append_history({"m": 40.0}, path=path, reps=3, note="r2")
    monkeypatch.setenv("RTPU_TORCH_perf_history_path", path)
    from ray_tpu_torch.dashboard.head import DashboardHead

    # no live GCS behind this address: the ledger half must still serve
    head = DashboardHead("127.0.0.1:1")

    def _refused():
        raise ConnectionRefusedError("no GCS at 127.0.0.1:1")

    # refuse at once (a client's connect to a dead address retries ~30 s)
    monkeypatch.setattr(head, "_gcs_client", _refused)
    status, out = head._perf_api({"metric": "m"})
    assert status == 200
    assert [e["note"] for e in out["history"]] == ["r1", "r2"]
    assert out["delta"]["status"] == "fail"
    assert out["delta"]["metrics"]["m"]["status"] == "regression"
    assert [p["value"] for p in out["series"]] == [100.0, 40.0]
    status, out = head._perf_api({"limit": "notanint"})
    assert status == 400


# ----------------------------------------------------------- tier-1 smoke


@pytest.mark.timeout(170)
def test_perf_check_only_smoke(tmp_path):
    """`ray-tpu perf check --only single_client_put_calls --quick` runs the
    REAL microbench subset in a subprocess, passes on a clean tree (no
    baseline -> every metric lands as `new`), and --update seeds the
    ledger; the second comparison path is covered by the fast unit tests
    above (a second live run would double the smoke's wall time)."""
    from ray_tpu_torch import scripts

    ledger = str(tmp_path / "hist.jsonl")
    rc = 0
    try:
        scripts.main(["perf", "check", "--only", "single_client_put_calls",
                      "--quick", "--history", ledger, "--update",
                      "-o", str(tmp_path / "report.json")])
    except SystemExit as e:
        rc = e.code or 0
    assert rc == 0
    entries = pg.load_history(path=ledger)
    assert len(entries) == 1
    assert entries[0]["metrics"]["single_client_put_calls"] > 0
    assert entries[0]["reps"] == 1 and entries[0]["quick"]
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["status"] == "pass"
    assert (report["metrics"]["single_client_put_calls"]["status"] == "new")


# ------------------------------------------------- against the JAX package


def _metric_pairs(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    names = ["single_client_tasks_sync", "multi_client_tasks_async",
             "single_client_put_gigabytes", "serve_llm_stream_p99_ms",
             "serve_llm_spec_acceptance", "wait_1k_refs", "other_row"]
    base = {n: float(rng.uniform(1, 1000)) for n in names
            if rng.random() < 0.85}
    cur = {n: (base.get(n) or 100.0) * float(rng.uniform(0.3, 2.5))
           for n in names if rng.random() < 0.85}
    return base, cur


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("reps", [(1, 1), (3, 3), (3, 1)])
def test_compare_and_report_match_the_jax_package(seed, reps):
    """The same two metric dicts give the same delta report and the same
    rendered table under both gates."""
    from ray_tpu._private import perf_gate as jax_pg

    base, cur = _metric_pairs(seed)
    ours = pg.compare(base, cur, *reps)
    ref = jax_pg.compare(base, cur, *reps)
    assert ours == ref
    assert pg.render_report(ours) == jax_pg.render_report(ref)


def test_noise_bands_match_the_jax_package(monkeypatch):
    from ray_tpu._private import perf_gate as jax_pg

    assert pg._DEFAULT_BANDS == jax_pg._DEFAULT_BANDS
    assert pg._METRIC_BANDS == jax_pg._METRIC_BANDS
    assert pg._LOWER_IS_BETTER == jax_pg._LOWER_IS_BETTER
    # each gate scales by its own package's flag
    monkeypatch.setenv("RTPU_TORCH_perf_band_scale", "2.0")
    assert pg.noise_band("wait_1k_refs", 3) == pytest.approx(
        2.0 * jax_pg.noise_band("wait_1k_refs", 3))


def test_port_ledger_is_not_the_jax_packages(monkeypatch, tmp_path):
    """By default the port's gate reads and writes a ledger of its own at
    the repo root, never the JAX package's PERF_HISTORY.jsonl (TPU-era
    numbers): a check with no ledger of the port's sees every row as new."""
    from ray_tpu_torch import scripts
    from ray_tpu_torch._private import repo_root

    monkeypatch.delenv("RTPU_TORCH_perf_history_path", raising=False)
    path = pg.history_path()
    assert os.path.dirname(path) == repo_root()
    assert os.path.basename(path) != "PERF_HISTORY.jsonl"
    from ray_tpu._private import perf_gate as jax_pg

    assert path != jax_pg.history_path()
    jax_rows = jax_pg.load_history()
    if not os.path.exists(path):
        assert pg.load_baseline() is None
    # a check against the default ledger never takes a JAX row as baseline
    canned = {"schema": "microbench.v1", "reps": 1,
              "metrics": {"single_client_put_calls": {"value": 1.0}}}
    monkeypatch.setattr(pg, "run_microbench", lambda **kw: canned)
    report, _ = pg.check(only="single_client_put_calls")
    if jax_rows and not os.path.exists(path):
        assert report["metrics"]["single_client_put_calls"]["status"] == "new"
        assert "baseline_git" not in report
    existed = os.path.exists(path)
    try:
        scripts.main(["perf", "check", "--only", "single_client_put_calls",
                      "-o", str(tmp_path / "r.json")])
    except SystemExit:
        pass  # a regression against a seeded ledger of the port's
    assert os.path.exists(path) == existed  # no --update: nothing written


def test_perf_history_cli_reads_the_ledger(tmp_path, capsys):
    from ray_tpu_torch import scripts

    ledger = str(tmp_path / "h.jsonl")
    pg.append_history({"m": 1.5, "k": 2.0}, path=ledger, reps=1, note="one")
    pg.append_history({"m": 1.75}, path=ledger, reps=1, note="two")
    scripts.main(["perf", "history", "--history", ledger, "--metric", "m"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[-1] for line in out] == ["m=1.5", "m=1.75"]


def test_microbench_spec_rows_match_the_jax_package(tmp_path, capsys):
    """The port's microbench (its --json / --quick / --only flags, the
    serve_llm rows on --device cpu, the table written only to --output)
    measures the JAX microbench's acceptance on the same deterministic
    draft: the same engine logic, the same rows."""
    import microbench as jax_mb
    from ray_tpu_torch._private import microbench as mb

    table = tmp_path / "table.md"
    mb.main(["--json", "--quick", "--only", "serve_llm_spec_acceptance",
             "--device", "cpu", "--output", str(table)])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["schema"] == "microbench.v1" and doc["reps"] == 1
    assert set(doc["metrics"]) == {"serve_llm_spec_tokens_per_s",
                                   "serve_llm_spec_baseline_tokens_per_s",
                                   "serve_llm_spec_acceptance"}
    ref = jax_mb._bench_serve_llm_spec(True, 1)
    assert doc["metrics"]["serve_llm_spec_acceptance"]["value"] == round(
        ref["serve_llm_spec_acceptance"], 3)
    assert "| serve_llm_spec_acceptance |" in table.read_text()
    metrics, reps = pg.load_result(doc)
    assert reps == 1 and metrics["serve_llm_spec_acceptance"] > 0
