"""The port's job submission (manager, SDK, REST), its dashboard head and
its operator CLI: a copy of ``tests/test_jobs.py`` over ``ray_tpu_torch``
(one cluster for the module), plus the head's routes and the job record held
against the JAX package on the same inputs.

Reference contracts: JobManager + JobSupervisor run entrypoints as
subprocesses with the cluster address injected (``RTPU_TORCH_ADDRESS``) and
status/logs queryable (dashboard/modules/job/job_manager.py:57,
job_supervisor.py:51, sdk.py:35); the dashboard serves the state + job REST
API (dashboard/head.py:79); the CLI mirrors `ray status/timeline/job ...`
(scripts/scripts.py).
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from _torch_runtime import port_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def job_cluster():
    import ray_tpu_torch
    from ray_tpu_torch import api

    with pytest.MonkeyPatch.context() as mp:
        port_env(mp)
        ray_tpu_torch.init(num_cpus=4)
        try:
            yield api._local_node.gcs_address
        finally:
            ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def dashboard(job_cluster):
    from ray_tpu_torch.dashboard import start_dashboard

    head, port = start_dashboard(job_cluster)
    yield f"http://127.0.0.1:{port}"
    from ray_tpu_torch._private.rpc import IoThread

    IoThread.current().run(_close(head))


async def _close(head):
    head._server.close()
    await head._server.wait_closed()


def _wait_status(client, sid, want, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        status = client.get_job_status(sid)
        if status in want:
            return status
        time.sleep(0.3)
    return client.get_job_status(sid)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.timeout(150)
def test_job_lifecycle(job_cluster, tmp_path):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    script = tmp_path / "job_script.py"
    script.write_text(
        "import sys\n"
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init(address='auto')\n"
        "@ray_tpu_torch.remote\n"
        "def f(x):\n"
        "    return x * 2\n"
        "print('JOB_RESULT', sum(ray_tpu_torch.get([f.remote(i) for i in range(5)])))\n"
        "print('TORCH_IN_DRIVER', 'torch' in sys.modules)\n"
    )
    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} {script}")
    assert sid.startswith("raysubmit_")
    status = _wait_status(client, sid, (JobStatus.SUCCEEDED, JobStatus.FAILED,
                                        JobStatus.STOPPED), timeout=120)
    assert status == JobStatus.SUCCEEDED, client.get_job_logs(sid)
    logs = client.get_job_logs(sid)
    assert "JOB_RESULT 20" in logs
    # a control-plane driver: init and a CPU task load no torch
    assert "TORCH_IN_DRIVER False" in logs
    jobs = client.list_jobs()
    assert any(j["submission_id"] == sid for j in jobs)


@pytest.mark.timeout(150)
def test_job_failure_and_stop(job_cluster, tmp_path):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    client = JobSubmissionClient()
    bad = client.submit_job(entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    assert _wait_status(client, bad, (JobStatus.FAILED,)) == JobStatus.FAILED
    assert "code 3" in client.get_job_info(bad)["message"]

    sleeper = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(300)'"
    )
    assert _wait_status(client, sleeper, (JobStatus.RUNNING,)) == JobStatus.RUNNING
    assert client.stop_job(sleeper)
    assert _wait_status(client, sleeper, (JobStatus.STOPPED,)) == JobStatus.STOPPED


@pytest.mark.timeout(150)
def test_dashboard_api_and_rest_jobs(job_cluster, dashboard):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    cluster = _get(f"{dashboard}/api/cluster")
    assert cluster["nodes"] == 1
    nodes = _get(f"{dashboard}/api/nodes")["nodes"]
    assert nodes[0]["state"] == "ALIVE"
    with urllib.request.urlopen(f"{dashboard}/", timeout=30) as r:
        html = r.read().decode()
    assert "ray_tpu_torch" in html and "id=tiles" in html  # live SPA at /
    # the page's device tile counts the port's device
    assert "total.GPU" in html and "total.TPU" not in html
    import ray_tpu_torch

    assert _get(f"{dashboard}/api/version") == {
        "version": ray_tpu_torch.__version__}

    client = JobSubmissionClient(dashboard)  # REST transport
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('VIA_REST')\""
    )
    assert _wait_status(client, sid, (JobStatus.SUCCEEDED,)) == JobStatus.SUCCEEDED
    assert "VIA_REST" in client.get_job_logs(sid)
    # the logs route as an operator reads it
    logs = _get(f"{dashboard}/api/jobs/{sid}/logs")["logs"]
    assert "VIA_REST" in logs


@pytest.mark.timeout(150)
def test_dashboard_state_and_telemetry_routes(job_cluster, dashboard):
    """Every read-only route of the head answers from the port's state,
    GCS and telemetry (head.py's route table)."""
    for route, key in (("actors", "actors"), ("tasks", "tasks"),
                       ("objects", "objects"), ("workers", "workers"),
                       ("placement_groups", "placement_groups"),
                       ("jobs", "jobs"), ("logs", "logs")):
        out = _get(f"{dashboard}/api/{route}")
        assert isinstance(out[key], list), route
    # the process-global metric table may hold an earlier test's trainer
    # series: every job row the route builds carries the summed HBM series
    train = _get(f"{dashboard}/api/train")["jobs"]
    assert all("hbm_bytes_in_use" in row for row in train.values()), train
    assert "deployments" in _get(f"{dashboard}/api/serve")
    graf = _get(f"{dashboard}/api/grafana_dashboard")
    assert any(p["title"] == "GPUs in use" for p in graf["panels"])
    mem = _get(f"{dashboard}/api/memory?objects=0")
    assert "nodes" in mem and "rollup" in mem
    assert "path" in _get(f"{dashboard}/api/perf")
    try:
        urllib.request.urlopen(f"{dashboard}/api/nope", timeout=30)
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404


@pytest.mark.timeout(170)
def test_cli(job_cluster, tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def cli(*args):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
            capture_output=True, text=True, env=env, timeout=120,
        )

    out = cli("status", "--address", job_cluster)
    assert out.returncode == 0, out.stderr
    assert "1 alive" in out.stdout

    out = cli("nodes", "--address", job_cluster)
    assert out.returncode == 0 and "head=True" in out.stdout

    trace = tmp_path / "t.json"
    out = cli("timeline", "--address", job_cluster, "-o", str(trace))
    assert out.returncode == 0
    json.loads(trace.read_text())  # valid JSON

    out = cli("job", "--address", job_cluster, "submit", "--",
              sys.executable, "-c", "print(40+2)")
    assert out.returncode == 0, out.stderr
    sid = out.stdout.strip().splitlines()[-1]
    deadline = time.time() + 60
    while time.time() < deadline:
        st = cli("job", "--address", job_cluster, "status", sid)
        if st.stdout.strip() in ("SUCCEEDED", "FAILED"):
            break
        time.sleep(0.5)
    assert st.stdout.strip() == "SUCCEEDED"
    logs = cli("job", "--address", job_cluster, "logs", sid)
    assert "42" in logs.stdout


@pytest.mark.timeout(150)
def test_dashboard_logs_api(job_cluster, dashboard):
    """Log module (reference: dashboard/modules/log/): list + tail session
    log files over HTTP; path traversal is rejected."""
    logs = _get(f"{dashboard}/api/logs")["logs"]
    assert logs, "session log dir should contain process logs"
    name = next(l["name"] for l in logs if l["size_bytes"] > 0)
    payload = _get(f"{dashboard}/api/logs/{name}?tail=5")
    assert payload["name"] == name
    assert len(payload["lines"]) <= 5
    # traversal attempt 404s
    try:
        urllib.request.urlopen(f"{dashboard}/api/logs/..%2Fgcs.log", timeout=30)
        raise AssertionError("expected 404")
    except urllib.error.HTTPError as e:
        assert e.code == 404


# ------------------------------------------- against the JAX package


class _KvGcs:
    def __init__(self):
        self.kv = {}

    def kv_get(self, ns, key):
        return self.kv.get((ns, key))

    def kv_put(self, ns, key, value):
        self.kv[(ns, key)] = value


def _supervisor_record(pkg, monkeypatch, status):
    """The record a package's JobSupervisor writes for one status, through
    a stub GCS standing in for the worker's."""
    import importlib

    worker_mod = importlib.import_module(f"{pkg}._private.worker")
    mgr = importlib.import_module(f"{pkg}.job_submission._manager")
    gcs = _KvGcs()

    class _W:
        pass

    w = _W()
    w.gcs = gcs
    monkeypatch.setattr(worker_mod, "global_worker", w)
    sup = mgr.JobSupervisor("raysubmit_same", "python x.py", {}, "1.2.3.4:5",
                            "/logs/job-raysubmit_same.log")
    sup._start_time = 100.0
    gcs.kv_put(mgr.JOB_KV_NS, b"raysubmit_same",
               json.dumps({"metadata": {"k": "v"}}).encode())
    sup._set_status(status, "why")
    [(ns, key)] = gcs.kv
    rec = json.loads(gcs.kv[(ns, key)])
    if rec.get("end_time") is not None:
        rec["end_time"] = "set"
    return ns, key, rec


@pytest.mark.parametrize("status", ["RUNNING", "SUCCEEDED", "STOPPED"])
def test_job_record_matches_the_jax_package(monkeypatch, status):
    """Same KV namespace, key and job-info record from both supervisors."""
    assert (_supervisor_record("ray_tpu_torch", monkeypatch, status)
            == _supervisor_record("ray_tpu", monkeypatch, status))


@pytest.mark.parametrize("reply", [{}, {"session_dir": ""}, None])
def test_job_logs_fall_back_to_the_temp_dir(monkeypatch, tmp_path, reply):
    """Without a session directory from the GCS, job logs go under the
    process's temp dir (TMPDIR), as the port's sessions do, never under a
    fixed path."""
    import tempfile

    from ray_tpu_torch.job_submission import _manager as mgr

    class Gcs:
        def call(self, method, payload):
            if reply is None:
                raise ConnectionError("no GCS")
            return reply

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert mgr.JobManager(Gcs())._session_dir() == str(tmp_path / "ray_tpu_torch")


def test_job_client_rest_requests_match_the_jax_package():
    """Both packages' JobSubmissionClient send the same REST requests to a
    head and read the same answers."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    seen = []

    class H(BaseHTTPRequestHandler):
        def _answer(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            seen.append((self.command, self.path, body))
            path = self.path
            if path.endswith("/logs?offset=0"):
                out = {"logs": "hello"}
            elif path.endswith("/stop"):
                out = {"stopped": True}
            elif path == "/api/jobs/":
                out = ({"submission_id": "raysubmit_x"}
                       if self.command == "POST" else {"jobs": [{"a": 1}]})
            else:
                out = {"status": "RUNNING", "submission_id": "raysubmit_x"}
            data = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = do_POST = _answer

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        answers = {}
        for pkg in ("ray_tpu", "ray_tpu_torch"):
            import importlib

            js = importlib.import_module(f"{pkg}.job_submission")
            c = js.JobSubmissionClient(url)
            seen.clear()
            answers[pkg] = (
                c.submit_job(entrypoint="echo hi", metadata={"m": 1}),
                c.get_job_status("raysubmit_x"),
                c.get_job_logs("raysubmit_x"),
                c.stop_job("raysubmit_x"),
                c.list_jobs(),
                list(seen),
            )
        assert answers["ray_tpu"] == answers["ray_tpu_torch"]
    finally:
        srv.shutdown()
        srv.server_close()
