"""Job manager + supervisor: run driver scripts as managed cluster jobs.

Counterpart of the reference's job submission stack
(reference: python/ray/dashboard/modules/job/job_manager.py:57 JobManager,
job_supervisor.py:51 JobSupervisor — a detached supervisor actor per job
runs the entrypoint as a subprocess with the cluster address injected,
captures output, and records status for the REST/SDK/CLI surfaces).
Status lives in the GCS KV (ns "job_submission") so it survives the
submitting client.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import uuid
from typing import Dict, List, Optional

JOB_KV_NS = "job_submission"

PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"

_TERMINAL = (SUCCEEDED, FAILED, STOPPED)


class JobSupervisor:
    """Detached actor that owns one job's subprocess
    (reference: job_supervisor.py:51)."""

    def __init__(self, submission_id: str, entrypoint: str, env_vars: dict,
                 gcs_address: str, log_path: str):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.env_vars = dict(env_vars or {})
        self.gcs_address = gcs_address
        self.log_path = log_path
        self._proc = None
        self._stopped = False

    def _set_status(self, status: str, message: str = ""):
        from ray_tpu_torch._private import worker as worker_mod

        gcs = worker_mod.global_worker.gcs
        key = self.submission_id.encode()
        # Read-modify-write: preserve submit-time fields (metadata, ...).
        try:
            info = json.loads(gcs.kv_get(JOB_KV_NS, key) or b"{}")
        except Exception:
            info = {}
        info.update(
            submission_id=self.submission_id,
            entrypoint=self.entrypoint,
            status=status,
            message=message,
            start_time=getattr(self, "_start_time", None),
            end_time=time.time() if status in _TERMINAL else None,
            log_path=self.log_path,
        )
        gcs.kv_put(JOB_KV_NS, key, json.dumps(info).encode())

    async def start(self) -> bool:
        """Spawn the entrypoint subprocess. The submitter blocks on this so
        the job is provably started before submit_job returns (a
        fire-and-forget run could be lost if the submitting process exits
        immediately, e.g. the CLI)."""
        import asyncio
        import subprocess

        self._start_time = time.time()
        env = dict(os.environ)
        env.update(self.env_vars)
        env["RTPU_TORCH_ADDRESS"] = self.gcs_address
        os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
        logf = open(self.log_path, "ab", buffering=0)
        try:
            self._proc = subprocess.Popen(
                self.entrypoint,
                shell=True,
                stdout=logf,
                stderr=subprocess.STDOUT,
                env=env,
                start_new_session=True,
            )
        except Exception as e:
            logf.close()
            self._set_status(FAILED, f"failed to spawn entrypoint: {e}")
            return False
        self._set_status(RUNNING)
        self._wait_task = asyncio.ensure_future(self._wait(logf))
        return True

    async def _wait(self, logf) -> str:
        import asyncio

        loop = asyncio.get_running_loop()
        try:
            rc = await loop.run_in_executor(None, self._proc.wait)
        finally:
            logf.close()
        if self._stopped:
            status, msg = STOPPED, "stopped by user"
        elif rc == 0:
            status, msg = SUCCEEDED, ""
        else:
            status, msg = FAILED, f"entrypoint exited with code {rc}"
        self._set_status(status, msg)
        # Self-terminate after a grace period (reference: the supervisor
        # actor exits with the job) — the log file outlives the actor and
        # queries fall back to it; without this every job leaks a detached
        # actor forever.
        asyncio.get_running_loop().call_later(60.0, self._exit_self)
        return status

    def _exit_self(self):
        import os as _os

        _os._exit(0)

    async def run(self) -> str:
        """Start and block until terminal (in-process convenience)."""
        if not await self.start():
            return FAILED
        return await self._wait_task

    async def stop(self) -> bool:
        import signal

        self._stopped = True
        if self._proc is not None and self._proc.poll() is None:
            try:
                os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
            except Exception:
                try:
                    self._proc.terminate()
                except Exception:
                    return False
            return True
        return False

    async def get_logs(self, offset: int = 0) -> str:
        try:
            with open(self.log_path, "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    async def ping(self) -> bool:
        return True


class JobManager:
    """Submits/queries jobs against a connected cluster
    (reference: job_manager.py:57)."""

    def __init__(self, gcs_client=None):
        if gcs_client is None:
            from ray_tpu_torch._private import worker as worker_mod

            if worker_mod.global_worker is None:
                raise RuntimeError("ray_tpu_torch is not initialized")
            gcs_client = worker_mod.global_worker.gcs
        self.gcs = gcs_client

    def _ensure_connected(self):
        """Actor operations (supervisor spawn/lookup) need a driver; CLI
        and SDK callers may not have called ray_tpu_torch.init themselves."""
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=self.gcs.address, log_to_driver=False)

    # ----------------------------------------------------------- submission

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
    ) -> str:
        import ray_tpu_torch

        self._ensure_connected()
        submission_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        if self.gcs.kv_exists(JOB_KV_NS, submission_id.encode()):
            raise ValueError(f"job '{submission_id}' already exists")
        env_vars = dict((runtime_env or {}).get("env_vars") or {})
        working_dir = (runtime_env or {}).get("working_dir")
        if working_dir:
            env_vars.setdefault("RTPU_TORCH_JOB_WORKING_DIR", working_dir)
        session_dir = self._session_dir()
        log_path = os.path.join(session_dir, "logs", f"job-{submission_id}.log")
        info = {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": PENDING,
            "message": "",
            "metadata": metadata or {},
            "start_time": None,
            "end_time": None,
        }
        self.gcs.kv_put(
            JOB_KV_NS, submission_id.encode(), json.dumps(info).encode()
        )
        supervisor = (
            ray_tpu_torch.remote(JobSupervisor)
            .options(
                name=f"JOB_SUP::{submission_id}",
                lifetime="detached",
                max_concurrency=4,
                num_cpus=0,
            )
            .remote(
                submission_id,
                entrypoint,
                env_vars,
                self.gcs.address,
                log_path,
            )
        )
        # Block until the subprocess is spawned: the submitter may exit
        # right after (CLI one-shots) and a buffered fire-and-forget task
        # would be lost with it.
        ray_tpu_torch.get(supervisor.start.remote(), timeout=120)
        return submission_id

    def _session_dir(self) -> str:
        fallback = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
        try:
            r = self.gcs.call("GetInternalConfig", {})
            return r.get("session_dir") or fallback
        except Exception:
            return fallback

    # -------------------------------------------------------------- queries

    def get_job_info(self, submission_id: str) -> dict:
        raw = self.gcs.kv_get(JOB_KV_NS, submission_id.encode())
        if raw is None:
            raise ValueError(f"no job '{submission_id}'")
        return json.loads(raw)

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id)["status"]

    def list_jobs(self) -> List[dict]:
        out = []
        for key in self.gcs.kv_keys(JOB_KV_NS):
            raw = self.gcs.kv_get(JOB_KV_NS, key)
            if raw:
                out.append(json.loads(raw))
        out.sort(key=lambda j: j.get("start_time") or 0)
        return out

    def get_job_logs(self, submission_id: str, offset: int = 0) -> str:
        import ray_tpu_torch

        info = self.get_job_info(submission_id)  # raises on unknown id
        # The log file outlives the (self-terminating) supervisor actor;
        # prefer it when reachable, fall back to the actor for remote logs.
        log_path = info.get("log_path")
        if log_path and os.path.exists(log_path):
            try:
                with open(log_path, "rb") as f:
                    if offset:
                        f.seek(offset)
                    return f.read().decode("utf-8", "replace")
            except OSError:
                pass
        self._ensure_connected()
        try:
            sup = ray_tpu_torch.get_actor(f"JOB_SUP::{submission_id}")
            return ray_tpu_torch.get(sup.get_logs.remote(offset), timeout=30)
        except Exception:
            return ""

    def stop_job(self, submission_id: str) -> bool:
        import ray_tpu_torch

        self._ensure_connected()
        info = self.get_job_info(submission_id)
        if info["status"] in _TERMINAL:
            return False
        try:
            sup = ray_tpu_torch.get_actor(f"JOB_SUP::{submission_id}")
            return ray_tpu_torch.get(sup.stop.remote(), timeout=30)
        except Exception:
            return False

    def wait_until_finished(
        self, submission_id: str, timeout: float = 300.0
    ) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            status = self.get_job_status(submission_id)
            if status in _TERMINAL:
                return status
            time.sleep(0.5)
        raise TimeoutError(f"job '{submission_id}' still {status}")
