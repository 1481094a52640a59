"""ray_tpu_torch.job_submission — submit driver scripts as managed jobs.

Counterpart of ``ray.job_submission`` (reference:
python/ray/dashboard/modules/job/sdk.py:35 JobSubmissionClient). The client
speaks either directly to the GCS (``ray_tpu_torch://host:port`` or a bare
``host:port``) or to a dashboard's REST API (``http://host:port``).
"""

from __future__ import annotations

import json
import urllib.request
from typing import List, Optional

from ray_tpu_torch.job_submission._manager import (
    FAILED,
    PENDING,
    RUNNING,
    STOPPED,
    SUCCEEDED,
    JobManager,
    JobSupervisor,
)


class JobStatus:
    PENDING = PENDING
    RUNNING = RUNNING
    SUCCEEDED = SUCCEEDED
    FAILED = FAILED
    STOPPED = STOPPED


class JobSubmissionClient:
    def __init__(self, address: Optional[str] = None):
        self._http = None
        self._mgr: Optional[JobManager] = None
        if address and address.startswith("http"):
            self._http = address.rstrip("/")
        elif address:
            from ray_tpu_torch._private.gcs.client import GcsClient

            address = address.replace("ray_tpu_torch://", "")
            self._mgr = JobManager(GcsClient.from_address(address))
        else:
            self._mgr = JobManager()

    # ------------------------------------------------------------ REST glue

    def _req(self, method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self._http + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read() or b"{}")

    # ----------------------------------------------------------------- API

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
    ) -> str:
        if self._http:
            r = self._req(
                "POST",
                "/api/jobs/",
                {
                    "entrypoint": entrypoint,
                    "submission_id": submission_id,
                    "runtime_env": runtime_env,
                    "metadata": metadata,
                },
            )
            return r["submission_id"]
        return self._mgr.submit_job(
            entrypoint=entrypoint,
            submission_id=submission_id,
            runtime_env=runtime_env,
            metadata=metadata,
        )

    def get_job_status(self, submission_id: str) -> str:
        if self._http:
            return self._req("GET", f"/api/jobs/{submission_id}")["status"]
        return self._mgr.get_job_status(submission_id)

    def get_job_info(self, submission_id: str) -> dict:
        if self._http:
            return self._req("GET", f"/api/jobs/{submission_id}")
        return self._mgr.get_job_info(submission_id)

    def get_job_logs(self, submission_id: str, offset: int = 0) -> str:
        if self._http:
            return self._req(
                "GET", f"/api/jobs/{submission_id}/logs?offset={offset}"
            )["logs"]
        return self._mgr.get_job_logs(submission_id, offset)

    def stop_job(self, submission_id: str) -> bool:
        if self._http:
            return self._req("POST", f"/api/jobs/{submission_id}/stop")["stopped"]
        return self._mgr.stop_job(submission_id)

    def list_jobs(self) -> List[dict]:
        if self._http:
            return self._req("GET", "/api/jobs/")["jobs"]
        return self._mgr.list_jobs()

    def tail_job_logs(self, submission_id: str):
        """Yield new log chunks; each poll transfers only unseen bytes."""
        import time

        offset = 0
        while True:
            chunk = self.get_job_logs(submission_id, offset=offset)
            if chunk:
                yield chunk
                offset += len(chunk.encode("utf-8", "replace"))
            status = self.get_job_status(submission_id)
            if status in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED):
                chunk = self.get_job_logs(submission_id, offset=offset)
                if chunk:
                    yield chunk
                return
            time.sleep(0.5)


__all__ = ["JobSubmissionClient", "JobStatus", "JobManager", "JobSupervisor"]
