"""Worker process entrypoint, spawned by the raylet's WorkerPool.

Counterpart of the reference's default_worker.py
(reference: python/ray/_private/workers/default_worker.py, main loop
worker.py:877). The process hosts a CoreWorker whose RPC server receives
PushTask/CreateActor/PushActorTask; there is no polling loop — execution is
entirely push-driven, so the main thread just parks.
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-host", required=True)
    parser.add_argument("--raylet-port", type=int, required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--plasma-name", required=True)
    parser.add_argument("--job-id", required=True)
    parser.add_argument("--startup-token", type=int, required=True)
    parser.add_argument("--session-dir", default="")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    # runtime_env adoption, mirroring the fork-server child
    # (workers/fork_server.py _child_main): working_dir + pypath prepends
    # arrive via env vars because this entrypoint also runs under foreign
    # interpreters (conda envs) and inside containers.
    import os

    wd = os.environ.get("RTPU_TORCH_WORKING_DIR")
    if wd:
        try:
            os.chdir(wd)
            sys.path.insert(0, wd)
        except OSError:
            print(f"runtime_env: cannot enter working_dir {wd!r}",
                  file=sys.stderr)
    pypath = os.environ.get("RTPU_TORCH_PYPATH_PREPEND")
    if pypath:
        import importlib

        for p in reversed(pypath.split(os.pathsep)):
            if p and p not in sys.path:
                sys.path.insert(0, p)
        importlib.invalidate_caches()

    from ray_tpu_torch._private.ids import JobID
    from ray_tpu_torch._private.worker import MODE_WORKER, CoreWorker, set_global_worker

    worker = CoreWorker(
        mode=MODE_WORKER,
        gcs_address=args.gcs_address,
        raylet_addr=(args.raylet_host, args.raylet_port),
        job_id=JobID.from_hex(args.job_id),
        startup_token=args.startup_token,
        session_dir=args.session_dir,
        host=args.raylet_host,
        node_id_hex=args.node_id,
        plasma_name=args.plasma_name,
    )
    set_global_worker(worker)
    threading.Event().wait()


if __name__ == "__main__":
    main()
