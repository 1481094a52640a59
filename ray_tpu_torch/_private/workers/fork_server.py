"""Fork server: preimports the runtime once, then forks worker processes.

The reference hides worker-startup latency by prestarting pooled workers
(reference: src/ray/raylet/worker_pool.h:359 PrestartWorkers). We go further:
the raylet keeps one fork-server child per node that has already paid the
Python import cost; each worker is an os.fork() of it (~tens of ms instead of
~2 s of interpreter+import startup). The child process then builds its own
CoreWorker and IO loop from scratch, so no event-loop/thread state crosses the
fork — only module imports do.

Protocol (line-delimited JSON):
  stdin:  {"spawn": {"token": int, "job_id": hex, "env": {..}, "log_prefix": path}}
          {"kill": pid}
  stdout: {"ready": true}
          {"spawned": token, "pid": pid}
          {"dead": pid, "rc": int}
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def _reaper(out_lock):
    while True:
        try:
            pid, status = os.waitpid(-1, 0)
        except ChildProcessError:
            # no children right now; wait for SIGCHLD via sleep
            import time

            time.sleep(0.2)
            continue
        except InterruptedError:
            continue
        rc = os.waitstatus_to_exitcode(status)
        with out_lock:
            print(json.dumps({"dead": pid, "rc": rc}), flush=True)


def _child_main(args, spawn):
    _mark("start")
    os.setsid()
    for k, v in (spawn.get("env") or {}).items():
        os.environ[k] = str(v)
    # runtime_env working_dir: run user code from the materialized directory
    # with it importable (reference: runtime_env working_dir semantics —
    # cwd + sys.path entry).
    wd = os.environ.get("RTPU_TORCH_WORKING_DIR")
    if wd:
        try:
            os.chdir(wd)
            sys.path.insert(0, wd)
        except OSError:
            print(f"runtime_env: cannot enter working_dir {wd!r}", file=sys.stderr)
    # runtime_env pip venvs + py_modules: the raylet materialized them and
    # hands their import roots here; forked workers adopt them by sys.path
    # (the venv shares this interpreter via --system-site-packages, so
    # path adoption IS "running inside the venv" for import purposes).
    pypath = os.environ.get("RTPU_TORCH_PYPATH_PREPEND")
    if pypath:
        import importlib

        for p in reversed(pypath.split(os.pathsep)):
            if p and p not in sys.path:
                sys.path.insert(0, p)
        importlib.invalidate_caches()
    # No CUDA state crosses the fork: this server never imports torch (its
    # preimports below hold none), so a child's first CUDA call happens
    # here, after CUDA_VISIBLE_DEVICES was set from the lease's env above,
    # and torch.device("cuda") is the leased card.
    log_prefix = spawn.get("log_prefix", "")
    if log_prefix:
        out = open(log_prefix + ".out", "ab", buffering=0)
        err = open(log_prefix + ".err", "ab", buffering=0)
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
    devnull = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull, 0)

    from ray_tpu_torch._private.ids import JobID
    from ray_tpu_torch._private.worker import MODE_WORKER, CoreWorker, set_global_worker

    profile_dir = os.environ.get("RTPU_TORCH_PROFILE_WORKER_BOOT")
    prof = None
    if profile_dir:
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
    actor = spawn.get("actor")
    pre_register = None
    if actor:
        # Actor-in-spawn fast path: the lease carried the creation spec, so
        # the actor initializes during boot — before RegisterWorker — and
        # the result rides the registration request. No separate GCS->worker
        # connection, CreateActor round-trip, or ActorCreated report.
        import base64

        import msgpack

        spec = msgpack.unpackb(
            base64.b64decode(actor["spec_b64"]), raw=False, strict_map_key=False
        )
        fn_blob = actor.get("fn_blob_b64")

        async def pre_register(worker):
            try:
                if fn_blob:
                    # inside the try: an unpicklable class blob must surface
                    # as a creation error, not crash the child pre-register
                    worker.functions.seed(
                        spec["fn_key"], base64.b64decode(fn_blob)
                    )
                return await worker.executor.create_actor(spec, spec["actor_id"])
            except Exception as e:
                return {"ok": False, "error": repr(e)}

    _mark("pre_core")
    worker = CoreWorker(
        mode=MODE_WORKER,
        gcs_address=args.gcs_address,
        raylet_addr=(args.raylet_host, args.raylet_port),
        job_id=JobID.from_hex(spawn["job_id"]),
        startup_token=spawn["token"],
        session_dir=args.session_dir,
        host=args.raylet_host,
        driver_sys_path=spawn.get("sys_path"),
        node_id_hex=spawn.get("node_id", ""),
        plasma_name=spawn.get("plasma_name", ""),
        pre_register=pre_register,
    )
    _mark("core_done")
    set_global_worker(worker)
    secs = os.environ.get("RTPU_TORCH_PROFILE_WORKER_SECS")
    if secs and os.environ.get("RTPU_TORCH_PROFILE_WORKER_BOOT"):
        import cProfile as _cp

        def _steady():
            import time as _time

            p = _cp.Profile()
            p.enable()
            _time.sleep(float(secs))
            p.disable()
            try:
                p.dump_stats(os.path.join(
                    os.environ["RTPU_TORCH_PROFILE_WORKER_BOOT"],
                    f"steady-{os.getpid()}.prof"))
            except Exception:
                pass

        threading.Thread(target=_steady, daemon=True).start()
    if prof is not None:
        prof.disable()
        try:
            os.makedirs(profile_dir, exist_ok=True)
            prof.dump_stats(os.path.join(profile_dir, f"boot-{os.getpid()}.prof"))
        except Exception:
            pass  # diagnostics must never kill the worker
    if os.environ.get("RTPU_TORCH_BOOT_CPU_LOG"):
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        marks = " ".join(f"{k}={v * 1000:.1f}" for k, v in _BOOT_MARKS)
        print(f"BOOT_CPU pid={os.getpid()} "
              f"user={ru.ru_utime * 1000:.1f}ms sys={ru.ru_stime * 1000:.1f}ms "
              f"minflt={ru.ru_minflt} marks[{marks}]",
              file=sys.stderr, flush=True)
    threading.Event().wait()


_BOOT_MARKS: list = []


def _mark(label: str):
    if os.environ.get("RTPU_TORCH_BOOT_CPU_LOG"):
        import time as _time

        _BOOT_MARKS.append((label, _time.process_time()))


def _preimport():
    """Pay the import bill once, before any fork. This matters double on
    hosts with PYTHONDONTWRITEBYTECODE=1: a module imported lazily in the
    CHILD recompiles from source in EVERY child — ~80 ms a pop — because
    nothing ever writes a .pyc. Everything a worker touches during boot or
    its first task must be in sys.modules before fork. torch is not among
    them: a CUDA context in this server would be inherited by every child,
    which then could not use CUDA at all."""
    import base64  # noqa: F401
    import concurrent.futures  # noqa: F401

    import msgpack  # noqa: F401
    import numpy  # noqa: F401

    import ray_tpu_torch._private.direct_channel  # noqa: F401
    import ray_tpu_torch._private.executor  # noqa: F401
    import ray_tpu_torch._private.profiling  # noqa: F401
    import ray_tpu_torch._private.schema  # noqa: F401
    import ray_tpu_torch._private.worker  # noqa: F401
    import ray_tpu_torch.util.tracing  # noqa: F401

    # dlopen the plasma client library once pre-fork — children inherit the
    # mapping (the module memoizes in a global), saving ~1 ms per spawn.
    try:
        from ray_tpu_torch._native import plasma as _plasma

        _plasma._load()
    except Exception:
        pass


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet-host", required=True)
    parser.add_argument("--raylet-port", type=int, required=True)
    parser.add_argument("--gcs-address", required=True)
    parser.add_argument("--session-dir", default="")
    args = parser.parse_args(argv)

    _preimport()
    out_lock = threading.Lock()
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    threading.Thread(target=_reaper, args=(out_lock,), daemon=True).start()
    with out_lock:
        print(json.dumps({"ready": True}), flush=True)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "spawn" in req:
            spawn = req["spawn"]
            pid = os.fork()
            if pid == 0:
                try:
                    _child_main(args, spawn)
                except Exception:
                    import traceback

                    traceback.print_exc()
                finally:
                    os._exit(1)
            with out_lock:
                print(json.dumps({"spawned": spawn["token"], "pid": pid}), flush=True)
        elif "kill" in req:
            try:
                os.killpg(os.getpgid(req["kill"]), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                try:
                    os.kill(req["kill"], signal.SIGKILL)
                except ProcessLookupError:
                    pass


if __name__ == "__main__":
    main()
