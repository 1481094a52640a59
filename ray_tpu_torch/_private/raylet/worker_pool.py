"""Worker pool: leases Python worker processes forked from a warm fork server.

Counterpart of the reference's WorkerPool
(reference: src/ray/raylet/worker_pool.h:159 — StartWorkerProcess :425,
PrestartWorkers :359). Workers are forked from a per-node fork server that has
preimported the runtime (ray_tpu_torch/_private/workers/fork_server.py), so spawn
latency is ~tens of ms. Each spawn carries a startup token; when the new
process's CoreWorker registers back, the token pairs it with its spawn record.
Idle workers are cached per job and reaped after an idle timeout; actors get
dedicated workers that live until the actor dies.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG


@dataclass(eq=False)  # identity semantics: handles live in sets/lists
class WorkerHandle:
    worker_id: bytes
    pid: int
    job_id: bytes
    addr: Tuple[str, int] = ("", 0)
    registered: bool = False
    startup_token: int = 0
    alive: bool = True
    # lease state
    leased: bool = False
    lease_id: bytes = b""
    actor_id: bytes = b""
    returncode: Optional[int] = None
    idle_since: float = field(default_factory=time.time)
    register_event: Optional[asyncio.Event] = None
    # canonical runtime-env key: idle reuse only pairs identical envs
    # (reference: worker_pool.h keys pooled workers by runtime_env_hash)
    env_key: str = ""
    log_prefix: str = ""  # session-dir path stem of this worker's .out/.err
    # actor-in-spawn fast path: set when the spawn message carried an actor
    # spec; the creation result arrives inside the child's RegisterWorker
    actor_ready: Optional[asyncio.Event] = None
    actor_result: Optional[dict] = None
    # pool-initiated kill (idle reap, job teardown, shutdown): the death
    # callback must not publish a worker_crash incident for it
    expected_death: bool = False


class WorkerPool:
    def __init__(
        self,
        node_id: bytes,
        raylet_addr: Tuple[str, int],
        gcs_addr: str,
        plasma_name: str,
        session_dir: str,
        on_worker_death=None,
    ):
        self._node_id = node_id
        self._raylet_addr = raylet_addr
        self._gcs_addr = gcs_addr
        self._plasma_name = plasma_name
        self._session_dir = session_dir
        self._on_worker_death_cb = on_worker_death
        self._next_token = 1
        # startup_token -> handle (not yet registered)
        self._starting: Dict[int, WorkerHandle] = {}
        # worker_id -> handle (registered)
        self.workers: Dict[bytes, WorkerHandle] = {}
        self._by_pid: Dict[int, WorkerHandle] = {}
        self._idle: List[WorkerHandle] = []
        self._fs_proc: Optional[asyncio.subprocess.Process] = None
        self._fs_ready: Optional[asyncio.Event] = None
        self._fs_lock = asyncio.Lock()
        # pids whose death arrived before their "spawned" message (the fork
        # server's reaper thread can win that race for insta-crashing workers)
        self._dead_pids: Dict[int, Optional[int]] = {}
        # direct-exec workers (conda/container): (handle, Popen) — their
        # deaths are polled (no fork-server reaper covers them)
        self._exec_procs: list = []

    # ----------------------------------------------------------- fork server

    async def _ensure_fork_server(self):
        """Start (or restart) the fork server; raises if it fails to come up."""
        if self._fs_proc is not None and self._fs_proc.returncode is None:
            await self._await_fs_ready()
            return
        async with self._fs_lock:
            if self._fs_proc is not None and self._fs_proc.returncode is None:
                await self._await_fs_ready()
                return
            self._fs_ready = asyncio.Event()
            env = dict(os.environ)
            repo_root = os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            )
            env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
            log_dir = os.path.join(self._session_dir, "logs")
            os.makedirs(log_dir, exist_ok=True)
            err = open(os.path.join(log_dir, "fork_server.err"), "ab")
            self._fs_proc = await asyncio.create_subprocess_exec(
                sys.executable, "-u", "-m", "ray_tpu_torch._private.workers.fork_server",
                f"--raylet-host={self._raylet_addr[0]}",
                f"--raylet-port={self._raylet_addr[1]}",
                f"--gcs-address={self._gcs_addr}",
                f"--session-dir={self._session_dir}",
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=err,
                env=env,
            )
            asyncio.ensure_future(self._fs_read_loop(self._fs_proc, self._fs_ready))
            await self._await_fs_ready()

    async def _await_fs_ready(self):
        try:
            await asyncio.wait_for(
                self._fs_ready.wait(), CONFIG.worker_startup_timeout_s
            )
        except asyncio.TimeoutError:
            raise RuntimeError("fork server did not become ready") from None
        if self._fs_proc is None or self._fs_proc.returncode is not None:
            raise RuntimeError("fork server died during startup")

    async def _fs_read_loop(self, proc, ready_event):
        while True:
            line = await proc.stdout.readline()
            if not line:
                break
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            if msg.get("ready"):
                ready_event.set()
            elif "spawned" in msg:
                handle = self._starting.get(msg["spawned"])
                if handle is not None:
                    handle.pid = msg["pid"]
                    if msg["pid"] in self._dead_pids:
                        # the worker crashed before its spawn was announced
                        self._mark_dead(handle, self._dead_pids.pop(msg["pid"]))
                    else:
                        self._by_pid[msg["pid"]] = handle
            elif "dead" in msg:
                handle = self._by_pid.pop(msg["dead"], None)
                if handle is not None:
                    self._mark_dead(handle, msg.get("rc"))
                else:
                    self._dead_pids[msg["dead"]] = msg.get("rc")
        # Fork server EOF: wake any waiters so they fail fast instead of
        # hanging; a later spawn restarts it.
        ready_event.set()

    def _mark_dead(self, handle: WorkerHandle, rc: Optional[int]):
        if not handle.alive:
            return
        handle.alive = False
        handle.returncode = rc
        self._by_pid.pop(handle.pid, None)
        self.workers.pop(handle.worker_id, None)
        self._starting.pop(handle.startup_token, None)
        if handle in self._idle:
            self._idle.remove(handle)
        if handle.register_event is not None:
            handle.register_event.set()
        if handle.actor_ready is not None:
            handle.actor_ready.set()
        if self._on_worker_death_cb is not None:
            asyncio.ensure_future(self._on_worker_death_cb(handle))

    async def _fs_send(self, msg: dict):
        self._fs_proc.stdin.write((json.dumps(msg) + "\n").encode())
        await self._fs_proc.stdin.drain()

    # -------------------------------------------------------------- spawning

    @staticmethod
    def _env_key(env_overrides) -> str:
        if not env_overrides:
            return ""
        # JSON, not delimiter-joining: raw values may contain ';'/'=' and
        # must not let distinct environments collide onto one pooled worker.
        return json.dumps(sorted(env_overrides.items()))

    async def start_worker(
        self, job_id: bytes, env_overrides=None, spawn_extra: Optional[dict] = None
    ) -> WorkerHandle:
        from ray_tpu_torch._private import chaos as _chaos

        if _chaos.ARMED:
            act = _chaos.hit("raylet.spawn", job=job_id.hex())
            if act is not None:
                if act["action"] == "delay":
                    await asyncio.sleep(act["delay_s"])
                elif act["action"] in ("fail", "error", "drop"):
                    raise RuntimeError("chaos: worker spawn failed (injected)")
        if env_overrides and ("RTPU_TORCH_SPAWN_PYTHON" in env_overrides
                              or "RTPU_TORCH_SPAWN_PREFIX" in env_overrides):
            # conda / container runtime_env: the worker must run under a
            # DIFFERENT interpreter or inside a container, which a fork of
            # this interpreter can never provide — exec default_worker.py
            # directly (reference: conda.py worker command rewrite,
            # image_uri.py worker-in-container).
            return await self._start_worker_exec(
                job_id, env_overrides, spawn_extra)
        await self._ensure_fork_server()
        token = self._next_token
        self._next_token += 1
        log_prefix = os.path.join(self._session_dir, "logs", f"worker-{token}")
        handle = WorkerHandle(
            worker_id=b"", pid=0, job_id=job_id,
            startup_token=token, register_event=asyncio.Event(),
            env_key=self._env_key(env_overrides),
        )
        handle.log_prefix = log_prefix
        self._starting[token] = handle
        msg = {
            "token": token,
            "job_id": job_id.hex(),
            "env": env_overrides or {},
            "log_prefix": log_prefix,
        }
        if spawn_extra:
            msg.update(spawn_extra)
            if "actor" in spawn_extra:
                handle.actor_ready = asyncio.Event()
        await self._fs_send({"spawn": msg})
        return handle

    async def _start_worker_exec(
        self, job_id: bytes, env_overrides: dict,
        spawn_extra: Optional[dict] = None,
    ) -> WorkerHandle:
        """Spawn a worker as a fresh subprocess of an arbitrary interpreter
        (conda env python) and/or under a command prefix (docker run ...).
        No actor-in-spawn fast path here: the handle's actor_ready stays
        None, so the actor lease path drives CreateActor over RPC exactly
        like the idle-reuse branch."""
        import subprocess

        from ray_tpu_torch._private import repo_root

        env_overrides = dict(env_overrides)
        # env_key must cover the FULL overrides (incl. spawn keys): a conda
        # worker must never be pooled/reused for a different env's task.
        env_key = self._env_key(env_overrides)
        python = env_overrides.pop("RTPU_TORCH_SPAWN_PYTHON", "") or sys.executable
        prefix = json.loads(env_overrides.pop("RTPU_TORCH_SPAWN_PREFIX", "") or "[]")
        token = self._next_token
        self._next_token += 1
        log_prefix = os.path.join(self._session_dir, "logs", f"worker-{token}")
        handle = WorkerHandle(
            worker_id=b"", pid=0, job_id=job_id,
            startup_token=token, register_event=asyncio.Event(),
            env_key=env_key,
        )
        handle.log_prefix = log_prefix
        self._starting[token] = handle
        cmd = prefix + [
            python, "-m", "ray_tpu_torch._private.workers.default_worker",
            "--raylet-host", self._raylet_addr[0],
            "--raylet-port", str(self._raylet_addr[1]),
            "--gcs-address", self._gcs_addr,
            "--node-id", self._node_id.hex(),
            "--plasma-name", self._plasma_name,
            "--job-id", job_id.hex(),
            "--startup-token", str(token),
            "--session-dir", self._session_dir,
        ]
        child_env = dict(os.environ)
        child_env.update({k: str(v) for k, v in env_overrides.items()})
        child_env["PYTHONPATH"] = (
            repo_root() + os.pathsep + child_env.get("PYTHONPATH", ""))
        os.makedirs(os.path.dirname(log_prefix), exist_ok=True)
        try:
            out = open(log_prefix + ".out", "ab")
            err = open(log_prefix + ".err", "ab")
            try:
                # Own session: kill_worker kills by PROCESS GROUP (the fork
                # server's killpg) — without setsid this worker would share
                # the raylet's group and a routine idle-reap would SIGKILL
                # the whole node.
                proc = subprocess.Popen(cmd, env=child_env, stdout=out,
                                        stderr=err, stdin=subprocess.DEVNULL,
                                        start_new_session=True)
            finally:
                out.close()
                err.close()
        except Exception:
            # Never leak the _starting entry (it would skew prestart's
            # accounting forever and hold the cap).
            self._starting.pop(token, None)
            raise
        handle.pid = proc.pid
        self._by_pid[proc.pid] = handle
        self._exec_procs.append((handle, proc))
        return handle

    def on_worker_registered(
        self, startup_token: int, worker_id: bytes, addr: Tuple[str, int]
    ) -> Optional[WorkerHandle]:
        handle = self._starting.pop(startup_token, None)
        if handle is None:
            return None
        handle.worker_id = worker_id
        handle.addr = addr
        handle.registered = True
        self.workers[worker_id] = handle
        handle.register_event.set()
        return handle

    async def pop_worker(
        self, job_id: bytes, env_overrides=None, spawn_extra: Optional[dict] = None
    ) -> Optional[WorkerHandle]:
        """Get an idle worker for the job or fork a fresh one. Awaits
        registration — or, when `spawn_extra` carries an actor spec, the
        creation result folded into the child's RegisterWorker request (the
        actor initializes during boot, so the lease path pays one
        round-trip instead of lease+create).

        An idle hit returns a registered worker with `actor_ready is None`;
        the caller then drives CreateActor over RPC itself."""
        env_key = self._env_key(env_overrides)
        for i, h in enumerate(self._idle):
            if h.job_id == job_id and h.alive and h.env_key == env_key:
                self._idle.pop(i)
                h.leased = True
                return h
        try:
            handle = await self.start_worker(job_id, env_overrides, spawn_extra)
        except Exception:
            # fork server failed to start or its stdin pipe broke; callers
            # (lease handlers) must release their resource grants on None.
            return None
        wait_event = handle.actor_ready or handle.register_event
        try:
            await asyncio.wait_for(
                wait_event.wait(), CONFIG.worker_startup_timeout_s
            )
        except asyncio.TimeoutError:
            await self.kill_worker(handle)
            return None
        if not handle.registered:
            return None
        handle.leased = True
        return handle

    def on_actor_created(self, worker_id: bytes, startup_token: int,
                         result: dict):
        """Spawn-time actor creation outcome (from RegisterWorker)."""
        handle = self.workers.get(worker_id)
        if handle is None:
            handle = self._starting.get(startup_token)
        if handle is not None and handle.actor_ready is not None:
            handle.actor_result = result
            handle.actor_ready.set()

    def push_idle(self, handle: WorkerHandle):
        handle.leased = False
        handle.lease_id = b""
        handle.idle_since = time.time()
        if handle.alive:
            self._idle.append(handle)

    async def kill_worker(self, handle: WorkerHandle):
        # Pool-initiated: the death callback must not treat it as a crash.
        handle.expected_death = True
        if handle.pid:
            if self._fs_proc is not None and self._fs_proc.returncode is None:
                try:
                    await self._fs_send({"kill": handle.pid})
                except Exception:
                    self._kill_pid(handle.pid)
            else:
                # fork server gone: the worker is orphaned to init; kill it
                # directly (same host) — the liveness poll reports the death.
                self._kill_pid(handle.pid)
        self.workers.pop(handle.worker_id, None)
        if handle in self._idle:
            self._idle.remove(handle)
        self._starting.pop(handle.startup_token, None)

    @staticmethod
    def _kill_pid(pid: int):
        try:
            os.killpg(os.getpgid(pid), 9)
        except Exception:
            try:
                os.kill(pid, 9)
            except Exception:
                pass

    def reap_idle(self):
        now = time.time()
        keep = []
        for h in self._idle:
            if now - h.idle_since > CONFIG.idle_worker_keep_alive_s:
                asyncio.ensure_future(self.kill_worker(h))
            else:
                keep.append(h)
        self._idle = keep

    def check_liveness(self):
        """Fallback death detection: if the fork server died, its orphaned
        workers can't be waitpid-ed by anyone — poll pid liveness directly.
        Direct-exec (conda/container) workers are OUR subprocesses and are
        always polled (reaps the zombie too)."""
        for handle, proc in list(self._exec_procs):
            if proc.poll() is not None:
                self._exec_procs.remove((handle, proc))
                self._mark_dead(handle, proc.returncode)
        if self._fs_proc is not None and self._fs_proc.returncode is None:
            return
        for handle in list(self._by_pid.values()):
            try:
                os.kill(handle.pid, 0)
            except ProcessLookupError:
                self._mark_dead(handle, None)
            except Exception:
                pass

    def kill_job_workers(self, job_id: bytes):
        for h in list(self.workers.values()):
            if h.job_id == job_id and not h.actor_id:
                asyncio.ensure_future(self.kill_worker(h))

    def shutdown(self):
        # include workers still starting (forked but not yet registered)
        handles = (
            set(self.workers.values())
            | set(self._starting.values())
            | set(self._by_pid.values())
        )
        for h in handles:
            h.expected_death = True
            if h.pid:
                self._kill_pid(h.pid)
        if self._fs_proc is not None and self._fs_proc.returncode is None:
            try:
                self._fs_proc.kill()
            except Exception:
                pass

    def num_idle(self) -> int:
        return len(self._idle)

    async def prestart(self, job_id: bytes, env_overrides=None,
                       target_idle: int = 2, cap_starting: int = 8):
        """Keep warm registered workers ready for this job (reference:
        worker_pool.h:359 PrestartWorkers). Called fire-and-forget after
        lease activity: tops idle+starting up to `target_idle` so the next
        lease pops a booted worker instead of paying fork+boot latency.
        On a saturated single core this converts nothing (boot CPU is the
        bound — measured: creation runs at 0% idle); on real multi-core
        hosts the boots overlap the caller's work."""
        env_key = self._env_key(env_overrides)
        have = sum(
            1 for h in self._idle
            if h.job_id == job_id and h.alive and h.env_key == env_key
        )
        # In-flight starts for this job count toward the target, or a lease
        # burst fires N prestarts that each see have=0 and over-spawn to
        # the global cap.
        have += sum(
            1 for h in self._starting.values()
            if h.job_id == job_id and h.env_key == env_key
        )
        need = min(target_idle - have, cap_starting - len(self._starting))
        if need <= 0:
            return
        handles = []
        try:
            for _ in range(need):
                handles.append(
                    await self.start_worker(job_id, env_overrides))
        except Exception:
            pass  # fork server broke; still settle what did start
        for handle in handles:
            try:
                await asyncio.wait_for(
                    handle.register_event.wait(),
                    CONFIG.worker_startup_timeout_s)
            except asyncio.TimeoutError:
                await self.kill_worker(handle)
                continue
            if handle.registered and not handle.leased:
                self.push_idle(handle)
