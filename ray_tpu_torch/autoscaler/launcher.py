"""Cluster launcher: ``ray-tpu-torch up / down`` from a YAML cluster config.

Counterpart of the reference's launcher stack
(reference: python/ray/autoscaler/_private/commands.py:221
create_or_update_cluster, updater.py:40 NodeUpdater, command_runner.py:159
SSHCommandRunner, local/node_provider.py). Redesigned for the TPU-pod
shape: a pod's hosts are a FIXED fleet (provisioned by the cloud when the
slice is created), so the primary provider is a static host list reached
over SSH; elastic providers plug in through the same create/terminate
seam the autoscaler's CommandNodeProvider uses.

Config (YAML):

    cluster_name: my-tpu-pod
    provider:
      type: static            # static | command | process (tests)
      head_ip: 10.0.0.2
      worker_ips: [10.0.0.3, 10.0.0.4]
    auth:
      ssh_user: ubuntu
      ssh_private_key: ~/.ssh/id_rsa     # optional
    file_mounts:
      /remote/path: /local/path          # rsync'd before setup
    initialization_commands: []          # run once per node, pre-setup
    setup_commands:                      # run per node before start
      - pip install -e /remote/path
    head_setup_commands: []              # extra, head only
    worker_setup_commands: []            # extra, workers only
    head_start_command: >-
      ray-tpu-torch start --head --host $RTPU_TORCH_NODE_IP --port 6379
    worker_start_command: >-
      ray-tpu-torch start --address=$RTPU_TORCH_HEAD_IP:6379 --host $RTPU_TORCH_NODE_IP
    stop_command: ray-tpu-torch stop

Every command runs with RTPU_TORCH_NODE_IP / RTPU_TORCH_HEAD_IP / RTPU_TORCH_CLUSTER_NAME
exported. ``type: command`` adds create/terminate shell templates for
elastic fleets; ``type: process`` runs each "node" as local processes in
isolated state dirs (the fake-multinode e2e,
reference: autoscaler/_private/fake_multi_node/node_provider.py).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import yaml

DEFAULT_HEAD_START = (
    "ray-tpu-torch start --head --host $RTPU_TORCH_NODE_IP --port 6379"
)
DEFAULT_WORKER_START = (
    "ray-tpu-torch start --address=$RTPU_TORCH_HEAD_IP:6379 --host $RTPU_TORCH_NODE_IP"
)
DEFAULT_STOP = "ray-tpu-torch stop"


class LauncherError(RuntimeError):
    pass


def load_cluster_config(path: str) -> dict:
    with open(path) as f:
        config = yaml.safe_load(f)
    if not isinstance(config, dict):
        raise LauncherError(f"{path}: config must be a mapping")
    for key in ("cluster_name", "provider"):
        if key not in config:
            raise LauncherError(f"{path}: missing required key '{key}'")
    provider = config["provider"]
    ptype = provider.get("type")
    if ptype not in ("static", "command", "process", "gcp-tpu"):
        raise LauncherError(
            f"provider.type must be static|command|process|gcp-tpu, got {ptype!r}"
        )
    if ptype in ("static", "process") and "head_ip" not in provider:
        raise LauncherError("provider.head_ip is required")
    if ptype == "command" and "create_command" not in provider:
        raise LauncherError(
            "provider.create_command is required for type: command"
        )
    if ptype == "gcp-tpu":
        for key in ("project", "zone"):
            if key not in provider:
                raise LauncherError(f"provider.{key} is required for gcp-tpu")
        if not config.get("tpu_node_types"):
            raise LauncherError("gcp-tpu needs a tpu_node_types section")
    config.setdefault("auth", {})
    config.setdefault("file_mounts", {})
    config.setdefault("initialization_commands", [])
    config.setdefault("setup_commands", [])
    config.setdefault("head_setup_commands", [])
    config.setdefault("worker_setup_commands", [])
    config.setdefault("head_start_command", DEFAULT_HEAD_START)
    config.setdefault("worker_start_command", DEFAULT_WORKER_START)
    config.setdefault("stop_command", DEFAULT_STOP)
    # reject an unknowable GCS address BEFORE provisioning anything
    _extract_port(config["head_start_command"])
    return config


# --------------------------------------------------------------- runners


class CommandRunner:
    """Runs shell commands / syncs files on one node."""

    def run(self, cmd: str, env: Optional[Dict[str, str]] = None,
            timeout: float = 600.0) -> str:
        raise NotImplementedError

    def sync(self, local: str, remote: str) -> None:
        raise NotImplementedError


class SSHCommandRunner(CommandRunner):
    """ssh/rsync with connection multiplexing (reference:
    command_runner.py:159 — same ControlMaster trick so N setup commands
    pay one handshake)."""

    def __init__(self, ip: str, auth: dict, cluster_name: str):
        self.ip = ip
        self.user = auth.get("ssh_user", "")
        self.key = os.path.expanduser(auth.get("ssh_private_key", "")) or None
        control_dir = os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "rtpu_torch_ssh", cluster_name
        )
        os.makedirs(control_dir, exist_ok=True)
        self._opts = [
            "-o", "StrictHostKeyChecking=no",
            "-o", "UserKnownHostsFile=/dev/null",
            "-o", "LogLevel=ERROR",
            "-o", "ConnectTimeout=10",
            "-o", "ControlMaster=auto",
            "-o", f"ControlPath={control_dir}/%r@%h:%p",
            "-o", "ControlPersist=60s",
        ]
        if self.key:
            self._opts += ["-i", self.key]

    def _target(self) -> str:
        return f"{self.user}@{self.ip}" if self.user else self.ip

    def run(self, cmd: str, env: Optional[Dict[str, str]] = None,
            timeout: float = 600.0) -> str:
        exports = "".join(
            f"export {k}={shlex.quote(str(v))}; " for k, v in (env or {}).items()
        )
        full = ["ssh"] + self._opts + [self._target(),
                                       f"bash -lc {shlex.quote(exports + cmd)}"]
        proc = subprocess.run(
            full, capture_output=True, text=True, timeout=timeout
        )
        if proc.returncode != 0:
            raise LauncherError(
                f"[{self.ip}] `{cmd}` failed (rc={proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        return proc.stdout

    def sync(self, local: str, remote: str) -> None:
        ssh_cmd = " ".join(["ssh"] + [shlex.quote(o) for o in self._opts])
        if os.path.isdir(local):
            # trailing slash: copy CONTENTS into `remote` (same semantics
            # as the process runner's copytree), not a nested dir
            local = local.rstrip("/") + "/"
            self.run(f"mkdir -p {shlex.quote(remote)}")
        else:
            self.run(f"mkdir -p {shlex.quote(os.path.dirname(remote) or '/')}")
        proc = subprocess.run(
            ["rsync", "-az", "-e", ssh_cmd, local,
             f"{self._target()}:{remote}"],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise LauncherError(
                f"[{self.ip}] rsync {local} -> {remote} failed:\n{proc.stderr}"
            )


class ProcessCommandRunner(CommandRunner):
    """Runs "remote" commands as local subprocesses in a per-node state
    dir — the fake-multinode provider's runner. Each logical node gets its
    own RTPU_TORCH_STATE_FILE and TMPDIR so head/workers on one machine don't
    clobber each other."""

    def __init__(self, ip: str, node_dir: str):
        self.ip = ip
        self.node_dir = node_dir
        os.makedirs(node_dir, exist_ok=True)

    def run(self, cmd: str, env: Optional[Dict[str, str]] = None,
            timeout: float = 600.0) -> str:
        full_env = dict(os.environ)
        full_env.update(env or {})
        full_env["RTPU_TORCH_STATE_FILE"] = os.path.join(self.node_dir, "state.json")
        # `ray-tpu-torch` resolves through the current interpreter even when the
        # console script isn't on PATH (test environments).
        from ray_tpu_torch._private import repo_root

        full_env["PYTHONPATH"] = (
            repo_root() + os.pathsep + full_env.get("PYTHONPATH", "")
        )
        cmd = cmd.replace("ray-tpu-torch ", f"{sys.executable} -m ray_tpu_torch.scripts ")
        proc = subprocess.run(
            ["bash", "-c", cmd], capture_output=True, text=True,
            timeout=timeout, env=full_env, cwd=self.node_dir,
        )
        if proc.returncode != 0:
            raise LauncherError(
                f"[{self.ip}] `{cmd}` failed (rc={proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        return proc.stdout

    def sync(self, local: str, remote: str) -> None:
        import shutil

        dest = os.path.join(self.node_dir, remote.lstrip("/"))
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        if os.path.isdir(local):
            shutil.copytree(local, dest, dirs_exist_ok=True)
        else:
            shutil.copy2(local, dest)


# --------------------------------------------------------------- updater


class NodeUpdater:
    """Brings one node from bare to running: wait-for-reachable, sync file
    mounts, initialization + setup commands, start command (reference:
    updater.py:40 NodeUpdater.run)."""

    def __init__(self, ip: str, runner: CommandRunner, config: dict,
                 head_ip: str, is_head: bool):
        self.ip = ip
        self.runner = runner
        self.config = config
        self.head_ip = head_ip
        self.is_head = is_head
        self.error: Optional[Exception] = None

    def _env(self) -> Dict[str, str]:
        return {
            "RTPU_TORCH_NODE_IP": self.ip,
            "RTPU_TORCH_HEAD_IP": self.head_ip,
            "RTPU_TORCH_CLUSTER_NAME": self.config["cluster_name"],
        }

    def wait_ready(self, timeout: float = 120.0):
        deadline = time.time() + timeout
        last = None
        while time.time() < deadline:
            try:
                self.runner.run("uptime", timeout=15)
                return
            except Exception as e:
                last = e
                time.sleep(3)
        raise LauncherError(f"node {self.ip} never became reachable: {last}")

    def update(self):
        try:
            self.wait_ready()
            for remote, local in self.config["file_mounts"].items():
                self.runner.sync(os.path.expanduser(local), remote)
            env = self._env()
            commands = list(self.config["initialization_commands"])
            commands += self.config["setup_commands"]
            commands += (
                self.config["head_setup_commands"] if self.is_head
                else self.config["worker_setup_commands"]
            )
            commands.append(
                self.config["head_start_command"] if self.is_head
                else self.config["worker_start_command"]
            )
            for cmd in commands:
                print(f"[{self.ip}] $ {cmd}")
                out = self.runner.run(cmd, env=env)
                if out.strip():
                    print("\n".join(
                        f"[{self.ip}] {line}"
                        for line in out.strip().splitlines()[-5:]
                    ))
        except Exception as e:  # captured for the parallel-update driver
            self.error = e


# --------------------------------------------------------------- up/down


def _runner_for(config: dict, ip: str, node_index: int) -> CommandRunner:
    ptype = config["provider"]["type"]
    if ptype == "process":
        base = config["provider"].get(
            "state_dir",
            os.path.join(os.environ.get("TMPDIR", "/tmp"), "rtpu_torch_fake_nodes"),
        )
        return ProcessCommandRunner(
            ip, os.path.join(base, config["cluster_name"], f"node-{node_index}")
        )
    return SSHCommandRunner(ip, config["auth"], config["cluster_name"])


def _node_ips(config: dict) -> tuple:
    provider = config["provider"]
    ptype = provider["type"]
    if ptype in ("static", "process"):
        return provider["head_ip"], list(provider.get("worker_ips", []))
    if ptype == "gcp-tpu":
        from ray_tpu_torch.autoscaler.gcp_tpu import cluster_ips

        return cluster_ips(_gcp_provider(config), config)
    if ptype == "command":
        # Elastic: shell templates create the fleet, then report its IPs.
        create = provider["create_command"]  # $RTPU_TORCH_NODE_COUNT substituted
        n = int(provider.get("num_workers", 0)) + 1
        out = subprocess.run(
            ["bash", "-c", create.replace("$RTPU_TORCH_NODE_COUNT", str(n))],
            capture_output=True, text=True, timeout=1800,
        )
        if out.returncode != 0:
            raise LauncherError(f"create_command failed:\n{out.stderr}")
        ips = out.stdout.split()
        if len(ips) < n:
            raise LauncherError(
                f"create_command printed {len(ips)} IPs, need {n}"
            )
        return ips[0], ips[1:n]
    raise LauncherError(f"unknown provider type {ptype}")


def up(config_path: str) -> dict:
    """Provision + bootstrap the cluster; returns {head_ip, gcs_address}."""
    config = load_cluster_config(config_path)
    head_ip, worker_ips = _node_ips(config)
    print(f"cluster '{config['cluster_name']}': head {head_ip}, "
          f"{len(worker_ips)} workers")

    head = NodeUpdater(
        head_ip, _runner_for(config, head_ip, 0), config, head_ip, True
    )
    head.update()
    if head.error:
        raise LauncherError(f"head bootstrap failed: {head.error}")

    updaters = [
        NodeUpdater(ip, _runner_for(config, ip, i + 1), config, head_ip, False)
        for i, ip in enumerate(worker_ips)
    ]
    threads = [
        threading.Thread(target=u.update, daemon=True) for u in updaters
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [u for u in updaters if u.error]
    if failed:
        raise LauncherError(
            "; ".join(f"{u.ip}: {u.error}" for u in failed)
        )
    gcs_port = _extract_port(config["head_start_command"])
    print(f"cluster up: connect with ray_tpu_torch.init("
          f"address='{head_ip}:{gcs_port}')")
    return {"head_ip": head_ip, "gcs_address": f"{head_ip}:{gcs_port}"}


def _extract_port(head_start_command: str) -> int:
    toks = head_start_command.split()
    port = None
    for i, t in enumerate(toks):
        if t == "--port" and i + 1 < len(toks):
            port = int(toks[i + 1])
        elif t.startswith("--port="):
            port = int(t.split("=", 1)[1])
    if not port:  # absent or explicit 0 (auto): the address is unknowable
        raise LauncherError(
            "head_start_command must pin a fixed --port so workers and "
            "drivers can address the GCS (auto ports only work "
            "single-node)"
        )
    return port


def down(config_path: str) -> None:
    """Stop every node (workers first so the head sees clean departures),
    then terminate elastic fleets."""
    config = load_cluster_config(config_path)
    head_ip, worker_ips = _node_ips_cached_or_static(config)
    stop = config["stop_command"]
    for i, ip in enumerate(worker_ips):
        try:
            _runner_for(config, ip, i + 1).run(stop, timeout=60)
            print(f"[{ip}] stopped")
        except Exception as e:
            print(f"[{ip}] stop failed: {e}", file=sys.stderr)
    if head_ip:
        try:
            _runner_for(config, head_ip, 0).run(stop, timeout=60)
            print(f"[{head_ip}] stopped")
        except Exception as e:
            print(f"[{head_ip}] stop failed: {e}", file=sys.stderr)
    terminate = config["provider"].get("terminate_command")
    if terminate:
        subprocess.run(["bash", "-c", terminate], timeout=1800)
    if config["provider"]["type"] == "gcp-tpu":
        from ray_tpu_torch.autoscaler.gcp_tpu import teardown

        for pid in teardown(_gcp_provider(config)):
            print(f"terminated TPU slice {pid}")


def _gcp_provider(config: dict):
    from ray_tpu_torch.autoscaler.gcp_tpu import GcpTpuNodeProvider

    provider = config["provider"]
    return GcpTpuNodeProvider(
        project=provider["project"], zone=provider["zone"],
        cluster_name=config["cluster_name"],
        node_types=config.get("tpu_node_types", {}),
        timeout_s=float(provider.get("gcloud_timeout_s", 900.0)),
    )


def _node_ips_cached_or_static(config: dict) -> tuple:
    provider = config["provider"]
    if provider["type"] in ("static", "process"):
        return provider["head_ip"], list(provider.get("worker_ips", []))
    if provider["type"] == "gcp-tpu":
        gcp = _gcp_provider(config)
        head_type = provider.get("head_type", "head")
        # Head slice first: down() stops workers before the head, so ips[0]
        # must really be the head host, whatever order gcloud lists in.
        nodes = sorted(gcp.non_terminated_nodes().items(),
                       key=lambda kv: kv[1] != head_type)
        ips: list = []
        for pid, _ntype in nodes:
            ips.extend(gcp.slice_hosts(pid))
        if not ips:
            return "", []
        return ips[0], ips[1:]
    # command provider: the operator's list_command reports the live fleet
    lister = provider.get("list_command")
    if not lister:
        raise LauncherError(
            "command provider needs list_command for `down`"
        )
    out = subprocess.run(
        ["bash", "-c", lister], capture_output=True, text=True, timeout=300
    )
    if out.returncode != 0:
        raise LauncherError(
            f"list_command failed (rc={out.returncode}):\n{out.stderr}"
        )
    ips = out.stdout.split()
    if not ips:
        return "", []
    return ips[0], ips[1:]
