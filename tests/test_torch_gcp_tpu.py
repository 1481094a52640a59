"""The port's GCP TPU-VM node provider (ray_tpu_torch/autoscaler/gcp_tpu.py,
a copy of the JAX package's): a copy of ``tests/test_gcp_tpu.py`` over
``ray_tpu_torch``, plus the gcloud argv held against the JAX package's for
the same calls. Recorded-command unit tests with an injected gcloud runner (the reference mocks googleapiclient
the same way, python/ray/tests/gcp/test_gcp_node_provider.py), plus the
launcher glue, plus an executable fake-ssh-on-PATH test that drives
SSHCommandRunner through a real subprocess instead of a monkeypatch."""

import json
import os
import stat
import sys

import pytest

from ray_tpu_torch.autoscaler.gcp_tpu import (
    GcpTpuNodeProvider,
    cluster_ips,
    teardown,
)

NODE_TYPES = {
    "head": {"accelerator_type": "v5litepod-8",
             "version": "tpu-ubuntu2204-base"},
    "worker": {"accelerator_type": "v5litepod-16",
               "version": "tpu-ubuntu2204-base", "spot": True},
}


class FakeGcloud:
    """Records every argv; answers list/describe from a mutable fleet."""

    def __init__(self):
        self.calls = []
        self.fleet = {}  # name -> {type, state, endpoints}

    def __call__(self, argv, timeout):
        self.calls.append(argv)
        assert argv[:5] == ["gcloud", "compute", "tpus", "tpu-vm", argv[4]]
        verb = argv[4]
        assert "--project" in argv and "--zone" in argv
        if verb == "create":
            name = argv[argv.index("--zone") + 2]
            labels = argv[argv.index("--labels") + 1]
            ntype = dict(kv.split("=") for kv in labels.split(","))[
                "rtpu-node-type"]
            n_hosts = 2 if ntype == "worker" else 1
            self.fleet[name] = {
                "type": ntype, "state": "READY",
                "endpoints": [f"10.0.{len(self.fleet)}.{i}"
                              for i in range(n_hosts)],
            }
            return ""
        if verb == "list":
            return json.dumps([
                {"name": f"projects/p/locations/z/nodes/{name}",
                 "state": rec["state"],
                 "labels": {"rtpu-cluster": "c1",
                            "rtpu-node-type": rec["type"]}}
                for name, rec in self.fleet.items()
            ])
        if verb == "describe":
            name = argv[argv.index("--zone") + 2]
            rec = self.fleet[name]
            return json.dumps({
                "name": name, "state": rec["state"],
                "networkEndpoints": [{"ipAddress": ip}
                                     for ip in rec["endpoints"]],
            })
        if verb == "delete":
            name = argv[argv.index("--zone") + 2]
            self.fleet.pop(name, None)
            return ""
        raise AssertionError(f"unexpected verb {verb}")


def _provider(fake):
    return GcpTpuNodeProvider(
        project="proj", zone="us-central2-b", cluster_name="c1",
        node_types=NODE_TYPES, runner=fake, timeout_s=5)


def test_create_command_shape():
    fake = FakeGcloud()
    p = _provider(fake)
    (name,) = p.create_node("worker")
    assert name.startswith("c1-worker-")
    argv = fake.calls[0]
    assert argv[4] == "create"
    assert argv[argv.index("--accelerator-type") + 1] == "v5litepod-16"
    assert argv[argv.index("--version") + 1] == "tpu-ubuntu2204-base"
    assert "--spot" in argv
    assert ("rtpu-cluster=c1,rtpu-node-type=worker"
            == argv[argv.index("--labels") + 1])


def test_list_filters_terminal_states_and_foreign_clusters():
    fake = FakeGcloud()
    p = _provider(fake)
    p.create_node("head")
    (w,) = p.create_node("worker")
    fake.fleet[w]["state"] = "PREEMPTED"
    nodes = p.non_terminated_nodes()
    assert list(nodes.values()) == ["head"]
    list_call = fake.calls[-1]
    assert ("labels.rtpu-cluster=c1"
            == list_call[list_call.index("--filter") + 1])


def test_slice_hosts_expands_pod_endpoints():
    fake = FakeGcloud()
    p = _provider(fake)
    (w,) = p.create_node("worker")  # fake gives worker slices 2 hosts
    assert len(p.slice_hosts(w)) == 2


def test_cluster_ips_assembles_fleet_and_is_idempotent():
    fake = FakeGcloud()
    p = _provider(fake)
    config = {"provider": {"head_type": "head",
                           "worker_types": {"worker": 2}}}
    head, workers = cluster_ips(p, config)
    assert head and len(workers) == 4  # 2 slices x 2 hosts
    created = [c for c in fake.calls if c[4] == "create"]
    assert len(created) == 3  # 1 head + 2 workers
    # second call finds the fleet and creates nothing
    head2, workers2 = cluster_ips(p, config)
    assert (head2, sorted(workers2)) == (head, sorted(workers))
    assert len([c for c in fake.calls if c[4] == "create"]) == 3


def test_wait_ready_polls_until_ready():
    fake = FakeGcloud()
    p = _provider(fake)
    (h,) = p.create_node("head")
    fake.fleet[h]["state"] = "CREATING"
    flips = {"n": 0}
    orig = fake.__call__

    def flip(argv, timeout):
        if argv[4] == "describe":
            flips["n"] += 1
            if flips["n"] >= 3:
                fake.fleet[h]["state"] = "READY"
        return orig(argv, timeout)

    p._run = flip
    rec = p.wait_ready(h, poll_s=0.01, timeout_s=5)
    assert rec["state"] == "READY" and flips["n"] >= 3


def test_teardown_deletes_every_labelled_slice():
    fake = FakeGcloud()
    p = _provider(fake)
    p.create_node("head")
    p.create_node("worker", 2)
    gone = teardown(p)
    assert len(gone) == 3 and fake.fleet == {}


def test_launcher_config_validation(tmp_path):
    import yaml

    from ray_tpu_torch.autoscaler.launcher import LauncherError, load_cluster_config

    cfg = {"cluster_name": "c1",
           "provider": {"type": "gcp-tpu", "project": "p"}}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(LauncherError, match="zone"):
        load_cluster_config(str(path))
    cfg["provider"]["zone"] = "z"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(LauncherError, match="tpu_node_types"):
        load_cluster_config(str(path))
    cfg["tpu_node_types"] = NODE_TYPES
    path.write_text(yaml.safe_dump(cfg))
    assert load_cluster_config(str(path))["provider"]["type"] == "gcp-tpu"


def test_launcher_node_ips_uses_provider(monkeypatch, tmp_path):
    import yaml

    from ray_tpu_torch.autoscaler import launcher

    fake = FakeGcloud()
    monkeypatch.setattr(launcher, "_gcp_provider",
                        lambda config: _provider(fake))
    cfg = {
        "cluster_name": "c1",
        "provider": {"type": "gcp-tpu", "project": "p", "zone": "z",
                     "head_type": "head", "worker_types": {"worker": 1}},
        "tpu_node_types": NODE_TYPES,
    }
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    config = launcher.load_cluster_config(str(path))
    head, workers = launcher._node_ips(config)
    assert head and len(workers) == 2  # the worker slice has 2 hosts
    # `down`'s listing path sees the same fleet
    head2, workers2 = launcher._node_ips_cached_or_static(config)
    assert set([head2] + workers2) == set([head] + workers)


# ------------------------------------------------------- real-subprocess ssh


@pytest.fixture
def fake_ssh_on_path(tmp_path, monkeypatch):
    """An executable `ssh` shim that RUNS the remote command locally (and an
    `rsync` shim copying via cp). Unlike monkeypatching subprocess.run,
    this drives SSHCommandRunner's real argv through a real exec — flag
    parsing bugs and quoting bugs fail loudly. (A true loopback sshd test
    needs an sshd binary; this image ships none.)"""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "ssh.log"
    ssh = bindir / "ssh"
    ssh.write_text(f"""#!{sys.executable}
import subprocess, sys
args = sys.argv[1:]
with open({str(log)!r}, "a") as f:
    f.write(repr(args) + "\\n")
# drop -o options and -i key
rest = []
i = 0
while i < len(args):
    if args[i] in ("-o", "-i"):
        i += 2
        continue
    rest.append(args[i]); i += 1
target, command = rest[0], " ".join(rest[1:])
assert "@" in target or target, target
proc = subprocess.run(["bash", "-c", command])
sys.exit(proc.returncode)
""")
    ssh.chmod(ssh.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return log


def test_ssh_runner_through_real_exec(fake_ssh_on_path, tmp_path):
    from ray_tpu_torch.autoscaler.launcher import SSHCommandRunner

    runner = SSHCommandRunner(
        "127.0.0.1", {"ssh_user": "u", "ssh_private_key": "~/.ssh/k"}, "c1")
    marker = tmp_path / "touched"
    out = runner.run(f"echo hello && touch {marker}",
                     env={"GREETING": "hi there"})
    assert "hello" in out
    assert marker.exists()  # the command really executed
    logged = fake_ssh_on_path.read_text()
    assert "u@127.0.0.1" in logged
    assert "ControlMaster=auto" in logged  # multiplexing opts reached exec
    # failures surface as LauncherError with the remote stderr
    from ray_tpu_torch.autoscaler.launcher import LauncherError

    with pytest.raises(LauncherError, match="rc=3"):
        runner.run("exit 3")


# ------------------------------------------------- against the JAX package


def _drive(provider_cls, teardown_fn):
    """One provider lifetime through a FakeGcloud: create, list, describe,
    wait, tear down. Returns the recorded argv and the fleet views."""
    fake = FakeGcloud()
    p = provider_cls(project="proj", zone="us-central2-b",
                     cluster_name="c1", node_types=NODE_TYPES, runner=fake,
                     timeout_s=5)
    names = p.create_node("head") + p.create_node("worker", 2)
    nodes = p.non_terminated_nodes()
    hosts = {n: p.slice_hosts(n) for n in names}
    ready = p.wait_ready(names[0], poll_s=0.01, timeout_s=5)["state"]
    gone = teardown_fn(p)
    strip = [[a for a in argv if not a.startswith("c1-")] for argv in fake.calls]
    return (strip, sorted(nodes.values()), sorted(map(len, hosts.values())),
            ready, len(gone))


def test_gcloud_calls_match_the_jax_package():
    """The same provider calls issue the same gcloud argv (node names aside:
    they carry a random suffix) and see the same fleet under both
    packages."""
    from ray_tpu.autoscaler import gcp_tpu as jax_gcp

    assert (_drive(GcpTpuNodeProvider, teardown)
            == _drive(jax_gcp.GcpTpuNodeProvider, jax_gcp.teardown))
