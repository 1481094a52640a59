"""The port's cluster launcher e2e, a copy of ``tests/test_launcher.py`` over
``ray_tpu_torch``: `up` bootstraps a head + worker as isolated local
processes (provider type `process` — the fake-multinode analogue of
reference autoscaler/_private/fake_multi_node/node_provider.py) through the
``ray-tpu-torch`` CLI, a driver connects and runs work across both nodes,
`down` tears everything back down. Plus the parsed config and the ssh argv
held against the JAX package's for the same input."""

import socket
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import launcher

from _torch_runtime import port_env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def cluster_yaml(tmp_path, monkeypatch):
    port_env(monkeypatch)
    port = _free_port()
    config = f"""
cluster_name: fake-e2e
provider:
  type: process
  state_dir: {tmp_path}/nodes
  head_ip: 127.0.0.1
  worker_ips: ["127.0.0.1"]
setup_commands:
  - echo setup-ran > setup_marker.txt
head_start_command: >-
  ray-tpu-torch start --head --host 127.0.0.1 --port {port}
  --resources '{{"CPU": 2, "GPU": 0, "head_label": 1}}'
worker_start_command: >-
  ray-tpu-torch start --address=127.0.0.1:{port}
  --resources '{{"CPU": 2, "GPU": 0, "worker_label": 1}}'
"""
    path = tmp_path / "cluster.yaml"
    path.write_text(config)
    yield str(path), port, tmp_path
    # belt-and-braces teardown if the test failed mid-way
    try:
        launcher.down(str(path))
    except Exception:
        pass


@pytest.mark.timeout(150)
def test_up_run_down(cluster_yaml):
    path, port, tmp_path = cluster_yaml
    info = launcher.up(path)
    assert info["gcs_address"] == f"127.0.0.1:{port}"

    # setup commands ran on every node
    for node in ("node-0", "node-1"):
        marker = tmp_path / "nodes" / "fake-e2e" / node / "setup_marker.txt"
        assert marker.read_text().strip() == "setup-ran", node

    ray_tpu_torch.init(address=info["gcs_address"])
    try:
        # both nodes joined with their labels
        deadline = time.time() + 60
        while time.time() < deadline:
            total = ray_tpu_torch.cluster_resources()
            if total.get("head_label") and total.get("worker_label"):
                break
            time.sleep(1)
        total = ray_tpu_torch.cluster_resources()
        assert total.get("head_label") == 1.0, total
        assert total.get("worker_label") == 1.0, total
        assert total.get("CPU") == 4.0, total
        assert not total.get("GPU"), total  # --resources GPU 0: no card

        # run work pinned to each node's label
        @ray_tpu_torch.remote(resources={"worker_label": 0.1})
        def on_worker():
            return "w"

        @ray_tpu_torch.remote(resources={"head_label": 0.1})
        def on_head():
            return "h"

        assert ray_tpu_torch.get([on_worker.remote(), on_head.remote()],
                                 timeout=60) == ["w", "h"]
    finally:
        ray_tpu_torch.shutdown()

    launcher.down(path)
    # the GCS is gone: a fresh connect must fail
    from ray_tpu_torch._private.gcs.client import GcsClient

    time.sleep(2)
    with pytest.raises(Exception):
        GcsClient("127.0.0.1", port).call("Ping", {}, timeout=5)


def test_config_validation(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("cluster_name: x\nprovider:\n  type: warp\n")
    with pytest.raises(launcher.LauncherError, match="provider.type"):
        launcher.load_cluster_config(str(bad))
    bad.write_text("provider:\n  type: static\n  head_ip: 1.2.3.4\n")
    with pytest.raises(launcher.LauncherError, match="cluster_name"):
        launcher.load_cluster_config(str(bad))


def _ssh_argv(mod, env):
    calls = {}

    def fake_run(cmd, **kw):
        calls["cmd"] = cmd

        class R:
            returncode = 0
            stdout = ""
            stderr = ""

        return R()

    runner = mod.SSHCommandRunner(
        "10.0.0.9", {"ssh_user": "tpu", "ssh_private_key": "/k"}, "c1"
    )
    orig = mod.subprocess.run
    mod.subprocess.run = fake_run
    try:
        runner.run("echo hi", env=env)
    finally:
        mod.subprocess.run = orig
    return calls["cmd"]


def test_ssh_runner_command_shape():
    """SSH runner builds a correct command line (no live ssh in CI — we
    intercept subprocess.run)."""
    cmd = _ssh_argv(launcher, {"RTPU_TORCH_HEAD_IP": "10.0.0.2"})
    assert cmd[0] == "ssh" and "tpu@10.0.0.9" in cmd
    assert any("ControlMaster=auto" in c for c in cmd)
    assert "-i" in cmd and "/k" in cmd
    joined = " ".join(cmd)
    assert "RTPU_TORCH_HEAD_IP" in joined and "echo hi" in joined


# ------------------------------------------------- against the JAX package


def test_ssh_argv_matches_the_jax_package():
    """The same command and environment give the same ssh argv, but for the
    ssh control directory, which is each package's own."""
    from ray_tpu.autoscaler import launcher as jax_launcher

    env = {"GREETING": "hi there", "X": "1"}
    port = _ssh_argv(launcher, env)
    assert any("rtpu_torch_ssh" in arg for arg in port)
    assert [arg.replace("rtpu_torch_ssh", "rtpu_ssh") for arg in port] \
        == _ssh_argv(jax_launcher, env)


def test_loaded_config_matches_the_jax_package(tmp_path):
    """A YAML config loads to the same dict under both packages, but for
    the default commands, which name each package's own CLI and
    environment."""
    from ray_tpu.autoscaler import launcher as jax_launcher

    path = tmp_path / "c.yaml"
    path.write_text(
        "cluster_name: c\nprovider:\n  type: static\n  head_ip: 1.2.3.4\n"
        "  worker_ips: [1.2.3.5]\nsetup_commands: [echo hi]\n")
    ours = launcher.load_cluster_config(str(path))
    ref = jax_launcher.load_cluster_config(str(path))

    def as_jax(v):
        if isinstance(v, str):
            return v.replace("ray-tpu-torch", "ray-tpu").replace(
                "RTPU_TORCH_", "RTPU_")
        return v

    assert {k: as_jax(v) for k, v in ours.items()} == ref
    assert ours["head_start_command"].startswith("ray-tpu-torch start --head")
    assert "$RTPU_TORCH_NODE_IP" in ours["head_start_command"]
    assert ours["stop_command"] == "ray-tpu-torch stop"
