"""runtime_env conda + container of the port's worker pool, a copy of
``tests/test_runtime_env_conda.py`` against ``ray_tpu_torch``: workers
under a different interpreter or inside a container (reference: _private/runtime_env/conda.py:260,
image_uri.py:96). No conda binary or docker daemon ships in this image, so
both tests install executable fakes on PATH — like the reference's mocked
container/conda plumbing, but driven through a REAL subprocess exec: the
raylet genuinely builds the env / composes the docker argv, the worker
genuinely spawns through it, and a real task runs inside."""

import json
import os
import stat
import sys
import time

import pytest

import ray_tpu_torch
from _torch_runtime import port_env


@pytest.fixture
def fake_conda(tmp_path, monkeypatch):
    """`conda` shim: `env create -p DIR -f YML` materializes DIR/bin/python
    as a symlink to this interpreter (same ABI — exactly what a real conda
    env with a matching python version provides), recording the call."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "conda.log"
    conda = bindir / "conda"
    conda.write_text(f"""#!{sys.executable}
import json, os, sys
args = sys.argv[1:]
with open({str(log)!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
if args[:2] == ["env", "create"]:
    prefix = args[args.index("-p") + 1]
    os.makedirs(os.path.join(prefix, "bin"), exist_ok=True)
    # a wrapper (not a bare symlink): a symlink without pyvenv.cfg would
    # make CPython treat the fake env dir as sys.prefix and lose the base
    # env's site-packages; real conda envs ship their own interpreter+libs
    py = os.path.join(prefix, "bin", "python")
    with open(py, "w") as f:
        f.write("#!/bin/sh\\nexec {sys.executable} \\"$@\\"\\n")
    os.chmod(py, 0o755)
    # the env advertises itself so tasks can prove where they ran
    open(os.path.join(prefix, ".built-by-fake-conda"), "w").write("1")
elif args[:2] == ["env", "list"]:
    print(json.dumps({{"envs": []}}))
sys.exit(0)
""")
    conda.chmod(conda.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("RTPU_TORCH_CONDA_EXE", str(conda))
    return log


@pytest.fixture
def fake_docker(tmp_path, monkeypatch):
    """`docker` shim: `docker run [opts] image cmd...` records the argv and
    execs cmd locally — the container boundary is faked, the worker spawn,
    registration and task execution are real."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    log = tmp_path / "docker.log"
    docker = bindir / "docker"
    docker.write_text(f"""#!{sys.executable}
import json, os, sys
args = sys.argv[1:]
assert args[0] == "run", args
i = 1
seen = []
while i < len(args):
    a = args[i]
    if a in ("-v", "-e", "--name"):
        seen.append(args[i + 1]); i += 2
    elif a.startswith("-"):
        seen.append(a); i += 1
    else:
        break  # the image name
image, cmd = args[i], args[i + 1:]
with open({str(log)!r}, "a") as f:
    f.write(json.dumps({{"image": image, "opts": seen, "cmd": cmd[:3]}}) + "\\n")
os.environ["RTPU_FAKE_CONTAINER_IMAGE"] = image
os.execvp(cmd[0], cmd)
""")
    docker.chmod(docker.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("RTPU_TORCH_CONTAINER_EXE", str(docker))
    return log


@pytest.fixture
def env_cluster(monkeypatch):
    port_env(monkeypatch)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_conda_env_builds_caches_and_hosts_tasks(fake_conda, env_cluster):
    @ray_tpu_torch.remote(runtime_env={"conda": {"dependencies": ["pip"]}})
    def where():
        import sys

        prefix = os.environ.get("CONDA_PREFIX", "")
        return {
            "conda_prefix": prefix,
            "built_marker": os.path.exists(
                os.path.join(prefix, ".built-by-fake-conda")),
            "exe_is_env_python": "conda-" in os.path.realpath(sys.argv[0])
            or True,  # symlinked interpreter resolves to the base python
            "pid": os.getpid(),
        }

    r1 = ray_tpu_torch.get(where.remote(), timeout=120)
    assert r1["conda_prefix"] and r1["built_marker"]
    assert "conda-" in r1["conda_prefix"]  # hash-keyed env dir
    # second task with the SAME spec: env is cached (one create call) and
    # the worker can be reused
    r2 = ray_tpu_torch.get(where.remote(), timeout=120)
    assert r2["conda_prefix"] == r1["conda_prefix"]
    creates = [json.loads(l) for l in
               fake_conda.read_text().splitlines()
               if json.loads(l)[:2] == ["env", "create"]]
    assert len(creates) == 1, creates
    argv = creates[0]
    assert "-p" in argv and "-f" in argv and "--yes" in argv


def test_conda_prefix_string_and_isolation(fake_conda, tmp_path,
                                           env_cluster):
    # build a "prebuilt" env via the fake, then reference it by prefix path
    import subprocess

    prefix = str(tmp_path / "preenv")
    subprocess.run([os.environ["RTPU_TORCH_CONDA_EXE"], "env", "create", "--yes",
                    "-p", prefix, "-f", "/dev/null"], check=True)

    @ray_tpu_torch.remote(runtime_env={"conda": prefix})
    def in_env():
        return os.environ.get("CONDA_PREFIX")

    @ray_tpu_torch.remote
    def base_env():
        return os.environ.get("CONDA_PREFIX", "")

    assert ray_tpu_torch.get(in_env.remote(), timeout=120) == prefix
    # plain tasks keep the base interpreter (no env leak across pools)
    assert ray_tpu_torch.get(base_env.remote(), timeout=60) != prefix


def test_container_runtime_env(fake_docker, env_cluster):
    @ray_tpu_torch.remote(
        runtime_env={"container": {"image": "rayproject/tpu:latest",
                                   "run_options": ["-e", "XYZ=1"]}})
    def inside():
        return {
            "image": os.environ.get("RTPU_FAKE_CONTAINER_IMAGE", ""),
            "pid": os.getpid(),
        }

    r = ray_tpu_torch.get(inside.remote(), timeout=120)
    assert r["image"] == "rayproject/tpu:latest"
    rec = json.loads(fake_docker.read_text().splitlines()[0])
    assert rec["image"] == "rayproject/tpu:latest"
    assert "--rm" in rec["opts"] and "--network=host" in rec["opts"]
    assert "/dev/shm:/dev/shm" in rec["opts"]
    assert rec["cmd"][1:3] == ["-m", "ray_tpu_torch._private.workers.default_worker"]


def test_container_worker_death_detected(fake_docker, env_cluster):
    @ray_tpu_torch.remote(
        runtime_env={"container": {"image": "img:1"}})
    class A:
        def pid(self):
            return os.getpid()

        def boom(self):
            os._exit(9)

    a = A.remote()
    pid = ray_tpu_torch.get(a.pid.remote(), timeout=120)
    assert pid > 0
    a.boom.remote()
    from ray_tpu_torch.exceptions import ActorDiedError, WorkerCrashedError

    with pytest.raises((ActorDiedError, WorkerCrashedError)):
        for _ in range(40):
            ray_tpu_torch.get(a.pid.remote(), timeout=30)
            time.sleep(0.5)
