"""runtime_env pip venvs + py_modules of the port's worker pool: a copy of
``tests/test_runtime_env_pip.py`` against ``ray_tpu_torch`` (reference:
_private/runtime_env/agent/runtime_env_agent.py:162, pip.py, py_modules
via packaging.py). Offline-friendly: the test package installs from a
local source tree with --no-index."""

import os
import textwrap
import time

import pytest

import ray_tpu_torch
from _torch_runtime import port_env


@pytest.fixture
def cluster(tmp_path, monkeypatch):
    port_env(monkeypatch)
    ray_tpu_torch.init(num_cpus=4)
    yield tmp_path
    ray_tpu_torch.shutdown()


def _make_pkg(tmp_path, name="rtpu_test_pkg", value=41):
    pkg = tmp_path / f"{name}_src"
    (pkg / name).mkdir(parents=True)
    (pkg / name / "__init__.py").write_text(f"MAGIC = {value}\n")
    (pkg / "setup.py").write_text(textwrap.dedent(f"""
        from setuptools import setup, find_packages
        setup(name="{name}", version="1.0", packages=find_packages())
    """))
    return str(pkg)


PIP_OPTS = ["--no-index", "--no-build-isolation", "--no-deps"]


def test_pip_env_installs_and_caches(cluster):
    pkg_dir = _make_pkg(cluster)

    # the package must NOT be importable in the base env
    with pytest.raises(ImportError):
        import rtpu_test_pkg  # noqa: F401

    env = {"pip": {"packages": [pkg_dir], "pip_install_options": PIP_OPTS}}

    @ray_tpu_torch.remote(runtime_env=env)
    def use_pkg():
        import rtpu_test_pkg

        return rtpu_test_pkg.MAGIC, rtpu_test_pkg.__file__

    magic, path = ray_tpu_torch.get(use_pkg.remote(), timeout=180)
    assert magic == 41
    assert "runtime_envs" in path and "venvs" in path

    # cached: a second task (possibly a different worker) reuses the venv
    t0 = time.time()
    magic2, path2 = ray_tpu_torch.get(use_pkg.remote(), timeout=60)
    assert magic2 == 41 and os.path.dirname(path2) == os.path.dirname(path)
    assert time.time() - t0 < 30  # no rebuild

    # concurrent tasks with the same env share one venv build
    outs = ray_tpu_torch.get([use_pkg.remote() for _ in range(3)], timeout=120)
    assert all(m == 41 for m, _ in outs)


def test_pip_env_evicted_on_job_end(cluster):
    pkg_dir = _make_pkg(cluster, name="rtpu_evict_pkg", value=7)
    env = {"pip": {"packages": [pkg_dir], "pip_install_options": PIP_OPTS}}

    @ray_tpu_torch.remote(runtime_env=env)
    def use_pkg():
        import rtpu_evict_pkg

        return os.path.dirname(os.path.dirname(rtpu_evict_pkg.__file__))

    pkg_parent = ray_tpu_torch.get(use_pkg.remote(), timeout=180)
    venv_dir = pkg_parent  # --target dir IS the env dir
    assert os.path.isdir(venv_dir), venv_dir

    # the driver's job finishing evicts the venv (exercise the raylet's
    # JobFinished path directly — in production the GCS sends it when the
    # driver disconnects)
    from ray_tpu_torch._private.worker import get_global_worker

    worker = get_global_worker()
    worker.io.run(
        worker.raylet.call(
            "JobFinished", {"job_id": worker.job_id.binary()}
        )
    )
    deadline = time.time() + 20
    while os.path.isdir(venv_dir):
        assert time.time() < deadline, f"venv not evicted: {venv_dir}"
        time.sleep(0.5)


def test_py_modules(cluster):
    mod_dir = cluster / "mods"
    (mod_dir / "rtpu_extra_mod").mkdir(parents=True)
    (mod_dir / "rtpu_extra_mod" / "__init__.py").write_text("WHO = 'extra'\n")

    # reference contract: each entry IS a module/package directory
    env = {"py_modules": [str(mod_dir / "rtpu_extra_mod")]}

    @ray_tpu_torch.remote(runtime_env=env)
    def use_mod():
        import rtpu_extra_mod

        return rtpu_extra_mod.WHO

    assert ray_tpu_torch.get(use_mod.remote(), timeout=120) == "extra"
