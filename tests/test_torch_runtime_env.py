"""runtime_env (env_vars + working_dir) and log_to_driver on the port.

A copy of ``tests/test_runtime_env.py`` against ``ray_tpu_torch``; its
unsupported-field test names a field outside ``RUNTIME_ENV_SUPPORTED``
(``conda``, which the JAX copy names, is supported in both packages).

Reference contracts: runtime_env env_vars/working_dir are applied before
user code runs, workers with different envs never share a process
(python/ray/_private/runtime_env/, worker_pool runtime_env_hash), and
worker stdout/stderr stream to the driver via per-node log monitors
(python/ray/_private/log_monitor.py:103).
"""

import os
import time

import pytest

from _torch_runtime import ray_start_regular, shutdown_only  # noqa: F401  (fixtures)


def test_env_vars_applied_and_isolated(ray_start_regular):
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def read_env():
        return os.environ.get("RTPU_TEST_FLAG"), os.getpid()

    val, pid_plain = ray_tpu_torch.get(read_env.remote())
    assert val is None

    with_env = read_env.options(
        runtime_env={"env_vars": {"RTPU_TEST_FLAG": "on"}}
    )
    val, pid_env = ray_tpu_torch.get(with_env.remote())
    assert val == "on"
    assert pid_env != pid_plain  # different env -> different worker process

    # Plain tasks keep running in unpolluted workers.
    val, _ = ray_tpu_torch.get(read_env.remote())
    assert val is None


def test_working_dir(ray_start_regular, tmp_path):
    import ray_tpu_torch

    (tmp_path / "rt_env_probe_mod.py").write_text("MAGIC = 'from-working-dir'\n")
    (tmp_path / "data.txt").write_text("payload")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(tmp_path)})
    def probe():
        import rt_env_probe_mod  # importable because cwd/sys.path = working_dir

        with open("data.txt") as f:
            payload = f.read()
        return rt_env_probe_mod.MAGIC, payload, os.getcwd()

    magic, payload, cwd = ray_tpu_torch.get(probe.remote())
    assert magic == "from-working-dir"
    assert payload == "payload"
    # The worker runs from the *extracted* copy under the session dir, not
    # the driver's original path (multi-node semantics).
    assert "runtime_envs" in cwd


def test_actor_runtime_env(ray_start_regular):
    import ray_tpu_torch

    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ACTOR_FLAG": "yes"}})
    class A:
        def read(self):
            return os.environ.get("ACTOR_FLAG")

    a = A.remote()
    assert ray_tpu_torch.get(a.read.remote()) == "yes"


def test_unsupported_runtime_env_field_rejected(ray_start_regular):
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def f():
        return 1

    from ray_tpu_torch._private.task_spec import RUNTIME_ENV_SUPPORTED

    assert "nsight" not in RUNTIME_ENV_SUPPORTED
    with pytest.raises(ValueError, match="unsupported runtime_env"):
        f.options(runtime_env={"nsight": {"cuda-graph-trace": "node"}}).remote()


def test_log_to_driver(shutdown_only, capfd):
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2, log_to_driver=True)

    @ray_tpu_torch.remote
    def shout():
        print("HELLO_FROM_WORKER_STDOUT", flush=True)
        return 1

    assert ray_tpu_torch.get(shout.remote()) == 1
    # The node's log monitor tails the worker's log and the driver relays
    # it with a (pid=, ip=) prefix. Poll: tail period is 250ms.
    deadline = time.time() + 20
    seen = ""
    while time.time() < deadline:
        seen += capfd.readouterr().out
        if "HELLO_FROM_WORKER_STDOUT" in seen:
            break
        time.sleep(0.25)
    assert "HELLO_FROM_WORKER_STDOUT" in seen
    assert "(pid=" in seen
