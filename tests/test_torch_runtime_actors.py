"""Actor tests of the port's runtime.

A copy of tests/test_actors.py run against ``ray_tpu_torch`` (fixtures from
tests/_torch_runtime.py), ``test_owner_fate_sharing`` whole: an owner's
child actor and its placement group (``ray_tpu_torch.util.placement_group``)
both die with it.
"""

import asyncio
import time

import pytest

import ray_tpu_torch
from _torch_runtime import ray_start_regular  # noqa: F401
from ray_tpu_torch.exceptions import ActorDiedError, TaskError


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, k=1):
        self.n += k
        return self.n

    def get(self):
        return self.n

    def fail(self):
        raise RuntimeError("method failure")

    def pid(self):
        import os

        return os.getpid()


def test_actor_basic(ray_start_regular):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.inc.remote()) == 1
    assert ray_tpu_torch.get(c.inc.remote(5)) == 6


def test_actor_constructor_args(ray_start_regular):
    c = Counter.remote(100)
    assert ray_tpu_torch.get(c.get.remote()) == 100


def test_actor_method_ordering(ray_start_regular):
    c = Counter.remote()
    refs = [c.inc.remote() for _ in range(20)]
    assert ray_tpu_torch.get(refs) == list(range(1, 21))


def test_actor_state_isolated(ray_start_regular):
    a, b = Counter.remote(), Counter.remote()
    ray_tpu_torch.get(a.inc.remote())
    assert ray_tpu_torch.get(b.get.remote()) == 0


def test_actor_method_exception(ray_start_regular):
    c = Counter.remote()
    with pytest.raises(TaskError, match="method failure"):
        ray_tpu_torch.get(c.fail.remote())
    # actor still alive afterwards
    assert ray_tpu_torch.get(c.inc.remote()) == 1


def test_actor_handle_passing(ray_start_regular):
    c = Counter.remote()

    @ray_tpu_torch.remote
    def use(handle):
        return ray_tpu_torch.get(handle.inc.remote(10))

    assert ray_tpu_torch.get(use.remote(c)) == 10
    assert ray_tpu_torch.get(c.get.remote()) == 10


def test_named_actor(ray_start_regular):
    Counter.options(name="global_counter").remote(7)
    h = ray_tpu_torch.get_actor("global_counter")
    assert ray_tpu_torch.get(h.get.remote()) == 7


def test_named_actor_missing(ray_start_regular):
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("does_not_exist")


def test_get_if_exists(ray_start_regular):
    a = Counter.options(name="gie").remote(1)
    b = Counter.options(name="gie", get_if_exists=True).remote(999)
    ray_tpu_torch.get(a.inc.remote())
    assert ray_tpu_torch.get(b.get.remote()) == 2


def test_kill_actor(ray_start_regular):
    c = Counter.remote()
    ray_tpu_torch.get(c.inc.remote())
    ray_tpu_torch.kill(c)
    with pytest.raises((ActorDiedError, TaskError)):
        for _ in range(50):
            ray_tpu_torch.get(c.inc.remote(), timeout=5)
            time.sleep(0.1)


def test_actor_restart(ray_start_regular):
    @ray_tpu_torch.remote(max_restarts=1)
    class Flaky:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def die(self):
            import os

            os._exit(1)

    f = Flaky.remote()
    assert ray_tpu_torch.get(f.inc.remote()) == 1
    f.die.remote()
    # After restart, state resets (fresh __init__) and calls succeed again.
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            v = ray_tpu_torch.get(f.inc.remote(), timeout=10)
            break
        except Exception:
            time.sleep(0.2)
    else:
        pytest.fail("actor did not restart")
    assert v >= 1


def test_async_actor(ray_start_regular):
    @ray_tpu_torch.remote
    class AsyncActor:
        async def work(self, t):
            await asyncio.sleep(t)
            return t

        async def quick(self):
            return "fast"

    a = AsyncActor.remote()
    assert ray_tpu_torch.get(a.quick.remote()) == "fast"  # wait for creation
    # concurrent execution: total time ~max not ~sum
    t0 = time.time()
    refs = [a.work.remote(0.5) for _ in range(4)]
    assert ray_tpu_torch.get(refs) == [0.5] * 4
    assert time.time() - t0 < 1.5


def test_threaded_actor_concurrency(ray_start_regular):
    @ray_tpu_torch.remote(max_concurrency=4)
    class Blocking:
        def block(self, t):
            time.sleep(t)
            return t

    b = Blocking.remote()
    ray_tpu_torch.get(b.block.remote(0))  # wait for creation
    t0 = time.time()
    ray_tpu_torch.get([b.block.remote(0.5) for _ in range(4)])
    assert time.time() - t0 < 1.5


def test_actor_infeasible_resources(ray_start_regular):
    # Requesting more CPU than the cluster has → creation pends forever;
    # calls should not crash the runtime (we just check registration worked).
    h = Counter.options(num_cpus=64).remote()
    # the handle exists; the call stays pending — verify no crash within 1s
    ref = h.get.remote()
    ready, pending = ray_tpu_torch.wait([ref], timeout=1)
    assert pending


def test_owner_fate_sharing(ray_start_regular):
    """Actors and placement groups created by a worker die with it
    (reference: gcs_actor_manager OnWorkerDead destroys owned actors)."""
    import time as _time

    from ray_tpu_torch.util.placement_group import placement_group_table

    @ray_tpu_torch.remote
    class Child:
        def ping(self):
            return "ok"

    @ray_tpu_torch.remote
    class Owner:
        def setup(self):
            from ray_tpu_torch.util.placement_group import placement_group

            self.child = Child.options(num_cpus=0).remote()
            ray_tpu_torch.get(self.child.ping.remote())
            self.pg = placement_group([{"CPU": 1}])
            self.pg.ready(timeout=30)
            return self.child, self.pg.id

    owner = Owner.remote()
    child, pg_id = ray_tpu_torch.get(owner.setup.remote())
    assert ray_tpu_torch.get(child.ping.remote()) == "ok"
    assert placement_group_table()[pg_id.hex()]["state"] == "CREATED"
    ray_tpu_torch.kill(owner)
    deadline = _time.time() + 30
    child_dead = pg_gone = False
    while _time.time() < deadline and not (child_dead and pg_gone):
        try:
            ray_tpu_torch.get(child.ping.remote(), timeout=5)
        except Exception:
            child_dead = True
        table = placement_group_table()
        rec = table.get(pg_id.hex()) if isinstance(table, dict) else None
        pg_gone = rec is None or rec.get("state") == "REMOVED"
        _time.sleep(0.2)
    assert child_dead, "child actor outlived its owner"
    assert pg_gone, "placement group outlived its owner"
