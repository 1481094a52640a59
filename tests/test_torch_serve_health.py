"""The port's serve controller's health rule (``_reconcile_once`` in
``ray_tpu_torch/serve/_controller.py``), driven on a bare
``ServeController`` with a fake clock and fake replica actors.

A replica that has not pushed its metrics yet gets 20 s. While its actor is
still being placed or constructed it is not a failure: a model's build can
outlast the grace, and a replica killed the moment its constructor returns
is replaced by one that meets the same fate. So the grace counts from the
last time the actor was seen still being created. Once a replica pushes, a
push older than 6 s, or one that says it is unhealthy, replaces it. The
last test checks, on the port's runtime, that an actor's state stays
pending while its constructor runs, which the rule relies on.
"""

import asyncio
import time
import types

import pytest

import ray_tpu_torch
from _torch_runtime import ray_start_2_cpus  # noqa: F401
from ray_tpu_torch.serve import _controller

FIRST = "SERVE_REPLICA::app#Model::0"

# name -> (the actor's creation ends at this time (0: created at once),
#          pushes as (time, healthy), the ticks of the reconcile loop,
#          the tick at which the first replica is replaced)
SCENARIOS = {
    "constructor_outlasts_the_grace": (
        31.0, [], [10.0, 20.5, 25.0, 30.5, 31.0, 40.0, 50.0, 51.0], 51.0),
    "constructor_outlasts_the_grace_then_pushes": (
        31.0, [(35.0, True), (40.0, True), (45.0, True)],
        [20.5, 30.5, 31.0, 35.0, 40.0, 45.0, 51.0, 52.0], 52.0),
    "up_at_once_never_pushes": (0.0, [], [10.0, 20.0, 20.5], 20.5),
    "push_goes_stale": (0.0, [(1.0, True)], [1.0, 7.0, 7.5], 7.5),
    "push_says_unhealthy": (0.0, [(1.0, True), (3.0, False)], [1.0, 2.0, 3.0], 3.0),
}


class _FakeActor:
    def __init__(self):
        self.start_metrics_push = types.SimpleNamespace(remote=lambda *a, **k: None)


def _fake_remote(cls):
    return types.SimpleNamespace(
        options=lambda **kw: types.SimpleNamespace(remote=lambda *a, **k: _FakeActor()))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_first_push_grace_counts_from_the_end_of_creation(scenario, monkeypatch):
    created_until, pushes, ticks, expected = SCENARIOS[scenario]
    clock = [0.0]
    killed = []
    monkeypatch.setattr(_controller, "time", types.SimpleNamespace(time=lambda: clock[0]))
    monkeypatch.setattr(ray_tpu_torch, "kill", killed.append)
    monkeypatch.setattr(ray_tpu_torch, "remote", _fake_remote)
    monkeypatch.setattr(_controller.ServeController, "_actor_pending",
                        staticmethod(lambda name: name == FIRST and clock[0] < created_until))

    controller = _controller.ServeController()
    first = _FakeActor()
    controller._deployments["app#Model"] = {
        "spec": {"version": "v", "callable": b"", "name": "app#Model"},
        "target": 1, "next_id": 1, "draining": {},
        "replicas": {FIRST: {"handle": first, "created": 0.0, "version": "v"}},
    }

    async def drive():
        replaced_at = None
        for tick in ticks:
            clock[0] = tick
            for at, healthy in pushes:
                if at == tick:
                    await controller.report_replica_metrics(
                        "app#Model", FIRST, {"ongoing": 0, "healthy": healthy})
            await controller._reconcile_once()
            if replaced_at is None and FIRST not in controller._deployments[
                    "app#Model"]["replicas"]:
                replaced_at = tick
        return replaced_at

    replaced_at = asyncio.run(drive())
    assert replaced_at == expected
    assert killed == [first]
    # the deployment is back at its target with a new replica
    assert len(controller._deployments["app#Model"]["replicas"]) == 1


@pytest.mark.timeout(90)
def test_actor_is_pending_until_its_constructor_returns(ray_start_2_cpus, tmp_path):
    """The rule above reads "still being created" from the actor's state,
    which must stay pending while the constructor runs, not only while the
    actor waits for a worker."""
    marker = tmp_path / "constructing"

    @ray_tpu_torch.remote
    class SlowStart:
        def __init__(self, path):
            import pathlib
            import time as _time

            pathlib.Path(path).write_text("in the constructor")
            _time.sleep(4.0)

        def ping(self):
            return "up"

    actor = SlowStart.options(name="SERVE_REPLICA::health#SlowStart::0").remote(str(marker))
    deadline = time.time() + 60
    while not marker.exists():
        assert time.time() < deadline, "the constructor never started"
        time.sleep(0.05)
    assert _controller.ServeController._actor_pending("SERVE_REPLICA::health#SlowStart::0")
    assert ray_tpu_torch.get(actor.ping.remote(), timeout=60) == "up"
    assert not _controller.ServeController._actor_pending("SERVE_REPLICA::health#SlowStart::0")
