"""The port's invariant lint plane (ray_tpu_torch/_private/lint/), a copy of
``tests/test_lint.py`` over ``ray_tpu_torch``, plus the JAX package's lint
and the port's held to the same findings on the same seeded fixture.

Each rule is exercised against a SYNTHETIC mini-repo (its own contract
files + seeded violations) so the assertions pin exact rule ids and
file:line anchors, independent of the real package's contents; the tier-1
test at the bottom then runs the full linter over the real ray_tpu_torch/ and
asserts zero non-baseline findings — the same gate CI runs.
"""

import json
import os
import textwrap

import pytest

from ray_tpu_torch._private.lint import (
    DEFAULT_BASELINE,
    find_repo_root,
    load_baseline,
    render_report,
    run_lint,
    save_baseline,
)
from ray_tpu_torch._private.lint.core import apply_baseline

REPO_ROOT = find_repo_root(os.path.dirname(os.path.dirname(__file__)))


def _write(root, rel, text):
    path = os.path.join(root, *rel.split("/"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(text))
    return path


def make_mini_repo(tmp_path):
    """A synthetic repo with one declared flag/metric/event/site each."""
    root = str(tmp_path / "repo")
    _write(root, "ray_tpu_torch/_private/config.py", '''\
        _FLAGS = {
            "declared_flag": 1,
        }
        ''')
    # a reader for every declared flag, so the default mini repo is clean
    _write(root, "ray_tpu_torch/_read_flags.py", '''\
        from ray_tpu_torch._private.config import CONFIG

        DECLARED = CONFIG.declared_flag
        ''')
    _write(root, "ray_tpu_torch/util/metrics.py", '''\
        """Contract:
            ray_tpu_registered_total   counter
        """
        ''')
    _write(root, "ray_tpu_torch/_private/flight_recorder.py", '''\
        """Recorder.

        EVENT-NAME STABILITY CONTRACT
        -----------------------------
          good.event   a fine event
        """
        def record(event, a=b"", b=""):
            pass
        ''')
    _write(root, "ray_tpu_torch/_private/chaos.py", '''\
        """Chaos.

        SITE-NAME STABILITY CONTRACT
        ----------------------------
          good.site   a fine site

        THE PLAN
        --------
        (rules...)
        """
        ARMED = False
        def hit(site, **attrs):
            return None
        ''')
    return root


def _rules_at(result, rel):
    return [(f.rule, f.line) for f in result.new if f.path == rel]


# ------------------------------------------------------ contract cross-check


@pytest.mark.fast
def test_flag_undeclared_and_dead(tmp_path):
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/_private/config.py", '''\
        _FLAGS = {
            "declared_flag": 1,
            "dead_flag": 2,
        }
        ''')
    _write(root, "ray_tpu_torch/app.py", '''\
        import os
        from ray_tpu_torch._private.config import CONFIG

        def f():
            a = CONFIG.declared_flag          # ok: declared
            b = CONFIG.bogus_flag             # line 6: undeclared
            c = os.environ.get("RTPU_TORCH_bogus_two")   # line 7: undeclared
            d = os.environ.get("RTPU_TORCH_ADDRESS")     # ok: infra env (caps)
            return a, b, c, d
        ''')
    r = run_lint(root=root)
    assert _rules_at(r, "ray_tpu_torch/app.py") == [
        ("flag-undeclared", 6),
        ("flag-undeclared", 7),
    ]
    # dead_flag is declared but never read -> anchored at its config line
    dead = [f for f in r.new if f.rule == "flag-dead"]
    assert [f.path for f in dead] == ["ray_tpu_torch/_private/config.py"]
    assert "dead_flag" in dead[0].message
    assert dead[0].line == 3


@pytest.mark.fast
def test_metric_unregistered(tmp_path):
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/emit.py", '''\
        from ray_tpu_torch.util.metrics import Counter

        good = Counter("ray_tpu_registered_total")
        bad = Counter("ray_tpu_bogus_total")
        samples = []
        samples.append(("ray_tpu_tuple_metric", {"node": "n"}, 1.0))
        samples.append(("ray_tpu_results", "not-a-labels-dict"))
        other = Counter(some_dynamic_name)
        ''')
    r = run_lint(root=root)
    assert _rules_at(r, "ray_tpu_torch/emit.py") == [
        ("metric-unregistered", 4),
        ("metric-unregistered", 6),
    ]
    assert "ray_tpu_bogus_total" in r.new[0].message or \
        "ray_tpu_bogus_total" in " ".join(f.message for f in r.new)


@pytest.mark.fast
def test_event_and_chaos_site_unregistered(tmp_path):
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/events.py", '''\
        from ray_tpu_torch._private import flight_recorder as _fr
        from ray_tpu_torch._private import chaos as _chaos

        def f(name):
            _fr.record("good.event", b"", "fine")
            _fr.record("bogus.event", b"", "nope")
            _fr.record(name)              # dynamic: out of scope
            _chaos.hit("good.site")
            _chaos.hit("bogus.site", x=1)
        ''')
    r = run_lint(root=root)
    assert _rules_at(r, "ray_tpu_torch/events.py") == [
        ("event-unregistered", 6),
        ("chaos-site-unregistered", 9),
    ]


# ---------------------------------------------------------- shard safety


@pytest.mark.fast
def test_shard_safety_rules(tmp_path):
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/server_mod.py", '''\
        _SHARD_SAFE_FIELDS = {"stats"}

        class Node:
            def start(self, server):
                server.register_all(self)
                server.set_shard_safe({"Good", "Bad", "Typo"})

            async def handle_Good(self, req):
                with self._lock:
                    self.counter += 1        # locked: fine
                self.stats.append(1)         # allowlisted field: fine
                local = {}
                local["x"] = 1               # not self state: fine
                return {"ok": True}

            async def handle_Bad(self, req):
                self.counter += 1            # line 17: unlocked mutation
                self.pending.append(req)     # line 18: unlocked mutator call
                return {"ok": True}
        ''')
    r = run_lint(root=root)
    got = _rules_at(r, "ray_tpu_torch/server_mod.py")
    assert ("shard-safe-unresolved", 6) in got      # "Typo" never resolves
    assert ("shard-unsafe-mutation", 17) in got
    assert ("shard-unsafe-mutation", 18) in got
    assert len(got) == 3
    unresolved = [f for f in r.new if f.rule == "shard-safe-unresolved"]
    assert "handle_Typo" in unresolved[0].message


@pytest.mark.fast
def test_rpc_choke_point_bypass(tmp_path):
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/_private/rpc.py", '''\
        class RpcServer:
            async def _run_handler(self, method, handler, payload):
                return await handler(payload)    # the one legal call site

            async def _dispatch_ok(self, method, payload):
                handler = self._handlers.get(method)
                return await self._run_handler(method, handler, payload)

            async def _dispatch_bad(self, method, payload):
                handler = self._handlers.get(method)
                return await handler(payload)    # line 11: bypasses the hop

            async def _notify_bad(self, method, payload):
                return self._handlers[method](payload)   # line 14: same
        ''')
    r = run_lint(root=root)
    got = _rules_at(r, "ray_tpu_torch/_private/rpc.py")
    assert ("shard-home-loop-bypass", 11) in got
    assert ("shard-home-loop-bypass", 14) in got
    assert len(got) == 2


# ------------------------------------------------------- blocking detector


@pytest.mark.fast
def test_blocking_calls_in_coroutines(tmp_path):
    root = make_mini_repo(tmp_path)
    # inside the package: only control-plane modules are in scope
    _write(root, "ray_tpu_torch/serve/loopmod.py", '''\
        import asyncio
        import subprocess
        import time

        async def bad():
            time.sleep(1)                     # line 6
            subprocess.run(["true"])          # line 7
            open("/tmp/x")                    # line 8
            with lock_thing:                  # line 9: sync lock
                pass

        async def good(sem, loop):
            await asyncio.sleep(0)
            await sem.acquire()               # awaited: fine

            def helper():
                time.sleep(1)                 # sync def: fine (executor)
            await loop.run_in_executor(None, helper)
        ''')
    # same violations OUTSIDE the control-plane scope: ignored
    _write(root, "ray_tpu_torch/train/offloop.py", '''\
        import time

        async def also_sleeps():
            time.sleep(1)
        ''')
    r = run_lint(root=root)
    assert _rules_at(r, "ray_tpu_torch/serve/loopmod.py") == [
        ("blocking-call-in-async", 6),
        ("blocking-call-in-async", 7),
        ("blocking-io-in-async", 8),
        ("sync-lock-in-async", 9),
    ]
    assert _rules_at(r, "ray_tpu_torch/train/offloop.py") == []


@pytest.mark.fast
def test_unawaited_lock_acquire_in_coroutine(tmp_path):
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/serve/lockmod.py", '''\
        async def f(self):
            self._lock.acquire()              # line 2: un-awaited
            ok = await self._alock.acquire()  # awaited: fine
            self.queue.get()                  # not lock-ish: fine
            return ok
        ''')
    r = run_lint(root=root)
    assert _rules_at(r, "ray_tpu_torch/serve/lockmod.py") == [
        ("sync-lock-in-async", 2),
    ]


# ------------------------------------------------- pragma + baseline round-trip


@pytest.mark.fast
def test_allow_pragma_suppression(tmp_path):
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/serve/pragmod.py", '''\
        import time

        async def f():
            time.sleep(1)  # lint: allow(blocking-call-in-async) -- why
            # lint: allow(blocking-call-in-async) -- pragma on prior line
            time.sleep(2)
            time.sleep(3)  # lint: allow(some-other-rule)
            time.sleep(4)  # lint: allow(*)
        ''')
    r = run_lint(root=root)
    got = _rules_at(r, "ray_tpu_torch/serve/pragmod.py")
    assert got == [("blocking-call-in-async", 7)]  # wrong-rule pragma: kept
    assert r.suppressed == 3


@pytest.mark.fast
def test_baseline_round_trip(tmp_path):
    root = make_mini_repo(tmp_path)
    mod = _write(root, "ray_tpu_torch/serve/basemod.py", '''\
        import time

        async def f():
            time.sleep(1)
        ''')
    r1 = run_lint(root=root)
    assert [f.rule for f in r1.new] == ["blocking-call-in-async"]

    # accept the current findings; a re-run is clean
    bl_path = os.path.join(root, ".lint-baseline.json")
    save_baseline(bl_path, r1.new)
    bl = load_baseline(bl_path)
    r2 = run_lint(root=root, baseline=bl)
    assert r2.ok and len(r2.accepted) == 1

    # a NEW violation fails while the accepted one stays accepted
    with open(mod, "a") as f:
        f.write("\nasync def g():\n    time.sleep(2)\n")
    r3 = run_lint(root=root, baseline=bl)
    assert [f.rule for f in r3.new] == ["blocking-call-in-async"]
    assert "time.sleep(2)" in r3.new[0].snippet
    assert len(r3.accepted) == 1

    # editing the ACCEPTED line re-surfaces its finding for review
    with open(mod, "w") as f:
        f.write("import time\n\nasync def f():\n    time.sleep(1 + 0)\n")
    r4 = run_lint(root=root, baseline=bl)
    assert [f.snippet for f in r4.new] == ["time.sleep(1 + 0)"]
    assert not r4.accepted


@pytest.mark.fast
def test_report_rendering_and_json(tmp_path):
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/serve/rmod.py", '''\
        import time

        async def f():
            time.sleep(1)
        ''')
    r = run_lint(root=root)
    text = render_report(r)
    assert "ray_tpu_torch/serve/rmod.py:4: blocking-call-in-async" in text
    assert text.strip().endswith(")") and "FAIL" in text
    doc = r.to_json()
    assert doc["schema"] == "ray_tpu_torch.lint.v1"
    assert doc["ok"] is False
    assert doc["findings"][0]["rule"] == "blocking-call-in-async"
    json.dumps(doc)  # artifact mode must be serializable


# ------------------------------------------------------------- tier-1 gate


def test_full_package_lint_is_clean():
    """The same gate CI runs: the real linter over the real package with
    the committed baseline must produce zero new findings. If this fails,
    either fix the new violation or (for an accepted design) add an
    inline `# lint: allow(<rule>)` / regenerate the baseline — see the
    rule reference in ray_tpu_torch/_private/lint/__init__.py."""
    bl = load_baseline(os.path.join(REPO_ROOT, DEFAULT_BASELINE))
    result = run_lint(root=REPO_ROOT, baseline=bl)
    assert result.files > 100  # sanity: the real package was scanned
    assert result.ok, "new lint findings:\n" + render_report(result)


def test_seeded_violations_all_fire_on_real_contracts(tmp_path):
    """Acceptance sweep: one seeded violation per analyzer, checked
    against the REAL repo contracts (not the mini fixtures), each caught
    with the right rule id and line."""
    fixture = _write(str(tmp_path), "seeded.py", '''\
        import time
        from ray_tpu_torch._private import flight_recorder as _fr
        from ray_tpu_torch._private.config import CONFIG
        from ray_tpu_torch.util.metrics import Counter

        flag = CONFIG.definitely_not_a_flag          # line 6
        metric = Counter("ray_tpu_never_registered_total")  # line 7

        def emit():
            _fr.record("never.registered")                # line 10

        class Srv:
            def start(self, server):
                server.set_shard_safe({"Mut"})            # line 14

            async def handle_Mut(self, req):
                self.state = req                          # line 17

        async def pump():
            time.sleep(0.1)                               # line 20
        ''')
    r = run_lint(paths=[fixture], root=REPO_ROOT)
    got = {(f.rule, f.line) for f in r.new}
    assert ("flag-undeclared", 6) in got
    assert ("metric-unregistered", 7) in got
    assert ("event-unregistered", 10) in got
    assert ("shard-unsafe-mutation", 17) in got
    assert ("blocking-call-in-async", 20) in got


def test_cli_json_and_exit_codes(tmp_path, capsys):
    """`ray-tpu-torch lint` over the real repo: exit 0 + machine-readable
    report with the committed baseline; exit 1 with --no-baseline (the
    accepted findings exist)."""
    from ray_tpu_torch import scripts

    scripts.main(["lint", "--root", REPO_ROOT, "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == "ray_tpu_torch.lint.v1" and doc["ok"] is True
    assert doc["accepted_by_baseline"]  # the committed accepted findings

    with pytest.raises(SystemExit) as ei:
        scripts.main(["lint", "--root", REPO_ROOT, "--no-baseline"])
    assert ei.value.code == 1


def test_jax_flag_prefix_is_a_finding(tmp_path):
    """A ``"RTPU_<name>"`` literal in the port names the JAX package's flag,
    which the port's config never reads: flag-undeclared, whether or not
    ``<name>`` is declared in the port's ``_FLAGS``."""
    root = make_mini_repo(tmp_path)
    _write(root, "ray_tpu_torch/app.py", '''\
        import os

        def f():
            a = os.environ.get("RTPU_TORCH_declared_flag")  # ok: the port's
            b = os.environ.get("RTPU_declared_flag")        # line 5
            c = os.environ.get("RTPU_ADDRESS")              # caps: exempt
            return a, b, c
        ''')
    r = run_lint(root=root)
    assert _rules_at(r, "ray_tpu_torch/app.py") == [("flag-undeclared", 5)]
    assert "JAX package's flag prefix" in r.new[0].message


# ------------------------------------------------- against the JAX package

# One seeded violation of every rule, written for a package: ``{pkg}`` its
# directory, ``{cfg}`` its config object, ``{flag}`` its flag prefix.
_SEEDED = {
    "{pkg}/_private/config.py": '''\
        _FLAGS = {{
            "declared_flag": 1,
            "dead_flag": 2,
        }}
        ''',
    "{pkg}/app.py": '''\
        import os
        from {pkg}._private.config import {cfg}

        def f():
            a = {cfg}.declared_flag
            b = {cfg}.bogus_flag
            c = os.environ.get("{flag}bogus_two")
            d = os.environ.get("{flag}ADDRESS")
            return a, b, c, d
        ''',
    "{pkg}/emit.py": '''\
        from {pkg}.util.metrics import Counter

        good = Counter("ray_tpu_registered_total")
        bad = Counter("ray_tpu_bogus_total")
        samples = []
        samples.append(("ray_tpu_tuple_metric", {{"node": "n"}}, 1.0))
        ''',
    "{pkg}/events.py": '''\
        from {pkg}._private import flight_recorder as _fr
        from {pkg}._private import chaos as _chaos

        def f(name):
            _fr.record("good.event", b"", "fine")
            _fr.record("bogus.event", b"", "nope")
            _chaos.hit("good.site")
            _chaos.hit("bogus.site", x=1)
        ''',
    "{pkg}/server_mod.py": '''\
        _SHARD_SAFE_FIELDS = {{"stats"}}

        class Node:
            def start(self, server):
                server.set_shard_safe({{"Good", "Bad", "Typo"}})

            async def handle_Good(self, req):
                with self._lock:
                    self.counter += 1
                return {{"ok": True}}

            async def handle_Bad(self, req):
                self.counter += 1
                self.pending.append(req)
        ''',
    "{pkg}/_private/rpc.py": '''\
        class RpcServer:
            async def _run_handler(self, method, handler, payload):
                return await handler(payload)

            async def _dispatch_bad(self, method, payload):
                handler = self._handlers.get(method)
                return await handler(payload)
        ''',
    "{pkg}/serve/loopmod.py": '''\
        import subprocess
        import time

        async def bad(self):
            time.sleep(1)
            subprocess.run(["true"])
            open("/tmp/x")
            with lock_thing:
                pass
            self._lock.acquire()
            time.sleep(2)  # lint: allow(blocking-call-in-async)
        ''',
}


def _mini_repo_as(tmp_path, pkg):
    """make_mini_repo's contract files, under ``pkg``'s name."""
    port_root = make_mini_repo(tmp_path / "mini")
    if pkg == "ray_tpu_torch":
        return port_root
    root = str(tmp_path / "repo")
    for dirpath, _, names in os.walk(os.path.join(port_root, "ray_tpu_torch")):
        for name in names:
            src = os.path.join(dirpath, name)
            rel = os.path.relpath(src, port_root).replace(
                "ray_tpu_torch", pkg, 1)
            with open(src) as f:
                text = f.read()
            text = text.replace("ray_tpu_torch", pkg).replace(
                "CONFIG", "RTPU_CONFIG")
            _write(root, rel.replace(os.sep, "/"), text)
    return root


def _seed_and_lint(tmp_path, pkg, cfg, flag):
    import importlib

    lint = importlib.import_module(f"{pkg}._private.lint")
    root = _mini_repo_as(tmp_path, pkg)
    for rel, text in _SEEDED.items():
        _write(root, rel.format(pkg=pkg),
               text.format(pkg=pkg, cfg=cfg, flag=flag))
    r = lint.run_lint(root=root)
    return sorted((f.rule, f.path.replace(pkg + "/", "<pkg>/"), f.line)
                  for f in r.new), r.suppressed


def test_seeded_fixture_gives_the_jax_packages_findings(tmp_path):
    """The same seeded violations (every rule, one pragma) give the same
    findings, rule by rule and line by line, from both packages' lint."""
    ours = _seed_and_lint(tmp_path / "port", "ray_tpu_torch", "CONFIG",
                          "RTPU_TORCH_")
    ref = _seed_and_lint(tmp_path / "jax", "ray_tpu", "RTPU_CONFIG", "RTPU_")
    assert ours == ref
    rules = {rule for rule, _, _ in ours[0]}
    assert rules == {
        "flag-undeclared", "flag-dead", "metric-unregistered",
        "event-unregistered", "chaos-site-unregistered",
        "shard-safe-unresolved", "shard-unsafe-mutation",
        "shard-home-loop-bypass", "blocking-call-in-async",
        "blocking-io-in-async", "sync-lock-in-async"}
    assert ours[1] == 1  # the pragma
