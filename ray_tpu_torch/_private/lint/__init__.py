"""The invariant lint plane of the port: static analysis over the whole
``ray_tpu_torch`` package (a copy of ``ray_tpu/_private/lint/``, pointed at
the port's contracts: its ``RTPU_TORCH_<name>`` flags and ``_FLAGS``, the
``ray_tpu_*`` series and flight events it keeps, its own baseline).

Correctness here increasingly hinges on invariants that live only in
docstrings — the stability contracts (flags, metric names, flight events,
chaos sites), the sharded reactor's thread-ownership rules, and the
never-block-the-loop discipline of the asyncio control plane. The
reference enforces its analogues at build time (``RayConfig`` flags are
generated from ``common/ray_config_def.h``; the RPC surface is
proto-compiled); this package is our equivalent: an AST pass run as
``ray-tpu-torch lint`` and gated in CI.

RULE REFERENCE
--------------
Contract cross-checker (lint/contracts.py):

  flag-undeclared         an ``RTPU_TORCH_<name>`` read — ``CONFIG.<name>``
                          or a ``"RTPU_TORCH_<name>"`` env literal with
                          lowercase ``<name>`` — names no flag declared in
                          ``_private/config.py`` ``_FLAGS``; or a
                          ``"RTPU_<name>"`` literal, the JAX package's
                          prefix, which the port's config never reads.
                          (All-caps ``RTPU_TORCH_FOO`` env vars are
                          infrastructure knobs, exempt.)
  flag-dead               a declared flag nothing in the package reads:
                          dead contract surface — wire it or remove it.
  metric-unregistered     a ``ray_tpu_*`` series is emitted (literal
                          Counter/Gauge/Histogram name, or a raylet/GCS/
                          agent ``(name, labels, value)`` sample tuple)
                          but missing from the metric-name contract
                          docstring in ``util/metrics.py``.
  event-unregistered      a literal ``flight_recorder.record("x.y", ...)``
                          event name is missing from the EVENT-NAME
                          contract docstring in
                          ``_private/flight_recorder.py``.
  chaos-site-unregistered a literal ``chaos.hit("x.y", ...)`` site is
                          missing from the SITE-NAME contract docstring
                          in ``_private/chaos.py``.

Shard-safety / thread-ownership analyzer (lint/shard_safety.py):

  shard-safe-unresolved   a ``set_shard_safe({...})`` name doesn't resolve
                          to a ``handle_<name>`` method on the enclosing
                          class.
  shard-unsafe-mutation   a shard-safe handler mutates ``self`` state
                          outside a ``with self.<lock>:`` block and off
                          the module's ``_SHARD_SAFE_FIELDS`` allowlist.
  shard-home-loop-bypass  rpc.py calls a registered handler anywhere but
                          the ``_run_handler`` choke point that
                          implements the home-loop hop.

Blocking-call detector (lint/blocking.py) — control-plane ``async def``
bodies only (``_private/rpc.py``, ``_private/worker.py``,
``_private/raylet/``, ``_private/gcs/``, ``serve/``):

  blocking-call-in-async  ``time.sleep`` / ``subprocess.run|check_*`` /
                          ``os.system`` / sync DNS/HTTP inside a
                          coroutine.
  blocking-io-in-async    sync ``open()`` / un-awaited socket
                          ``.accept/.connect/.recv/.sendall`` inside a
                          coroutine.
  sync-lock-in-async      un-awaited lock acquisition (``with
                          self._lock:`` or bare ``.acquire()``) inside a
                          coroutine.

SUPPRESSING A FINDING
---------------------
Inline, for accepted-by-design sites (same line or a comment line
immediately above)::

    with self.engine._lock:  # lint: allow(sync-lock-in-async) -- why

or ``# lint: allow(rule-a, rule-b)``; ``allow(*)`` suppresses every rule
on that line. Pre-existing accepted findings live in the committed
baseline instead (``ray_tpu_torch/.lint-baseline.json``, the port's own;
the repo root's ``.lint-baseline.json`` is the JAX package's):
``ray-tpu-torch lint`` fails only on findings NOT in the baseline. Regenerate after triaging with
``ray-tpu-torch lint --update-baseline`` — the baseline keys on (rule, file,
source-line content), so editing an offending line re-surfaces its
finding for review while unrelated line drift doesn't.

Run it: ``ray-tpu-torch lint [paths...] [--baseline F] [--json] [--verbose]``;
``--json`` is the machine-readable report.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ray_tpu_torch._private.lint import blocking, contracts, shard_safety
from ray_tpu_torch._private.lint.core import (
    Finding,
    SourceFile,
    apply_baseline,
    collect_files,
    fingerprints,
    load_baseline,
    load_source,
    save_baseline,
)

__all__ = [
    "Finding", "LintResult", "run_lint", "render_report",
    "load_baseline", "save_baseline", "find_repo_root", "DEFAULT_BASELINE",
]

# relative to the repo root (the JAX package's baseline sits at the root)
DEFAULT_BASELINE = "ray_tpu_torch/.lint-baseline.json"


def find_repo_root(start: Optional[str] = None) -> str:
    """The directory holding the ray_tpu_torch package (falls back to cwd)."""
    here = os.path.abspath(start or os.getcwd())
    probe = here
    while True:
        if os.path.isdir(os.path.join(probe, "ray_tpu_torch", "_private")):
            return probe
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    # installed-package fallback: locate the package next to this file
    pkg = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.dirname(pkg)


class LintResult:
    def __init__(self, findings: List[Finding], new: List[Finding],
                 accepted: List[Finding], suppressed: int, files: int):
        self.findings = findings  # all, post-pragma
        self.new = new  # not in baseline -> these fail the run
        self.accepted = accepted  # matched baseline entries
        self.suppressed = suppressed  # killed by inline pragmas
        self.files = files

    @property
    def ok(self) -> bool:
        return not self.new

    def to_json(self) -> dict:
        return {
            "schema": "ray_tpu_torch.lint.v1",
            "ok": self.ok,
            "files_scanned": self.files,
            "suppressed_by_pragma": self.suppressed,
            "accepted_by_baseline": [f.to_json() for f in self.accepted],
            "findings": [f.to_json() for f in self.new],
        }


def _order(f: Finding):
    return (f.path, f.line, f.rule)


def run_lint(
    paths: Optional[List[str]] = None,
    root: Optional[str] = None,
    baseline: Optional[Dict[str, dict]] = None,
) -> LintResult:
    """Run every analyzer. ``paths`` defaults to the whole ray_tpu_torch package
    under ``root``; ``baseline`` is a loaded fingerprint map (see
    core.load_baseline) or None for no baseline."""
    root = os.path.abspath(root or find_repo_root())
    pkg_dir = os.path.join(root, "ray_tpu_torch")
    if paths is None:
        paths = [pkg_dir]
    files = collect_files(paths, root)

    # the flag-dead direction always scans the full package, whatever
    # subset is being linted (see contracts.analyze)
    pkg_files: Optional[List[SourceFile]] = None
    if os.path.isdir(pkg_dir):
        if paths == [pkg_dir]:
            pkg_files = files
        else:
            pkg_files = collect_files([pkg_dir], root)

    cts = contracts.Contracts(root)
    findings: List[Finding] = []
    findings += contracts.analyze(files, cts, package_files=pkg_files)
    findings += shard_safety.analyze(files)
    findings += blocking.analyze(files)

    # inline pragma suppression — a finding may land in a file we didn't
    # lint (flag-dead anchors at config.py), so load lazily by rel path
    by_rel: Dict[str, SourceFile] = {sf.rel: sf for sf in files}

    def _sf_for(rel: str) -> Optional[SourceFile]:
        sf = by_rel.get(rel)
        if sf is None:
            path = os.path.join(root, *rel.split("/"))
            if os.path.isfile(path):
                sf = load_source(path, root)
                if sf is not None:
                    by_rel[rel] = sf
        return sf

    kept: List[Finding] = []
    suppressed = 0
    for f in findings:
        sf = _sf_for(f.path)
        if sf is not None and sf.allowed(f.line, f.rule):
            suppressed += 1
        else:
            kept.append(f)
    kept.sort(key=_order)

    if baseline:
        new, accepted = apply_baseline(kept, baseline)
    else:
        new, accepted = kept, []
    return LintResult(kept, new, accepted, suppressed, len(files))


def render_report(result: LintResult, verbose: bool = False) -> str:
    lines: List[str] = []
    for f in result.new:
        lines.append(f.render())
    if result.new:
        lines.append("")
    summary = (
        f"{len(result.new)} finding(s) "
        f"({result.files} files, {len(result.accepted)} baseline-accepted, "
        f"{result.suppressed} pragma-suppressed)"
    )
    if verbose and result.accepted:
        lines.append("baseline-accepted findings:")
        for f in result.accepted:
            lines.append("  " + f.render().replace("\n", "\n  "))
        lines.append("")
    lines.append(("FAIL: " if result.new else "OK: ") + summary)
    return "\n".join(lines)
