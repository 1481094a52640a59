"""Contract cross-checker: the port's code vs its declared stability
contracts (a copy of ``ray_tpu/_private/lint/contracts.py`` over the
``ray_tpu_torch`` package and its ``RTPU_TORCH_<name>`` flags).

Four contracts, each declared exactly once in the tree (mirroring the
reference's build-time-generated ``RayConfig`` flag table and its
compiler-enforced proto RPC surface — here the enforcement is this lint):

  flags    ``_FLAGS`` in ``ray_tpu_torch/_private/config.py``. Every flag-style
           read — ``CONFIG.<name>`` or a ``"RTPU_TORCH_<name>"`` env-var
           literal where ``<name>`` starts lowercase — must name a declared
           flag (``flag-undeclared``), and every declared flag must be read
           somewhere in the package (``flag-dead``). All-caps ``RTPU_TORCH_FOO``
           env vars are process-level infrastructure knobs (RTPU_TORCH_ADDRESS,
           RTPU_TORCH_STATE_FILE, ...), not config flags, and are exempt.
  metrics  the metric-name docstring in ``ray_tpu_torch/util/metrics.py``. Every
           ``ray_tpu_*`` series emitted — a literal first argument to
           Counter/Gauge/Histogram, or the ``(name, labels, value)`` sample
           tuples the raylet/GCS/agent collectors build — must be listed
           (``metric-unregistered``).
  events   the EVENT-NAME contract in the
           ``ray_tpu_torch/_private/flight_recorder.py`` docstring vs every
           literal ``record("x.y", ...)`` call (``event-unregistered``).
  sites    the SITE-NAME contract in the ``ray_tpu_torch/_private/chaos.py``
           docstring vs every literal ``chaos.hit("x.y", ...)`` seam
           (``chaos-site-unregistered``).

Dynamic names (f-strings, variables) are invisible to a literal scan and
are deliberately out of scope — the contracts exist precisely so the
stable names stay greppable literals.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.lint.core import (
    Finding,
    SourceFile,
    call_name,
    const_str,
    load_source,
)

_FLAG_READ_RE = re.compile(r"^RTPU_TORCH_([a-z][A-Za-z0-9_]*)$")
# the JAX package's flag prefix: in the port such a read reaches no flag
_JAX_FLAG_READ_RE = re.compile(r"^RTPU_([a-z][A-Za-z0-9_]*)$")
_METRIC_RE = re.compile(r"ray_tpu_[a-z0-9_]+")
_EVENT_RE = re.compile(r"\b([a-z_]{2,}\.[a-z_]{2,})\b")
# dotted tokens in contract prose that are file names, not event names
_FILE_SUFFIXES = (".py", ".json", ".jsonl", ".md", ".yml", ".yaml", ".txt",
                  ".html", ".sh", ".cc", ".h")

_CONTRACT_FILES = {
    "flags": "ray_tpu_torch/_private/config.py",
    "metrics": "ray_tpu_torch/util/metrics.py",
    "events": "ray_tpu_torch/_private/flight_recorder.py",
    "sites": "ray_tpu_torch/_private/chaos.py",
}


class Contracts:
    """The declared names, parsed once per lint run from the repo root."""

    def __init__(self, root: str):
        self.root = root
        self.flags: Set[str] = set()
        self.flag_lines: Dict[str, int] = {}
        self.metrics: Set[str] = set()
        self.events: Set[str] = set()
        self.sites: Set[str] = set()
        self.config_rel = _CONTRACT_FILES["flags"]
        self._parse()

    def _load(self, key: str) -> Optional[SourceFile]:
        path = os.path.join(self.root, *_CONTRACT_FILES[key].split("/"))
        if not os.path.isfile(path):
            return None
        return load_source(path, self.root)

    def _parse(self):
        cfg = self._load("flags")
        if cfg is not None:
            for node in ast.walk(cfg.tree):
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, ast.AnnAssign):
                    targets = [node.target]
                else:
                    continue
                if not any(
                    isinstance(t, ast.Name) and t.id == "_FLAGS"
                    for t in targets
                ):
                    continue
                if isinstance(node.value, ast.Dict):
                    for k in node.value.keys:
                        name = const_str(k)
                        if name:
                            self.flags.add(name)
                            self.flag_lines[name] = k.lineno
        met = self._load("metrics")
        if met is not None:
            doc = ast.get_docstring(met.tree) or ""
            self.metrics.update(_METRIC_RE.findall(doc))
        fr = self._load("events")
        if fr is not None:
            doc = ast.get_docstring(fr.tree) or ""
            marker = "EVENT-NAME STABILITY CONTRACT"
            section = doc[doc.index(marker):] if marker in doc else doc
            self.events.update(self._dotted_names(section))
        ch = self._load("sites")
        if ch is not None:
            doc = ast.get_docstring(ch.tree) or ""
            start = "SITE-NAME STABILITY CONTRACT"
            end = "THE PLAN"
            if start in doc:
                doc = doc[doc.index(start):]
            if end in doc:
                doc = doc[: doc.index(end)]
            self.sites.update(self._dotted_names(doc))

    @staticmethod
    def _dotted_names(text: str) -> Set[str]:
        out = set()
        for name in _EVENT_RE.findall(text):
            if not name.endswith(_FILE_SUFFIXES):
                out.add(name)
        return out


def _docstring_nodes(sf: SourceFile) -> Set[int]:
    return sf.docstring_ids()


def _jax_prefix_reads(sf: SourceFile) -> List[Tuple[str, int]]:
    """(literal, line) for every ``"RTPU_<name>"`` flag literal: the JAX
    package's name for a flag, which ``CONFIG`` never reads."""
    docstrings = _docstring_nodes(sf)
    return [(node.value, node.lineno) for node in sf.nodes()
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings
            and _JAX_FLAG_READ_RE.match(node.value)]


def _flag_reads(sf: SourceFile) -> List[Tuple[str, int]]:
    """(flag_name, line) for every flag-style read in one module."""
    reads: List[Tuple[str, int]] = []
    docstrings = _docstring_nodes(sf)
    for node in sf.nodes():
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            if node.value.id == "CONFIG" and not node.attr.startswith("_"):
                if node.attr not in ("apply_system_config", "dump"):
                    reads.append((node.attr, node.lineno))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) in docstrings:
                continue
            m = _FLAG_READ_RE.match(node.value)
            if m:
                reads.append((m.group(1), node.lineno))
    return reads


def _metric_emissions(sf: SourceFile) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for node in sf.nodes():
        if isinstance(node, ast.Call):
            name = call_name(node)
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("Counter", "Gauge", "Histogram") and node.args:
                s = const_str(node.args[0])
                if s and s.startswith("ray_tpu_"):
                    out.append((s, node.args[0].lineno))
        elif isinstance(node, ast.Tuple) and len(node.elts) == 3:
            # the raylet/GCS/agent collectors build (name, labels, value)
            # sample tuples outside util.metrics
            s = const_str(node.elts[0])
            if (
                s
                and _METRIC_RE.fullmatch(s)
                and isinstance(node.elts[1], ast.Dict)
            ):
                out.append((s, node.elts[0].lineno))
    return out


def _record_modules(sf: SourceFile) -> Set[str]:
    """Local names under which flight_recorder's record() is reachable."""
    names: Set[str] = set()
    direct = False
    for node in sf.nodes():
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.endswith("flight_recorder"):
            for alias in node.names:
                if alias.name == "record":
                    direct = True
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in getattr(node, "names", []):
                if alias.name.split(".")[-1] == "flight_recorder":
                    names.add(alias.asname or "flight_recorder")
    if direct:
        names.add("")  # bare record() calls
    return names


def _event_emissions(sf: SourceFile) -> List[Tuple[str, int]]:
    mods = _record_modules(sf)
    if not mods:
        return []
    out: List[Tuple[str, int]] = []
    for node in sf.nodes():
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        hit = False
        if isinstance(f, ast.Attribute) and f.attr == "record":
            if isinstance(f.value, ast.Name) and f.value.id in mods:
                hit = True
        elif isinstance(f, ast.Name) and f.id == "record" and "" in mods:
            hit = True
        if hit:
            s = const_str(node.args[0])
            if s and "." in s:
                out.append((s, node.lineno))
    return out


def _site_emissions(sf: SourceFile) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for node in sf.nodes():
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "hit"
            and isinstance(f.value, ast.Name)
            and f.value.id in ("chaos", "_chaos")
        ):
            s = const_str(node.args[0])
            if s:
                out.append((s, node.lineno))
    return out


def analyze(
    files: List[SourceFile],
    contracts: Contracts,
    package_files: Optional[List[SourceFile]] = None,
) -> List[Finding]:
    """Cross-check ``files`` against the contracts. ``package_files``, when
    given, is the full package scan used for the flag-dead direction (a
    flag is dead only if NOTHING in the whole package reads it — a subset
    lint must not mass-report dead flags)."""
    findings: List[Finding] = []

    for sf in files:
        # each contract file is exempt only from its OWN check (config.py
        # builds "RTPU_TORCH_" strings generically; metrics.py's docstring IS the
        # metric list; ...) — chaos.py reading an undeclared flag must
        # still be a finding
        if sf.rel != _CONTRACT_FILES["flags"]:
            for name, line in _flag_reads(sf):
                if contracts.flags and name not in contracts.flags:
                    findings.append(Finding(
                        "flag-undeclared", sf.rel, line,
                        f"RTPU_TORCH_{name} read here but not declared in "
                        f"{contracts.config_rel} _FLAGS (stability "
                        "contract: declare the flag or rename the read)",
                        sf.snippet(line)))
            for literal, line in _jax_prefix_reads(sf):
                findings.append(Finding(
                    "flag-undeclared", sf.rel, line,
                    f"{literal} is the JAX package's flag prefix; the "
                    "port's flags are RTPU_TORCH_<name>",
                    sf.snippet(line)))
        if sf.rel != _CONTRACT_FILES["metrics"]:
            for name, line in _metric_emissions(sf):
                if name not in contracts.metrics:
                    findings.append(Finding(
                        "metric-unregistered", sf.rel, line,
                        f"metric '{name}' emitted here but missing from "
                        "the stability contract docstring in "
                        f"{_CONTRACT_FILES['metrics']}",
                        sf.snippet(line)))
        if sf.rel != _CONTRACT_FILES["events"]:
            for name, line in _event_emissions(sf):
                if name not in contracts.events:
                    findings.append(Finding(
                        "event-unregistered", sf.rel, line,
                        f"flight event '{name}' recorded here but missing "
                        "from the EVENT-NAME contract docstring in "
                        f"{_CONTRACT_FILES['events']}",
                        sf.snippet(line)))
        if sf.rel != _CONTRACT_FILES["sites"]:
            for name, line in _site_emissions(sf):
                if name not in contracts.sites:
                    findings.append(Finding(
                        "chaos-site-unregistered", sf.rel, line,
                        f"chaos site '{name}' fired here but missing from "
                        "the SITE-NAME contract docstring in "
                        f"{_CONTRACT_FILES['sites']}",
                        sf.snippet(line)))

    # flag-dead: the reverse direction, package-wide by construction
    scan = package_files if package_files is not None else files
    if scan and contracts.flags:
        read_anywhere: Set[str] = set()
        for sf in scan:
            if sf.rel == _CONTRACT_FILES["flags"]:
                continue
            read_anywhere.update(name for name, _ in _flag_reads(sf))
        cfg_sf = load_source(
            os.path.join(contracts.root, *contracts.config_rel.split("/")),
            contracts.root)
        for name in sorted(contracts.flags - read_anywhere):
            line = contracts.flag_lines.get(name, 1)
            findings.append(Finding(
                "flag-dead", contracts.config_rel, line,
                f"flag '{name}' declared in _FLAGS but never read "
                "anywhere in the package (dead contract surface: wire it "
                "or remove it)",
                cfg_sf.snippet(line) if cfg_sf else ""))
    return findings
