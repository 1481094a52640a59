"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for ``sm_90a``,
into ``_build/<name>-<hash>.so``, where the hash covers the nvcc flags, the
source and every ``csrc/*.cuh`` header. The sources expose plain C
functions, loaded with :mod:`ctypes`; no PyTorch header is compiled, so a
build takes seconds. Building happens at first use (or through
:func:`build`), never at import, and every missing source is compiled in
parallel: one ``nvcc`` process per source, all started together.

A missing ``nvcc`` or a failed compile raises :class:`RuntimeError` carrying
nvcc's own output. The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills of every kernel) is kept beside each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # honours CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the port's "
        "CUDA kernels are compiled from ray_tpu_torch/csrc at first use and "
        "need the CUDA toolkit")


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: List[str] | None = None) -> Dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that have no
    up-to-date library yet, all at once; return ``{name: library path}``."""
    sources = sorted(CSRC.glob("*.cu"))
    if names is not None:
        sources = [s for s in sources if s.stem in names]
        missing = set(names) - {s.stem for s in sources}
        if missing:
            raise RuntimeError(f"no CUDA source for {sorted(missing)} in {CSRC}")
    out = {s.stem: _library_path(s) for s in sources}
    todo = [s for s in sources if not out[s.stem].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {src.name} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        final = out[src.stem]
        final.with_suffix(".log").write_text(log)
        os.replace(tmp, final)  # atomic: a concurrent loader sees all or none
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (the ptxas register/spill report) for a built source."""
    path = _library_path(CSRC / f"{name}.cu").with_suffix(".log")
    return path.read_text() if path.exists() else ""
