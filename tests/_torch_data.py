"""The runs of the port's data parity tests (``tests/test_torch_data*.py``).

Each of those files holds programs ``prog(rt, rd, tmp)``: ``rt`` is a
runtime package (``ray_tpu`` or ``ray_tpu_torch``), ``rd`` its ``data``
package and ``tmp`` a directory of the program's own. :func:`run_both`
runs every program under ``ray_tpu`` in one runtime session, shuts it
down, then runs them (and the port-only ones) under ``ray_tpu_torch`` in
one session of its own, with the port's test flags: one session per
package per file, never both at once. A program that raises leaves the
names of its exception's classes and its traceback in place of a result,
and :func:`same` fails the test that reads it. The test module travels to
the workers by value (``cloudpickle.register_pickle_by_value``), so a
worker of the port never imports it, nor JAX with it.
"""

from __future__ import annotations

import importlib
import traceback

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtime import port_env


class Raised:
    def __init__(self, e: BaseException):
        self.names = [c.__name__ for c in type(e).__mro__]
        self.trace = traceback.format_exc()


def _run(rt, programs, tmp, num_cpus: int):
    rd = importlib.import_module(f"{rt.__name__}.data")
    out = {}
    rt.init(num_cpus=num_cpus)
    try:
        for name, prog in programs.items():
            d = tmp / rt.__name__ / name
            d.mkdir(parents=True)
            try:
                out[name] = prog(rt, rd, d)
            except Exception as e:  # noqa: BLE001 — the test that reads it fails
                out[name] = Raised(e)
    finally:
        rt.shutdown()
    return out


def run_both(module, programs, tmp, *, port_only=None, num_cpus: int = 8):
    """``(jax_results, port_results)``: dicts by program name."""
    cloudpickle.register_pickle_by_value(module)
    try:
        jax = _run(ray_tpu, programs, tmp, num_cpus)
        assert not ray_tpu.is_initialized()
        with pytest.MonkeyPatch.context() as mp:
            port_env(mp)
            port = _run(ray_tpu_torch, {**programs, **(port_only or {})}, tmp,
                        num_cpus)
    finally:
        cloudpickle.unregister_pickle_by_value(module)
    return jax, port


def result(results, name: str, side: int = 1):
    """One package's result (the port's by default); a program that raised
    fails the test with its traceback."""
    got = results[side][name]
    if isinstance(got, Raised):
        pytest.fail(f"{('ray_tpu', 'ray_tpu_torch')[side]}: {name} raised\n{got.trace}")
    return got


def same(results, name: str):
    """The port's result of ``name``, after holding it equal to the JAX
    package's."""
    ref = result(results, name, 0)
    got = result(results, name, 1)
    assert got == ref
    return got
