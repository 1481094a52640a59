"""Env-gated whole-process cProfile for the runtime daemons.

Set ``RTPU_TORCH_PROFILE_PROC=<dir>`` before starting a cluster and every daemon
(GCS, raylet) dumps ``<dir>/<name>-<pid>.prof`` when it receives SIGTERM or
exits cleanly. Complements the profiling plane's on-demand sampler
(`_private/sampling_profiler.py` behind StartProfile/CollectProfile,
`ray-tpu-torch profile`, `/api/profile`): the sampler is timed windows while the
cluster runs; this one is cProfile whole-life coverage with zero blind
spots at process start, which is where burst bottlenecks (actor-creation
storms) live. Inspect with ``python -m pstats`` or snakeviz.
"""

from __future__ import annotations

import atexit
import os
import signal


def maybe_enable_process_profile(name: str) -> None:
    profile_dir = os.environ.get("RTPU_TORCH_PROFILE_PROC")
    if not profile_dir:
        return
    import cProfile

    prof = cProfile.Profile()
    prof.enable()
    done = {"dumped": False}

    def _dump():
        if done["dumped"]:
            return
        done["dumped"] = True
        prof.disable()
        try:
            os.makedirs(profile_dir, exist_ok=True)
            prof.dump_stats(
                os.path.join(profile_dir, f"{name}-{os.getpid()}.prof")
            )
        except Exception:
            pass

    atexit.register(_dump)
    prev = signal.getsignal(signal.SIGTERM)

    def _on_term(signum, frame):
        _dump()
        if callable(prev):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not the main thread
