

import os as _os


def repo_root() -> str:
    """Directory containing the ray_tpu_torch package — prepended to PYTHONPATH
    for spawned daemons/workers so they import this same checkout."""
    return _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))))
