"""Load a pure-Python module of the JAX package as a module of the port.

`apf_quadruped_tpu/config.py` (frozen dataclasses) and
`apf_quadruped_tpu/models/dogbot.py` (numpy) import no jax, so the port
shares them instead of copying them: one source of truth for the
configuration tree and the robot constants.  They are executed from
their files under the port's own module names, so that a process running
the port never imports the JAX package itself.  A relative import inside
a shared file (`from ..config import RobotConfig`) therefore resolves to
the port's module of the same name.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_JAX_PACKAGE = Path(__file__).resolve().parent.parent / "apf_quadruped_tpu"


def load_shared(name: str, relpath: str):
    """Execute `apf_quadruped_tpu/<relpath>` as module `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, _JAX_PACKAGE / relpath)
    if spec is None:
        raise ImportError(f"cannot load {relpath} from {_JAX_PACKAGE}")
    module = importlib.util.module_from_spec(spec)
    # dataclasses resolve string annotations through sys.modules
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module
