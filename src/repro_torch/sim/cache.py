"""Persistent kernel-build cache wiring.

What the port compiles is its nvcc libraries (``kernels/_build.py``): each
kernel source is built at first use into a library keyed by a hash of
the source, the shared headers and the flags, and a later process finds
it there instead of running nvcc again.  This module is the counterpart
of the reference's persistent XLA compile cache: it points that build
directory somewhere else, so the builds are paid once per machine (or
shared volume) instead of once per checkout.  The hash key does not
depend on the directory, so two checkouts that share a cache directory
share their builds.

Enable it explicitly::

    from repro_torch.sim import enable_compile_cache
    enable_compile_cache("/path/to/cache")    # or no arg: env / default

or through the environment (read when ``repro_torch.sim`` is imported)::

    REPRO_COMPILE_CACHE=/path/to/cache python my_sweep.py

Without either, libraries go to ``build/repro_torch_kernels/`` at the root
of the checkout, which is also the directory an explicit call with no
path and no environment variable selects.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from ..kernels import _build

#: environment variable naming the cache directory.
ENV_VAR = "REPRO_COMPILE_CACHE"

#: the directory an explicit call with no path and no env selects: the
#: checkout's default build directory.
DEFAULT_DIR = _build.BUILD_DIR

_active_dir: Optional[str] = None


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Build and look up the kernel libraries in a persistent directory.

    Resolution order: explicit ``path`` > ``$REPRO_COMPILE_CACHE`` >
    :data:`DEFAULT_DIR`.  Creates the directory; an unusable path raises
    ``OSError`` and leaves the build directory as it was.  Returns the
    directory used.  Libraries already loaded stay loaded; only lookups
    made afterwards use the new directory.
    """
    global _active_dir
    target = Path(path or os.environ.get(ENV_VAR) or DEFAULT_DIR)
    target.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = target
    _active_dir = str(target)
    return _active_dir


def maybe_enable_from_env() -> Optional[str]:
    """Enable the cache iff ``$REPRO_COMPILE_CACHE`` is set (the
    ``repro_torch.sim`` import hook); returns the directory or None.

    Unlike the explicit :func:`enable_compile_cache` call, a failure here
    (an unwritable path) degrades to a warning and keeps the default
    directory: an opt-in performance variable must not turn ``import
    repro_torch.sim`` into a crash.
    """
    if not os.environ.get(ENV_VAR):
        return None
    try:
        return enable_compile_cache()
    except OSError as e:
        import warnings
        warnings.warn(f"{ENV_VAR}={os.environ[ENV_VAR]!r} unusable "
                      f"({e}); continuing with the default build "
                      f"directory", RuntimeWarning, stacklevel=2)
        return None


def active_cache_dir() -> Optional[str]:
    """The directory the cache was enabled with, or None."""
    return _active_dir
