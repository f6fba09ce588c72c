"""Persistent JAX compilation cache at one fixed place.

JAX keys its cache by program and backend, and looks for it by path,
so a directory that moves never hits.  Every entry point (the CLI,
``bench.py``, ``chip_smoke.py``, the tests and the tools) calls
:func:`enable` so they all share one directory:

* ``JAX_COMPILATION_CACHE_DIR``, if set — JAX reads the variable
  itself, and no other directory is set here;
* otherwise ``<checkout>/.jax_cache`` for an accelerator, and for the
  CPU backend a sibling keyed by this host's CPU features: JAX's key
  does not include the target machine's feature set, so a CPU
  executable cached on another host can fault (XLA warns of SIGILL;
  a full test run was once seen to SIGSEGV inside such an entry).

An installed package (no ``pyproject.toml`` beside it) has no
checkout: there, and wherever the directory cannot be made, the
persistent cache stays off unless the variable names one.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import platform as _platform

def checkout() -> pathlib.Path | None:
    """The source checkout this package runs from, or None when it is
    installed (site-packages holds no ``pyproject.toml``)."""
    root = pathlib.Path(__file__).resolve().parents[2]
    return root if (root / "pyproject.toml").is_file() else None


def _cpu_tag() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            sig = next(line for line in f
                       if line.startswith(("flags", "Features")))
    except (OSError, StopIteration):
        sig = _platform.processor() or _platform.machine()
    return hashlib.sha1(sig.encode()).hexdigest()[:12]


def cache_dir(platform: str) -> pathlib.Path | None:
    """The cache directory for programs compiled for ``platform``;
    None outside a checkout when the variable is unset."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return pathlib.Path(env)
    root = checkout()
    if root is None:
        return None
    if platform == "cpu":
        return root / f".jax_cache_cpu-{_cpu_tag()}"
    return root / ".jax_cache"


def enable(platform: str | None = None) -> pathlib.Path | None:
    """Turn the persistent cache on for this process; returns its
    directory, or None when it stays off.  ``platform`` defaults to
    JAX's default backend."""
    import jax

    if platform is None:
        platform = jax.default_backend()
    path = cache_dir(platform)
    if path is None:
        return None
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            path.mkdir(exist_ok=True)
        except OSError:
            return None
        jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
