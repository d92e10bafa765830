"""Runtime helpers: persistent XLA compilation cache, stage timing.

The reference tracks per-stage wall time with ad-hoc ``timeit`` prints
(/root/reference/bin/mercat2.py:230,299,335). StageTimer is the structured
equivalent; ``enable_compilation_cache`` amortizes XLA compile time across
runs (first compile of the sort kernel is tens of seconds; subsequent runs
hit the on-disk cache).
"""

from __future__ import annotations

import os
import time
from pathlib import Path


#: the source checkout this package runs from, when it runs from one
_CHECKOUT = Path(__file__).resolve().parents[2]


def compilation_cache_dir() -> str | None:
    """The persistent compile cache's directory.

    ``$JAX_COMPILATION_CACHE_DIR`` when set. Otherwise ``.jax_cache`` at a
    fixed place inside the source checkout, so that a later run of the
    same checkout finds the programs an earlier one compiled. An installed
    package (no ``pyproject.toml`` beside it) or a checkout this process
    cannot write to gets None: no persistent cache.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cache = _CHECKOUT / ".jax_cache"
    if not (_CHECKOUT / "pyproject.toml").is_file():
        return None
    if not os.access(cache if cache.exists() else _CHECKOUT, os.W_OK):
        return None
    return str(cache)


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; returns its directory.

    The directory is :func:`compilation_cache_dir`: where
    ``JAX_COMPILATION_CACHE_DIR`` is set, that directory and no other.
    Every program is cached, however small or quick to compile. Without
    a directory the run goes on uncached and prints one line saying so.
    """
    import jax

    path = compilation_cache_dir()
    if path is None:
        print("Compile cache off: JAX_COMPILATION_CACHE_DIR is unset and "
              f"{_CHECKOUT} is not a writable source checkout")
        return None
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def mem_use() -> str:
    """Current host RAM usage, GB (reference's mem_use,
    /root/reference/bin/mercat2.py:31-32)."""
    try:
        import psutil

        return f"{psutil.virtual_memory().used / 1024**3:.2f} GB"
    except ImportError:  # pragma: no cover
        return "n/a"


class DebugTrace:
    """Optional observability for ``-debug`` runs: prints host RAM at each
    stage (the reference gates the same prints on its hidden ``-debug``
    flag) and records a ``jax.profiler`` trace of the device timeline."""

    def __init__(self, enabled: bool, trace_dir=None):
        self.enabled = enabled
        self.trace_dir = str(trace_dir) if trace_dir else None
        self._trace = None

    def __enter__(self):
        if self.enabled and self.trace_dir:
            import jax

            self._trace = jax.profiler.trace(self.trace_dir)
            self._trace.__enter__()
            print(f"[debug] jax profiler trace -> {self.trace_dir}")
        return self

    def __exit__(self, *exc):
        if self._trace is not None:
            self._trace.__exit__(*exc)
        return False

    def stage(self, name: str) -> None:
        if self.enabled:
            print(f"[debug] {name}: host RAM {mem_use()}")


class StageTimer:
    """Named wall-clock stage timer with a report() summary."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.stages: list[tuple[str, float]] = []
        self._t0: float | None = None
        self._name: str | None = None

    def start(self, name: str) -> None:
        self.stop()
        self._name = name
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.stages.append((self._name, dt))
            if self.verbose:
                print(f"Time to {self._name}: {round(dt, 2)} seconds")
            self._t0 = None
            self._name = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
