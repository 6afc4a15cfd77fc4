"""Timing / tracing utilities.

The reference measures wall-clock with a warmup run to exclude JIT
compilation (misc/benchmark/benchmark.jl:37-54); here: ``block_until_ready``
timing plus ``jax.profiler`` traces (SURVEY §5.1), and one fixed place for
JAX's persistent compile cache.
"""
from __future__ import annotations

import contextlib
import os
import time

__all__ = ["benchmark", "trace", "Timer", "enable_compile_cache"]

# the checkout that holds this package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache(root: str = _CHECKOUT):
    """Point JAX's persistent compile cache at ``<root>/.jax_cache``.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  The path is fixed (never a temporary or per-run name)
    because it is part of the cache key: a directory that moves never hits.
    Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


class Timer:
    """Accumulating wall-clock timer with named sections."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        return "\n".join(f"{k:30s} {v * 1e3:9.2f} ms" for k, v in self.times.items())


def benchmark(fn, *args, warmup: int = 1, reps: int = 3):
    """min/median wall time of ``fn(*args)`` with device completion
    barriers; compiles excluded via warmup runs.

    Returns (best_seconds, all_times)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
