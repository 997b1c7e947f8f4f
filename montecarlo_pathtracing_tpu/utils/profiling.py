"""Profiling & observability — the FPS-counter/GPU-memory-query layer.

The reference's only instruments are an FPS average over 50-frame windows
(easycppogl/gl_viewer.cpp:412-418), a BVH-build wall-time print
(MontecarloGPU/montecarlo.cpp:354-363), and NVX GPU-memory queries
(gl_viewer.cpp:443-452). Equivalents here:

  - PassTimer: windowed passes/s + rays/s counters (the FPS analog)
  - trace_context: jax.profiler trace to a directory for xprof
  - device_memory_stats: per-device memory usage (the NVX query analog)
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import jax


class PassTimer:
    """Windowed throughput counter (50-pass window like the reference's
    50-frame FPS window)."""

    def __init__(self, rays_per_pass: int, window: int = 50):
        self.rays_per_pass = rays_per_pass
        self.times = deque(maxlen=window + 1)

    def tick(self):
        self.times.append(time.perf_counter())

    @property
    def passes_per_s(self) -> float:
        if len(self.times) < 2:
            return 0.0
        dt = self.times[-1] - self.times[0]
        return (len(self.times) - 1) / dt if dt > 0 else 0.0

    @property
    def rays_per_s(self) -> float:
        return self.passes_per_s * self.rays_per_pass


@contextlib.contextmanager
def trace_context(logdir: str):
    """jax.profiler trace for xprof / tensorboard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats():
    """Per-device memory stats dict (bytes); empty entries where the
    backend doesn't report (CPU)."""
    out = {}
    for d in jax.devices():
        try:
            out[str(d)] = d.memory_stats() or {}
        except Exception:
            out[str(d)] = {}
    return out


def timed_block(fn, *args, sync=True):
    """(result, seconds) with device sync — device timing needs
    block_until_ready, not wall clock around dispatch."""
    t0 = time.perf_counter()
    out = fn(*args)
    if sync:
        out = jax.block_until_ready(out)
    return out, time.perf_counter() - t0


CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache(min_compile_secs: float = 2.0) -> str | None:
    """Persistent XLA compilation cache, shared across processes.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already uses that directory
    and nothing is changed here. Otherwise the cache goes to the fixed
    path <checkout>/.jax_cache: the directory is part of the cache's key,
    so a path that moved between runs would never hit. Not enabled on
    the CPU backend, whose ahead-of-time results are stamped with the
    building host's ISA features and rejected on load. Called by every
    entry point (bench.py, the CLI, __graft_entry__, chip_smoke.py).
    Returns the directory in use, or None."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return CACHE_DIR
