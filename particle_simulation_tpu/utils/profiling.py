"""Profiling / tracing harness.

Reference equivalents (SURVEY.md §5.1): the nsys wrapper (`report:1`), CUDA
events around the sim loop (src/pic.cu:374-376, 570-572), and the chrono
process timer (src/main.cu:19,45).  Here: jax.profiler traces
(Perfetto/XProf-compatible; on the GPU they hold the device's kernels) plus
block_until_ready wall timers.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str = "out/trace"):
    """Capture a device trace viewable in XProf/Perfetto:
    `with profiling.trace(): run_pic(cfg)`."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class DeviceTimer:
    """block_until_ready wall timer, the CUDA-events equivalent."""

    def __init__(self):
        self.t0 = None
        self.elapsed_s = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s += time.perf_counter() - self.t0
        return False

    def stop(self, *arrays):
        jax.block_until_ready(arrays)
        self.elapsed_s += time.perf_counter() - self.t0
        return self.elapsed_s


def time_fn(fn, *args, iters: int = 3, warmup: int = 1):
    """Median wall time of fn(*args) with block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
