"""Benchmark/profiling harness (SURVEY.md §5.1).

The reference has no timing code at all.  This module provides the honest
measurement pattern for an accelerator: warmup to amortise compilation,
``block_until_ready`` around every timed region, best-of-N wall clock, and
optional
Perfetto/TensorBoard traces via ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import jax


@dataclass
class TimingResult:
    name: str
    mean_s: float
    best_s: float
    reps: int

    @property
    def per_second(self) -> float:
        return 1.0 / self.best_s

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (f"{self.name}: best {self.best_s*1e3:.3f} ms, "
                f"mean {self.mean_s*1e3:.3f} ms over {self.reps} reps")


def simple_timeit(fn: Callable, *args, warmup: int = 2, reps: int = 5,
                  name: str = "fn") -> TimingResult:
    """Time ``fn(*args)`` with device-sync fencing.

    ``fn`` should be jitted; its output is blocked on every reption so
    async dispatch doesn't leak out of the timed region.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return TimingResult(name=name, mean_s=sum(times) / len(times),
                        best_s=min(times), reps=reps)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a jax.profiler trace around a block (Perfetto/TensorBoard).

    No-op when ``log_dir`` is None so call sites can leave the hook in place.
    """
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def step_timer(sink: list):
    """Append the wall-clock seconds of the block to ``sink``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink.append(time.perf_counter() - t0)
