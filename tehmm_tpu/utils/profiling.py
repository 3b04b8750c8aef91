"""Tracing/profiling helpers (SURVEY.md §5 "Tracing / profiling": the
reference has none — wall clock via log timestamps; the rebuild wraps
``jax.profiler`` traces around the device kernels and derives
cell-updates/sec).
"""

from __future__ import annotations

import contextlib
import time

from tehmm_tpu.utils.common import logger


@contextlib.contextmanager
def trace(out_dir: str | None):
    """Capture a jax.profiler device trace into ``out_dir`` (viewable in
    TensorBoard / Perfetto).  No-op when out_dir is falsy."""
    if not out_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("wrote profiler trace to %s", out_dir)


def median_time(fn, reps: int) -> float:
    """Median wall seconds of ``fn()`` over ``reps`` runs, each ended by
    ``block_until_ready``, after two warm-up calls (compile + caches).
    JAX returns before the device finishes, so a timing without the
    sync would measure only the enqueue."""
    import statistics

    import jax

    jax.block_until_ready(fn())
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


class StageTimer:
    """Lightweight wall-clock stage timing with a derived-metric report
    (positions/s, cell-updates/s)."""

    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = (
                self.stages.get(name, 0.0) + time.perf_counter() - t0
            )

    def report(self, positions: int | None = None,
               num_states: int | None = None) -> dict:
        out: dict = {"stages_seconds": dict(self.stages)}
        total = sum(self.stages.values())
        out["total_seconds"] = total
        if positions and total > 0:
            out["positions_per_sec"] = positions / total
            if num_states:
                out["cell_updates_per_sec"] = (
                    2 * positions * num_states * num_states / total
                )
        return out
