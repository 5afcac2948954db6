"""Per-stage timing and profiling (SURVEY.md §5 tracing/profiling).

The reference wraps every stage in gettimeofday pairs under -DTIME_DEBUG and
prints per-stage seconds plus MB/s (dctz-comp-lib.c:762-773,
dctz-decomp-lib.c:519-528). Here the same breakdown is a context-manager
stack that any caller can enable at runtime, plus an optional
jax.profiler trace for device-side inspection.

Usage:
    with StageTimer() as t:
        with t.stage("device"):
            ...
        with t.stage("zlib"):
            ...
    print(t.report(nbytes))  # per-stage seconds + MB/s like TIME_DEBUG
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator


class StageTimer:
    """Accumulates named stage durations; reentrant stages sum up.

    sync=True waits for the device (jax.block_until_ready) at device-stage
    boundaries so async dispatch time is attributed to the right stage;
    leave False in production paths to keep dispatch fully asynchronous.
    """

    def __init__(self, sync: bool = False) -> None:
        self.stages: dict[str, float] = {}
        self.sync = sync
        self._t0 = time.perf_counter()

    def __enter__(self) -> "StageTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total = time.perf_counter() - self._t0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self, nbytes: int | None = None) -> dict:
        """Structured breakdown; MB/s mirrors the reference's printout."""
        total = getattr(self, "total", sum(self.stages.values()))
        out: dict = {"total_s": total, "stages_s": dict(self.stages)}
        if nbytes is not None and total > 0:
            out["mb_per_s"] = nbytes / 1e6 / total
        return out

    def print_report(self, nbytes: int | None = None, label: str = "") -> None:
        r = self.report(nbytes)
        parts = ", ".join(f"{k}={v:.6f}(s)" for k, v in r["stages_s"].items())
        print(f"{label}{parts}")
        if "mb_per_s" in r:
            print(
                f"{label}time = {r['total_s']:.6f} (s), rate = "
                f"{r['mb_per_s']:.3f} (MB/s)"
            )


@contextlib.contextmanager
def device_trace(log_dir: str | None) -> Iterator[None]:
    """Optional jax.profiler trace wrapper (no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
