"""Timing/observability utilities (reference parity: PROFILERH stage timers,
rmap.cpp:16-26,867-869, and the always-on real/CPU/peak-RSS summary,
rutils.c:22-45 + main.cpp:606-611)."""

from __future__ import annotations

import resource
import sys
import time
from collections import defaultdict
from contextlib import contextmanager


def realtime() -> float:
    return time.time()


def cputime() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def peakrss_bytes() -> int:
    r = resource.getrusage(resource.RUSAGE_SELF)
    mult = 1024 if sys.platform.startswith("linux") else 1
    return r.ru_maxrss * mult


class StageProfiler:
    """Accumulates wall time per pipeline stage (the PROFILERH equivalent:
    file read / signal / sketch / seed / chain / map)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> str:
        parts = [
            f"{k}: {v:.3f}s (x{self.counts[k]})"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "; ".join(parts)


def resource_summary(t0: float) -> str:
    """reference: main.cpp:610-611 closing line."""
    return (
        f"Real time: {realtime() - t0:.3f} sec; CPU: {cputime():.3f} sec; "
        f"Peak RSS: {peakrss_bytes() / 1024**3:.3f} GB"
    )
