"""Timing/observability utilities (reference parity: PROFILERH stage timers,
rmap.cpp:16-26,867-869, and the always-on real/CPU/peak-RSS summary,
rutils.c:22-45 + main.cpp:606-611)."""

from __future__ import annotations

import contextlib
import resource
import sys
import threading
import time
from collections import defaultdict

import torch
from torch.profiler import record_function

# what a span books besides its wall time (`StageProfiler.stage`)
STAGE, TRANSFER, WAIT = "stage", "transfer", "wait"
# the span that is no span: tracing is off
NO_SPAN = contextlib.nullcontext()
# the keys of the totals that are no stage's wall time, besides <stage>.cpu
SPLIT_KEYS = ("host_blocked", "device_drain")
WAIT_KEYS = ("worker_wait", "handoff")


def realtime() -> float:
    return time.time()


def cputime() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def peakrss_bytes() -> int:
    r = resource.getrusage(resource.RUSAGE_SELF)
    mult = 1024 if sys.platform.startswith("linux") else 1
    return r.ru_maxrss * mult


def stage_walls(totals: dict) -> dict:
    """The stages' wall times among a StageProfiler's totals."""
    return {k: v for k, v in totals.items()
            if not k.endswith(".cpu") and k not in SPLIT_KEYS + WAIT_KEYS}


def sync_stream(device: torch.device) -> None:
    """The tracer's sync: wait for the work queued on `device`'s current
    stream (nothing to wait for off the card)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class StageProfiler:
    """The engine's tracer: time per pipeline stage (the PROFILERH
    equivalent) in `totals` and `counts`, and a torch.profiler range per
    span.  Threads may add at once: each addition holds `lock` (its own if
    none is given).

    Tracing is on while a torch.profiler records in the process, or always
    with `on`; the engine reads `tracing()` once per chunk step.  Off,
    the engine opens no span: no sync, no range, no clock read, nothing
    booked.  On, a stage's span books, under these keys:

        <stage>        wall time from its start to after its sync
        <stage>.cpu    the thread's CPU time in it, its syncs left out
        device_drain   time in the tracer's syncs: device work still queued
                       when the host was done
        host_blocked   the rest of the wall time: the thread off the CPU
                       (mostly the GIL)

    so over the stages Σ <stage> = Σ <stage>.cpu + host_blocked +
    device_drain.  A transfer's off-CPU time is the copy itself: it books
    <stage> and <stage>.cpu only.  A wait books its wall time only."""

    def __init__(self, lock=None, on: bool = False):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = lock if lock is not None else threading.Lock()
        self.on = on

    def tracing(self) -> bool:
        # torch's process-wide flag: torch.autograd._profiler_enabled() reads
        # the calling thread's state, which a profiler of all threads leaves off
        return self.on or torch.autograd.profiler._is_profiler_enabled

    def range(self, name: str, ids: str = ""):
        """A torch.profiler range `rh.<name> <ids>` that books nothing.
        The ids are in the name: torch keeps a range's string args only as
        an input, under record_shapes, and shows them empty."""
        return record_function(f"rh.{name} {ids}" if ids else f"rh.{name}")

    def stage(self, name: str, ids: str = "", device: torch.device | None = None,
              lead: bool = False, kind: str = STAGE) -> Span:
        """The span of stage `name` (a context manager) in the range
        `rh.<name> <ids>`.  With `device` its end syncs that device's
        current stream, and with `lead` so does its start, inside its wall
        time."""
        return Span(self, name, ids, device, lead, kind)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def book(self, name: str, wall: float, cpu: float, drain: float,
             kind: str = STAGE) -> None:
        """A span's times, by `kind` (the class docstring's keys)."""
        books = [(name, wall)]
        if kind != WAIT:
            books.append((name + ".cpu", cpu))
        if kind == STAGE:
            books += [("device_drain", drain), ("host_blocked", wall - cpu - drain)]
        with self._lock:
            for key, seconds in books:
                self.totals[key] += seconds
                self.counts[key] += 1

    def summary(self) -> str:
        parts = [
            f"{k}: {v:.3f}s (x{self.counts[k]})"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "; ".join(parts)


class Span:
    """One open span (StageProfiler.stage): the range, then the host clock
    and the thread's CPU clock at its start (after a leading sync) and at
    its end (before the closing sync); booked when it closes."""

    __slots__ = ("prof", "name", "ids", "device", "lead", "kind", "_range",
                 "t0", "c0", "drain")

    def __init__(self, prof, name, ids, device, lead, kind):
        self.prof, self.name, self.ids = prof, name, ids
        self.device, self.lead, self.kind = device, lead, kind

    def __enter__(self) -> Span:
        self._range = self.prof.range(self.name, self.ids)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        self.drain = 0.0
        if self.lead:
            sync_stream(self.device)
            self.drain = time.perf_counter() - self.t0
        self.c0 = time.thread_time()
        return self

    def __exit__(self, *exc) -> None:
        t1, c1 = time.perf_counter(), time.thread_time()
        t2 = t1
        if self.device is not None:
            sync_stream(self.device)
            t2 = time.perf_counter()
        self._range.__exit__(*exc)
        self.prof.book(self.name, t2 - self.t0, c1 - self.c0,
                       self.drain + t2 - t1, self.kind)


def resource_summary(t0: float) -> str:
    """reference: main.cpp:610-611 closing line."""
    return (
        f"Real time: {realtime() - t0:.3f} sec; CPU: {cputime():.3f} sec; "
        f"Peak RSS: {peakrss_bytes() / 1024**3:.3f} GB"
    )
