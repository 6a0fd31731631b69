"""What the traced run reads from torch.profiler's trace (CPU and CUDA
activities) and from spies on the port's functions.

- The device's busy time: the union of the intervals in which the card ran
  a kernel, a copy or a memset, inside the window.
- The breakdown: the device operations that took most time, and the
  longest idle gaps on the card, each labelled by the host-side event that
  spans it (the innermost CPU op or annotation holding the whole gap).
- The chaining fill's launches: each call of the port's
  map.device_step.chain_fill in the window runs inside an annotation of
  its own, inside which its kernel's launch lies; the first calls' inputs
  are kept (up to a budget) for K1's bound.
- Annotations around the port's engine steps, which name the host's work
  in the idle gaps.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import threading

import torch

WINDOW_OPEN = "rhbench.window_open"
WINDOW_CLOSE = "rhbench.window_close"
FILL_MARK = "rhbench.chain_fill#"
FILL_KEEP_CALLS = 64
FILL_KEEP_BYTES = 2 << 30
# the engine's steps annotated in the traced run (module, attribute)
ENGINE_STEPS = (
    ("rawhash_tpu_torch.map.engine", "_submit_chunk"),
    ("rawhash_tpu_torch.map.engine", "_process_host"),
    ("rawhash_tpu_torch.map.engine", "_process_tail"),
    ("rawhash_tpu_torch.map.engine", "_finalize_batch"),
    ("rawhash_tpu_torch.map.engine", "chunk_step"),
    ("rawhash_tpu_torch.map.engine", "tail_finish"),
    ("rawhash_tpu_torch.map.device_step", "events_and_sketch"),
    ("rawhash_tpu_torch.map.device_step", "lookup_expand"),
    ("rawhash_tpu_torch.map.device_step", "merge_sort_fill"),
)


ANNOTATIONS = {f"{m.rsplit('.', 1)[1]}.{a}" for m, a in ENGINE_STEPS}


def mark(name: str) -> None:
    """An instant in the trace: an empty annotation."""
    with torch.profiler.record_function(name):
        pass


class Spies:
    """The traced run's wrappers on the port's functions; `restore` puts the
    originals back."""

    def __init__(self):
        self._originals = []
        self._lock = threading.Lock()
        self.fill_calls = []  # [(mark, inputs or None, params)]
        self._kept_bytes = 0

    def _wrap(self, mod, attr, make):
        fn = getattr(mod, attr)
        wrapper = functools.wraps(fn)(make(fn))
        wrapper.__dict__.update(fn.__dict__)
        self._originals.append((mod, attr, fn))
        setattr(mod, attr, wrapper)

    def install(self) -> None:
        import importlib

        for mod_name, attr in ENGINE_STEPS:
            mod = importlib.import_module(mod_name)

            def annotate(fn, label=f"{mod_name.rsplit('.', 1)[1]}.{attr}"):
                def call(*a, **k):
                    with torch.profiler.record_function(label):
                        return fn(*a, **k)
                return call
            self._wrap(mod, attr, annotate)
        self._wrap(importlib.import_module("rawhash_tpu_torch.map.device_step"),
                   "chain_fill", self._fill_spy)

    def _fill_spy(self, fn):
        def call(key, tpos, qpos, n_anchors, **params):
            with self._lock:
                k = len(self.fill_calls)
                kept = None
                if k < FILL_KEEP_CALLS and key.is_cuda:
                    # the fill's inputs are ready: the stage before it
                    # synchronised the stream
                    n = max(1, int(n_anchors.max()))
                    nbytes = 3 * key.shape[0] * n * 4
                    if self._kept_bytes + nbytes <= FILL_KEEP_BYTES:
                        self._kept_bytes += nbytes
                        kept = (key[:, :n].clone(), tpos[:, :n].clone(),
                                qpos[:, :n].clone(), n_anchors.clone(),
                                tuple(key.shape))
                self.fill_calls.append((f"{FILL_MARK}{k}", kept, params))
            with torch.profiler.record_function(f"{FILL_MARK}{k}"):
                return fn(key, tpos, qpos, n_anchors, **params)
        return call

    def restore(self) -> None:
        for mod, attr, fn in reversed(self._originals):
            setattr(mod, attr, fn)
        self._originals.clear()


@contextlib.contextmanager
def profiled():
    """torch.profiler over CPU and CUDA activities, no shapes, stacks or
    memory."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, profile_memory=False,
                 with_stack=False) as prof:
        yield prof


def _annotation(e, name: str) -> bool:
    """A device-side span of an annotation (a record_function range), which
    is no work of the device's."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or name in ANNOTATIONS or name.startswith("rhbench.")


def _runtime(name: str) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel, ...)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof) -> dict:
    """The window's device busy seconds and length, the device operations
    by time, the idle gaps with their host labels, and the device time of
    each marked fill call's chain_fill kernel (by the mark's name)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    dev, host, marks, launches, fill_cpu = [], [], {}, [], []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # an annotation's span on the device is no work of the device's
            if not _annotation(e, name):
                dev.append((start, end, name, e.correlation_id()))
            continue
        if _runtime(name):
            if "Launch" in name:
                launches.append((e.start_thread_id(), start, e.correlation_id()))
            continue
        if name in (WINDOW_OPEN, WINDOW_CLOSE):
            marks[name] = start
        elif name.startswith(FILL_MARK):
            fill_cpu.append((e.start_thread_id(), start, end, name))
        host.append((start, end, name))
    if WINDOW_OPEN not in marks or WINDOW_CLOSE not in marks:
        raise RuntimeError("the trace lacks the window's marks")
    w0, w1 = marks[WINDOW_OPEN], marks[WINDOW_CLOSE]
    clipped = [(max(a, w0), min(b, w1)) for a, b, _, _ in dev if b > w0 and a < w1]
    busy = _merge(clipped)
    busy_ns = sum(b - a for a, b in busy)
    by_name = {}
    for a, b, name, _ in dev:
        if b > w0 and a < w1:
            by_name[name] = by_name.get(name, 0) + (min(b, w1) - max(a, w0))
    fill_ns = _fill_times(dev, fill_cpu, launches)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = [[_label(host, a, b), (b - a) / 1e9] for a, b in gaps]
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": [[n, ns / 1e9] for n, ns in ops], "idle_gaps": idle,
            "fill_ms": {k: v / 1e6 for k, v in fill_ns.items()},
            "counts": {"events": len(events), "device_ops": len(dev),
                       "fill_marks": len(fill_cpu), "launches": len(launches),
                       "fills_timed": len(fill_ns)}}


def _fill_times(dev, fill_cpu, launches) -> dict:
    """Each marked fill call's chain_fill kernel time (ns): the kernel whose
    launch the call made (the runtime call on the call's thread inside its
    mark shares the kernel's correlation id)."""
    fills = {corr: b - a for a, b, name, corr in dev if "chain_fill" in name}
    by_thread = {}
    for tid, t, corr in launches:
        by_thread.setdefault(tid, []).append((t, corr))
    for runs in by_thread.values():
        runs.sort()
    out = {}
    for tid, a, b, mark_name in fill_cpu:
        runs = by_thread.get(tid, [])
        lo = bisect.bisect_left(runs, (a, -1))
        hi = bisect.bisect_right(runs, (b, float("inf")))
        hits = [fills[c] for _, c in runs[lo:hi] if c in fills]
        if len(hits) == 1:
            out[mark_name] = hits[0]
    return out


def _label(host, a: int, b: int) -> str:
    """The innermost host event holding [a, b], else the one overlapping it
    most, else "none"."""
    holding = [(e - s, n) for s, e, n in host if s <= a and e >= b]
    if holding:
        return min(holding)[1]
    over = [(min(e, b) - max(s, a), n) for s, e, n in host if e > a and s < b]
    return max(over)[1] if over else "none"
