#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rawhash_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printed as one JSON line and each fatal on failure:
  1. build     the CUDA kernels from rawhash_tpu_torch/csrc with nvcc, one
               process per source, in parallel
  2. k1        chain_fill kernel vs the plain PyTorch fill on the card
               (B=256, N in {4096, 16384}, W=200, viral and sensitive
               parameters, rows sorted by (key, tpos)): f and p must be
               bit-equal; kernel timed (median of 7), the plain fill timed
               once; each line carries its input's chain segments
  3. backtrack chain_backtrack kernel vs its plain version on f/p from K1
               (sensitive): B=256 N=16384 (the D2 regime), B=32 N=40960
               (past 32768, the K3 regime), B=64 N=4096 with k_cap 4
               (chains lost to k_cap); all ten outputs, the compacted
               summaries and the carried prefix bit-equal; kernel timed
               with its candidate order (median of 7), the old full-width
               sort and the new order timed apart, the plain version once
               (on CPU copies); the counted work (candidates, walk and
               claim steps, serial_steps_max) and the bound from it; at
               256 x 16384 the kernel at each staging depth, checked and
               timed in turns
  4. event_kernels the events stage's three kernels (events_fused,
               csrc/events_fused.cu, the engine's path) held bit for bit
               against the stage's op chain on the card and timed beside it
               and their bound; the single kernels (the peak detector
               csrc/events_peaks.cu, the ordered prefix sums and sums
               csrc/ordered_scan.cu, the diff filter csrc/diff_filter.cu)
               on the inputs one events+sketch call of the op chain on the
               card gives them (the engine launches only the diff filter of
               these), 256 reads at the viral and sensitive (4000 samples, 768
               events) and ava (28672, 16384) shapes: each call (the sum of
               the signal and its square, the prefix sums of the clipped
               signal and its square, the prefix sum of the kept values,
               the detector, the filter) held bit for bit against its plain
               version on the card, with no sync in the kernel route; each
               timed three ways (device time by a CUDA graph of 20 launches,
               L2 warm; call time on an idle card; the wrapper's host time),
               the plain version once; the ordered sums also as the single
               function beside one torch.cumsum / torch.sum call, each
               beside its bound (the serial scans' critical paths at
               latencies measured here); then the stage's torch ops at L =
               4000 and 8000, which must be equal (no op a position or an
               event), with no sync at either
  5. k4        the fill-loop probe (a serial ring's floor): the card's
               latencies (a dependent VIADDMNMX, REDUX, 5-round shuffle max,
               FSETP -> PLOP3 -> SEL chain; the int32 rate on every SM); kernel vs the plain probe bit
               for bit on a random start at 1000 iterations, W in {1, 33,
               64, 200, 256} (ring in registers) and {257, 4096} (shared
               memory) x 256 at k_ops 2, 7 (runtime k_ops), 20, 60, kernel
               timed (median of 7) and the plain probe once; the kernel
               against the closed form from INT32_MIN at 100000
               iterations; the probe's entry point run with its launch
               counter set to 0 just before and read just after; 200 x 256
               (K1's W) timed at 100000 iterations; each beside its bound
               (int32 rate and critical path); in the SASS of every kernel
               instance the integer max count >= k_ops x SPL and growing
               with k_ops, REDUX present, and in the register form no
               LDL/STL or SHFL; the compare-select probes' FSETP and PLOP3
  6. fixture   the CLI (`python -m rawhash_tpu_torch`) on a small fixture,
               --device cuda vs --device cpu: same mapped reads, same PAF
               columns 1, 5 and 6, column 8 within 20; and on cuda with
               RAWHASH_TPU_DEVICE_TAIL=1, and at --batch-reads 2: PAF
               columns 1-12 equal to the one-batch host tail's; then,
               cuda vs cpu, the
               all-vs-all fixture (5 overlapping reads, `-x ava-viral`,
               index built with --sig-target) reports the same overlap
               pairs, --out-quantize prints the same bytes, and
               --sequence-until stops at the same read
  7. d1        SARS-CoV-2-sized deployment: 30 kb genome, viral preset,
               2 x 256 reads of 1200 bases; stays on the host tail
  8. d2        E. coli-sized deployment: 5 Mbp genome, sensitive preset,
               2 x 256 reads of 2500 bases, --max-anchors 16384; switches
               to the device tail
  9. d4        100 Mbp deployment: genome from seed 13, sensitive preset,
               1 x 256 reads of 3000 bases, default --max-anchors (4096)
               and --max-anchor-cap (2^17); the device tail at backtrack
               widths past 32768
 10. d2_kernels the backtrack on the inputs d2's main path gave it (its
               widest device-tail call, caught during the run), as in
               phase 3, every row held bit for bit against the plain
               version, with the staging depths; and the standalone
               backtrack + compaction (backtrack_compact): its kernel route
               on the whole call timed beside chain_backtrack, its launches
               counted by chain_backtrack's counter, every output held
               whole on the same rows against its CPU route
     d4_kernels both kernels on d4's widest device-tail call: timed at
               that whole shape (median of 5), and 8 of its rows at full
               width held bit for bit against the plain fill and the plain
               backtrack (all ten outputs, compaction, carried prefix) on
               CPU copies, each plain version timed once; with the fill
               input's chain segments and the backtrack's work and depths,
               and backtrack_compact as in d2_kernels on the same 8 rows
 11. fill_warps K1 at 4, 8 and 16 warps a read on the main path's own fill
               inputs (the widest fill call of d1, d2 and d4, caught during
               their runs) and on k1's sensitive 256 x 16384 input: each
               bit-equal to chain_fill's f/p, then timed in turns (median
               of 5, forward and reverse order, twice); with each input's
               chain segments
 12. ava       all-vs-all overlapping (Rawsamble), `-x ava`: 512 reads of
               3000 bases from a 250 kb genome (seed 23, random strands,
               about 6x coverage, made as bench.py's ava workload), the
               index built from the reads' signals, mapped in 2 x 256 on
               the engine's own tail choice; precision and recall of the
               overlap pairs as bench.py counts them (min_ov 450); the
               engine must take the device tail; no record with a query
               name at or after its target's
     ava_tails the first 64 ava reads again on the forced host tail, PAF
               columns 1-12 equal to the ava run's (device tail) for them
     ava_kernels both kernels on ava's widest device-tail call, as
               d4_kernels (8 rows held), with the ava preset's parameters
 13. ava_quality bench.py's own ava workload unchanged (120 reads of 1500
               bases, 60 kb, seed 23, `-x ava-viral`, --max-anchors 2048),
               mapped as one batch: precision >= 0.12 and recall >= 0.65
 14. dtw       D1's genome indexed with --store-sig, `-x viral
               --dtw-evaluate-chains`, 1 x 256 reads, the banded DTW on its
               kernel (csrc/dtw_banded.cu: ragged pairs, the long ones a
               warp each); every call timed (the host wrapper's whole call,
               the kernel's by CUDA events), the widest one held bit for bit
               against the plain version on the same pairs padded, on the
               card (max abs err 0), and timed three ways beside it and its
               bound, with the host wrapper's whole call, the bytes it
               copied, T and the pairs on each path; the kernel again with
               every pair on a thread, bit for bit
 15. rmq, bw_long D1 with --rmq, then with --bw-long at 5x the preset's --bw,
               1 x 256 reads each
 16. dist      the sharded engine (--n-shards 1) in a one-rank NCCL process
               group on cuda:0 (the table unsplit: NCCL takes no two ranks
               on one card), on the first batch of d1 (host tail) and of d2
               (device tail: K1 and the backtrack on the rank's rows): PAF
               columns 1-12 equal to the single-device engine's on the same
               reads (in the cell's main run); bp/s of both, shard_hits,
               the gather and lookup+expand seconds
 17. multihost `python -m rawhash_tpu_torch.parallel.multihost --selftest
               --device cuda` as its own process, a world of one over NCCL:
               must print MULTIHOST_OK
 18. k1_wide   K1 past the shared-memory cap: W = 20000 (the rings in a
               global-memory scratch) on 8 rows of 16384 anchors all in band,
               chains stepping 14465 anchors back (sensitive): bit-equal to
               the plain fill, chain ends better than at W = 14464; timed (median of 5) beside the
               shared-memory path at W = 14464, the plain fill once, with its
               bound; then the CLI maps the fixture with --max-iterations
               20000 on cuda
     pipeline  D1 (host tail) and D2 (device tail), 2 batches each, mapped
               again from the same reads at --pipeline-depth 1: records
               equal to the main run's, which ran at the default depth, 3;
               bp/s, wall seconds, the stage sums and the distinct CUDA
               streams K1 and K2 launched on, per cell and depth (one at
               depth 1, one a batch in flight at depth 3)
Every mapping phase runs at the default --pipeline-depth, 3 (batches in
flight, each on a CUDA stream of its own, chunk tails on a worker pool),
unless it says otherwise; the fixture's CLI also maps at --batch-reads 2
(three batches in flight), PAF columns 1-12 equal to the one-batch run's.
Phases 6-9, 12-15, 16 and pipeline (not the *_kernels checks) are the main-path run:
each resets the kernels' launch counters just before it and reads them
just after; every kernel of its path must have launched in it: the
events and sketch kernels and the fill in every run, the backtrack too
in those that take the device tail (all but d1, ava_tails, ava_quality,
dtw, rmq and bw_long), the banded DTW in dtw.  Phases 7-9, 14 and 15 need
>= 95% of reads mapped at accuracy >= 0.95 (strand right, mapped target
interval inside the read's true interval +/- 200).
The plain versions that run on the host CPU (the backtrack on CPU copies,
the fill of d4's and ava's held rows, backtrack_compact's CPU route), the
fixture's --device cpu runs and the ava cell's index build go to two
worker processes (one thread and one core each, at a lower priority;
`--host-workers N` sets how many, 0 runs each in turn on the calling
thread) and run beside the card's phases; each check is made when its result is back,
all of them before the kernels line, and a phase whose check waits emits
its line then.
The line before the card's line lists every kernel with its launches, error
and times beside its bound (rawhash_tpu_torch/profiling/bounds.py: bytes,
fp32, int32, fp32 mins and conversions each at the H100's own rate, and
for K4, the peak detector, the diff filter and the banded DTW their
critical paths at the card's measured latencies, the largest time);
the last line is {"ok": true, "device": ...}.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def bound_by(row) -> str:
    """The kernels line's bound_by: "bytes" or "operations" (a class of
    operations, or a critical path of dependent ones)."""
    return "bytes" if row["bound_class"] == "bytes" else "operations"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA events.
    The caller has run fn once already (the warm-up)."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def timed_once(torch, fn):
    """(result, milliseconds) of one call of fn, timed with CUDA events."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


class HostWorkers:
    """The plain versions that run on the host CPU (the backtrack on CPU
    copies, the fill of wide rows, the CPU CLI runs) in worker processes,
    beside the card's work: `submit(fn, *args, then=...)` queues fn(*args)
    (numpy arrays and numbers in, numpy arrays and numbers out); `settle()`
    waits for each in order and hands its result to its `then`, which holds
    it against the card's output (raising Failed) and emits the phase line.
    Nothing is left out: every check runs, later."""

    def __init__(self, workers: int, threads: int):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = None  # no workers: each fn runs at once, on the calling thread
        if workers:
            cores = sorted(os.sched_getaffinity(0))
            self.pool = ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=host_worker_init,
                initargs=(threads, set(cores[-workers * threads:])))
        self.pending = []

    def submit(self, fn, *args, then=None):
        from concurrent.futures import Future

        if self.pool is None:
            fut = Future()
            fut.set_result(fn(*args))
        else:
            fut = self.pool.submit(fn, *args)
        if then is not None:
            self.pending.append((fut, then))
        return fut

    def later(self, fn) -> None:
        """Run fn() at settle time, after the checks queued before it."""
        self.pending.append((None, lambda _: fn()))

    def settle(self) -> None:
        while self.pending:
            fut, then = self.pending.pop(0)
            then(None if fut is None else fut.result())

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)


def host_worker_init(threads: int, cores: set) -> None:
    """A host worker keeps to `cores` and yields the CPU to the process
    that drives the card."""
    import torch

    os.sched_setaffinity(0, cores)
    os.nice(10)
    torch.set_num_threads(threads)


def tensors(arrays):
    import torch

    return [torch.from_numpy(a) for a in arrays]


def plain_fill(arrays, prm):
    """(f, p, ms) of the plain fill on CPU tensors (in a host worker)."""
    from rawhash_tpu_torch.chain.device import chain_fill_batch

    t0 = time.perf_counter()
    f, p = chain_fill_batch(*tensors(arrays), **prm)
    return f.numpy(), p.numpy(), (time.perf_counter() - t0) * 1e3


def plain_backtrack(arrays, key, bt, k_cap):
    """(the ten outputs, compact_batch's asc and summaries of its chains,
    ms of the backtrack) of the plain backtrack on CPU copies of (f, p,
    n_anchors, tpos, qpos) (in a host worker)."""
    from rawhash_tpu_torch.chain.backtrack_device import backtrack_plain, compact_batch

    cpu_in = tensors(arrays)
    t0 = time.perf_counter()
    want = backtrack_plain(*cpu_in, **bt, k_cap=k_cap)
    ms = (time.perf_counter() - t0) * 1e3
    asc, _, summ = compact_batch(*want[:5], *tensors([key]), *cpu_in[3:],
                                 q_span=bt["q_span"])
    return [w.numpy() for w in want], asc.numpy(), summ.numpy(), ms


def cpu_backtrack_compact(arrays, bt, k_cap):
    """(outputs, ms) of backtrack_compact's CPU route on (f, p, n_anchors,
    key, tpos, qpos) (in a host worker)."""
    from rawhash_tpu_torch.chain.backtrack_device import backtrack_compact

    t0 = time.perf_counter()
    out = backtrack_compact(*tensors(arrays), **bt, k_cap=k_cap)
    return [o.numpy() for o in out], (time.perf_counter() - t0) * 1e3


def cli_run(args):
    """(exit code, seconds) of the port's CLI (in a host worker)."""
    from rawhash_tpu_torch.cli import main as cli

    t0 = time.perf_counter()
    rc = cli(args)
    return rc, time.perf_counter() - t0


_SPY_LOCK = threading.Lock()


def spy(mod, name, record):
    """Wrap mod.name so that each call first hands (name, the original, its
    arguments, keyword arguments) to record, one call at a time (the
    engine's workers call from several threads); returns the original,
    which the caller puts back."""
    fn = getattr(mod, name)

    def wrapper(*a, **k):
        with _SPY_LOCK:
            record(name, fn, a, k)
        return fn(*a, **k)
    # the same attributes: a kernel wrapper that counts its launches on its
    # module's name for it counts them on the original
    wrapper.__dict__ = fn.__dict__
    setattr(mod, name, wrapper)
    return fn


def for_default_stream(x):
    """x (a tensor, or tuples of them) kept past a run for use on the
    default stream: made on a batch's stream, its memory must not go back
    to that stream while the default stream may still read it."""
    import torch

    if isinstance(x, tuple):
        for t in x:
            for_default_stream(t)
    elif isinstance(x, torch.Tensor):
        x.record_stream(torch.cuda.default_stream(x.device))
    return x


def fill_bound(key, tpos, qpos, n_anchors, prm) -> dict:
    """K1's bound from this run's inputs: key/tpos/qpos read for the live
    anchors, f/p written for all slots; each anchor's in-band suffix of its
    window and the one predecessor that ends it pay the band test, and the
    pairs in band the steps of the score they reach, instruction by
    instruction from chain_fill.cuh (profiling/bounds.py: fill_work counts
    the pairs on the card, fill_ops prices them).  The inputs must be
    sorted by (key, tpos), as the kernel and the suffix need: fails on any
    in-band pair past an out-of-band one.  Also the input's chain segments
    (fill_segments)."""
    from rawhash_tpu_torch.profiling.bounds import (
        bound, fill_ops, fill_segments, fill_work,
    )

    work = fill_work(key, tpos, qpos, n_anchors, **prm)
    check(work["unsorted"] == 0,
          f"k1 input: {work['unsorted']} in-band pairs past an out-of-band one")
    b, n = key.shape
    nbytes = 12.0 * int(n_anchors.sum()) + 4 * b + 8.0 * b * n
    return {**bound(nbytes, **fill_ops(work)), "work": work,
            "segments": fill_segments(key, tpos, n_anchors, **prm)}


def check_fill(torch, host, label, args, f, p, prm, row) -> None:
    """Hold the kernel's f/p (on the card) against the plain fill on CPU
    copies of `args` (key, tpos, qpos, n_anchors) in a host worker; when it
    is back, `row` gets its max abs error and plain ms."""
    f, p = f.cpu(), p.cpu()

    def then(result):
        f0, p0 = tensors(result[:2])
        err = max(int((f - f0).abs().max()), int((p - p0).abs().max()))
        check(torch.equal(f, f0) and torch.equal(p, p0),
              f"{label}: kernel disagrees with the plain fill (max abs err {err})")
        row.update(max_abs_err=err, plain_ms=result[2], plain_device="cpu")

    host.submit(plain_fill, [t.cpu().numpy() for t in args], prm, then=then)


def phase_k1(torch, dev) -> list:
    """Kernel vs plain fill on clustered anchors from a numpy seed."""
    from rawhash_tpu_torch.chain.device import chain_fill_batch
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import clustered_anchors, options

    results = []
    for preset in ("viral", "sensitive"):
        prm = fill_params(*options(preset))
        for n in (4096, 16384):
            b = 256
            host = clustered_anchors(n, b, n)
            args = [torch.from_numpy(x).to(dev) for x in host]
            f, p = chain_fill(*args, **prm)  # also the timing's warm-up
            (f0, p0), plain_ms = timed_once(
                torch, lambda: chain_fill_batch(*args, **prm))
            err = max(int((f - f0).abs().max()), int((p - p0).abs().max()))
            check(torch.equal(f, f0) and torch.equal(p, p0),
                  f"k1 {preset} N={n}: kernel disagrees with the plain fill "
                  f"(max abs err {err})")
            ms = cuda_ms(torch, lambda: chain_fill(*args, **prm), 7)
            row = dict(preset=preset, b=b, n=n, w=prm["max_iter"],
                       anchors=int(host[3].sum()), max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, **fill_bound(*args, prm))
            emit({"phase": "k1", **row})
            results.append(row)
    return results


def backtrack_bound(inputs, bt, k_cap) -> dict:
    """The backtrack's bound from this run's inputs (profiling/bounds.py):
    its serial algorithm run on the host counts the candidates, claimed
    skips, walk and claim steps, kept chains and v writes these inputs
    need; their bytes and int32 operations at the H100's rates.  With the
    counts (`work`, its serial_steps_max the longest read's dependent
    steps)."""
    from rawhash_tpu_torch.profiling.bounds import (
        backtrack_bytes, backtrack_ops, backtrack_work, bound,
    )

    work = backtrack_work(*inputs, **bt, k_cap=k_cap)
    return {**bound(backtrack_bytes(work, inputs[0].shape[0]), **backtrack_ops(work)),
            "work": work}


def check_backtrack(torch, label, inputs, key, got, row, host, *, bt, k_cap,
                    p_out) -> None:
    """Hold the kernel's ten outputs `got` (on the card) against the plain
    version on CPU copies of `inputs` (f, p, n_anchors, tpos, qpos), and the
    compaction of each (summaries of the live chains, carried prefix).  The
    plain version runs in a host worker; when it is back, `row` gets its
    max abs error and plain ms.

    The plain lockstep takes ~3N steps of ~150 small ops: on the card
    (launch-bound) it ran 102 s at N=16384 and 205 s at N=40960 on an H100
    80GB HBM3 at 700 W, so it runs on CPU copies of the same tensors (~4x
    faster)."""
    from rawhash_tpu_torch.chain.backtrack import compact_from_chain_stats

    _, _, _, tpos, qpos = inputs
    asc, _, summ = compact_from_chain_stats(
        *got[:2], *got[6:], got[2], got[3], got[4], key, tpos, qpos,
        p_out=p_out)
    got, asc, summ = ([t.cpu() for t in got], asc.cpu(), summ.cpu())

    def then(result):
        want, asc_b, summ_b, plain_ms = result
        want, asc_b, summ_b = tensors(want), *tensors([asc_b, summ_b])
        err = max(int((a.long() - c.long()).abs().max()) for a, c in zip(want, got))
        check(all(torch.equal(a, c) for a, c in zip(want, got)),
              f"{label}: kernel disagrees with the plain version (max abs err {err})")
        n_u, n_v = got[2], got[4]
        po = min(p_out, asc_b.shape[1])  # past the width, asc is padding
        live = torch.arange(k_cap)[None, :] < n_u[:, None]
        pre = torch.arange(po)[None, :] < n_v.clamp(max=po)[:, None]
        check(torch.equal(summ[live], summ_b[live])
              and torch.equal(asc[:, :po][pre], asc_b[:, :po][pre]),
              f"{label}: compacted summaries or carried prefix differ between "
              "the kernel's chain stats and the plain version")
        row.update(max_abs_err=err, plain_ms=plain_ms)

    host.submit(plain_backtrack, [t.cpu().numpy() for t in inputs],
                key.cpu().numpy(), bt, k_cap, then=then)


def backtrack_params(mo, prm) -> dict:
    return dict(min_cnt=mo.min_num_anchors, min_sc=mo.min_chaining_score,
                max_drop=mo.bw, q_span=prm["q_span"])


def measure_backtrack(torch, label, inputs, key, host, *, bt, k_cap, p_out,
                      reps, rows=None) -> dict:
    """chain_backtrack on `inputs` (f, p, n_anchors, tpos, qpos on the
    card): its time with its candidate order, the old full-width sort's
    time beside the new order's, the candidates, the launch plan and the
    counted bound with ns per serial step; its outputs on `rows` (all if
    None) held against the plain version on CPU copies in a host worker
    (check_backtrack: max_abs_err and plain_ms come with it)."""
    from rawhash_tpu_torch.chain.backtrack import (
        candidate_order, candidates, chain_backtrack, launch_depth,
    )

    f, _, n_anchors, _, _ = inputs
    got = chain_backtrack(*inputs, **bt, k_cap=k_cap)  # the warm-up
    ms = cuda_ms(torch, lambda: chain_backtrack(*inputs, **bt, k_cap=k_cap), reps)
    sort_ms = cuda_ms(torch, lambda: candidates(f, n_anchors), reps)
    order_ms = cuda_ms(torch, lambda: candidate_order(f, n_anchors, bt["min_sc"]), reps)
    z_f, _, n_cand, a_max = candidate_order(f, n_anchors, bt["min_sc"])
    depth = launch_depth(a_max)
    bnd = backtrack_bound(inputs, bt, k_cap)
    check(int(n_cand.sum()) == bnd["work"]["candidates"],
          f"{label}: the candidate order and the counted work disagree")
    steps = bnd["work"]["serial_steps_max"]
    row = dict(
        b=f.shape[0], n=f.shape[1], k_cap=k_cap, anchors=int(n_anchors.sum()),
        a_max=a_max, candidates=int(n_cand.sum()), c=z_f.shape[1],
        depth=depth, n_u_max=int(got[2].max()),
        n_v_max=int(got[4].max()), chain_overflow=int(got[5].sum()),
        ms=ms, full_sort_ms=sort_ms, order_ms=order_ms, plain_device="cpu",
        plain_rows=f.shape[0] if rows is None else len(rows),
        ns_per_serial_step=ms * 1e6 / max(steps, 1), **bnd)
    if rows is None:
        check_backtrack(torch, label, inputs, key, got, row, host, bt=bt,
                        k_cap=k_cap, p_out=p_out)
    else:
        check_backtrack(torch, f"{label} {len(rows)} rows", [t[rows] for t in inputs],
                        key[rows], [t[rows] for t in got], row, host, bt=bt,
                        k_cap=k_cap, p_out=p_out)
    return row


DEPTHS = (0, 4, 8, 16, 32)


def backtrack_depths(torch, label, inputs, *, bt, k_cap) -> dict:
    """The kernel on one input at each staging depth of DEPTHS (as far as
    its shared memory holds it): each bit-equal to chain_backtrack's
    outputs, then timed in turns (median of 5, forward and reverse order,
    twice), the launch alone (the candidate order built once, before)."""
    from rawhash_tpu_torch.chain.backtrack import (
        backtrack_launch, candidate_order, chain_backtrack, launch_depth,
    )

    f, p, n_anchors, tpos, qpos = inputs
    order = candidate_order(f, n_anchors, bt["min_sc"])
    want = chain_backtrack(*inputs, **bt, k_cap=k_cap)
    depths = {f"d{d}": launch_depth(order[3], d) for d in DEPTHS}

    def run(name):
        return backtrack_launch(f, p, tpos, qpos, order, **bt, k_cap=k_cap,
                                depth=depths[name])

    for name in depths:  # also each timing's warm-up
        check(all(torch.equal(a, c) for a, c in zip(run(name), want)),
              f"{label}: depth {name} disagrees with chain_backtrack")
    ms = {name: [] for name in depths}
    names = list(depths)
    for turn in (names, names[::-1]) * 2:
        for name in turn:
            ms[name].append(cuda_ms(torch, lambda: run(name), 5))
    med = {name: float(np.median(v)) for name, v in ms.items()}
    return dict(depths=depths, ms=ms, median_ms=med,
                fastest=min(med, key=med.get))


def phase_backtrack(torch, dev, host) -> list:
    """The backtrack kernel vs its plain version on f/p from K1, and the
    compaction of each; the staging depths on the 256 x 16384 input.  Each
    row's line is emitted once its plain version is back."""
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import clustered_anchors, options

    io, mo = options("sensitive")
    prm = fill_params(io, mo)
    bt = backtrack_params(mo, prm)
    results = []
    for b, n, k_cap in ((256, 16384, 1024), (32, 40960, 1024), (64, 4096, 4)):
        args = [torch.from_numpy(x).to(dev) for x in clustered_anchors(n, b, n)]
        key, tpos, qpos, n_anchors = args
        f, p = chain_fill(*args, **prm)
        inputs = (f, p, n_anchors, tpos, qpos)
        row = measure_backtrack(torch, f"backtrack B={b} N={n}", inputs, key, host,
                                bt=bt, k_cap=k_cap, p_out=min(4096, n), reps=7)
        if n == 16384:
            row["depths"] = backtrack_depths(
                torch, f"backtrack B={b} N={n}", inputs, bt=bt, k_cap=k_cap)
        host.later(lambda row=row: emit({"phase": "backtrack", **row}))
        results.append(row)
        if k_cap < 10:
            check(row["chain_overflow"] > 0, "backtrack: k_cap 4 lost no chain")
    return results


def held_rows(n_anchors, rows: int):
    """`rows` rows by live anchors: the widest, the narrowest and others
    evenly between them."""
    na = n_anchors.cpu().numpy()
    b = len(na)
    return np.argsort(-na, kind="stable")[np.linspace(0, b - 1, rows).astype(int)]


def phase_tail_kernels(torch, name, caught, host, *, rows=None, fill=False,
                       preset="sensitive") -> dict:
    """The kernels on the inputs a cell's main path gave them: its widest
    tail_finish call, caught there, with the cell's `preset`.  The
    backtrack (and, with `fill`, the fill) is timed at that whole shape;
    its outputs on `rows` of its rows (the widest, the narrowest and others
    evenly between them by live anchors; all rows if None), at full width,
    are held bit for bit against the plain versions on CPU copies in a host
    worker; then the backtrack at each staging depth.  The standalone
    backtrack + compaction (backtrack_compact) runs its kernel route on the
    whole call, timed beside chain_backtrack, its launches counted by
    chain_backtrack's counter, and is held whole on the same rows against
    its CPU route.  The line is emitted once the plain versions are back."""
    from rawhash_tpu_torch.chain.backtrack import chain_backtrack
    from rawhash_tpu_torch.chain.backtrack_device import backtrack_compact
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import options

    io, mo = options(preset)
    prm = fill_params(io, mo)
    bt = backtrack_params(mo, prm)
    out, k_cap, p_out = caught["out"], caught["k_cap"], caught["p_out"]
    b, n = out.f.shape
    idx = None
    na = out.n_anchors.cpu().numpy()
    res = dict(b=b, n=n, k_cap=k_cap, p_out=p_out, anchors=int(na.sum()),
               anchors_max=int(na.max()), plain_device="cpu")
    if rows is not None:
        sel = held_rows(out.n_anchors, rows)
        idx = torch.as_tensor(sel, device=out.f.device)
        res["plain_rows_anchors"] = [int(na[r]) for r in sel]

    def held(ts):
        return [(t if idx is None else t[idx]).cpu() for t in ts]

    if fill:  # K1: the main path's f/p against the plain fill
        fill_in = (out.key, out.tpos, out.qpos, out.n_anchors)
        f, p = chain_fill(*fill_in, **prm)  # also the timing's warm-up
        check(torch.equal(f, out.f) and torch.equal(p, out.p),
              f"{name}: the fill gave another f/p on the same inputs")
        res["fill"] = dict(ms=cuda_ms(torch, lambda: chain_fill(*fill_in, **prm), 5),
                           **fill_bound(*fill_in, prm))
        check_fill(torch, host, f"{name} fill", held(fill_in), *held((out.f, out.p)),
                   prm, res["fill"])

    inputs = (out.f, out.p, out.n_anchors, out.tpos, out.qpos)
    res["backtrack"] = measure_backtrack(
        torch, f"{name} backtrack", inputs, out.key, host, bt=bt, k_cap=k_cap,
        p_out=p_out, reps=5, rows=idx)
    res["backtrack"]["depths"] = backtrack_depths(
        torch, f"{name} backtrack", inputs, bt=bt, k_cap=k_cap)

    # backtrack_compact: the kernel route on the card against the CPU route
    bc_in = (out.f, out.p, out.n_anchors, out.key, out.tpos, out.qpos)
    n0 = chain_backtrack.launches
    got = held(backtrack_compact(*bc_in, **bt, k_cap=k_cap))  # also the warm-up
    check(chain_backtrack.launches == n0 + 1,
          f"{name}: backtrack_compact launched the backtrack kernel "
          f"{chain_backtrack.launches - n0} times, not once")
    bc = res["backtrack_compact"] = dict(
        ms=cuda_ms(torch, lambda: backtrack_compact(*bc_in, **bt, k_cap=k_cap), 5),
        chain_backtrack_ms=res["backtrack"]["ms"])
    bc["launches_counted_by_chain_backtrack"] = chain_backtrack.launches - n0

    def bc_then(result):
        want = tensors(result[0])
        err = max(int((a.long() - c.long()).abs().max()) for a, c in zip(want, got))
        check(all(torch.equal(a, c) for a, c in zip(want, got)),
              f"{name}: backtrack_compact's kernel route disagrees with its CPU "
              f"route (max abs err {err})")
        bc.update(max_abs_err=err, cpu_ms=result[1])

    host.submit(cpu_backtrack_compact, [t.numpy() for t in held(bc_in)], bt, k_cap,
                then=bc_then)
    host.later(lambda: emit({"phase": f"{name}_kernels", **res}))
    return res


WARPS = (4, 8, 16)


def phase_fill_warps(torch, dev, fills) -> list:
    """K1 at each of WARPS warps a read (csrc/chain_fill.cu: kWarps is the
    most, and what chain_fill launches) on the main path's own fill inputs
    `fills` ({cell: (its widest fill call's tensors, keyword arguments)})
    and on k1's clustered sensitive 256 x 16384 input.  Each warp count is
    bit-equal to chain_fill's f/p, then timed in turns."""
    import ctypes

    from rawhash_tpu_torch._build import load_library
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.profiling.bounds import fill_segments, fill_work
    from rawhash_tpu_torch.signal.events import f32
    from rawhash_tpu_torch.synthetic import clustered_anchors, options

    fn = load_library().rh_chain_fill_warps
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])

    def fill_at(warps, key, tpos, qpos, n_anchors, *, q_span, max_dist_t,
                max_dist_q, bw, max_iter, chn_pen_gap, chn_pen_skip):
        """chain_fill's launch at `warps` warps a read."""
        f, p = torch.empty_like(key), torch.empty_like(key)
        rc = fn(key.data_ptr(), tpos.data_ptr(), qpos.data_ptr(),
                n_anchors.data_ptr(), f.data_ptr(), p.data_ptr(), *key.shape,
                max_iter, q_span, max(max_dist_t, bw), max(max_dist_q, bw), bw,
                f32(chn_pen_gap), f32(chn_pen_skip), warps,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"fill_warps: launch at {warps} warps: CUDA error {rc}")
        return f, p

    inputs = dict(fills)
    inputs["k1_sensitive_16384"] = (
        [torch.from_numpy(x).to(dev) for x in clustered_anchors(16384, 256, 16384)],
        fill_params(*options("sensitive")))
    results = []
    for name, (args, prm) in inputs.items():
        check(fill_work(*args, **prm)["unsorted"] == 0,
              f"fill_warps {name}: in-band pairs past an out-of-band one")
        want = chain_fill(*args, **prm)
        for w in WARPS:  # also each timing's warm-up
            got = fill_at(w, *args, **prm)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"fill_warps {name}: {w} warps disagree with chain_fill")
        ms = {w: [] for w in WARPS}
        for order in (WARPS, WARPS[::-1]) * 2:
            for w in order:
                ms[w].append(cuda_ms(torch, lambda: fill_at(w, *args, **prm), 5))
        med = {w: float(np.median(v)) for w, v in ms.items()}
        row = dict(input=name, b=args[0].shape[0], n=args[0].shape[1],
                   w=prm["max_iter"], anchors=int(args[3].sum()),
                   segments=fill_segments(args[0], args[1], args[3], **prm),
                   ms={str(w): v for w, v in ms.items()},
                   median_ms={str(w): v for w, v in med.items()},
                   fastest=min(med, key=med.get))
        emit({"phase": "fill_warps", **row})
        results.append(row)
    return results


# the events and sketch kernels: name, source, and what each replaces in the
# JAX package (a lax.scan, or jnp.cumsum / jnp.sum in XLA's CPU order,
# inside its jitted events and sketch programs)
EVENT_KERNEL_ROWS = (
    ("events_fused", "rawhash_tpu_torch/csrc/events_fused.cu",
     "rawhash_tpu/signal/events.py:287"),
    ("gen_peaks", "rawhash_tpu_torch/csrc/events_peaks.cu", "rawhash_tpu/signal/events.py:145"),
    ("ordered_cumsum", "rawhash_tpu_torch/csrc/ordered_scan.cu",
     "rawhash_tpu/signal/events.py:319"),
    ("ordered_sum", "rawhash_tpu_torch/csrc/ordered_scan.cu",
     "rawhash_tpu/signal/events.py:307"),
    ("diff_filter", "rawhash_tpu_torch/csrc/diff_filter.cu", "rawhash_tpu/sketch/device.py:22"),
)
# the events and sketch kernels' shapes on the main path: (preset, chunk
# length, events a chunk), 256 reads; ava's chunk is a whole 3000-base read
# (28672 samples) and its events cap 16384 (map/engine.py::_caps)
EVENT_SHAPES = {"viral": ("viral", 4000, 768), "sensitive": ("sensitive", 4000, 768),
                "ava": ("ava", 28672, 16384)}


def event_kernels():
    """The events and sketch stage's single kernel wrappers by name (each
    with its `launches` counter): the events stage's op chain's (the peak
    detector and the ordered sums, which run on the card only where the op
    chain is called, detect_events_batch_plain) and the diff filter."""
    from rawhash_tpu_torch.signal import events as ev
    from rawhash_tpu_torch.sketch import device as sk

    return {"gen_peaks": ev._gen_peaks, "ordered_cumsum": ev.ordered_cumsum,
            "ordered_sum": ev.ordered_sum, "diff_filter": sk._diff_filter}


def main_path_event_kernels():
    """The kernels the engine's events and sketch stage launches, by name:
    the events stage's three (events_fused) and the diff filter."""
    from rawhash_tpu_torch.signal import events as ev
    from rawhash_tpu_torch.sketch import device as sk

    return {"events_fused": ev.events_fused, "diff_filter": sk._diff_filter}


def stage_inputs(torch, dev, b, l, seed) -> tuple:
    """(sig, slen) of one chunk of b nanopore-like reads of l samples on dev."""
    from rawhash_tpu_torch.synthetic import signal_chunk

    sig = torch.from_numpy(signal_chunk(np.random.default_rng(seed), b, l)).to(dev)
    return sig, torch.full((b,), l, dtype=torch.int32, device=dev)


def events_stage(sig, slen, preset, e_cap):
    """The events and sketch stage on one chunk, as the engine's step runs
    it; returns its outputs."""
    from rawhash_tpu_torch.map.device_step import events_and_sketch
    from rawhash_tpu_torch.signal.events import NormCarry
    from rawhash_tpu_torch.synthetic import options

    io, mo = options(preset)
    return events_and_sketch(
        sig, slen, NormCarry.zeros(sig.shape[0], sig.device),
        window_length1=mo.window_length1, window_length2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height, e_cap=e_cap, min_events=mo.min_events,
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k, fine_min=io.fine_min,
        fine_max=io.fine_max, fine_range=io.fine_range)


def stage_ops(torch, dev, l) -> tuple:
    """(torch ops dispatched, syncs) of the events and sketch stage on one
    chunk of 64 viral reads of l samples already on the card; a sync is a
    call that waits for the card (torch.cuda's sync debug mode warns on
    each)."""
    import warnings

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    sig, slen = stage_inputs(torch, dev, 64, l, l)
    events_stage(sig, slen, "viral", 768)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught, Count() as count:
            warnings.simplefilter("always")
            events_stage(sig, slen, "viral", 768)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return count.n, sum("synchroniz" in str(w.message) for w in caught)


def fused_stage_row(torch, sig, slen, preset, e_cap, stage, lat) -> dict:
    """The events stage's three kernels (events_fused) on one chunk, held
    bit for bit against the op chain's outputs `stage` (events, n_ev, the
    carry), with no sync, and timed three ways beside their bound; the op
    chain on the card (detect_events_batch_plain) timed once beside them
    (plain_ms)."""
    from rawhash_tpu_torch.profiling import bounds
    from rawhash_tpu_torch.profiling.kernel_time import call_ms, device_ms, host_ms
    from rawhash_tpu_torch.signal import events as ev
    from rawhash_tpu_torch.synthetic import options

    _, mo = options(preset)
    b, l = sig.shape
    carry = ev.NormCarry.zeros(b, sig.device)
    prm = dict(window_length1=mo.window_length1, window_length2=mo.window_length2,
               threshold1=mo.threshold1, threshold2=mo.threshold2,
               peak_height=mo.peak_height, e_cap=e_cap)
    sig16 = sig.half()  # the engine's samples (stage_inputs rounds them to f16)
    call = lambda: ev.events_fused(sig16, slen, carry, **prm)  # noqa: E731
    before = ev.events_fused.launches, ev.events_fused.wide_calls
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a sync raises
    try:
        events, n_ev, new_carry = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(ev.events_fused.launches == before[0] + 3, "event_kernels: events_fused did not "
          "launch its three kernels")
    wide = ev.events_fused.wide_calls - before[1]
    err = float((events - stage[0]).abs().max())
    for name, g, w in zip(("events", "n_ev", "sum", "sum_sq", "n"),
                          (events, n_ev, *new_carry), (stage[0], stage[1], *stage[2])):
        check(torch.equal(g, w), f"event_kernels {preset} {b}x{l}: events_fused's {name} "
              f"disagrees with the stage's op chain (events' max abs err {err})")
    _, plain_ms = timed_once(torch, lambda: ev.detect_events_batch_plain(sig16, slen, carry,
                                                                         **prm))
    n_live = int(slen.clamp(0, l).max())
    return dict(kernel="events_fused", shape=[b, l], e_cap=e_cap, wide=wide,
                max_abs_err=err, ms=device_ms(call, 10), call_ms=call_ms(call),
                host_ms=host_ms(call, 10), plain_ms=plain_ms, library_ms=None,
                **bounds.events_stage_bound(b, l, e_cap, n_live, 2, lat))


def phase_event_kernels(torch, dev) -> dict:
    """The events and sketch kernels at the main path's shapes (EVENT_SHAPES,
    256 reads of nanopore-like signal): the events stage's three kernels
    (events_fused) held against the stage's op chain on the card, bit for
    bit, and timed (fused_stage_row); each single kernel's inputs are
    caught from that op chain's events+sketch call, then each kernel is
    held against its plain version on the card on the same inputs, bit for
    bit (the peak
    detector, the diff filter and all three ordered sums of the chunk), with
    no sync in the kernel routes; each call timed three ways
    (profiling/kernel_time.py: device time, 20 launches in a CUDA graph
    replayed, the inputs warm in the L2 cache; call time, one call on an
    idle card; host time, the wrapper's host path), the plain version once;
    the ordered sums beside the PyTorch calls that give the same outputs
    (torch.cumsum, torch.sum of x and of x * x, the leading zero padded),
    and also as the single function (x alone, no leading zero), held
    against its plain version, beside the one PyTorch call for it; each
    beside its bound (the serial scans' critical
    paths at the latencies the card measures here); and the stage's torch
    ops at L = 4000 and 8000, which must be equal, with no sync in the
    stage at either."""
    from rawhash_tpu_torch.profiling import bounds
    from rawhash_tpu_torch.profiling.fill_loop_overhead import measure_latencies
    from rawhash_tpu_torch.profiling.kernel_time import call_ms, device_ms, host_ms
    from rawhash_tpu_torch.signal import events as ev
    from rawhash_tpu_torch.sketch import device as sk

    lat = measure_latencies()
    check(lat["viaddmnmx"] > 0 and lat["fsetp_plop3_sel"] > 0,
          f"event_kernels: the latency did not measure: {lat}")
    plain = {"gen_peaks": ev._gen_peaks_plain, "ordered_cumsum": ev.ordered_cumsum_plain,
             "ordered_sum": ev.ordered_sum_plain, "diff_filter": sk._diff_filter_plain}
    pad = torch.nn.functional.pad
    library = {"ordered_cumsum": lambda x: torch.cumsum(x, dim=1),
               "ordered_sum": lambda x: torch.sum(x, dim=1)}
    # the PyTorch calls that give a call's outputs (a value and its square,
    # the prefix sum's leading zero)
    library_out = {
        "ordered_cumsum": lambda x, squares=False, lead_zero=False: tuple(
            pad(torch.cumsum(v, dim=1), (int(lead_zero), 0))
            for v in ((x, x * x) if squares else (x,))),
        "ordered_sum": lambda x, squares=False: tuple(
            torch.sum(v, dim=1) for v in ((x, x * x) if squares else (x,)))}
    out = {"latencies": lat, "shapes": {}}
    counted = {**event_kernels(), **main_path_event_kernels()}
    launches0 = {name: fn.launches for name, fn in counted.items()}
    for shape, (preset, l, e_cap) in EVENT_SHAPES.items():
        b = 256
        calls = []
        wrappers = event_kernels()
        names = {fn.__name__: name for name, fn in wrappers.items()}
        originals = {(sys.modules[fn.__module__], fn.__name__): spy(
            sys.modules[fn.__module__], fn.__name__,
            lambda attr, _, a, k: calls.append((names[attr], a, k)))
            for fn in wrappers.values()}
        sig, slen = stage_inputs(torch, dev, b, l, 3)
        # the stage's op chain on the card (the kernels' inputs caught from
        # it), then the stage as its three kernels, which equal it bit for bit
        takes_kernels = ev.takes_kernels
        ev.takes_kernels = lambda sig: False
        try:
            stage = events_stage(sig, slen, preset, e_cap)
        finally:
            ev.takes_kernels = takes_kernels
            put_back(originals)
        n_ev = stage[1]
        rows = [fused_stage_row(torch, sig, slen, preset, e_cap, stage, lat)]
        for name, a, k in calls:
            fn = wrappers[name]
            before = fn.launches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")  # a sync raises
            try:
                got = fn(*a, **k)
            except RuntimeError as e:
                raise Failed(f"event_kernels {shape}: {name}'s kernel route: {e}") from e
            finally:
                torch.cuda.set_sync_debug_mode("default")
            check(fn.launches == before + 1, f"event_kernels {shape}: {name} did not "
                  "launch its kernel")
            want, plain_ms = timed_once(torch, lambda: plain[name](*a, **k))
            err = 0
            for g, w in zip(*((v if isinstance(v, tuple) else (v,)) for v in (got, want))):
                if g.dtype == torch.bool:
                    err = max(err, int((g != w).sum()))
                elif g.dtype == torch.int32:
                    err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
                else:
                    err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
                check(torch.equal(g, w), f"event_kernels {shape}: {name} {k} disagrees "
                      f"with its plain version (max abs err {err})")
            call = lambda: fn(*a, **k)  # noqa: E731
            n = 10 if name == "gen_peaks" else 20
            row = dict(kernel=name, shape=list(a[0].shape), options=k, max_abs_err=err,
                       ms=device_ms(call, n), call_ms=call_ms(call), host_ms=host_ms(call, n),
                       plain_ms=plain_ms, library_ms=None)
            if name in library:
                # the single function too (x alone, no leading zero), held
                # against its plain version before it is timed, beside the
                # one PyTorch call that computes it
                x = a[0]
                kind = name.split("_")[1]
                one, one_want = fn(x), plain[name](x)
                one_err = float((one - one_want).abs().max())
                check(torch.equal(one, one_want), f"event_kernels {shape}: {name} of x "
                      f"alone disagrees with its plain version (max abs err {one_err})")
                row.update(
                    library_ms=device_ms(lambda: library_out[name](x, **k)),
                    library_call_ms=call_ms(lambda: library_out[name](x, **k)),
                    single=dict(max_abs_err=one_err, ms=device_ms(lambda: fn(x)),
                                call_ms=call_ms(lambda: fn(x)),
                                bound_ms=bounds.scan_bound(*x.shape, kind)["bound_ms"],
                                library_ms=device_ms(lambda: library[name](x)),
                                library_call_ms=call_ms(lambda: library[name](x))),
                    **bounds.scan_bound(*x.shape, kind, squares=k.get("squares", False),
                                        lead_zero=k.get("lead_zero", False)))
            elif name == "gen_peaks":
                n_live = int(a[2].clamp(0, l).max())
                row.update(n_live=n_live, **bounds.peaks_bound(b, l, n_live, lat))
            else:
                n_live = int(a[1].clamp(0, a[0].shape[1]).max())
                row.update(n_live=n_live, **bounds.diff_filter_bound(b, a[0].shape[1],
                                                                      n_live, lat))
            rows.append(row)
        check(sorted(r["kernel"] for r in rows) == sorted(
            ["events_fused", "gen_peaks", "diff_filter"] + ["ordered_cumsum"] * 2
            + ["ordered_sum"]),
            f"event_kernels {shape}: unexpected calls {[r['kernel'] for r in rows]}")
        line = dict(shape=shape, preset=preset, b=b, l=l, e_cap=e_cap,
                    mean_events=float(n_ev.float().mean()), calls=rows,
                    l2="warm: the same inputs every launch (at 4000 a call's inputs "
                       "and outputs fit the 50 MB L2 cache; ava's prefix sums, "
                       "88 MB, do not)")
        emit({"phase": "event_kernels", **line})
        out["shapes"][shape] = line
    (ops4, syncs4), (ops8, syncs8) = (stage_ops(torch, dev, l) for l in (4000, 8000))
    out["stage_ops"] = {"4000": ops4, "8000": ops8, "syncs_4000": syncs4,
                        "syncs_8000": syncs8}
    emit({"phase": "event_stage_ops", **out["stage_ops"]})
    # the kernels' launches in this phase (the single ones of the op chain
    # launch nowhere else)
    out["launches"] = {name: fn.launches - launches0[name] for name, fn in counted.items()}
    check(ops4 == ops8, f"event_kernels: the events and sketch stage dispatched {ops4} "
          f"torch ops at L = 4000 and {ops8} at L = 8000")
    check(syncs4 == syncs8 == 0, f"event_kernels: the events and sketch stage waited "
          f"for the card {syncs4} times at L = 4000, {syncs8} at L = 8000")
    return out


def phase_k4(torch, dev) -> dict:
    """The fill-loop probe (K4): the card's latencies, kernel vs plain probe
    on both ring forms at fixed and runtime k_ops, the closed form, the
    probe's entry point with its launch counter, us per iteration beside
    both bounds, and the SASS check of every kernel instance."""
    from rawhash_tpu_torch.profiling import fill_loop_overhead as flo

    lat = flo.measure_latencies()
    check(all(v > 0 for v in lat.values()), f"k4: a latency did not measure: {lat}")
    n_check, n_full = 1000, 100_000
    rng = np.random.default_rng(5)
    checks = []
    # registers up to W = 256 (SPL 1, 2, 7, 8), shared memory past it;
    # k_ops 7 takes the runtime-k_ops instances
    for w in (1, 33, 64, 200, 256, 257, 4096):
        for k_ops in (2, 7, 20, 60):
            x = torch.from_numpy(
                rng.integers(-2**20, 2**20, (w, flo.B)).astype(np.int32)).to(dev)
            got = flo.fill_loop_probe(x, n_check, k_ops)  # also the warm-up
            want, plain_ms = timed_once(
                torch, lambda: flo.fill_loop_probe_plain(x, n_check, k_ops))
            err = int((got.long() - want.long()).abs().max())
            check(torch.equal(got, want), f"k4 {w}x{flo.B} k_ops={k_ops}: kernel "
                  f"disagrees with the plain probe (max abs err {err})")
            ms = cuda_ms(torch, lambda: flo.fill_loop_probe(x, n_check, k_ops), 7)
            checks.append(dict(w=w, b=flo.B, n_iter=n_check, k_ops=k_ops,
                               max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               **flo.probe_bound(n_check, k_ops, w, lat=lat)))
    for k_ops in flo.K_OPS:
        x = torch.full((flo.W, flo.B), flo.INT32_MIN, dtype=torch.int32, device=dev)
        got = flo.fill_loop_probe(x, n_full, k_ops)
        check(bool((got == flo.INT32_MIN + k_ops * n_full).all()),
              f"k4 k_ops={k_ops}: the kernel's ring after {n_full} iterations "
              "is not INT32_MIN + k_ops * n_iter")

    # the probe's entry point, as a user runs it
    flo.fill_loop_probe.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = flo.main([str(n_full)])
    launches = flo.fill_loop_probe.launches
    lines = buf.getvalue().splitlines()
    check(rc == 0 and launches > 0,
          f"k4: the probe's entry point failed ({rc}) or launched nothing")
    per_iter = []
    for line in lines:
        m = re.match(r"k_ops=(\d+): (\S+) us/iter \((\S+) s total\)", line)
        if m:
            k_ops = int(m.group(1))
            per_iter.append(dict(w=flo.W, b=flo.B, n_iter=n_full, k_ops=k_ops,
                                 us_per_iter=float(m.group(2)),
                                 ms=float(m.group(3)) * 1e3,
                                 **flo.probe_bound(n_full, k_ops, lat=lat)))
    check(len(per_iter) == len(flo.K_OPS), f"k4: unexpected output {lines}")
    per_iter += [flo.time_probe(n_full, k_ops, w=200, lat=lat) for k_ops in flo.K_OPS]

    # every instance: one REDUX an iteration (nvcc may unroll the iteration
    # loop: a REDUX per copy), and the chain unfolded (at least k_ops x SPL
    # maxes a REDUX, more as k_ops grows); the register form without local
    # memory or shuffles
    sass = flo.sass_counts()
    regs = {k: v for k, v in sass.items() if k.startswith("regs<")}
    smem = {k: v for k, v in sass.items() if k.startswith("smem<")}
    check(len(regs) == 8 * (len(flo.K_OPS) + 1) and len(smem) == len(flo.K_OPS) + 1,
          f"k4: unexpected kernel instances {sorted(sass)}")
    check(all(v["redux"] >= 1 for v in (*regs.values(), *smem.values())),
          f"k4: an instance lacks REDUX: {sass}")
    for spl in (*range(1, 9), 0):
        names = [f"regs<{spl},{k}>" if spl else f"smem<{k}>" for k in flo.K_OPS]
        per = [sass[n]["max"] / sass[n]["redux"] for n in names]
        check(per == sorted(set(per))
              and all(c >= k * max(spl, 1) for c, k in zip(per, flo.K_OPS)),
              f"k4: the chain is folded: maxes a REDUX {dict(zip(names, per))}")
    check(all(v["local"] == 0 and v["shfl"] == 0 for v in regs.values()),
          f"k4: the register form uses local memory or shuffles: {regs}")
    check(sass["lat_chain"]["max"] >= flo.LAT_K
          and sass["lat_redux"]["redux"] >= flo.LAT_REDUX
          and sass["lat_fsel<maj>"]["plop3"] >= flo.LAT_SEL
          and sass["lat_fsel<xor>"]["plop3"] == 0
          and min(sass[f"lat_fsel<{k}>"]["fsetp"] for k in ("maj", "xor")) >= 3 * flo.LAT_SEL,
          f"k4: the latency kernels are folded: {sass}")
    out = dict(latencies=lat, checks=checks, per_iter=per_iter,
               entry_point_output=lines, launches=launches, sass=sass)
    emit({"phase": "k4", **out})
    return out


def phase_fixture(d: Path, host) -> dict:
    """The CLI on the fixture, each preset: --device cuda against --device
    cpu (the cpu run in a host worker, beside the cuda runs, held against
    them when it is back), the forced device tail, and two reads a batch
    (three batches) at the default --pipeline-depth, 3, against the
    one-batch run; then the other modes (fixture_modes).  Depth 1 over
    several batches is the pipeline phase's, on D1 and D2."""
    from rawhash_tpu_torch.cli import main as cli
    from rawhash_tpu_torch.synthetic import write_fixture

    write_fixture(d)
    out = {}
    for preset in ("sensitive", "viral"):
        idx = d / f"ref_{preset}.rhi.npz"
        rc = cli(["-x", preset, "-p", str(d / "pore.model"), "-d", str(idx),
                  str(d / "ref.fa"), "--device", "cuda"])
        check(rc == 0, f"fixture index build failed ({rc})")

        def args(run, device, more=(), preset=preset, idx=idx):
            return ["-x", preset, "--max-anchors", "512", str(idx),
                    str(d / "reads.sig.npz"), "--device", device,
                    "-o", str(d / f"{preset}_{run}.paf"), *more]

        def paf(run, preset=preset):
            return [l.split("\t") for l in (d / f"{preset}_{run}.paf").read_text().splitlines()]

        pafs = {}
        # (run, more arguments): the last maps two reads a batch (three
        # batches in flight at the default --pipeline-depth, 3)
        for run, more in (("cuda", []), ("cuda_tail", []),
                          ("cuda_depth3", ["--batch-reads", "2"])):
            if run == "cuda_tail":
                os.environ["RAWHASH_TPU_DEVICE_TAIL"] = "1"
            t0 = time.perf_counter()
            try:
                rc = cli(args(run, "cuda", more))
            finally:
                os.environ.pop("RAWHASH_TPU_DEVICE_TAIL", None)
            check(rc == 0, f"fixture mapping ({run}) failed ({rc})")
            pafs[run] = (paf(run), time.perf_counter() - t0)
        rows = {run: {c[0]: c for c in cols if c[4] in "+-"}
                for run, (cols, _) in pafs.items()}
        tail_same = ({n: r[:12] for n, r in rows["cuda_tail"].items()}
                     == {n: r[:12] for n, r in rows["cuda"].items()})
        cols = {run: [c[:12] for c in pafs[run][0]] for run in pafs}
        depths_same = cols["cuda_depth3"] == cols["cuda"]
        line = {"phase": "fixture", "preset": preset,
                "mapped_cuda": len(rows["cuda"]),
                "mapped_cuda_device_tail": len(rows["cuda_tail"]),
                "device_tail_equals_host_tail": tail_same,
                "three_batches_depth3_equal_one_batch": depths_same,
                "seconds_cuda": pafs["cuda"][1],
                "seconds_cuda_device_tail": pafs["cuda_tail"][1],
                "seconds_cuda_depth3": pafs["cuda_depth3"][1]}
        check(tail_same, f"fixture {preset}: the device tail's PAF columns 1-12 "
              "differ from the host tail's on cuda")
        check(depths_same, f"fixture {preset}: PAF columns 1-12 of three batches at "
              "--pipeline-depth 3 differ from the one-batch run's")

        def then(result, preset=preset, on_cuda=rows["cuda"], line=line, paf=paf):
            rc, seconds = result
            check(rc == 0, f"fixture {preset}: mapping on cpu failed ({rc})")
            on_cpu = {c[0]: c for c in paf("cpu") if c[4] in "+-"}
            diffs = []
            for name in sorted(set(on_cuda) | set(on_cpu)):
                a, c = on_cuda.get(name), on_cpu.get(name)
                if a is None or c is None or a[:12] != c[:12]:
                    diffs.append({"read": name, "cuda": a and a[:12], "cpu": c and c[:12]})
            emit({**line, "mapped_cpu": len(on_cpu), "seconds_cpu": seconds,
                  "differences": diffs})
            check(set(on_cuda) == set(on_cpu), f"fixture {preset}: mapped sets differ")
            for name, a in on_cuda.items():
                c = on_cpu[name]
                check(a[0] == c[0] and a[4] == c[4] and a[5] == c[5],
                      f"fixture {preset}: PAF columns 1/5/6 differ for {name}")
                check(abs(int(a[7]) - int(c[7])) <= 20,
                      f"fixture {preset}: PAF column 8 differs by > 20 for {name}")

        host.submit(cli_run, args("cpu", "cpu"), then=then)
        out[preset] = len(rows["cuda"])
    out.update(fixture_modes(d, cli, host))
    return out


def fixture_modes(d: Path, cli, host) -> dict:
    """The other modes on small fixtures through the CLI, --device cuda
    against --device cpu (in a host worker, held against the cuda runs
    when it is back): all-vs-all (the same overlap pairs), --out-quantize
    (the same bytes), --sequence-until (the same stopping read)."""
    from rawhash_tpu_torch.io.sigfile import write_sig_npz
    from rawhash_tpu_torch.synthetic import ava_fixture_reads

    write_sig_npz(str(d / "ava_reads.sig.npz"), ava_fixture_reads())
    ava_idx = str(d / "ava.rhi.npz")
    check(cli(["-x", "ava-viral", "--sig-target", "-d", ava_idx,
               str(d / "ava_reads.sig.npz"), "--device", "cuda"]) == 0,
          "fixture: the all-vs-all index build failed")
    runs = {
        "ava": ["-x", "ava-viral", "--max-anchors", "512", ava_idx,
                str(d / "ava_reads.sig.npz")],
        "out_quantize": ["-x", "sensitive", "--out-quantize", str(d / "reads.sig.npz")],
        "sequence_until": ["-x", "sequence-until", "--sequence-until",
                           "--min-reads", "1", "--test-frequency", "1",
                           "--n-samples", "2", "--batch-reads", "2",
                           "--max-anchors", "512", str(d / "ref_sensitive.rhi.npz"),
                           str(d / "reads.sig.npz")],
    }

    def args(mode, device):
        return runs[mode] + ["--device", device, "-o", str(d / f"{mode}_{device}.out")]

    def outputs(device):
        got = {m: (d / f"{m}_{device}.out").read_bytes() for m in runs}
        pairs = sorted({(c[0], c[5]) for c in (l.split("\t") for l in
                        got["ava"].decode().splitlines()) if c[5] != "*"})
        stops = [l.split("\t")[0] for l in got["sequence_until"].decode().splitlines()]
        return pairs, got["out_quantize"], stops

    seconds = {}
    for mode in runs:
        t0 = time.perf_counter()
        check(cli(args(mode, "cuda")) == 0, f"fixture {mode} on cuda failed")
        seconds[f"seconds_{mode}_cuda"] = time.perf_counter() - t0
    pairs, quantized, stops = outputs("cuda")
    check(len(pairs) >= 2, "fixture: all-vs-all found < 2 overlap pairs on cuda")
    check(0 < len(stops) < 6, "fixture: --sequence-until did not stop early on cuda")
    on_cpu = {mode: host.submit(cli_run, args(mode, "cpu")) for mode in runs}

    def held():
        for mode, fut in on_cpu.items():
            rc, seconds[f"seconds_{mode}_cpu"] = fut.result()
            check(rc == 0, f"fixture {mode} on cpu failed")
        pairs_cpu, quantized_cpu, stops_cpu = outputs("cpu")
        emit({"phase": "fixture_modes", "ava_pairs_cuda": pairs, "ava_pairs_cpu": pairs_cpu,
              "out_quantize_bytes": len(quantized),
              "out_quantize_same": quantized == quantized_cpu,
              "sequence_until_reads_cuda": len(stops),
              "sequence_until_reads_cpu": len(stops_cpu), **seconds})
        check(pairs == pairs_cpu, "fixture: all-vs-all overlap pairs differ between "
              "cuda and cpu")
        check(quantized == quantized_cpu, "fixture: --out-quantize output differs")
        check(stops == stops_cpu, "fixture: --sequence-until stopped at another read")

    host.later(held)
    return {"ava_pairs": len(pairs), "sequence_until_reads": len(stops)}


def catch_widest(caught, also=None):
    """Spies on device_step.chain_fill and engine.tail_finish that keep a
    run's widest fill call (copies of its tensors, its keyword arguments) in
    caught["fill"] and its widest device-tail call (its ChunkOut `out`,
    `k_cap` and `p_out`) in caught["tail"]; `also(fill arguments)` sees
    every fill call.  caught["streams"] gathers the CUDA streams K1 (the
    fill) and K2 (the backtrack, launched inside tail_finish) were called
    on.  Returns the originals, which the caller puts back."""
    import torch

    from rawhash_tpu_torch.map import device_step
    from rawhash_tpu_torch.map import engine as eng_mod

    streams = caught.setdefault("streams", {"chain_fill": set(),
                                            "chain_backtrack": set()})

    def widest_fill(_, fn, a, k):
        streams["chain_fill"].add(torch.cuda.current_stream(a[0].device).cuda_stream)
        if also is not None:
            also(a)
        if "fill" not in caught or a[0].shape[1] >= caught["fill"][0][0].shape[1]:
            caught["fill"] = ([for_default_stream(t.clone()) for t in a], dict(k))

    def widest_tail(_, fn, a, k):
        out = a[0]
        streams["chain_backtrack"].add(torch.cuda.current_stream(out.f.device).cuda_stream)
        if "tail" not in caught or out.f.shape[1] >= caught["tail"]["out"].f.shape[1]:
            caught["tail"] = dict(out=for_default_stream(out), k_cap=k["k_cap"],
                                  p_out=k["p_out"])

    return {(device_step, "chain_fill"): spy(device_step, "chain_fill", widest_fill),
            (eng_mod, "tail_finish"): spy(eng_mod, "tail_finish", widest_tail)}


def put_back(originals) -> None:
    for (mod, attr), fn in originals.items():
        setattr(mod, attr, fn)


def phase_deployment(torch, dev, name, genome_len, preset, n_batches,
                     read_len, max_anchors, seed, caught, store_sig=False,
                     configure=None, keep=None) -> dict:
    """Build the index and map n_batches x 256 simulated reads on the card
    through the engine's streaming entry point.  The run's widest fill and
    device-tail calls are kept in `caught` (catch_widest).  `store_sig` keeps the expected
    signal in the index (for DTW); `configure(mopt)` sets the run's mode;
    `keep` receives the index, the options, the first batch (with its
    truth), every batch, the run's records and its row for later phases."""
    from rawhash_tpu_torch.chain.backtrack import chain_backtrack
    from rawhash_tpu_torch.map import engine as eng_mod
    from rawhash_tpu_torch.synthetic import deployment

    t0 = time.perf_counter()
    setup = {}
    index, mopt, reads = deployment(genome_len, preset, n_batches * 256,
                                    read_len, max_anchors, seed, seconds=setup,
                                    store_sig=store_sig)
    if configure is not None:
        configure(mopt)
    t_setup = time.perf_counter() - t0
    batches = [[(n, s) for n, s, _, _ in reads[i:i + 256]]
               for i in range(0, len(reads), 256)]
    if keep is not None:
        keep.update(index=index, mopt=copy.deepcopy(mopt), reads=reads[:256],
                    read_len=read_len, all_reads=reads, batches=batches)
    engine = eng_mod.MappingEngine(index, mopt, device=dev, trace=True)
    originals = catch_widest(caught)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = [r for batch in engine.map_stream(batches) for r in batch]
    finally:
        put_back(originals)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    n_mapped, n_correct, bases = score_mapping(reads, results, mopt, read_len)
    row = dict(
        reads=len(reads), mapped=n_mapped,
        mapped_frac=n_mapped / len(reads),
        accuracy=n_correct / max(n_mapped, 1),
        seconds=dt, bp_per_s=bases / dt, reads_per_s=len(reads) / dt,
        setup_s=t_setup, genome_s=setup["genome"], index_build_s=setup["index"],
        reads_s=setup["reads"], index_seeds=index.n_seeds,
        index_bytes_on_card=engine.didx.nbytes(),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        device_tail=engine.device_tail,
        tail_switch_anchors=engine.tail_switch_anchors,
        device_tail_chunks=engine.stats["tail_chunks"],
        backtrack_max_width=chain_backtrack.max_width,
        stage_seconds=dict(engine.profiler.totals),
        stage_counts=dict(engine.profiler.counts),
        anchor_regrows=engine.stats["anchor_regrows"],
        hit_overflow=engine.stats["hit_overflow"],
        prev_overflow=engine.stats["prev_overflow"],
        chain_overflow=engine.stats["chain_overflow"],
        pipeline_depth=engine.pipeline_depth,
        streams={k: len(v) for k, v in caught["streams"].items()},
    )
    if keep is not None:
        keep.update(records=records_of(results), row=row)
    emit({"phase": name, "preset": preset, "genome_len": genome_len, **row})
    check(row["mapped_frac"] >= 0.95, f"{name}: mapped {n_mapped}/{len(reads)}")
    check(row["accuracy"] >= 0.95, f"{name}: accuracy {row['accuracy']:.3f}")
    return row


def score_mapping(reads, results, mopt, read_len) -> tuple:
    """(mapped reads, of them right, bases of signal consumed) of simulated
    reads (name, signal, true start, strand): right is the true strand and
    a target interval inside the true one +/- 200; bases count each read's
    chunks (ci) of chunk_size samples."""
    n_mapped = n_correct = 0
    bases = 0.0
    for (_, _, start, strand), res in zip(reads, results):
        rec = res.records[0]
        ci = int(next(t[5:] for t in rec.tags.split("\t") if t.startswith("ci:i:")))
        bases += ci * mopt.chunk_size / mopt.sample_per_base
        if rec.mapped:
            n_mapped += 1
            lo, hi = rec.frag_start, rec.frag_start + rec.frag_len
            n_correct += (rec.rev == strand and lo >= start - 200
                          and hi <= start + read_len + 200)
    return n_mapped, n_correct, bases


# the ava cell: 512 reads of 3000 bases cover a 250 kb genome about 6x,
# the least depth a de-novo assembly uses
AVA = dict(n_reads=512, genome_len=250_000, read_len=3000, seed=23)


def ava_workload():
    """(reads, truth pairs, truth pairs >= min_ov, index, seconds of each)
    of the AVA cell: the reads and the index built from their signals (set
    up in a host worker, beside the card's earlier phases)."""
    from rawhash_tpu_torch.index.build import build_index_from_signals
    from rawhash_tpu_torch.synthetic import options, overlap_workload

    t0 = time.perf_counter()
    reads, truth_any, truth_sub = overlap_workload(**AVA)
    t_reads = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_index_from_signals(reads, None, options("ava")[0])
    return reads, truth_any, truth_sub, index, t_reads, time.perf_counter() - t0


def phase_ava(torch, dev, caught, workload) -> dict:
    """All-vs-all overlapping at full width: the `ava` preset on the AVA
    reads, the index built from their signals (`workload`, from
    ava_workload), mapped 256 reads at a time on the engine's own tail
    choice.  The run's widest fill and device-tail calls are kept in
    `caught` (catch_widest), and (index, options, the first 64 reads, their
    PAF columns 1-12) in caught["rerun"] for phase_ava_tails."""
    from rawhash_tpu_torch.chain.backtrack import chain_backtrack
    from rawhash_tpu_torch.io.paf import paf_lines
    from rawhash_tpu_torch.map.engine import MappingEngine
    from rawhash_tpu_torch.synthetic import options, overlap_quality

    reads, truth_any, truth_sub, index, t_reads, t_index = workload
    _, mo = options("ava")
    mo.batch_reads = 256
    check(index.sig_target and index.n_seq == len(reads), "ava: not a signal-target index")
    engine = MappingEngine(index, mo, device=dev, trace=True)
    fills = []  # each fill call's live anchors a read
    originals = catch_widest(caught, lambda a: fills.append(a[3].cpu().numpy()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        batches = [reads[i:i + 256] for i in range(0, len(reads), 256)]
        results = [r for batch in engine.map_stream(batches) for r in batch]
    finally:
        put_back(originals)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    caught["rerun"] = (index, mo, reads[:64], [
        line.split("\t")[:12] for res in results[:64] for line in paf_lines(res, index)])

    pred, ranked_wrong, n_records = set(), [], 0
    for res in results:
        for rec in res.records:
            if rec.mapped:
                n_records += 1
                target = index.seq_names[rec.ref_id]
                if res.name >= target:
                    ranked_wrong.append((res.name, target))
                pred.add((min(res.name, target), max(res.name, target)))
    precision, recall = overlap_quality(pred, truth_any, truth_sub)
    live = np.concatenate(fills)
    live = live[live > 0]
    bases = sum(s.shape[0] for _, s in reads) / mo.sample_per_base
    row = dict(
        **AVA, coverage=AVA["n_reads"] * AVA["read_len"] / AVA["genome_len"],
        seconds=dt, reads_per_s=len(reads) / dt, bp_per_s=bases / dt,
        reads_s=t_reads, index_build_s=t_index, index_seeds=index.n_seeds,
        anchors_per_read_min=int(live.min()), anchors_per_read_max=int(live.max()),
        fill_calls=len(fills), backtrack_max_width=chain_backtrack.max_width,
        device_tail=engine.device_tail, tail_switch_anchors=engine.tail_switch_anchors,
        device_tail_chunks=engine.stats["tail_chunks"],
        stage_seconds=dict(engine.profiler.totals),
        stage_counts=dict(engine.profiler.counts),
        anchor_regrows=engine.stats["anchor_regrows"],
        hit_overflow=engine.stats["hit_overflow"],
        chain_overflow=engine.stats["chain_overflow"],
        mapped_records=n_records, predicted_pairs=len(pred),
        true_pairs_any=len(truth_any), true_pairs_min_ov=len(truth_sub),
        precision=precision, recall=recall,
        query_ranked_at_or_after_target=ranked_wrong[:10],
    )
    emit({"phase": "ava", **row})
    check(engine.device_tail and engine.stats["tail_chunks"] > 0,
          "ava: the engine did not switch to the device tail")
    check(not ranked_wrong, f"ava: {len(ranked_wrong)} records with the query "
          "name at or after the target's")
    check(len(pred) > 0, "ava: no overlap found")
    return row


def phase_ava_tails(torch, dev, rerun) -> dict:
    """The ava cell's first 64 reads again on the forced host tail
    (RAWHASH_TPU_NO_DEVICE_TAIL=1), through map_batch: their PAF columns
    1-12 must equal the ava run's for them, which took the device tail."""
    from rawhash_tpu_torch.io.paf import paf_lines
    from rawhash_tpu_torch.map.engine import MappingEngine

    index, mo, reads, device_tail = rerun
    os.environ["RAWHASH_TPU_NO_DEVICE_TAIL"] = "1"
    try:
        eng = MappingEngine(index, mo, device=dev)
        host_tail = [line.split("\t")[:12] for res in eng.map_batch(reads)
                     for line in paf_lines(res, index)]
    finally:
        os.environ.pop("RAWHASH_TPU_NO_DEVICE_TAIL")
    row = dict(reads=len(reads), records=len(host_tail),
               device_tail=eng.device_tail, paf_equal=host_tail == device_tail)
    emit({"phase": "ava_tails", **row})
    check(not eng.device_tail, "ava_tails: the forced host tail took the device tail")
    check(row["paf_equal"], "ava: the host tail's and the device tail's PAF "
          "columns 1-12 differ on the first 64 reads")
    return row


def phase_ava_quality(torch, dev) -> dict:
    """bench.py's all-vs-all workload unchanged: 120 reads of 1500 bases
    from a 60 kb genome (seed 23), `-x ava-viral`, --max-anchors 2048; the
    overlap pairs' precision and recall.  bench.py maps 64 reads at a time;
    here one batch of 120 does, one event-detection pass instead of two
    (a read's records do not depend on its batch)."""
    from rawhash_tpu_torch.index.build import build_index_from_signals
    from rawhash_tpu_torch.map.engine import MappingEngine
    from rawhash_tpu_torch.synthetic import options, overlap_quality, overlap_workload

    reads, truth_any, truth_sub = overlap_workload(120, 60_000, 1500, 23)
    io, mo = options("ava-viral")
    mo.max_anchors_per_read = 2048
    index = build_index_from_signals(reads, None, io)
    engine = MappingEngine(index, mo, device=dev)
    t0 = time.perf_counter()
    pred = set()
    for res in engine.map_batch(reads):
        for rec in res.records:
            if rec.mapped:
                a, b = res.name, index.seq_names[rec.ref_id]
                pred.add((min(a, b), max(a, b)))
    torch.cuda.synchronize()
    precision, recall = overlap_quality(pred, truth_any, truth_sub)
    row = dict(reads=len(reads), seconds=time.perf_counter() - t0,
               predicted_pairs=len(pred), true_pairs_min_ov=len(truth_sub),
               precision=precision, recall=recall,
               device_tail_chunks=engine.stats["tail_chunks"])
    emit({"phase": "ava_quality", **row})
    check(precision >= 0.12 and recall >= 0.65,
          f"ava_quality: precision {precision} (>= 0.12) or recall {recall} "
          "(>= 0.65) too low")
    return row


def phase_dtw(torch, dev, lat) -> dict:
    """D1's genome indexed with --store-sig and mapped with
    --dtw-evaluate-chains (1 x 256 reads), the banded DTW on its kernel:
    every dtw_banded_batch_host call timed on the host clock (the whole
    call: pack, one H2D, launch, D2H) and every kernel call
    (dtw_banded_ragged) with CUDA events.  On the widest call: the kernel's
    costs held bit for bit against the plain version on the same pairs
    padded to the longest, on the card; the kernel timed three ways
    (profiling/kernel_time.py: device time by a CUDA graph of 5 launches,
    call time, host time) beside the plain version's one call and its bound
    (profiling/bounds.py::dtw_bound, the pairs' own columns, the longest
    pair's chain at the card's latencies `lat`); the host wrapper's whole
    call and its packing timed (median of 5), the bytes it copied to the
    card, the column histogram, T and the pairs on each path; then the
    kernel again with every pair on a thread, bit for bit."""
    from rawhash_tpu_torch.config import MapFlag
    from rawhash_tpu_torch.dtw import device as dtw_device
    from rawhash_tpu_torch.profiling import bounds
    from rawhash_tpu_torch.profiling.kernel_time import call_ms, device_ms, host_ms

    counter = dtw_device.dtw_banded_batch  # the kernel's launches, both entries
    ragged, host_fn = dtw_device.dtw_banded_ragged, dtw_device.dtw_banded_batch_host
    calls, host_calls = [], []

    def timed(*a, **k):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = ragged(*a, **k)
        e.record()
        calls.append((s, e, a, k, out))
        return out

    def timed_host(pairs, radii, device="cuda"):
        t0 = time.perf_counter()
        out = host_fn(pairs, radii, device)
        host_calls.append((time.perf_counter() - t0, pairs, radii))
        return out

    def dtw_mode(mo):
        mo.flag |= MapFlag.DTW_EVALUATE_CHAINS

    dtw_device.dtw_banded_ragged = timed
    dtw_device.dtw_banded_batch_host = timed_host
    try:
        row = phase_deployment(torch, dev, "dtw", 30_000, "viral", 1, 1200, 3072, 7,
                               {}, store_sig=True, configure=dtw_mode)
    finally:
        dtw_device.dtw_banded_ragged = ragged
        dtw_device.dtw_banded_batch_host = host_fn
    check(calls and len(calls) == len(host_calls),
          f"dtw: {len(host_calls)} host wrapper calls, {len(calls)} kernel calls")
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e, *_ in calls]

    def work(c):
        return int(c[2][2].sum()) * c[3]["max_radius"]  # columns x radius

    widest = max(range(len(calls)), key=lambda i: work(calls[i]))
    _, _, a, k, got = calls[widest]
    _, pairs, radii = host_calls[widest]
    # the launches below compare and time the kernel: the main path's count
    # is the run's
    counted = counter.launches
    values, a_off, a_len, b_off, b_len, radius, order = a
    longest = int(a_len.max())
    r = k["max_radius"]
    width = 2 * r + 1
    pad = dtw_device._pad_rows
    plain_in = (pad(values, a_off, a_len, longest), a_len,
                pad(values, b_off, b_len, longest), b_len, radius)
    want, plain_ms = timed_once(
        torch, lambda: dtw_device.dtw_banded_batch_plain(*plain_in, max_radius=r))
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"dtw: the kernel's costs differ from the plain "
          f"version's on the widest call (max abs err {err})")
    n_pairs = a_len.shape[0]
    cols = a_len.cpu().numpy()
    columns, n_values = int(cols.sum()), int(values.shape[0])
    threshold = dtw_device.WARP_COLUMNS
    on_warps = min(k["long_pairs"], int((cols >= threshold).sum()))
    call = lambda: ragged(*a, **k)  # noqa: E731
    whole = lambda: host_fn(pairs, radii, "cuda")  # noqa: E731
    whole()
    whole_ms, pack_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole()
        whole_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        dtw_device.pack_pairs(pairs, radii)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
    out = dict(calls=len(calls), total_ms=float(sum(ms)), median_ms=float(np.median(ms)),
               widest_pairs=n_pairs, widest_longest=longest, widest_max_radius=r,
               widest_ms=ms[widest], widest_host_call_ms=host_calls[widest][0] * 1e3,
               max_abs_err=err, ms=device_ms(call, 5), call_ms=call_ms(call),
               host_ms=host_ms(call, 5), plain_ms=plain_ms,
               whole_call_ms=float(np.median(whole_ms)), pack_ms=float(np.median(pack_ms)),
               h2d_bytes=values.untyped_storage().nbytes(),
               padded_bytes=2 * 4 * n_pairs * longest,
               warp_columns=threshold, pairs_on_warps=on_warps,
               pairs_on_threads=n_pairs - on_warps,
               share_of_cell=sum(ms) / 1e3 / row["seconds"],
               columns=columns, values=n_values,
               pairs_with_columns_at_least={t: int((cols >= t).sum())
                                            for t in (2, 4, 8, 16, 24, 32, 64, 128)},
               **bounds.dtw_bound(n_pairs, longest, width, lat, columns=columns,
                                  values=n_values))
    # the thread path alone at the main path's shapes (the sweep of T is
    # profiling/kernel_time.py --dtw's)
    check(torch.equal(ragged(*a, **dict(k, threshold=2 ** 30, long_pairs=0)), want),
          "dtw: the kernel with every pair on a thread differs from the plain version")
    counter.launches = counted
    emit({"phase": "dtw_banded_batch", **out})
    row["dtw_banded_batch"] = out
    return row


def records_of(results) -> list:
    """Each read's records as PAF columns 1-12 and the tags but mt:f."""
    return [(r.name, [(m.read_length, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.mapq, m.rev, m.mapped,
                       [t for t in m.tags.split("\t") if not t.startswith("mt:f:")])
                      for m in r.records]) for r in results]


def map_timed(torch, engine, kept) -> tuple:
    """(results, seconds) of one engine.map_batch of a kept batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.map_batch([(n, s) for n, s, _, _ in kept["reads"]])
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def phase_pipeline(torch, dev, kept) -> dict:
    """D1 (host tail) and D2 (device tail) mapped again from the main run's
    reads at --pipeline-depth 1: records equal to the main run's, which ran
    at the default depth, 3; per cell and depth, bp/s, wall seconds, the
    stage sums and the distinct CUDA streams K1 and K2 launched on: at
    depth 1 one, at depth 3 more than one (one a batch in flight)."""
    from rawhash_tpu_torch.map.engine import MappingEngine
    from rawhash_tpu_torch.utils.timers import stage_walls

    out = {}
    for cell, k in kept.items():
        main = k["row"]
        check(main["pipeline_depth"] == 3, f"pipeline {cell}: the main run's "
              f"depth is {main['pipeline_depth']}, not 3")
        runs = {"depth3": dict(depth=3, main_run=True, seconds=main["seconds"],
                               bp_per_s=main["bp_per_s"], streams=main["streams"],
                               stage_seconds=main["stage_seconds"],
                               stage_sum=sum(stage_walls(main["stage_seconds"]).values()))}
        mopt = copy.deepcopy(k["mopt"])
        mopt.pipeline_depth = 1
        engine = MappingEngine(k["index"], mopt, device=dev, trace=True)
        caught = {}
        originals = catch_widest(caught)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            results = [r for batch in engine.map_stream(k["batches"]) for r in batch]
        finally:
            put_back(originals)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_mapped, n_correct, bases = score_mapping(k["all_reads"], results, mopt,
                                                   k["read_len"])
        stages = dict(engine.profiler.totals)
        row = dict(depth=1, pipeline_depth=engine.pipeline_depth,
                   seconds=dt, bp_per_s=bases / dt, mapped=n_mapped,
                   accuracy=n_correct / max(n_mapped, 1),
                   records_equal_main=records_of(results) == k["records"],
                   streams={n: len(v) for n, v in caught["streams"].items()},
                   stage_seconds=stages, stage_sum=sum(stage_walls(stages).values()),
                   stage_counts=dict(engine.profiler.counts),
                   device_tail=engine.device_tail,
                   anchor_regrows=engine.stats["anchor_regrows"])
        emit({"phase": "pipeline", "cell": cell, **row})
        check(row["records_equal_main"], f"pipeline {cell}: the records at "
              "depth 1 differ from the main run's (depth 3)")
        runs["depth1"] = row
        out[cell] = runs
        kernels = ("chain_fill", "chain_backtrack") if cell == "d2" else ("chain_fill",)
        for name in kernels:
            check(runs["depth1"]["streams"][name] == 1
                  and runs["depth3"]["streams"][name] > 1,
                  f"pipeline {cell}: {name} streams at depth 1 / 3 (the main "
                  f"run): {runs['depth1']['streams'][name]} / "
                  f"{runs['depth3']['streams'][name]}")
    return out


def phase_dist(torch, dev, kept) -> dict:
    """The sharded engine (--n-shards 1) in a process group of one rank
    over NCCL on cuda:0, the table unsplit (one card: NCCL takes no two
    ranks on one device), on each kept cell's first batch: D1's on the host
    tail, D2's on the device tail (K1 and the backtrack on the rank's
    rows).  PAF columns 1-12 must equal the single-device engine's on the
    same reads, in the cell's main run; bp/s of both, shard_hits, the
    gather stage and the launches of each."""
    import torch.distributed as tdist

    from rawhash_tpu_torch.chain.backtrack import chain_backtrack
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import MappingEngine
    from rawhash_tpu_torch.parallel.dist import init_process_group

    rank_dev = init_process_group("cuda")
    out = {}
    try:
        check(tdist.get_backend() == "nccl" and rank_dev.index == 0,
              f"dist: backend {tdist.get_backend()} on {rank_dev}")
        for cell, k in kept.items():
            mopt = copy.deepcopy(k["mopt"])
            mopt.n_shards = 1
            engine = MappingEngine(k["index"], mopt, device=rank_dev, trace=True)
            n0 = (chain_fill.launches, chain_backtrack.launches)
            results, dt = map_timed(torch, engine, k)
            n_mapped, n_correct, bases = score_mapping(k["reads"], results, mopt,
                                                       k["read_len"])
            same = records_of(results) == k["records"][:len(results)]
            stages = engine.profiler.totals
            row = dict(
                reads=len(results), mapped=n_mapped,
                accuracy=n_correct / max(n_mapped, 1),
                paf_equal_single_device=same, seconds=dt, bp_per_s=bases / dt,
                single_device_bp_per_s=k["row"]["bp_per_s"],
                world=engine.dist.world, n_shards=engine.dist.n_shards,
                backend=tdist.get_backend(),
                shard_hits=engine.stats["shard_hits"].tolist(),
                device_tail=engine.device_tail,
                device_tail_chunks=engine.stats["tail_chunks"],
                table_bytes_on_card=engine.dist.nbytes(),
                gather_s=stages.get("gather", 0.0),
                lookup_expand_s=stages.get("lookup+expand", 0.0),
                stage_seconds=dict(stages), stage_counts=dict(engine.profiler.counts),
                launches={"chain_fill": chain_fill.launches - n0[0],
                          "chain_backtrack": chain_backtrack.launches - n0[1]})
            emit({"phase": "dist", "cell": cell, **row})
            check(same, f"dist {cell}: the sharded engine's PAF columns 1-12 "
                  "differ from the single-device engine's")
            check(engine.device_tail == k["row"]["device_tail"],
                  f"dist {cell}: another tail than the single-device engine's")
            out[cell] = row
    finally:
        tdist.destroy_process_group()
    check(not out["d1"]["device_tail"] and out["d2"]["device_tail"]
          and out["d2"]["launches"]["chain_backtrack"] > 0,
          "dist: D1 must stay on the host tail and D2 take the device tail")
    return out


def phase_multihost(torch) -> dict:
    """The multi-host selftest as its own process, a world of one over
    NCCL: `python -m rawhash_tpu_torch.parallel.multihost ... --selftest
    --device cuda`, the sharded chunk step gathered against chunk_step."""
    import socket
    import subprocess

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "rawhash_tpu_torch.parallel.multihost",
           "--coordinator", f"localhost:{port}", "--num-processes", "1",
           "--process-id", "0", "--n-shards", "1", "--selftest", "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)), cwd=str(ROOT))
    row = dict(rc=proc.returncode, seconds=time.perf_counter() - t0,
               stdout=proc.stdout.strip()[-500:], stderr=proc.stderr.strip()[-1500:])
    emit({"phase": "multihost", **row})
    check(proc.returncode == 0 and "MULTIHOST_OK process=0" in proc.stdout,
          "multihost: the selftest failed")
    return row


K1_WIDE = dict(b=8, n=16384, w=20000, seed=17)


def phase_k1_wide(torch, dev, d: Path) -> dict:
    """K1 past the shared-memory cap: W = 20000 (the rings in a global
    scratch buffer) on 8 rows of 16384 anchors, every predecessor in band
    and a chain step 14465 anchors long (synthetic.wide_band_anchors),
    sensitive parameters: bit-equal to the plain fill, and finding the
    chains W = 14464 misses; kernel timed (median of 5) beside the
    shared-memory path at W = 14464, the plain fill once; then the CLI
    maps the fixture (in `d`, from phase_fixture, with its sensitive index)
    with --max-iterations 20000 on cuda."""
    from rawhash_tpu_torch.chain.device import chain_fill_batch
    from rawhash_tpu_torch.chain.fill import (
        GLOBAL_RING_BUDGET, MAX_ITER_CAP, chain_fill, global_ring_plan,
    )
    from rawhash_tpu_torch.cli import main as cli
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import options, wide_band_anchors

    c = K1_WIDE
    prm = dict(fill_params(*options("sensitive")), max_iter=c["w"])
    host_in = wide_band_anchors(c["seed"], c["b"], c["n"], prm["max_dist_q"],
                                MAX_ITER_CAP + 1)
    args = [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)
            for x in host_in]
    n0 = chain_fill.launches
    f, p = chain_fill(*args, **prm)  # also the timing's warm-up
    launches = chain_fill.launches - n0
    (f0, p0), plain_ms = timed_once(torch, lambda: chain_fill_batch(*args, **prm))
    err = max(int((f - f0).abs().max()), int((p - p0).abs().max()))
    check(torch.equal(f, f0) and torch.equal(p, p0),
          f"k1_wide: kernel disagrees with the plain fill (max abs err {err})")
    cap = dict(prm, max_iter=MAX_ITER_CAP)
    f_cap, _ = chain_fill(*args, **cap)
    check(bool((f > f_cap).any()), "k1_wide: W = 20000 finds no chain W = 14464 misses")
    ms = cuda_ms(torch, lambda: chain_fill(*args, **prm), 5)
    cap_ms = cuda_ms(torch, lambda: chain_fill(*args, **cap), 5)
    budget = min(GLOBAL_RING_BUDGET, torch.cuda.mem_get_info(dev)[0] // 4)
    warps, rows = global_ring_plan(c["b"], c["w"], budget)
    row = dict(**c, anchors=int(host_in[3].sum()), launches=launches,
               warps=warps, rows_a_launch=rows,
               scratch_bytes=rows * warps * 16 * (c["w"] + 64),
               max_abs_err=err, ms=ms, plain_ms=plain_ms, shared_cap_ms=cap_ms,
               improved_chain_ends=int((f > f_cap).sum()), **fill_bound(*args, prm))

    idx = d / "ref_sensitive.rhi.npz"
    paf = d / "wide.paf"
    n0 = chain_fill.launches
    rc = cli(["-x", "sensitive", "--max-iterations", str(c["w"]), "--max-anchors",
              "512", str(idx), str(d / "reads.sig.npz"), "--device", "cuda",
              "-o", str(paf)])
    lines = [l.split("\t") for l in paf.read_text().splitlines()] if rc == 0 else []
    row.update(cli_rc=rc, cli_mapped=sum(l[4] in "+-" for l in lines),
               cli_fill_launches=chain_fill.launches - n0)
    emit({"phase": "k1_wide", **row})
    check(rc == 0 and row["cli_mapped"] >= 5,
          f"k1_wide: the CLI at --max-iterations {c['w']} on cuda (rc {rc})")
    return row


def main_path(name, fn, counters) -> tuple:
    """Run one main-path phase with every kernel's launch counter set to 0
    just before it; (its result, {kernel: launches in it})."""
    for k in counters.values():
        k.launches = 0
        if hasattr(k, "max_width"):
            k.max_width = 0
    t0 = time.perf_counter()
    out = fn()
    launches = {n: k.launches for n, k in counters.items()}
    emit({"phase": f"{name}_done", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return out, launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--host-workers", type=int, default=2,
                    help="worker processes for the plain versions on the host CPU "
                         "(0: each runs in turn on the calling thread, so no host "
                         "work runs beside the card's phases)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "rawhash_tpu_torch").is_dir():
        print("chip_smoke: run it from the root of a rawhash-tpu checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from rawhash_tpu_torch.profiling.fill_loop_overhead import card as nvidia_smi

    dev = torch.device("cuda")
    card = nvidia_smi()
    t_all = time.perf_counter()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    host = HostWorkers(workers=args.host_workers, threads=1)
    ava_inputs = host.submit(ava_workload)  # ready by the ava phase
    work = tempfile.TemporaryDirectory()
    fixture_dir = Path(work.name)
    try:
        from rawhash_tpu_torch import _build
        from rawhash_tpu_torch.chain.backtrack import chain_backtrack
        from rawhash_tpu_torch.chain.fill import chain_fill
        from rawhash_tpu_torch.config import MapFlag
        from rawhash_tpu_torch.dtw.device import dtw_banded_batch
        from rawhash_tpu_torch.profiling.bounds import sm_clock

        t0 = time.perf_counter()
        so = _build.build()
        _build.load_library()
        log = so.with_suffix(".log")
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": so.name, "sm_clock_hz": sm_clock()[0],
              "sm_clock_from": sm_clock()[1],
              "ptxas": [l for l in (log.read_text().splitlines() if log.exists() else [])
                        if "registers" in l or "spill" in l or "Function properties" in l]})

        timed = {}
        for name, fn in (("k1", phase_k1),
                         ("backtrack", lambda torch, dev: phase_backtrack(torch, dev, host)),
                         ("event_kernels", phase_event_kernels), ("k4", phase_k4)):
            t0 = time.perf_counter()
            timed[name] = fn(torch, dev)
            emit({"phase": f"{name}_done", "seconds": time.perf_counter() - t0})

        counters = {"chain_fill": chain_fill, "chain_backtrack": chain_backtrack,
                    **main_path_event_kernels(), "dtw_banded_batch": dtw_banded_batch}
        runs = {}
        runs["fixture"] = main_path(
            "fixture", lambda: phase_fixture(fixture_dir, host), counters)
        cells = {
            "d1": (30_000, "viral", 2, 1200, 3072, 7),
            "d2": (5_000_000, "sensitive", 2, 2500, 16384, 11),
            "d4": (100_000_000, "sensitive", 1, 3000, 4096, 13),
        }
        caught = {c: {} for c in cells}  # each cell's widest fill/tail calls
        kept = {"d1": {}, "d2": {}}  # their reads and records: pipeline, dist
        for name, cell in cells.items():
            runs[name] = main_path(
                name, lambda: phase_deployment(torch, dev, name, *cell,
                                               caught[name], keep=kept.get(name)),
                counters)
        (d1, _), (d2, _), (d4, _) = (runs[c] for c in cells)
        # the kernels on each device-tail cell's own widest tail call: D2's
        # backtrack held on all its rows, D4's fill and backtrack on 8
        for name, rows, fill in (("d2", None, False), ("d4", 8, True)):
            check("tail" in caught[name],
                  f"{name}: no device-tail call to check the kernels on")
            t0 = time.perf_counter()
            timed[f"{name}_kernels"] = phase_tail_kernels(
                torch, name, caught[name].pop("tail"), host, rows=rows, fill=fill)
            emit({"phase": f"{name}_kernels_done",
                  "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        timed["fill_warps"] = phase_fill_warps(
            torch, dev, {c: caught[c].pop("fill") for c in cells})
        caught.clear()
        emit({"phase": "fill_warps_done", "seconds": time.perf_counter() - t0})
        # D1 and D2 again at --pipeline-depth 1, then 3
        runs["pipeline"] = main_path(
            "pipeline", lambda: phase_pipeline(torch, dev, kept), counters)

        # the sharded engine in a one-rank NCCL group on D1's and D2's
        # first batches, against their main runs; the multi-host selftest;
        # K1 past the shared-memory cap
        runs["dist"] = main_path("dist", lambda: phase_dist(torch, dev, kept), counters)
        kept.clear()
        for name, fn in (("multihost", lambda: phase_multihost(torch)),
                         ("k1_wide", lambda: phase_k1_wide(torch, dev, fixture_dir))):
            t0 = time.perf_counter()
            timed[name] = fn()
            emit({"phase": f"{name}_done", "seconds": time.perf_counter() - t0})

        # the other mapping modes: all-vs-all, DTW, RMQ, --bw-long
        def long_gaps(mo):
            mo.bw_long = 5 * mo.bw

        def rmq_mode(mo):
            mo.flag |= MapFlag.RMQ

        ava = {}  # the ava cell's widest fill/tail calls, and its reruns' inputs
        modes = {
            "ava": lambda: phase_ava(torch, dev, ava, ava_inputs.result()),
            "ava_tails": lambda: phase_ava_tails(torch, dev, ava.pop("rerun")),
            "ava_quality": lambda: phase_ava_quality(torch, dev),
            "dtw": lambda: phase_dtw(torch, dev, timed["event_kernels"]["latencies"]),
            "rmq": lambda: phase_deployment(torch, dev, "rmq", 30_000, "viral", 1,
                                            1200, 3072, 7, {}, configure=rmq_mode),
            "bw_long": lambda: phase_deployment(torch, dev, "bw_long", 30_000, "viral",
                                                1, 1200, 3072, 7, {}, configure=long_gaps),
        }
        for name, fn in modes.items():
            runs[name] = main_path(name, fn, counters)
        # the kernels on ava's own widest tail call: the fill and the
        # backtrack, 8 rows held
        check("tail" in ava, "ava: no device-tail call to check the kernels on")
        t0 = time.perf_counter()
        timed["ava_kernels"] = phase_tail_kernels(
            torch, "ava", ava.pop("tail"), host, rows=8, fill=True, preset="ava")
        ava.clear()
        emit({"phase": "ava_kernels_done", "seconds": time.perf_counter() - t0})
        check(not d1["device_tail"] and d1["device_tail_chunks"] == 0,
              "d1: the viral cell left the host tail")
        check(d2["device_tail"] and d2["device_tail_chunks"] > 0,
              "d2: the E. coli cell did not switch to the device tail")
        check(d4["backtrack_max_width"] > 32768,
              f"d4: widest backtrack {d4['backtrack_max_width']} <= 32768")
        # every main-path run maps on the card: the events and sketch
        # kernels and the fill in all, the backtrack on the device tail
        host_tail = ("d1", "ava_tails", "ava_quality", "dtw", "rmq", "bw_long")
        for name, (_, n) in runs.items():
            path = {k: v for k, v in n.items()
                    if not (k == "chain_backtrack" and name in host_tail)
                    and not (k == "dtw_banded_batch" and name != "dtw")}
            check(all(v > 0 for v in path.values()),
                  f"{name}: a kernel of its path was not launched: {n}")
        launches = {k: sum(n[k] for _, n in runs.values()) for k in counters}
        emit({"phase": "main_path_launches", "total": launches,
              **{name: n for name, (_, n) in runs.items()}})

        # the plain versions' checks, run meanwhile in the host workers
        t0 = time.perf_counter()
        host.settle()
        emit({"phase": "host_checks_done", "seconds_waited": time.perf_counter() - t0})

        k1 = timed["k1"]
        main_shape = next(r for r in k1 if r["preset"] == "sensitive" and r["n"] == 16384)
        d4f = timed["d4_kernels"]["fill"]
        avaf = timed["ava_kernels"]["fill"]
        kernels = [{
            "name": "chain_fill", "route": "cuda",
            "source": "rawhash_tpu_torch/csrc/chain_fill.cu",
            "replaces": "rawhash_tpu/chain/pallas_fill.py:226",
            "launches": launches["chain_fill"],
            "max_abs_err": max(r["max_abs_err"] for r in k1 + [d4f, avaf, timed["k1_wide"]]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": bound_by(main_shape),
            "library_ms": None,
            # the same kernel at D4's and ava's main-path inputs (plain:
            # their held rows)
            **{c: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "segments")}
               for c, r in (("d4", d4f), ("ava", avaf))},
            # past the shared-memory cap: W = 20000, the rings in global memory
            "wide": {k: timed["k1_wide"][k] for k in (
                "b", "n", "w", "ms", "plain_ms", "bound_ms", "shared_cap_ms",
                "launches", "warps", "max_abs_err")},
        }]
        # one kernel for both TPU kernels: K2's row at the D2 regime
        # (B=256, N=16384); K3's at D4's main-path inputs past 32768 (the
        # kernel on the whole batch, the plain version on its held rows)
        # (K2's row also at D2's main-path inputs, all rows held; K3's also
        # at ava's, past 32768 too, 8 rows held)
        bt = timed["backtrack"]
        d2k = timed["d2_kernels"]["backtrack"]
        d4k = timed["d4_kernels"]["backtrack"]
        avak = timed["ava_kernels"]["backtrack"]
        for replaces, shape, extra in (
                ("rawhash_tpu/chain/backtrack_pallas.py:147", bt[0], {"d2": d2k}),
                ("rawhash_tpu/chain/backtrack_pallas_big.py:361", d4k, {"ava": avak})):
            kernels.append({
                "name": "chain_backtrack", "route": "cuda",
                "source": "rawhash_tpu_torch/csrc/chain_backtrack.cu",
                "replaces": replaces,
                "launches": launches["chain_backtrack"],
                "max_abs_err": max(r["max_abs_err"] for r in bt + [d2k, d4k, avak]),
                "ms": shape["ms"], "plain_ms": shape["plain_ms"],
                "bound_ms": shape["bound_ms"], "bound_by": bound_by(shape),
                "library_ms": None,
                **{c: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"],
                       "serial_steps_max": r["work"]["serial_steps_max"]}
                   for c, r in extra.items()},
            })
        k4 = timed["k4"]
        k4_row = next(c for c in k4["checks"] if c["w"] == 64 and c["k_ops"] == 20)
        kernels.append({
            "name": "fill_loop_probe", "route": "cuda",
            "source": "rawhash_tpu_torch/csrc/fill_loop_probe.cu",
            "replaces": "tools/profiling/fill_loop_overhead.py:33",
            "launches": k4["launches"],
            "max_abs_err": max(c["max_abs_err"] for c in k4["checks"]),
            "ms": k4_row["ms"], "plain_ms": k4_row["plain_ms"],
            "bound_ms": k4_row["bound_ms"], "bound_by": bound_by(k4_row),
            "library_ms": None,
        })
        # the events and sketch kernels (the JAX package's events program,
        # scans and ordered sums, not Pallas kernels): the row at the viral
        # chunk's first call, the same at the sensitive and ava shapes beside
        # it; launches on the main path for the kernels the engine launches,
        # in the event_kernels phase for the op chain's single kernels
        shapes = timed["event_kernels"]["shapes"]
        for name, source, replaces in EVENT_KERNEL_ROWS:
            calls = {c: [r for r in line["calls"] if r["kernel"] == name]
                     for c, line in shapes.items()}
            row = calls["viral"][0]
            # the ordered sums' row times the call the stage makes (its
            # options: a value and its square, a leading zero) beside the
            # PyTorch calls that give the same outputs; the single function
            # (x alone, one PyTorch call) stands beside it under `single`
            scan = "single" in row
            on_path = name in launches
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": (launches if on_path else timed["event_kernels"]["launches"])[name],
                "launches_in": "main_path" if on_path else "event_kernels",
                "max_abs_err": max(r["max_abs_err"] for c in calls.values() for r in c),
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": "bytes" if scan else bound_by(row),
                "library_ms": row["library_ms"],
                "call_ms": row["call_ms"], "host_ms": row["host_ms"],
                **({"options": row["options"],
                    "library_of": "torch.sum / torch.cumsum of x (and of x * x), "
                                  "padded with the leading zero",
                    "single": row["single"]} if scan else {}),
                "as_called": {c: [{k: r[k] for k in ("options", "shape", "ms", "call_ms",
                                                     "host_ms", "bound_ms", "library_ms",
                                                     "library_call_ms", "single", "plain_ms",
                                                     "wide", "staged_bytes") if k in r}
                                  for r in rs] for c, rs in calls.items()},
                **{c: {k: calls[c][0][k] for k in ("shape", "ms", "bound_ms", "library_ms")}
                   for c in ("sensitive", "ava")},
            })
        # the banded DTW (the JAX package's compiled scan, not Pallas): the
        # dtw cell's widest call
        dtw = runs["dtw"][0]["dtw_banded_batch"]
        kernels.append({
            "name": "dtw_banded_batch", "route": "cuda",
            "source": "rawhash_tpu_torch/csrc/dtw_banded.cu",
            "replaces": "rawhash_tpu/dtw/device.py:33",
            "launches": launches["dtw_banded_batch"], "max_abs_err": dtw["max_abs_err"],
            "ms": dtw["ms"], "plain_ms": dtw["plain_ms"], "bound_ms": dtw["bound_ms"],
            "bound_by": bound_by(dtw), "library_ms": None,
            "call_ms": dtw["call_ms"], "host_ms": dtw["host_ms"],
            # pairs, the longest pair's columns, the band's width
            "shape": [dtw["widest_pairs"], dtw["widest_longest"],
                      2 * dtw["widest_max_radius"] + 1],
            **{key: dtw[key] for key in ("whole_call_ms", "h2d_bytes", "warp_columns",
                                         "pairs_on_warps", "pairs_on_threads")},
        })
        emit({"kernels": kernels,
              **{f"{c}_bp_per_s": runs[c][0]["bp_per_s"]
                 for c in (*cells, "ava", "dtw", "rmq", "bw_long")},
              "dist_bp_per_s": {c: r["bp_per_s"] for c, r in runs["dist"][0].items()},
              "pipeline_bp_per_s": {c: {run: r["bp_per_s"] for run, r in p.items()}
                                    for c, p in runs["pipeline"][0].items()},
              "seconds": time.perf_counter() - t_all})
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        host.close()
        work.cleanup()
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
