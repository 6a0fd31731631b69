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
  4. loops     time the plain stages' stepped loops (_gen_peaks, _diff_filter)
  5. k4        the fill-loop probe (K1's loop skeleton): kernel vs the plain
               probe bit for bit on a random start at 1000 iterations
               (64 x 256 at k_ops 2, 20, 60; 200 x 256 at 20), kernel timed
               (median of 7) and the plain probe once; the kernel against
               the closed form from INT32_MIN at 100000 iterations; the
               probe's entry point run with its launch counter set to 0
               just before and read just after; 200 x 256 (K1's W) timed at
               100000 iterations; the integer max instructions in the compiled
               chain at k_ops 2, 20, 60 must grow with k_ops
  6. fixture   the CLI (`python -m rawhash_tpu_torch`) on a small fixture,
               --device cuda vs --device cpu: same mapped reads, same PAF
               columns 1, 5 and 6, column 8 within 20; and on cuda with
               RAWHASH_TPU_DEVICE_TAIL=1: PAF columns 1-12 of the mapped
               rows equal to the host tail's
  7. d1        SARS-CoV-2-sized deployment: 30 kb genome, viral preset,
               5 x 256 reads of 1200 bases; stays on the host tail
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
               version, with the staging depths
     d4_kernels both kernels on d4's widest device-tail call: timed at
               that whole shape (median of 5), and 8 of its rows at full
               width held bit for bit against the plain fill and the plain
               backtrack (all ten outputs, compaction, carried prefix) on
               CPU copies, each plain version timed once; with the fill
               input's chain segments and the backtrack's work and depths
 11. fill_warps K1 at 4, 8 and 16 warps a read on the main path's own fill
               inputs (the widest fill call of d1, d2 and d4, caught during
               their runs) and on k1's sensitive 256 x 16384 input: each
               bit-equal to chain_fill's f/p, then timed in turns (median
               of 5, forward and reverse order, twice); with each input's
               chain segments
Phases 6-9 are the main-path run: each resets the kernels' launch counters
just before it and reads them just after; every kernel must have launched
in it.  Phases 7-9 need >= 95% of reads mapped at accuracy >= 0.95 (strand
right, mapped target interval inside the read's true interval +/- 200).
The line before the card's line lists every kernel with its launches, error
and times beside its bound (rawhash_tpu_torch/profiling/bounds.py: bytes,
fp32, int32 and conversions each at the H100's own rate, the largest time);
the last line is {"ok": true, "device": ...}.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def bound_by(row) -> str:
    """The kernels line's bound_by: "bytes" or "operations"."""
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


def spy(mod, name, record):
    """Wrap mod.name so that each call first hands (name, the original, its
    arguments, keyword arguments) to record; returns the original, which
    the caller puts back."""
    fn = getattr(mod, name)

    def wrapper(*a, **k):
        record(name, fn, a, k)
        return fn(*a, **k)
    setattr(mod, name, wrapper)
    return fn


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


def check_backtrack(torch, label, inputs, key, got, *, bt, k_cap, p_out) -> tuple:
    """Hold the kernel's ten outputs `got` (on the card) against the plain
    version on CPU copies of `inputs` (f, p, n_anchors, tpos, qpos), and the
    compaction of each (summaries of the live chains, carried prefix).
    Returns (max abs error, plain ms).

    The plain lockstep takes ~3N steps of ~150 small ops: on the card
    (launch-bound) it ran 102 s at N=16384 and 205 s at N=40960 on an H100
    80GB HBM3 at 700 W, so it runs on CPU copies of the same tensors (~4x
    faster)."""
    from rawhash_tpu_torch.chain.backtrack import compact_from_chain_stats
    from rawhash_tpu_torch.chain.backtrack_device import (
        backtrack_plain, compact_batch,
    )

    _, _, _, tpos, qpos = inputs
    asc, _, summ = compact_from_chain_stats(
        *got[:2], *got[6:], got[2], got[3], got[4], key, tpos, qpos,
        p_out=p_out)
    got, asc, summ = ([t.cpu() for t in got], asc.cpu(), summ.cpu())
    cpu_in = [t.cpu() for t in inputs]
    t0 = time.perf_counter()
    want = backtrack_plain(*cpu_in, **bt, k_cap=k_cap)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((a.long() - c.long()).abs().max()) for a, c in zip(want, got))
    check(all(torch.equal(a, c) for a, c in zip(want, got)),
          f"{label}: kernel disagrees with the plain version (max abs err {err})")
    asc_b, _, summ_b = compact_batch(*want[:5], key.cpu(), *cpu_in[3:],
                                     q_span=bt["q_span"])
    n_u, n_v = got[2], got[4]
    po = min(p_out, asc_b.shape[1])  # past the width, asc is padding
    live = torch.arange(k_cap)[None, :] < n_u[:, None]
    pre = torch.arange(po)[None, :] < n_v.clamp(max=po)[:, None]
    check(torch.equal(summ[live], summ_b[live])
          and torch.equal(asc[:, :po][pre], asc_b[:, :po][pre]),
          f"{label}: compacted summaries or carried prefix differ between "
          "the kernel's chain stats and the plain version")
    return err, plain_ms


def backtrack_params(mo, prm) -> dict:
    return dict(min_cnt=mo.min_num_anchors, min_sc=mo.min_chaining_score,
                max_drop=mo.bw, q_span=prm["q_span"])


def measure_backtrack(torch, label, inputs, key, *, bt, k_cap, p_out, reps,
                      rows=None) -> dict:
    """chain_backtrack on `inputs` (f, p, n_anchors, tpos, qpos on the
    card): its outputs on `rows` (all if None) against the plain version on
    CPU copies (check_backtrack), its time with its candidate order, the
    old full-width sort's time beside the new order's, the candidates, the
    launch plan and the counted bound with ns per serial step."""
    from rawhash_tpu_torch.chain.backtrack import (
        candidate_order, candidates, chain_backtrack, launch_depth,
    )

    got = chain_backtrack(*inputs, **bt, k_cap=k_cap)  # the warm-up
    if rows is None:
        err, plain_ms = check_backtrack(torch, label, inputs, key, got, bt=bt,
                                        k_cap=k_cap, p_out=p_out)
    else:
        err, plain_ms = check_backtrack(
            torch, f"{label} {len(rows)} rows", [t[rows] for t in inputs],
            key[rows], [t[rows] for t in got], bt=bt, k_cap=k_cap, p_out=p_out)
    f, _, n_anchors, _, _ = inputs
    ms = cuda_ms(torch, lambda: chain_backtrack(*inputs, **bt, k_cap=k_cap), reps)
    sort_ms = cuda_ms(torch, lambda: candidates(f, n_anchors), reps)
    order_ms = cuda_ms(torch, lambda: candidate_order(f, n_anchors, bt["min_sc"]), reps)
    z_f, _, n_cand, a_max = candidate_order(f, n_anchors, bt["min_sc"])
    depth = launch_depth(a_max)
    bnd = backtrack_bound(inputs, bt, k_cap)
    check(int(n_cand.sum()) == bnd["work"]["candidates"],
          f"{label}: the candidate order and the counted work disagree")
    steps = bnd["work"]["serial_steps_max"]
    return dict(
        b=f.shape[0], n=f.shape[1], k_cap=k_cap, anchors=int(n_anchors.sum()),
        a_max=a_max, candidates=int(n_cand.sum()), c=z_f.shape[1],
        depth=depth, n_u_max=int(got[2].max()),
        n_v_max=int(got[4].max()), chain_overflow=int(got[5].sum()),
        max_abs_err=err, ms=ms, full_sort_ms=sort_ms, order_ms=order_ms,
        plain_ms=plain_ms, plain_device="cpu",
        plain_rows=f.shape[0] if rows is None else len(rows),
        ns_per_serial_step=ms * 1e6 / max(steps, 1), **bnd)


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


def phase_backtrack(torch, dev) -> list:
    """The backtrack kernel vs its plain version on f/p from K1, and the
    compaction of each; the staging depths on the 256 x 16384 input."""
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
        row = measure_backtrack(torch, f"backtrack B={b} N={n}", inputs, key,
                                bt=bt, k_cap=k_cap, p_out=min(4096, n), reps=7)
        if n == 16384:
            row["depths"] = backtrack_depths(
                torch, f"backtrack B={b} N={n}", inputs, bt=bt, k_cap=k_cap)
        emit({"phase": "backtrack", **row})
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


def phase_tail_kernels(torch, name, caught, *, rows=None, fill=False) -> dict:
    """The kernels on the inputs a cell's main path gave them: its widest
    tail_finish call, caught there.  The backtrack (and, with `fill`, the
    fill) is timed at that whole shape; its outputs on `rows` of its rows
    (the widest, the narrowest and others evenly between them by live
    anchors; all rows if None), at full width, are held bit for bit against
    the plain versions on CPU copies; then the backtrack at each staging depth."""
    from rawhash_tpu_torch.chain.device import chain_fill_batch
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import options

    io, mo = options("sensitive")
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

    if fill:  # K1: the main path's f/p against the plain fill
        fill_in = (out.key, out.tpos, out.qpos, out.n_anchors)
        f, p = chain_fill(*fill_in, **prm)  # also the timing's warm-up
        check(torch.equal(f, out.f) and torch.equal(p, out.p),
              f"{name}: the fill gave another f/p on the same inputs")
        held = [t if idx is None else t[idx] for t in (*fill_in, out.f, out.p)]
        t0 = time.perf_counter()
        f0, p0 = chain_fill_batch(*(t.cpu() for t in held[:4]), **prm)
        fill_plain_ms = (time.perf_counter() - t0) * 1e3
        f_r, p_r = held[4].cpu(), held[5].cpu()
        fill_err = max(int((f_r - f0).abs().max()), int((p_r - p0).abs().max()))
        check(torch.equal(f_r, f0) and torch.equal(p_r, p0),
              f"{name}: fill kernel disagrees with the plain fill (max abs err {fill_err})")
        res["fill"] = dict(ms=cuda_ms(torch, lambda: chain_fill(*fill_in, **prm), 5),
                           plain_ms=fill_plain_ms, max_abs_err=fill_err,
                           **fill_bound(*fill_in, prm))

    inputs = (out.f, out.p, out.n_anchors, out.tpos, out.qpos)
    res["backtrack"] = measure_backtrack(
        torch, f"{name} backtrack", inputs, out.key, bt=bt, k_cap=k_cap,
        p_out=p_out, reps=5, rows=idx)
    res["backtrack"]["depths"] = backtrack_depths(
        torch, f"{name} backtrack", inputs, bt=bt, k_cap=k_cap)
    emit({"phase": f"{name}_kernels", **res})
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


def phase_loops(torch, dev) -> dict:
    """Time the two stepped loops of the plain stages, the candidates for the
    next kernels, at the main path's shapes (256 reads, one 4000-sample
    chunk, viral preset): the event detector's _gen_peaks and the sketch's
    _diff_filter.  Their arguments are caught from one events+sketch call."""
    from rawhash_tpu_torch.signal import events as ev
    from rawhash_tpu_torch.sketch import device as sk
    from rawhash_tpu_torch.synthetic import options

    io, mo = options("viral")
    rng = np.random.default_rng(3)
    b, l = 256, mo.chunk_size
    levels = rng.normal(90.0, 12.0, size=(b, l // 9 + 1))
    sig = np.repeat(levels, 9, axis=1)[:, :l] + rng.normal(0, 1.0, (b, l))
    sig = torch.from_numpy(sig.astype(np.float16)).to(dev).to(torch.float32)
    slen = torch.full((b,), l, dtype=torch.int32, device=dev)
    caught = {}

    def keep(name, fn, a, k):
        caught[name] = (fn, a, k)

    originals = {(ev, "_gen_peaks"): spy(ev, "_gen_peaks", keep),
                 (sk, "_diff_filter"): spy(sk, "_diff_filter", keep)}
    try:
        events, n_ev, _ = ev.detect_events_batch(
            sig, slen, ev.NormCarry.zeros(b, dev),
            window_length1=mo.window_length1, window_length2=mo.window_length2,
            threshold1=mo.threshold1, threshold2=mo.threshold2,
            peak_height=mo.peak_height, e_cap=mo.max_events_per_chunk,
        )
        sk.sketch_batch(events, n_ev, diff=io.diff, w=io.w, e=io.e, q=io.q,
                        k=io.k, fine_min=io.fine_min, fine_max=io.fine_max,
                        fine_range=io.fine_range)
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    out = {"b": b, "l": l, "e_cap": mo.max_events_per_chunk,
           "mean_events": float(n_ev.float().mean())}
    for name, (fn, a, k) in caught.items():
        out[f"{name}_ms"] = cuda_ms(torch, lambda: fn(*a, **k), 3)
    emit({"phase": "loops", **out})
    return out


def phase_k4(torch, dev) -> dict:
    """The fill-loop probe (K4): kernel vs plain probe, the closed form, the
    probe's entry point with its launch counter, and the SASS check."""
    from rawhash_tpu_torch.profiling import fill_loop_overhead as flo

    n_check, n_full = 1000, 100_000
    rng = np.random.default_rng(5)
    checks = []
    for w, k_ops in ((64, 2), (64, 20), (64, 60), (200, 20)):
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
                           **flo.probe_bound(n_check, k_ops, w)))
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
                                 **flo.probe_bound(n_full, k_ops)))
    check(len(per_iter) == len(flo.K_OPS), f"k4: unexpected output {lines}")
    per_iter += [flo.time_probe(n_full, k_ops, w=200) for k_ops in flo.K_OPS]

    sass = flo.sass_max_counts()
    fixed = [sass[f"k_ops={k}"] for k in flo.K_OPS]
    check(fixed == sorted(set(fixed)),
          f"k4: the compiled chain's max count does not grow with k_ops: {sass}")
    out = dict(checks=checks, per_iter=per_iter, entry_point_output=lines,
               launches=launches, sass_max=sass)
    emit({"phase": "k4", **out})
    return out


def phase_fixture(d: Path) -> dict:
    from rawhash_tpu_torch.cli import main as cli
    from rawhash_tpu_torch.synthetic import write_fixture

    write_fixture(d)
    out = {}
    for preset in ("sensitive", "viral"):
        idx = d / f"ref_{preset}.rhi.npz"
        rc = cli(["-x", preset, "-p", str(d / "pore.model"), "-d", str(idx),
                  str(d / "ref.fa"), "--device", "cuda"])
        check(rc == 0, f"fixture index build failed ({rc})")
        pafs = {}
        for run, device in (("cuda", "cuda"), ("cpu", "cpu"), ("cuda_tail", "cuda")):
            paf = d / f"{preset}_{run}.paf"
            if run == "cuda_tail":
                os.environ["RAWHASH_TPU_DEVICE_TAIL"] = "1"
            t0 = time.perf_counter()
            try:
                rc = cli(["-x", preset, "--max-anchors", "512", str(idx),
                          str(d / "reads.sig.npz"), "--device", device,
                          "-o", str(paf)])
            finally:
                os.environ.pop("RAWHASH_TPU_DEVICE_TAIL", None)
            check(rc == 0, f"fixture mapping ({run}) failed ({rc})")
            pafs[run] = ([l.split("\t") for l in paf.read_text().splitlines()],
                         time.perf_counter() - t0)
        rows = {run: {c[0]: c for c in cols if c[4] in "+-"}
                for run, (cols, _) in pafs.items()}
        diffs = []
        for name in sorted(set(rows["cuda"]) | set(rows["cpu"])):
            a, c = rows["cuda"].get(name), rows["cpu"].get(name)
            if a is None or c is None or a[:12] != c[:12]:
                diffs.append({"read": name, "cuda": a and a[:12], "cpu": c and c[:12]})
        tail_same = ({n: r[:12] for n, r in rows["cuda_tail"].items()}
                     == {n: r[:12] for n, r in rows["cuda"].items()})
        emit({"phase": "fixture", "preset": preset,
              "mapped_cuda": len(rows["cuda"]), "mapped_cpu": len(rows["cpu"]),
              "mapped_cuda_device_tail": len(rows["cuda_tail"]),
              "device_tail_equals_host_tail": tail_same,
              "seconds_cuda": pafs["cuda"][1], "seconds_cpu": pafs["cpu"][1],
              "seconds_cuda_device_tail": pafs["cuda_tail"][1],
              "differences": diffs})
        check(set(rows["cuda"]) == set(rows["cpu"]), "fixture: mapped sets differ")
        for name, a in rows["cuda"].items():
            c = rows["cpu"][name]
            check(a[0] == c[0] and a[4] == c[4] and a[5] == c[5],
                  f"fixture: PAF columns 1/5/6 differ for {name}")
            check(abs(int(a[7]) - int(c[7])) <= 20,
                  f"fixture: PAF column 8 differs by > 20 for {name}")
        check(tail_same, "fixture: the device tail's PAF columns 1-12 differ "
              "from the host tail's on cuda")
        out[preset] = len(rows["cuda"])
    return out


def phase_deployment(torch, dev, name, genome_len, preset, n_batches,
                     read_len, max_anchors, seed, caught) -> dict:
    """Build the index and map n_batches x 256 simulated reads on the card
    through the engine's streaming entry point.  The run's widest fill call
    (copies of its tensors, its keyword arguments) is kept in
    caught["fill"], and its widest device-tail call (its ChunkOut `out`,
    `k_cap` and `p_out`) in caught["tail"]."""
    from rawhash_tpu_torch.chain.backtrack import chain_backtrack
    from rawhash_tpu_torch.map import device_step
    from rawhash_tpu_torch.map import engine as eng_mod
    from rawhash_tpu_torch.synthetic import deployment

    t0 = time.perf_counter()
    setup = {}
    index, mopt, reads = deployment(genome_len, preset, n_batches * 256,
                                    read_len, max_anchors, seed, seconds=setup)
    t_setup = time.perf_counter() - t0
    batches = [[(n, s) for n, s, _, _ in reads[i:i + 256]]
               for i in range(0, len(reads), 256)]
    engine = eng_mod.MappingEngine(index, mopt, device=dev)

    def widest_fill(_, fn, a, k):
        if "fill" not in caught or a[0].shape[1] >= caught["fill"][0][0].shape[1]:
            caught["fill"] = ([t.clone() for t in a], dict(k))

    def widest_tail(_, fn, a, k):
        if "tail" not in caught or a[0].f.shape[1] >= caught["tail"]["out"].f.shape[1]:
            caught["tail"] = dict(out=a[0], k_cap=k["k_cap"], p_out=k["p_out"])

    originals = {(device_step, "chain_fill"): spy(device_step, "chain_fill", widest_fill),
                 (eng_mod, "tail_finish"): spy(eng_mod, "tail_finish", widest_tail)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = [r for batch in engine.map_stream(batches) for r in batch]
    finally:
        for (mod, attr), fn in originals.items():
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

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
    )
    emit({"phase": name, "preset": preset, "genome_len": genome_len, **row})
    check(row["mapped_frac"] >= 0.95, f"{name}: mapped {n_mapped}/{len(reads)}")
    check(row["accuracy"] >= 0.95, f"{name}: accuracy {row['accuracy']:.3f}")
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


def main() -> int:
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
    try:
        from rawhash_tpu_torch import _build
        from rawhash_tpu_torch.chain.backtrack import chain_backtrack
        from rawhash_tpu_torch.chain.fill import chain_fill
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
        for name, fn in (("k1", phase_k1), ("backtrack", phase_backtrack),
                         ("loops", phase_loops), ("k4", phase_k4)):
            t0 = time.perf_counter()
            timed[name] = fn(torch, dev)
            emit({"phase": f"{name}_done", "seconds": time.perf_counter() - t0})

        counters = {"chain_fill": chain_fill, "chain_backtrack": chain_backtrack}
        runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            runs["fixture"] = main_path(
                "fixture", lambda: phase_fixture(Path(tmp)), counters)
        cells = {
            "d1": (30_000, "viral", 5, 1200, 3072, 7),
            "d2": (5_000_000, "sensitive", 2, 2500, 16384, 11),
            "d4": (100_000_000, "sensitive", 1, 3000, 4096, 13),
        }
        caught = {c: {} for c in cells}  # each cell's widest fill/tail calls
        for name, cell in cells.items():
            runs[name] = main_path(
                name, lambda: phase_deployment(torch, dev, name, *cell,
                                               caught[name]), counters)
        (d1, n1), (d2, n2), (d4, n4) = (runs[c] for c in cells)
        # the kernels on each device-tail cell's own widest tail call: D2's
        # backtrack held on all its rows, D4's fill and backtrack on 8
        for name, rows, fill in (("d2", None, False), ("d4", 8, True)):
            check("tail" in caught[name],
                  f"{name}: no device-tail call to check the kernels on")
            t0 = time.perf_counter()
            timed[f"{name}_kernels"] = phase_tail_kernels(
                torch, name, caught[name].pop("tail"), rows=rows, fill=fill)
            emit({"phase": f"{name}_kernels_done",
                  "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        timed["fill_warps"] = phase_fill_warps(
            torch, dev, {c: caught[c].pop("fill") for c in cells})
        caught.clear()
        emit({"phase": "fill_warps_done", "seconds": time.perf_counter() - t0})
        check(not d1["device_tail"] and d1["device_tail_chunks"] == 0,
              "d1: the viral cell left the host tail")
        check(d2["device_tail"] and d2["device_tail_chunks"] > 0,
              "d2: the E. coli cell did not switch to the device tail")
        check(d4["backtrack_max_width"] > 32768,
              f"d4: widest backtrack {d4['backtrack_max_width']} <= 32768")
        for name, n in (("fixture", runs["fixture"][1]),
                        ("d1", {"chain_fill": n1["chain_fill"]}), ("d2", n2),
                        ("d4", n4)):
            check(all(v > 0 for v in n.values()),
                  f"{name}: a kernel of its path was not launched: {n}")
        launches = {k: sum(n[k] for _, n in runs.values()) for k in counters}
        emit({"phase": "main_path_launches", "total": launches,
              **{name: n for name, (_, n) in runs.items()}})

        k1 = timed["k1"]
        main_shape = next(r for r in k1 if r["preset"] == "sensitive" and r["n"] == 16384)
        d4f = timed["d4_kernels"]["fill"]
        kernels = [{
            "name": "chain_fill", "route": "cuda",
            "source": "rawhash_tpu_torch/csrc/chain_fill.cu",
            "replaces": "rawhash_tpu/chain/pallas_fill.py:226",
            "launches": launches["chain_fill"],
            "max_abs_err": max(r["max_abs_err"]
                               for r in k1 + [timed["d4_kernels"]["fill"]]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": bound_by(main_shape),
            "library_ms": None,
            # the same kernel at D4's main-path inputs (plain: its held rows)
            "d4": {k: d4f[k] for k in ("ms", "plain_ms", "bound_ms", "segments")},
        }]
        # one kernel for both TPU kernels: K2's row at the D2 regime
        # (B=256, N=16384); K3's at D4's main-path inputs past 32768 (the
        # kernel on the whole batch, the plain version on its held rows)
        # (K2's row also at D2's main-path inputs, all rows held)
        bt = timed["backtrack"]
        d2k = timed["d2_kernels"]["backtrack"]
        d4k = timed["d4_kernels"]["backtrack"]
        for replaces, shape, extra in (
                ("rawhash_tpu/chain/backtrack_pallas.py:147", bt[0], {"d2": d2k}),
                ("rawhash_tpu/chain/backtrack_pallas_big.py:361", d4k, {})):
            kernels.append({
                "name": "chain_backtrack", "route": "cuda",
                "source": "rawhash_tpu_torch/csrc/chain_backtrack.cu",
                "replaces": replaces,
                "launches": launches["chain_backtrack"],
                "max_abs_err": max(r["max_abs_err"] for r in bt + [d2k, d4k]),
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
        emit({"kernels": kernels,
              **{f"{c}_bp_per_s": runs[c][0]["bp_per_s"] for c in cells},
              "seconds": time.perf_counter() - t_all})
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
