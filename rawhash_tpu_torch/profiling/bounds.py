"""The least time an NVIDIA H100 SXM could take for a kernel's work: the
bound that `chip_smoke.py` and the fill-loop probe put beside each time.

Each class of work is priced at its own rate and the bound is the largest
of the times:

- device-memory bytes at 3.35 TB/s (NVIDIA H100 SXM data sheet);
- per SM and clock on compute capability 9.0 (NVIDIA's CUDA C++
  documentation, the arithmetic-instruction throughput table): 128 fp32
  adds or multiplies (the kernels build with --fmad=false, so each is one
  instruction), 64 int32 adds, mins, maxes, compares or logical
  operations, 16 type conversions (Hopper's I2FP int->float conversion is
  taken at that rate too), and 64 fp32 compares, mins or maxes (the
  table's "compare, minimum, maximum" row);
- over 132 SMs, at the SM clock nvidia-smi reports as clocks.max.sm, or at
  the data sheet's 1980 MHz boost where that cannot be read (`sm_clock`
  says which);
- for a latency-bound kernel, its critical path: the cycles of its longest
  chain of dependent instructions, at latencies the card measured
  (`fill_loop_overhead.measure_latencies`), at the same clock.

The work is counted from the inputs of the call, not the most they could
need: `fill_work` counts the (anchor, predecessor) pairs K1's function
needs, by how far the per-slot score takes each; `backtrack_work` counts
the candidate visits and walk steps the backtrack needs, by running its
serial algorithm on the host; the peak detector's and the diff filter's
critical paths run to the longest row's live positions or events; the
banded DTW's operations to each pair's own columns.
"""

from __future__ import annotations

import functools
import subprocess

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
SMS = 132
PER_SM_PER_CLOCK = {"fp32": 128, "int32": 64, "cvt": 16, "fp32_minmax": 64}
BOOST_HZ = 1.98e9


@functools.cache
def sm_clock() -> tuple[float, str]:
    """(SM clock in Hz, where it came from)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60,
        )
        return float(out.stdout.split()[0]) * 1e6, "nvidia-smi clocks.max.sm"
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return BOOST_HZ, "data sheet boost clock"


def bound(nbytes: float, critical_path: float | None = None, **ops: float) -> dict:
    """The largest of the bytes over the memory rate, each class of
    operations (`fp32=`, `int32=`, `cvt=`, `fp32_minmax=` counts) over its
    own rate and, where given, the critical path: the cycles of the work's longest chain
    of dependent instructions (at latencies measured on the card) at the SM
    clock.  {bound_ms, bound_class ("bytes", "critical_path" or the class of
    operations), class_ms (each class's time)}."""
    hz = sm_clock()[0]
    ms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    for cls, n in ops.items():
        ms[cls] = n / (SMS * PER_SM_PER_CLOCK[cls] * hz) * 1e3
    if critical_path is not None:
        ms["critical_path"] = critical_path / hz * 1e3
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_class": by, "class_ms": ms}


# K1's instructions for one (anchor, predecessor) pair, by how far rh_slot
# (csrc/chain_fill.cuh) takes the pair, as nvcc 12.8 compiles it for sm_90a
# (a compare and the logical operation joining it are one ISETP;
# --fmad=false keeps every fp32 multiply and add apart).  The kernel
# (csrc/chain_fill.cu) finds each anchor's in-band suffix with rh_in_band,
# scores the suffix's pairs with rh_pair_total (rh_slot's tests and score)
# and keeps their maxima with rh_scan_add (chain_fill.cuh).  Left out,
# so the bound stays a lower one: the ring slot's index, the shared-memory
# loads, the scan's ballot and loop, the warp reductions, segment starts,
# and the per-anchor step.
FILL_COST = {
    # every tested pair: dr and the band test (rh_in_band)
    "tested": {"int32": 5},
    # in band: dq, the early-out tests, |dr - dq| and dd > bw (rh_slot), and
    # the (f, j) maximum of the in-band predecessors (rh_scan_add)
    "in_band": {"int32": 13},
    # scored: min(dr, dq), min(dg, q_span), the penalty test (rh_score), the
    # total (rh_slot) and its (total, j) maximum (rh_scan_add)
    "scored": {"int32": 10},
    # penalised (dd != 0 or dg > q_span): dd >= 1, two int->float
    # conversions, the linear penalty, the sum, the truncation, sc -= (rh_score)
    "penalised": {"int32": 2, "fp32": 4, "cvt": 3},
    # logged (dd >= 1): dd + 1, its conversion, rh_mg_log2 and the halving
    "logged": {"int32": 6, "fp32": 6, "cvt": 2},
}


def fill_work(key, tpos, qpos, n_anchors, *, q_span, max_dist_t, max_dist_q,
              bw, max_iter, **_) -> dict:
    """Counts of the (anchor i, predecessor j) pairs, i < n_anchors,
    i - max_iter <= j < i, j >= 0, that K1's function needs on these inputs,
    by the furthest step of rh_slot each reaches.

    Anchors come sorted by (key, tpos), so the predecessors in band (same
    key, 0 <= dr <= max_dist_t) are a suffix of each window: the function
    needs the band test only on that suffix and on the one predecessor past
    it that ends the scan (minimap2's lchain moves its `st` so).  `tested`
    counts those, `in_band` and the later steps the pairs in band;
    `unsorted` counts pairs in band past a pair out of band, which sorted
    inputs never have (the counts are then no bound).  Counted with tensor
    operations on the inputs' device, one window offset at a time.  The
    distance limits are clamped to >= bw, as chain_fill passes them to the
    kernel."""
    mdt, mdq = max(max_dist_t, bw), max(max_dist_q, bw)
    b, n = key.shape
    live = torch.arange(n, device=key.device)[None, :] < n_anchors[:, None]
    run = live.clone()  # anchor i's window in band at every offset so far
    counts = {k: torch.zeros((), dtype=torch.int64, device=key.device)
              for k in (*FILL_COST, "unsorted")}
    for d in range(1, min(max_iter, n - 1) + 1):
        on = run[:, d:]
        dr = tpos[:, d:] - tpos[:, :-d]
        dq = qpos[:, d:] - qpos[:, :-d]
        in_band = (live[:, d:] & (key[:, d:] == key[:, :-d]) & (dr >= 0)
                   & (dr <= mdt))
        dd = (dr - dq).abs()
        scored = (in_band & (dq > 0) & (dq <= mdq) & (dr != 0) & (dr <= mdq)
                  & (dd <= bw))
        penalised = scored & ((dd != 0) | (torch.minimum(dr, dq) > q_span))
        for name, mask in (("tested", on), ("unsorted", in_band & ~on),
                           ("in_band", in_band), ("scored", scored),
                           ("penalised", penalised),
                           ("logged", scored & (dd != 0))):
            counts[name] = counts[name] + mask.sum()
        run[:, d:] = on & in_band
    return {k: int(v) for k, v in counts.items()}


def fill_ops(work: dict) -> dict:
    """Operations by class for K1's pair counts (`fill_work`)."""
    ops = {"int32": 0.0, "fp32": 0.0, "cvt": 0.0}
    for step, cost in FILL_COST.items():
        for cls, per in cost.items():
            ops[cls] += per * work[step]
    return ops


def fill_segments(key, tpos, n_anchors, *, max_dist_t, bw, **_) -> dict:
    """The chain segments of rows sorted by (unsigned key, tpos), as K1
    splits them (csrc/chain_fill.cuh: rh_segment_start): a live anchor
    starts one when it is a row's first or the anchor before it is out of
    its band (another key, or tpos not in [0, max_dist_t] behind, with
    max_dist_t clamped to >= bw).  {segments, longest, singletons, stepped}:
    stepped counts the anchors past a segment's first, which the kernel
    steps one by one.  Counted with tensor operations on the inputs'
    device."""
    mdt = max(max_dist_t, bw)
    b, n = key.shape
    if n == 0:
        return {"segments": 0, "longest": 0, "singletons": 0, "stepped": 0}
    live = torch.arange(n, device=key.device)[None, :] < n_anchors[:, None]
    dr = tpos[:, 1:] - tpos[:, :-1]
    band = (key[:, 1:] == key[:, :-1]) & (dr >= 0) & (dr <= mdt)
    start = live & torch.nn.functional.pad(~band, (1, 0), value=True)
    # a live anchor ends a segment when the next one starts one or is not live
    end = live & torch.nn.functional.pad(start[:, 1:] | ~live[:, 1:], (0, 1),
                                         value=True)
    # starts and ends alternate along each row, so in row-major order the
    # k-th start and the k-th end bound the k-th segment
    length = end.flatten().nonzero() - start.flatten().nonzero() + 1
    n_seg = int(length.numel())
    return {"segments": n_seg,
            "longest": int(length.max()) if n_seg else 0,
            "singletons": int((length == 1).sum()),
            "stepped": int(live.sum()) - n_seg}


# The backtrack's int32 instructions for each unit of its work (csrc/
# chain_backtrack.cuh: rh_backtrack_read, rh_bt_walk), counted from the
# source; left out, so the bound stays a lower one: loop control, address
# arithmetic, loads and stores.
BACKTRACK_COST = {
    # the claimed bit of the candidate: shift, mask, test
    "candidates": 3,
    # s = zsc - f, better, the drop and its test, the max, the root test and
    # the claimed bit of the node
    "walk_steps": 9,
    # the claimed bit set and the end test
    "claim_steps": 4,
    # the fuzzy lengths of a kept chain's pair: two differences, min, max,
    # two tests, the select, three adds
    "v_writes": 10,
    # the acceptance tests and k_cap
    "kept": 4,
}


def backtrack_work(f, p, n_anchors, tpos, qpos, *, min_cnt, min_sc, max_drop,
                   k_cap, q_span) -> dict:
    """The work the backtrack needs on these inputs, counted by its serial
    algorithm on the host (rh_backtrack_read via chain/backtrack.py::
    backtrack_host_serial, g++), summed over the rows: candidates (f >=
    min_sc) visited, of them skipped as claimed, walk-A steps, claim steps,
    kept chains and v writes; `live` anchors; and `serial_steps_max`, the
    largest row's candidates + walk steps + claim steps, the length of its
    chain of dependent steps."""
    from ..chain.backtrack import backtrack_host_serial

    _, work = backtrack_host_serial(
        f, p, n_anchors, tpos, qpos, min_cnt=min_cnt, min_sc=min_sc,
        max_drop=max_drop, k_cap=k_cap, q_span=q_span)
    n = f.shape[1]
    live = n_anchors.cpu().long().clamp(0, n)
    names = ("candidates", "skipped", "walk_steps", "claim_steps", "kept",
             "v_writes")
    out = {k: int(work[:, i].sum()) for i, k in enumerate(names)}
    serial = work[:, 0] + work[:, 2] + work[:, 3]
    out["live"] = int(live.sum())
    out["serial_steps_max"] = int(serial.max()) if len(serial) else 0
    # p read once at most for each live anchor a walk passes
    out["p_reads"] = int(np.minimum(work[:, 2], live.numpy()).sum())
    return out


def backtrack_ops(work: dict) -> dict:
    """int32 operations for the backtrack's work (`backtrack_work`)."""
    return {"int32": float(sum(per * work[k] for k, per in BACKTRACK_COST.items()))}


def backtrack_bytes(work: dict, b: int) -> float:
    """The bytes the backtrack must move, each once: f of every live anchor
    (to find the candidates), p of the anchors the walks pass, tpos and qpos
    of each kept anchor, n_anchors; v of each kept anchor, six chain rows a
    kept chain, three counts a read."""
    return (4.0 * work["live"] + 4.0 * work["p_reads"] + 8.0 * work["v_writes"]
            + 4.0 * b + 4.0 * work["v_writes"] + 24.0 * work["kept"] + 12.0 * b)


# The dependent instructions a position or an event needs, one after the
# other, in the serial scans (one thread a read), by class, each priced at
# the dependent-issue latency the card measured (`measure_latencies`):
# "viaddmnmx", an integer or fp32 ALU instruction (Hopper's share that
# latency), and "fsetp_plop3_sel", an fp32 compare, a predicate op and a
# select in a row.  The peak detector (K5) runs its two detectors on two
# warps, so its chain is one detector's a position, counted along the short
# one's carried value (csrc/events_peaks.cuh): the drop val - cur, then its
# test, the predicate ops that join it into the take, and the select of
# the new value (the further predicate ops of the take left out).  Along
# csrc/diff_filter.cuh's last kept value: v - last, the |.| >= diff test,
# the select.  Fewer than the source has, so the bound stays a lower one.
PEAKS_CHAIN = {"viaddmnmx": 1, "fsetp_plop3_sel": 1}
DIFF_CHAIN = 3


def chain_cycles(chain: dict, lat: dict) -> float:
    """Cycles of one step of a chain counted by class (PEAKS_CHAIN), at the
    card's latencies."""
    return sum(n * lat[cls] for cls, n in chain.items())


def peaks_bound(b: int, l: int, n_live: int, lat: dict | None = None) -> dict:
    """The peak detector's (K5) bound on [B, L] t-statistics: both read
    once and two i32 emissions a position written (16 B L + 4 B bytes);
    with the card's latencies, the critical path of the longest row's
    n_live positions (the largest n_sig, clamped to L)."""
    return bound(16.0 * b * l + 4.0 * b, critical_path=None if lat is None else
                 n_live * chain_cycles(PEAKS_CHAIN, lat))


def events_stage_bound(b: int, l: int, e_cap: int, n_live: int, sig_bytes: int = 2,
                       lat: dict | None = None) -> dict:
    """The events stage's kernels' (csrc/events_fused.cu) bound on a [B, L]
    chunk: the stage's own inputs and outputs, the signal (sig_bytes a
    sample), the row lengths and the carry read, the events, their counts
    and the carry written (L sig_bytes + 4 e_cap + 32 B a row); with the
    card's latencies, the detector's critical path (peaks_bound), which the
    three launches run in series.  Beside it, `staged_bytes`: what the
    kernels hand each other through global memory, the clipped row and both
    t-statistics written and read again, the detector's two i32 emissions a
    position written and read (40 B L a row)."""
    out = bound(float(b * (l * sig_bytes + 4 * e_cap + 32)),
                critical_path=None if lat is None else
                n_live * chain_cycles(PEAKS_CHAIN, lat))
    return {**out, "staged_bytes": 40 * b * l}


def diff_filter_bound(b: int, e: int, n_live: int, lat: dict | None = None) -> dict:
    """The diff filter's (K7) bound on [B, E] events: read once, one byte an
    event written (5 B E + 4 B bytes); with the card's latencies, the
    critical path of the longest row's n_live events (the largest n_ev,
    clamped to E)."""
    return bound(5.0 * b * e + 4.0 * b, critical_path=None if lat is None else
                 n_live * DIFF_CHAIN * lat["viaddmnmx"])


def scan_adds(n: int, kind: str) -> int:
    """The f32 adds of one row's ordered prefix sum (kind "cumsum") or sum
    ("sum") of n values, as csrc/ordered_scan.cuh makes them: the padding's
    zeros included, every level."""
    block = 16 if kind == "cumsum" else 32
    sizes = [n]
    while sizes[-1] > block:
        sizes.append(-(-sizes[-1] // block))
    adds = sum(block * s for s in sizes[1:]) + sizes[-1]
    if kind == "cumsum":  # the down-sweep: a running sum and a carry a value
        adds += 2 * sum(sizes[:-1])
    return adds


def scan_bound(b: int, l: int, kind: str, squares: bool = False,
               lead_zero: bool = False) -> dict:
    """The ordered prefix sum's or sum's (K6) bound on [B, L] f32: each row
    read once and its sums written (4 B L, or 4 B), and its adds; squares:
    the sums of the squares too, in the same pass (the outputs and the adds
    twice, and a multiply a value); lead_zero: the prefix sum's rows with a
    0 in front (4 B more a row)."""
    k = 2 if squares else 1
    out = 4.0 * b * k * (l + int(lead_zero) if kind == "cumsum" else 1)
    return bound(4.0 * b * l + out,
                 fp32=float(b * (k * scan_adds(l, kind) + (l if squares else 0))))


# The banded DTW's (K8) work a band slot a column, as the plain version
# (dtw/device.py::dtw_banded_batch_plain) and csrc/dtw_banded.cuh compute
# it: the adds |a - b|, min(left, topleft) + cost, bm - csum and
# cummin + csum, and the mins min(left, topleft), min(., BIG), the running
# minimum and min(new, BIG); csum's own adds are `xla_adds`.  The selects
# and the integer work of the band are left out, so the bound stays a lower
# one.
DTW_SLOT = {"fp32": 4, "fp32_minmax": 4}


def xla_adds(n: int) -> int:
    """The f32 adds of XLA's CPU prefix sum of n values as csrc/
    dtw_banded.cuh takes it: a level of more than 16 values adds inside its
    blocks of 16 and adds each value to the sum of the blocks before it,
    then its block totals are summed one level up; the top level (at most
    16 values) adds in order."""
    adds = 0
    while n > 16:
        blocks = -(-n // 16)
        adds += (n - blocks) + n
        n = blocks
    return adds + max(n - 1, 0)


def dtw_bound(pairs: int, max_len: int, width: int, lat: dict | None = None, *,
              columns: int | None = None, values: int | None = None) -> dict:
    """The banded DTW's (K8) bound on a call of `pairs` pairs padded to
    max_len with a band `width` slots wide: each pair's a and b values read
    once (`values`, the sum of the pairs' a_len and b_len; 2 pairs max_len
    if not given), its lengths and radius read and its cost written (16 B a
    pair); DTW_SLOT and xla_adds(width) a slot a column over `columns`
    columns (the sum of the pairs' a_len, column 0 included; pairs max_len if
    not given); with the card's latencies, the longest pair's max_len
    columns, each the chain that carries a column's dp to the next:
    min(left, topleft), + cost, min(., BIG), - csum, a running minimum over
    the band in ceil(log2 width) steps, + csum, min(., BIG) and the select of
    a valid slot, each at the ALU latency.  csum is not on that chain: it
    depends on a and b alone, so a column's can be summed before the column
    before it ends."""
    columns = pairs * max_len if columns is None else columns
    values = 2 * pairs * max_len if values is None else values
    ops = {cls: float(columns * width * n) for cls, n in DTW_SLOT.items()}
    ops["fp32"] += float(columns * xla_adds(width))
    chain = 7 + max(width - 1, 0).bit_length()
    return bound(4.0 * values + 16.0 * pairs,
                 critical_path=None if lat is None else
                 max_len * chain * lat["viaddmnmx"], **ops)
