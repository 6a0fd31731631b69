"""Batched DTW chain evaluation (RawAlign integration, device-backed).

The reference evaluates chains one at a time, each chain as a sequence of
small anchor-to-anchor banded DTWs with early termination against the best
score so far (align_chain, rmap.cpp:128-208).  On TPU the right shape is the
opposite: gather EVERY segment of EVERY chain of EVERY read in the batch,
run them as one padded device program (dtw/device.py), then replay the
reference's sequential accumulation/early-termination bookkeeping on the
host over the precomputed per-segment costs — the decisions are identical
because the costs are, but the thousands of tiny alignments run as a single
wavefront kernel instead of a Python loop.

Falls back to the scalar host path for the FULL fill method (full-matrix
DTW is not banded; it stays a host oracle until a batched full-DTW kernel
is warranted)."""

from __future__ import annotations

import sys

import numpy as np

from ..config import DtwBorderConstraint, DtwFillMethod, MapFlag
from .host import align_chain_host

NEG_INF = -1e10


def _log_score(mopt, chain, score) -> None:
    """--dtw-log-scores stderr line (reference: rmap.cpp:203-207; the
    reference logs only evaluations that reach the end of align_chain)."""
    if mopt.flag & MapFlag.DTW_LOG_SCORES:
        print(
            f"chaining_score={chain.score} alignment_score={score:f}",
            file=sys.stderr,
        )


def _chain_segments(chain, bx, by, ref, read_events, mopt):
    """Per-chain (qev, rev, exclude_last) segment list, mirroring
    align_chain's slicing (rmap.cpp:143-195)."""
    if mopt.dtw_border_constraint == DtwBorderConstraint.GLOBAL:
        rev = ref[chain.rs : chain.re + 1]
        qev = read_events[chain.qs : chain.qe + 1]
        return [(qev, rev, False)]
    segs = []
    parts = chain.cnt - 1
    k0 = chain.as_
    for part in range(parts):
        x0 = int(bx[k0 + part]) & 0xFFFFFFFF
        x1 = int(bx[k0 + part + 1]) & 0xFFFFFFFF
        y0 = int(by[k0 + part]) & 0xFFFFFFFF
        y1 = int(by[k0 + part + 1]) & 0xFFFFFFFF
        segs.append(
            (read_events[y0 : y1 + 1], ref[x0 : x1 + 1], part != parts - 1)
        )
    return segs


def _score_chain(chain, segs, costs, mopt, min_score: float) -> float:
    """Replay align_chain's accumulation over precomputed segment costs
    (rmap.cpp:143-201): same short-circuits, same early termination."""
    bonus = mopt.dtw_match_bonus
    if mopt.dtw_border_constraint == DtwBorderConstraint.GLOBAL:
        qev, rev, _ = segs[0]
        qlen = qev.shape[0]
        if qlen * bonus < min_score:
            return NEG_INF
        if rev.shape[0] == 0 or qlen == 0:
            return 0.0
        score = qlen * bonus - costs[0]
        _log_score(mopt, chain, score)
        return score
    qfull = chain.qe - chain.qs + 1
    max_attainable = qfull * bonus
    dtw_cost = 0.0
    num_aligned = 0
    for (qev, rev, _), sub in zip(segs, costs):
        if max_attainable < min_score:
            return NEG_INF
        if rev.shape[0] == 0 or qev.shape[0] == 0:
            continue
        dtw_cost += sub
        max_attainable -= sub
        num_aligned += qev.shape[0]
    score = num_aligned * bonus - dtw_cost
    _log_score(mopt, chain, score)
    return score


def evaluate_chains_batched(jobs, index, mopt, device="cuda") -> None:
    """Evaluate many reads' chains in one device program.

    jobs: list of (regs, bx, by, read_events) — one entry per read, with
    `regs` in decision order.  Sets reg.alignment_score in place with the
    same values/clamping as the per-read host path (engine's
    _dtw_evaluate semantics).  The segments' DTW runs on `device`."""
    if mopt.dtw_fill_method != DtwFillMethod.BANDED:
        for regs, bx, by, read_events in jobs:
            best_found = 0.0
            for r in regs:
                align_chain_host(
                    r, bx, by, index, read_events, mopt, min_score=best_found
                )
                best_found, r.alignment_score = _clamp(
                    r.alignment_score, best_found, mopt
                )
        return

    # pass 1: gather every segment of every chain
    per_chain = []  # (reg, segs, cost_slice_start)
    flat_pairs = []
    flat_radii = []
    for regs, bx, by, read_events in jobs:
        for r in regs:
            ref = (index.R[r.rid] if r.rev else index.F[r.rid]) if index.F else None
            if ref is None:
                per_chain.append((r, None, 0, 0))
                continue
            segs = _chain_segments(r, bx, by, ref, read_events, mopt)
            start = len(flat_pairs)
            for qev, rev, _ in segs:
                if qev.shape[0] == 0 or rev.shape[0] == 0:
                    continue
                flat_pairs.append((qev, rev))
                flat_radii.append(
                    max(1, int(qev.shape[0] * mopt.dtw_band_radius_frac))
                )
            per_chain.append((r, segs, start, len(flat_pairs) - start))

    # pass 2: one padded device program for all segments
    if flat_pairs:
        from .device import dtw_banded_batch_host

        all_costs = dtw_banded_batch_host(flat_pairs, flat_radii, device)
    else:
        all_costs = np.zeros(0, dtype=np.float32)

    # exclude_last subtracts the final cell's local cost (dtw.cpp:264-266)
    # pass 3: replay the sequential bookkeeping per read
    idx = 0
    ci = 0
    for regs, bx, by, read_events in jobs:
        best_found = 0.0
        for r in regs:
            reg, segs, start, ncost = per_chain[ci]
            ci += 1
            if segs is None:
                r.alignment_score = 0.0
                continue
            costs = []
            k = start
            for qev, rev, excl in segs:
                if qev.shape[0] == 0 or rev.shape[0] == 0:
                    costs.append(0.0)
                    continue
                c = float(all_costs[k])
                k += 1
                if excl:
                    c -= float(np.float32(abs(float(qev[-1]) - float(rev[-1]))))
                costs.append(c)
            score = _score_chain(r, segs, costs, mopt, best_found)
            best_found, r.alignment_score = _clamp(score, best_found, mopt)


def _clamp(score: float, best_found: float, mopt):
    """Post-evaluation clamping (engine decision preconditioning,
    reference: rmap.cpp:425-481 implicitly treats sub-threshold negatives
    as 'no alignment')."""
    if score >= mopt.dtw_min_score:
        return max(best_found, score), score
    if score < mopt.dtw_min_score and score < 0:
        return best_found, (0.0 if mopt.dtw_min_score > 0 else mopt.dtw_min_score)
    return best_found, score
