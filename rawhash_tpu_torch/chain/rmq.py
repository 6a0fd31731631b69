"""RMQ-based chaining (the reference's faster/looser alternative to DP).

Host port of mg_lchain_rmq (reference: lchain.c:532-756).  The reference uses
an augmented AVL tree (krmq.h) holding active anchors keyed by query position
with priority  f[j] + 0.5*chn_pen_gap*((int32)x_j + (int32)y_j); this port
keeps the active set as a y-sorted list with linear max-priority scans —
algorithmically simpler but decision-for-decision equivalent: the same
candidate is selected (max priority in the y-window), the same inner-window
refinement with the skip/t[] pruning runs, and the same backtracking follows.

The engine's default chainer is the device DP kernel; this mode exists for
`--rmq` capability parity and for the reference's bw-long re-chaining pass
(reference: rmap.cpp:332-340).
"""

from __future__ import annotations

import bisect

import numpy as np

from .host import (
    INT32_MIN,
    RI_ID_SHIFT,
    SPAN_MASK,
    _i32,
    chain_backtrack,
    compact_chains,
    mg_log2,
)


def comput_sc_simple(xi, yi, xj, yj, chn_pen_gap, chn_pen_skip):
    """reference: comput_sc_simple, lchain.c:557-580.
    Returns (sc, exact, width)."""
    dq = _i32(yi) - _i32(yj)
    dr = _i32(xi - xj)
    dd = dr - dq if dr > dq else dq - dr
    dg = dr if dr < dq else dq
    q_span = (yj >> RI_ID_SHIFT) & SPAN_MASK
    sc = q_span if q_span < dg else dg
    exact = dd == 0 and dg <= q_span
    if dd or dq > q_span:
        lin_pen = np.float32(chn_pen_gap) * np.float32(dd) + np.float32(
            chn_pen_skip
        ) * np.float32(dg)
        log_pen = np.float32(mg_log2(dd + 1)) if dd >= 1 else np.float32(0.0)
        sc -= int(lin_pen + np.float32(0.5) * log_pen)
    return sc, exact, dd


def lchain_rmq_fill_np(
    ax: np.ndarray,
    ay: np.ndarray,
    max_dist: int,
    max_dist_inner: int,
    bw: int,
    max_skip: int,
    cap_rmq_size: int,
    chn_pen_gap: float,
    chn_pen_skip: float,
):
    """Score-fill phase of mg_lchain_rmq (reference: lchain.c:648-738)."""
    n = ax.shape[0]
    if max_dist < bw:
        max_dist = bw
    if max_dist_inner <= 0 or max_dist_inner >= max_dist:
        max_dist_inner = 0
    X = [int(v) for v in ax]
    Y = [int(v) for v in ay]
    f = np.zeros(n, dtype=np.int32)
    p = np.full(n, -1, dtype=np.int64)
    t = np.full(n, -1, dtype=np.int64)

    # active set: parallel y-sorted lists of (y_low, idx); membership mirrors
    # the main tree; the inner tree holds the same elements under its own
    # eviction horizon
    act_y: list = []
    act_i: list = []
    inner_y: list = []
    inner_i: list = []
    in_main = np.zeros(n, dtype=bool)
    in_inner = np.zeros(n, dtype=bool)
    st = 0
    st_inner = 0
    i0 = 0
    for i in range(n):
        max_j = -1
        q_span = (Y[i] >> RI_ID_SHIFT) & SPAN_MASK
        max_f = q_span
        # delayed insert of anchors with smaller x (reference: lchain.c:653-666)
        if i0 < i and X[i0] != X[i]:
            for j in range(i0, i):
                yl = _i32(Y[j])
                pos = bisect.bisect_left(act_y, yl)
                while pos < len(act_y) and act_y[pos] == yl and act_i[pos] < j:
                    pos += 1
                act_y.insert(pos, yl)
                act_i.insert(pos, j)
                in_main[j] = True
                if max_dist_inner > 0:
                    pos = bisect.bisect_left(inner_y, yl)
                    while pos < len(inner_y) and inner_y[pos] == yl and inner_i[pos] < j:
                        pos += 1
                    inner_y.insert(pos, yl)
                    inner_i.insert(pos, j)
                    in_inner[j] = True
            i0 = i
        # evict out-of-range (reference: lchain.c:668-687)
        while st < i and (
            (X[i] >> 32) != (X[st] >> 32)
            or X[i] - X[st] > max_dist
            or len(act_y) > cap_rmq_size
        ):
            if in_main[st]:
                yl = _i32(Y[st])
                pos = bisect.bisect_left(act_y, yl)
                while pos < len(act_y) and act_i[pos] != st:
                    pos += 1
                if pos < len(act_y):
                    act_y.pop(pos)
                    act_i.pop(pos)
                in_main[st] = False
            st += 1
        if max_dist_inner > 0:
            while st_inner < i and (
                (X[i] >> 32) != (X[st_inner] >> 32)
                or X[i] - X[st_inner] > max_dist_inner
                or len(inner_y) > cap_rmq_size
            ):
                if in_inner[st_inner]:
                    yl = _i32(Y[st_inner])
                    pos = bisect.bisect_left(inner_y, yl)
                    while pos < len(inner_y) and inner_i[pos] != st_inner:
                        pos += 1
                    if pos < len(inner_y):
                        inner_y.pop(pos)
                        inner_i.pop(pos)
                    in_inner[st_inner] = False
                st_inner += 1
        # RMQ: max priority within y-range (reference: lchain.c:689-696)
        lo_y = _i32(Y[i]) - max_dist
        hi_y = _i32(Y[i])
        lo = bisect.bisect_left(act_y, lo_y)
        hi = bisect.bisect_right(act_y, hi_y)
        if hi > lo:
            best = None
            best_pri = None
            for pos in range(lo, hi):
                j = act_i[pos]
                pri = float(f[j]) + 0.5 * chn_pen_gap * (_i32(X[j]) + _i32(Y[j]))
                if best_pri is None or pri > best_pri:
                    best_pri = pri
                    best = j
            j = best
            sc, exact, width = comput_sc_simple(
                X[i], Y[i], X[j], Y[j], chn_pen_gap, chn_pen_skip
            )
            sc += int(f[j])
            if width <= bw and sc > max_f:
                max_f, max_j = sc, j
            # inner refinement (reference: lchain.c:697-724)
            if (not exact) and max_dist_inner > 0 and _i32(Y[i]) > 0:
                n_skip = 0
                hi2 = bisect.bisect_right(inner_y, _i32(Y[i]) - 1)
                for pos in range(hi2 - 1, -1, -1):
                    if inner_y[pos] < _i32(Y[i]) - max_dist_inner:
                        break
                    j = inner_i[pos]
                    sc, _ex, width = comput_sc_simple(
                        X[i], Y[i], X[j], Y[j], chn_pen_gap, chn_pen_skip
                    )
                    sc += int(f[j])
                    if width <= bw:
                        if sc > max_f:
                            max_f, max_j = sc, j
                            if n_skip > 0:
                                n_skip -= 1
                        elif t[j] == i:
                            n_skip += 1
                            if n_skip > max_skip:
                                break
                        if p[j] >= 0:
                            t[p[j]] = i
        f[i] = max_f
        p[i] = max_j
    return f, p


def lchain_rmq_np(
    ax, ay, max_dist, max_dist_inner, bw, max_skip, cap_rmq_size,
    min_cnt, min_sc, chn_pen_gap, chn_pen_skip,
):
    """Full RMQ chaining = fill + backtrack + compaction
    (reference: mg_lchain_rmq, lchain.c:606-756).

    The fill and tail run natively (C++, _native/chain_tail.cpp) when the
    toolchain is available — bit-identical to this module's numpy oracle
    (tested) — so `--rmq` / `--bw-long` configs are not Python-rate."""
    import os

    if ax.shape[0] == 0:
        e = np.zeros(0, dtype=np.uint64)
        return np.zeros((0, 2), dtype=np.int64), e, e.copy(), e.copy(), e.copy()
    if not os.environ.get("RAWHASH_TPU_NO_NATIVE_RMQ"):
        from .._native import chain_tail_native, rmq_fill_native

        filled = rmq_fill_native(
            ax, ay, max_dist, max_dist_inner, bw, max_skip, cap_rmq_size,
            chn_pen_gap, chn_pen_skip,
        )
        if filled is not None:
            tail = chain_tail_native(
                filled[0], filled[1], ax, ay, min_cnt, min_sc, bw
            )
            if tail is not None:
                return tail
    f, p = lchain_rmq_fill_np(
        ax, ay, max_dist, max_dist_inner, bw, max_skip, cap_rmq_size,
        chn_pen_gap, chn_pen_skip,
    )
    u, v = chain_backtrack(f, p, min_cnt, min_sc, max_drop=bw)
    return compact_chains(u, v, ax, ay)
