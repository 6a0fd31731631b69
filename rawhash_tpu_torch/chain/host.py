"""Host-side chaining: faithful port of the reference DP chainer and the
(inherently sequential) backtracking shared by the device path.

Anchors use the reference's 128-bit packing, carried as two uint64 numpy
arrays (reference: rmap.cpp:51-126):
    x = rev<<63 | tid<<32 | t_pos
    y = seg<<40 | q_span<<32 | q_pos

 * lchain_dp_np        — scalar port of mg_lchain_dp (reference:
                         lchain.c:385-530) including the max_skip/t[] pruning
                         heuristics; the oracle for the device scan kernel.
 * chain_backtrack     — port of mg_chain_backtrack (lchain.c:95-194).
 * compact_chains      — port of compact_a (lchain.c:214-281): groups chain
                         anchors and sorts chains by target position.
 * mg_log2             — the reference's bit-twiddled fast log2
                         (lchain.c:23-31), replicated exactly so chain scores
                         match to the integer.
"""

from __future__ import annotations

import numpy as np

RI_HASH_SHIFT = 6
RI_ID_SHIFT = 32
SPAN_MASK = (1 << RI_HASH_SHIFT) - 1
INT32_MIN = -(2**31)


def mg_log2(x: float) -> float:
    """Fast approximate log2 (reference: lchain.c:23-31). Only called with
    x >= 2 by the scorer."""
    z = np.float32(x).view(np.uint32)
    log_2 = np.float32(int((z >> np.uint32(23)) & np.uint32(255)) - 128)
    z = (z & np.uint32(~(255 << 23) & 0xFFFFFFFF)) + np.uint32(127 << 23)
    zf = z.view(np.float32)
    log_2 += (np.float32(-0.34484843) * zf + np.float32(2.02466578)) * zf - np.float32(
        0.67487759
    )
    return float(log_2)


def _i32(v: int) -> int:
    """Two's-complement int32 truncation of a python int."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def compute_score(
    xi: int, yi: int, xj: int, yj: int,
    max_dist_t, max_dist_q, bw, chn_pen_gap, chn_pen_skip,
) -> int:
    """Pairwise chaining score (reference: compute_score, lchain.c:297-356).
    Operates on python ints (anchor x/y words)."""
    dq = _i32(yi) - _i32(yj)
    if dq <= 0 or dq > max_dist_q:
        return INT32_MIN
    dr = _i32(xi - xj)
    if dr == 0 or dr > max_dist_t:
        return INT32_MIN
    dd = dr - dq if dr > dq else dq - dr
    if dd > bw or dr > max_dist_q:
        return INT32_MIN
    dg = dr if dr < dq else dq
    q_span = (yj >> RI_ID_SHIFT) & SPAN_MASK
    sc = q_span if q_span < dg else dg
    if dd or dg > q_span:
        # all-float32 penalty arithmetic, as in the C reference
        lin_pen = np.float32(chn_pen_gap) * np.float32(dd) + np.float32(
            chn_pen_skip
        ) * np.float32(dg)
        log_pen = np.float32(mg_log2(dd + 1)) if dd >= 1 else np.float32(0.0)
        sc -= int(lin_pen + np.float32(0.5) * log_pen)
    return int(sc)


def lchain_dp_fill_np(
    ax: np.ndarray,
    ay: np.ndarray,
    max_dist_t: int,
    max_dist_q: int,
    bw: int,
    max_skip: int,
    max_iter: int,
    chn_pen_gap: float,
    chn_pen_skip: float,
):
    """Score-fill phase of mg_lchain_dp (reference: lchain.c:439-505).

    Returns (f, p): best score ending at each anchor and best-predecessor
    indices.  Includes the max_skip/t[] pruning and the banded max_ii
    shortcut, so scores are bit-identical to the reference."""
    n = ax.shape[0]
    if max_dist_t < bw:
        max_dist_t = bw
    if max_dist_q < bw:
        max_dist_q = bw
    X = [int(v) for v in ax]
    Y = [int(v) for v in ay]
    f = np.zeros(n, dtype=np.int32)
    p = np.full(n, -1, dtype=np.int64)
    t = np.full(n, -1, dtype=np.int64)
    st = 0
    max_ii = -1
    for i in range(n):
        max_j = -1
        max_f = (Y[i] >> RI_ID_SHIFT) & SPAN_MASK
        n_skip = 0
        while st < i and (
            (X[i] >> RI_ID_SHIFT) != (X[st] >> RI_ID_SHIFT)
            or X[i] - X[st] > max_dist_t
        ):
            st += 1
        if i - st > max_iter:
            st = i - max_iter
        j = i - 1
        while j >= st:
            sc = compute_score(
                X[i], Y[i], X[j], Y[j],
                max_dist_t, max_dist_q, bw, chn_pen_gap, chn_pen_skip,
            )
            if sc != INT32_MIN:
                sc += int(f[j])
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
            j -= 1
        end_j = j
        if max_ii < 0 or X[i] - X[max_ii] > max_dist_t:
            mx = INT32_MIN
            max_ii = -1
            for j2 in range(i - 1, st - 1, -1):
                if mx < f[j2]:
                    mx, max_ii = int(f[j2]), j2
        if 0 <= max_ii < end_j:
            tmp = compute_score(
                X[i], Y[i], X[max_ii], Y[max_ii],
                max_dist_t, max_dist_q, bw, chn_pen_gap, chn_pen_skip,
            )
            if tmp != INT32_MIN and max_f < tmp + int(f[max_ii]):
                max_f, max_j = tmp + int(f[max_ii]), max_ii
        f[i] = max_f
        p[i] = max_j
        if max_ii < 0 or (X[i] - X[max_ii] <= max_dist_t and f[max_ii] < f[i]):
            max_ii = i
    return f, p


def chain_backtrack(
    f: np.ndarray,
    p: np.ndarray,
    min_cnt: int,
    min_sc: int,
    max_drop: int,
):
    """Backtrack all chains (reference: mg_chain_backtrack, lchain.c:95-194).

    Returns (u, v): u = list of (score, n_anchors) per chain, in discovery
    order; v = int array of anchor indices, chain-major, each chain's anchors
    in reverse (end->start) order, exactly like the reference's v[]."""
    n = f.shape[0]
    zi = np.nonzero(f >= min_sc)[0]
    if zi.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int64), np.zeros(0, dtype=np.int64)
    # sort candidates by (score, index) ascending — the reference radix-sorts
    # (f, idx) pairs on f with a stable sort (lchain.c:130)
    order = np.argsort(f[zi], kind="stable")
    z_score = f[zi][order].astype(np.int64)
    z_idx = zi[order].astype(np.int64)

    t = np.zeros(n, dtype=np.int64)
    v = np.zeros(n, dtype=np.int64)
    n_v = 0
    u = []
    for k in range(z_idx.shape[0] - 1, -1, -1):
        if t[z_idx[k]] != 0:
            continue
        n_v0 = n_v
        # find the chain start (mg_chain_bk_end, lchain.c:47-75)
        end_i = _bk_end(max_drop, z_score, z_idx, f, p, t, k)
        i = z_idx[k]
        while i != end_i:
            v[n_v] = i
            n_v += 1
            t[i] = 1
            i = p[i]
        sc = int(z_score[k]) if i < 0 else int(z_score[k]) - int(f[i])
        if sc >= min_sc and n_v > n_v0 and n_v - n_v0 >= min_cnt:
            u.append((sc, n_v - n_v0))
        else:
            n_v = n_v0
    return np.asarray(u, dtype=np.int64).reshape(-1, 2), v[:n_v]


def _bk_end(max_drop, z_score, z_idx, f, p, t, k):
    """reference: mg_chain_bk_end, lchain.c:47-75."""
    i = z_idx[k]
    if i < 0 or t[i] != 0:
        return i
    max_i = i
    max_s = 0
    end_i = -1
    while True:
        t[i] = 2
        end_i = i = p[i]
        s = int(z_score[k]) if i < 0 else int(z_score[k]) - int(f[i])
        if s > max_s:
            max_s, max_i = s, i
        elif max_s - s > max_drop:
            break
        if not (i >= 0 and t[i] == 0):
            break
    i = z_idx[k]
    while i >= 0 and i != end_i:
        nxt = p[i]
        t[i] = 0
        i = nxt
    return max_i


def compact_chains(u: np.ndarray, v: np.ndarray, ax: np.ndarray, ay: np.ndarray):
    """Group chain anchors and sort chains by target position
    (reference: compact_a, lchain.c:214-281).

    Returns (u_sorted [(score, cnt)], bx, by (anchors, chain-major, chains
    sorted by first-anchor x), prev_x, prev_y (anchors in pre-sort chain
    order — the reference's *_a, carried to the next chunk))."""
    n_u = u.shape[0]
    if n_u == 0:
        e = np.zeros(0, dtype=np.uint64)
        return u, e, e.copy(), e.copy(), e.copy()
    cnts = u[:, 1]
    ends = np.cumsum(cnts)
    starts = ends - cnts
    # chain anchors in increasing order: v runs are reversed per chain
    idx = np.concatenate(
        [v[s : s + c][::-1] for s, c in zip(starts, cnts)]
    ).astype(np.int64)
    bx, by = ax[idx], ay[idx]
    prev_x, prev_y = bx.copy(), by.copy()
    # sort chains by their first anchor's x (stable, ties keep chain order)
    first_x = bx[starts]
    order = np.argsort(first_x, kind="stable")
    u_sorted = u[order]
    out_idx = np.concatenate(
        [np.arange(starts[c], ends[c]) for c in order]
    ) if n_u else np.zeros(0, dtype=np.int64)
    return u_sorted, bx[out_idx], by[out_idx], prev_x, prev_y


def lchain_dp_np(
    ax: np.ndarray,
    ay: np.ndarray,
    max_dist_t: int,
    max_dist_q: int,
    bw: int,
    max_skip: int,
    max_iter: int,
    min_cnt: int,
    min_sc: int,
    chn_pen_gap: float,
    chn_pen_skip: float,
):
    """Full host chaining = fill + backtrack + compaction
    (reference: mg_lchain_dp, lchain.c:385-530)."""
    if ax.shape[0] == 0:
        e = np.zeros(0, dtype=np.uint64)
        return np.zeros((0, 2), dtype=np.int64), e, e.copy(), e.copy(), e.copy()
    f, p = lchain_dp_fill_np(
        ax, ay, max_dist_t, max_dist_q, bw, max_skip, max_iter,
        chn_pen_gap, chn_pen_skip,
    )
    u, v = chain_backtrack(f, p, min_cnt, min_sc, max_drop=bw)
    return compact_chains(u, v, ax, ay)
