"""Host DTW: oracle implementations + chain evaluation (RawAlign parity).

  * dtw_global_np   — full O(nm) DTW, |a-b| cost, global borders
                      (reference: DTW_global, dtw.cpp:37-66)
  * dtw_banded_np   — slanted-band DTW following the n:m diagonal
                      (reference: DTW_global_slantedbanded, dtw.cpp:167-271;
                      the antidiagonalwise variant computes the same values)
  * align_chain_host — per-chain evaluation, global or sparse
                      (anchor-to-anchor) modes with early termination
                      (reference: align_chain, rmap.cpp:128-208)
"""

from __future__ import annotations

import numpy as np

from ..config import DtwBorderConstraint, DtwFillMethod

BIG = np.float32(1e10)


def dtw_global_np(a: np.ndarray, b: np.ndarray, exclude_last: bool = False) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    n, m = a.shape[0], b.shape[0]
    dp = np.abs(a - b[0]).astype(np.float32)
    dp = np.cumsum(dp, dtype=np.float32)
    for i in range(1, m):
        cost = np.abs(a - b[i]).astype(np.float32)
        new = np.empty_like(dp)
        new[0] = dp[0] + cost[0]
        # sequential min over (top, left, topleft); vectorize partially:
        # left depends on new[j-1] -> do the classic one-pass loop
        topleft = dp[0]
        for j in range(1, n):
            best = min(new[j - 1], dp[j], topleft)
            topleft = dp[j]
            new[j] = best + cost[j]
        dp = new
    res = float(dp[n - 1])
    if exclude_last:
        res -= float(np.float32(abs(float(a[n - 1]) - float(b[m - 1]))))
    return res


def dtw_banded_np(
    a: np.ndarray, b: np.ndarray, band_radius: int, exclude_last: bool = False
) -> float:
    """Slanted-band DTW (port of DTW_global_slantedbanded, dtw.cpp:167-271).
    The band of width 2r+1 tracks the main diagonal of the (possibly swapped
    so a is longer) rectangle."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape[0] < b.shape[0]:
        a, b = b, a
    al, bl = a.shape[0], b.shape[0]
    r = int(band_radius)
    width = 2 * r + 1
    dp = np.full(width, BIG, dtype=np.float32)
    prev = np.float32(0.0)
    for off in range(0, min(r, bl - 1) + 1):
        cur = prev + np.float32(abs(float(a[0]) - float(b[off])))
        dp[r + off] = cur
        prev = cur
    center = 0
    for i in range(1, al):
        inc = (center + 1) * al <= bl * i
        if inc:
            center += 1
        lo = max(-r, -center)
        hi = min(r, bl - center - 1)
        top = BIG
        topleft = dp[r + lo] if (inc and center + lo > 0) else BIG
        for off in range(lo, hi + 1):
            j = center + off
            if inc:
                left = BIG if off == r else dp[r + off + 1]
            else:
                left = dp[r + off]
            c = min(top, left, topleft) + np.float32(abs(float(a[i]) - float(b[j])))
            dp[r + off] = c
            top = c
            topleft = left
    res = float(dp[r + (bl - 1 - center)])
    if exclude_last:
        res -= float(np.float32(abs(float(a[al - 1]) - float(b[bl - 1]))))
    return res


def dtw_semiglobal_np(a: np.ndarray, b: np.ndarray,
                      exclude_last: bool = False) -> float:
    """Semiglobal DTW: `a` aligned fully against the best-matching substring
    of `b` (reference: DTW_semiglobal, dtw.cpp:526-550; like the reference's
    rolling variant, the exclude_last flag is accepted but unused)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    n, m = a.shape[0], b.shape[0]
    dp = np.full(n, BIG, dtype=np.float32)
    best = np.float32(BIG)
    for i in range(m):
        old_left = dp[0]
        dp[0] = np.float32(abs(float(a[0]) - float(b[i])))
        for j in range(1, n):
            top = dp[j - 1]
            left = dp[j]
            c = min(top, left, old_left) + np.float32(abs(float(a[j]) - float(b[i])))
            old_left = left
            dp[j] = c
        best = min(best, dp[n - 1])
    return float(best)


def _dtw_traceback(dp: np.ndarray, a: np.ndarray, b: np.ndarray,
                   i: int, j: int, stop_at_i0: bool):
    """Shared traceback walk (reference: dtw.cpp:616-654, 699-737)."""
    rev = [(i, j, float(np.float32(abs(float(a[i]) - float(b[j])))))]
    while (i > 0) if stop_at_i0 else (i > 0 or j > 0):
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            left = dp[i - 1, j]
            top = dp[i, j - 1]
            topleft = dp[i - 1, j - 1]
            if left < min(top, topleft):
                i -= 1
            elif top < min(left, topleft):
                j -= 1
            else:
                i -= 1
                j -= 1
        rev.append((i, j, float(np.float32(abs(float(a[i]) - float(b[j]))))))
    return rev[::-1]


def _dtw_fill_full(a: np.ndarray, b: np.ndarray, semiglobal: bool) -> np.ndarray:
    n, m = a.shape[0], b.shape[0]
    dp = np.empty((n, m), dtype=np.float32)
    dp[0, 0] = np.float32(abs(float(a[0]) - float(b[0])))
    for i in range(1, n):
        dp[i, 0] = dp[i - 1, 0] + np.float32(abs(float(a[i]) - float(b[0])))
    row0 = np.abs(a[0] - b).astype(np.float32)
    dp[0, 1:] = row0[1:] if semiglobal else np.cumsum(row0, dtype=np.float32)[1:]
    for i in range(1, n):
        cost = np.abs(a[i] - b).astype(np.float32)
        prev = dp[i - 1]
        cur = dp[i]
        for j in range(1, m):
            cur[j] = min(prev[j], cur[j - 1], prev[j - 1]) + cost[j]
    return dp


def dtw_global_tb_np(a: np.ndarray, b: np.ndarray, exclude_last: bool = False):
    """Full-matrix global DTW with traceback; returns (cost,
    [(i, j, |a_i-b_j|)]) (reference: DTW_global_tb, dtw.cpp:595-667)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    n, m = a.shape[0], b.shape[0]
    dp = _dtw_fill_full(a, b, semiglobal=False)
    alignment = _dtw_traceback(dp, a, b, n - 1, m - 1, stop_at_i0=False)
    cost = float(dp[n - 1, m - 1])
    if exclude_last:
        cost -= float(np.float32(abs(float(a[n - 1]) - float(b[m - 1]))))
        alignment = alignment[:-1]
    return cost, alignment


def dtw_semiglobal_tb_np(a: np.ndarray, b: np.ndarray, exclude_last: bool = False):
    """Semiglobal DTW with traceback: `a` global, best end anywhere in `b`
    (reference: DTW_semiglobal_tb, dtw.cpp:669-753)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    n, m = a.shape[0], b.shape[0]
    dp = _dtw_fill_full(a, b, semiglobal=True)
    best_j = int(np.argmin(dp[n - 1]))
    alignment = _dtw_traceback(dp, a, b, n - 1, best_j, stop_at_i0=True)
    cost = float(dp[n - 1, best_j])
    if exclude_last:
        cost -= alignment[-1][2]
        alignment = alignment[:-1]
    return cost, alignment


def align_chain_host(
    chain, bx: np.ndarray, by: np.ndarray, index, read_events: np.ndarray,
    mopt, min_score: float = -1e10,
) -> None:
    """Evaluate one chain with DTW against the stored expected signal
    (reference: align_chain, rmap.cpp:128-208). Sets chain.alignment_score."""
    rid = chain.rid
    ref = (index.R[rid] if chain.rev else index.F[rid]) if index.F else None
    if ref is None:
        chain.alignment_score = 0.0
        return
    banded = mopt.dtw_fill_method == DtwFillMethod.BANDED
    dtw_cost = 0.0
    num_aligned = 0
    if mopt.dtw_border_constraint == DtwBorderConstraint.GLOBAL:
        rev = ref[chain.rs : chain.re + 1]
        qev = read_events[chain.qs : chain.qe + 1]
        qlen = qev.shape[0]
        if qlen * mopt.dtw_match_bonus < min_score:
            chain.alignment_score = -1e10
            return
        if rev.shape[0] == 0 or qlen == 0:
            chain.alignment_score = 0.0
            return
        if banded:
            from .banded import dtw_banded_vec

            radius = max(1, int(qlen * mopt.dtw_band_radius_frac))
            dtw_cost = dtw_banded_vec(qev, rev, radius)
        else:
            dtw_cost = dtw_global_np(qev, rev)
        num_aligned = qlen
    elif mopt.dtw_border_constraint == DtwBorderConstraint.SPARSE:
        parts = chain.cnt - 1
        qfull = chain.qe - chain.qs + 1
        max_attainable = qfull * mopt.dtw_match_bonus
        k0 = chain.as_
        for part in range(parts):
            x0 = int(bx[k0 + part]) & 0xFFFFFFFF
            x1 = int(bx[k0 + part + 1]) & 0xFFFFFFFF
            y0 = int(by[k0 + part]) & 0xFFFFFFFF
            y1 = int(by[k0 + part + 1]) & 0xFFFFFFFF
            rev = ref[x0 : x1 + 1]
            qev = read_events[y0 : y1 + 1]
            if max_attainable < min_score:
                chain.alignment_score = -1e10
                return
            if rev.shape[0] == 0 or qev.shape[0] == 0:
                continue
            exclude_last = part != parts - 1
            if banded:
                from .banded import dtw_banded_vec

                radius = max(1, int(qev.shape[0] * mopt.dtw_band_radius_frac))
                sub = dtw_banded_vec(qev, rev, radius, exclude_last)
            else:
                sub = dtw_global_np(qev, rev, exclude_last)
            dtw_cost += sub
            max_attainable -= sub
            num_aligned += qev.shape[0]
    else:
        raise ValueError("unsupported DTW border constraint")
    chain.alignment_score = num_aligned * mopt.dtw_match_bonus - dtw_cost
    from ..config import MapFlag

    if mopt.flag & MapFlag.DTW_LOG_SCORES:
        import sys

        print(
            f"chaining_score={chain.score} "
            f"alignment_score={chain.alignment_score:f}",
            file=sys.stderr,
        )
