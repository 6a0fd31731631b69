"""Vectorized slanted-band DTW (antidiagonal-wavefront, numpy).

Production host path for chain evaluation: computes exactly the same values
as dtw/host.py::dtw_banded_np (itself a port of the reference's slanted-band
fill, dtw.cpp:167-271 — the antidiagonalwise variant, dtw.cpp:273-520, is the
reference's own SIMD-shaped formulation of the same recurrence) but advances
the whole 2r+1-wide band per step with numpy ops instead of a per-cell loop.
"""

from __future__ import annotations

import numpy as np

BIG = np.float32(1e10)


def dtw_banded_vec(
    a: np.ndarray, b: np.ndarray, band_radius: int, exclude_last: bool = False
) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape[0] < b.shape[0]:
        a, b = b, a
    al, bl = a.shape[0], b.shape[0]
    r = int(band_radius)
    width = 2 * r + 1

    dp = np.full(width, BIG, dtype=np.float32)
    hi0 = min(r, bl - 1)
    # first column: cumulative |a0 - b[0..hi0]|
    dp[r : r + hi0 + 1] = np.cumsum(np.abs(np.float32(a[0]) - b[: hi0 + 1]),
                                    dtype=np.float32)

    center = 0
    offs = np.arange(-r, r + 1)
    shifted = np.empty(width, dtype=np.float32)
    for i in range(1, al):
        inc = (center + 1) * al <= bl * i
        if inc:
            center += 1
        j = center + offs  # target rows of each band slot
        valid = (j >= 0) & (j < bl)
        cost = np.abs(a[i] - b[np.clip(j, 0, bl - 1)]).astype(np.float32)
        if inc:
            # band slid down: slot o's (left, topleft) come from previous
            # column's slots (o+1, o)
            shifted[:-1] = dp[1:]
            shifted[-1] = BIG
            left = shifted
            topleft = dp.copy()
            if center + (-r) <= 0:
                # reference guard: topleft at the band's lower edge is only
                # real when center_row + row_offset_start > 0
                topleft[max(0, -center + r)] = BIG
        else:
            left = dp.copy()
            topleft = np.empty(width, dtype=np.float32)
            topleft[0] = BIG
            topleft[1:] = dp[:-1]
        best = np.minimum(left, topleft)
        # 'top' couples slots within the column: new[o] = min(best[o]+cost[o],
        # new[o-1]+cost[o]).  Unrolled, new[o] = min_{k<=o}(best[k]+cost[k] +
        # cost[k+1..o]); with c = cumsum(cost) that is a prefix-min:
        #   new[o] = min_{k<=o}(best[k]+cost[k]-c[k]) + c[o]
        bm = best + cost
        c = np.cumsum(cost, dtype=np.float32)
        new = (np.minimum.accumulate(bm - c) + c).astype(np.float32)
        new[~valid] = BIG
        dp = new
    res = float(dp[r + (bl - 1 - center)])
    if exclude_last:
        res -= float(np.float32(abs(float(a[al - 1]) - float(b[bl - 1]))))
    return res
