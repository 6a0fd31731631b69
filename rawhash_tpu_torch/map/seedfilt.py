"""Optional seeding filters: high-occurrence streak selection and query
sketch frequency filtering (port of rawhash_tpu/map/seedfilt.py).

Both exist in the reference but are dormant there — `ri_seed_select` is
bypassed in favor of a plain occ>max_occ cut (reference: rseed.c:127-132) and
`ri_seed_mz_flt` is never called (reference: rmap.cpp:284).  They are provided
here for capability parity and can be applied on the host seed-hit arrays
before chaining.

Semantics (reference: rseed.c:8-48, rseed.c:156-180):

* seed_select: over seed hits sorted by query position, find maximal streaks
  of hits whose index occurrence exceeds `max_occ`, bounded by low-occurrence
  hits (or the array/query ends).  In each streak keep at most
  round(span/dist) hits — the ones with the LOWEST occurrence counts, ties
  broken toward earlier position (the reference's max-heap only evicts on a
  strictly smaller count), capped at 128 — and always filter hits whose
  occurrence exceeds `max_max_occ`.
* query_freq_filter: if a query produced more than `q_occ_max` sketches, drop
  every sketch whose hash value repeats in more than `q_occ_frac` of the
  query's own sketch stream.
"""

from __future__ import annotations

import numpy as np

MAX_MAX_HIGH_OCC = 128  # reference: rseed.c:6


def seed_select(
    occ: np.ndarray,
    q_pos: np.ndarray,
    qlen: int,
    max_occ: int,
    max_max_occ: int,
    dist: int,
) -> np.ndarray:
    """Filter mask (True = drop) over seed hits sorted by query position.

    occ[i] = index occurrence count of hit i, q_pos[i] = query event position
    (reference: ri_seed_select, rseed.c:8-48)."""
    occ = np.asarray(occ, dtype=np.int64)
    q_pos = np.asarray(q_pos, dtype=np.int64)
    n = occ.shape[0]
    flt = np.zeros(n, dtype=bool)
    if n <= 1:
        return flt
    high = occ > max_occ
    if not high.any():
        return flt
    low_idx = np.nonzero(~high)[0]
    bounds = np.concatenate([[-1], low_idx, [n]])
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        st, en = int(b0) + 1, int(b1)
        if en <= st:  # empty streak between adjacent low-occ hits
            continue
        ps = 0 if b0 < 0 else int(q_pos[b0])
        pe = int(qlen) if b1 == n else int(q_pos[b1])
        k = int((pe - ps) / dist + 0.499)
        keep = np.zeros(en - st, dtype=bool)
        if k > 0:
            k = min(k, MAX_MAX_HIGH_OCC, en - st)
            # k lowest-occurrence hits, ties to earlier index (stable)
            order = np.lexsort((np.arange(en - st), occ[st:en]))[:k]
            keep[order] = True
        flt[st:en] = ~keep
        flt[st:en] |= occ[st:en] > max_max_occ
    return flt


def query_freq_filter(
    hashes: np.ndarray, q_occ_max: int, q_occ_frac: float
) -> np.ndarray:
    """Keep mask (True = keep) over a query's sketch hash stream
    (reference: ri_seed_mz_flt, rseed.c:156-180; the reference zeroes and
    compacts in place — a boolean mask is the array-era equivalent)."""
    hashes = np.asarray(hashes)
    n = hashes.shape[0]
    if n <= q_occ_max or q_occ_frac <= 0.0 or q_occ_max <= 0:
        return np.ones(n, dtype=bool)
    _uniq, inv, counts = np.unique(hashes, return_inverse=True, return_counts=True)
    return counts[inv] <= n * q_occ_frac
