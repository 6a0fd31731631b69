"""Host-side (numpy) sketching: event-diff compaction + seed generation.

This is the index-build path (whole genomes, so it must be vectorized) and the
oracle for the device kernels.  Mirrors reference behaviour:

  * event-diff filter: an event is kept iff it differs from the last *kept*
    event by >= diff (first event always kept)
    (reference: src/rsketch.c:95,187 `if |v[f] - v[last_kept]| < diff: skip`)
  * e-event rolling pack of q-bit quantized codes, mixed with the 32-bit hash;
    a seed is emitted per kept event t >= e-1 with query position = position
    of the FIRST event in the window (the reference's circular sigBuf delays
    .y by e-1 kept steps: src/rsketch.c:105-113,180-202)
  * minimizer windows over the seed stream when w > 0
    (reference: ri_sketch_min, src/rsketch.c:55-141); we emit the set of all
    window minima including ties, which is the same seed set the reference's
    queue emits (emission order differs; downstream sorts anchors, so order
    is immaterial).

The sequential diff filter is solved without a scalar loop using a
next-pointer + pointer-doubling scheme (O(n log n) gathers), so genome-scale
compaction stays vectorized.
"""

from __future__ import annotations

import numpy as np

from .quantize import dynamic_quantize_np, hash32_np

RI_HASH_SHIFT = 6  # reference: src/rsketch.h:8
RI_ID_SHIFT = 32
RI_POS_SHIFT = 1


def diff_compact_indices(values: np.ndarray, diff: float) -> np.ndarray:
    """Indices of events kept by the event-diff filter, in order.

    kept[0] = 0; kept[t+1] = min{ i > kept[t] : |v[i] - v[kept[t]]| >= diff }.

    Vectorized: first compute next[i] = min{ j > i : |v[j]-v[i]| >= diff }
    with widening shifted comparisons, then extract the orbit of 0 under
    `next` by path doubling (P_{2t} = P_t ++ next^t[P_t]).
    """
    v = np.asarray(values, dtype=np.float32)
    n = v.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if diff <= 0.0:
        return np.arange(n, dtype=np.int64)

    nxt = np.full(n, n, dtype=np.int64)
    unresolved = np.ones(n, dtype=bool)
    d = 1
    max_rounds = 256
    while d <= max_rounds and d < n and unresolved[: n - d].any():
        hit = np.abs(v[d:] - v[: n - d]) >= diff
        newly = unresolved[: n - d] & hit
        nxt[: n - d][newly] = np.nonzero(newly)[0] + d
        unresolved[: n - d] &= ~hit
        d += 1
    # rare stragglers (signal flat for >max_rounds samples): scalar scan
    if d >= max_rounds:
        for i in np.nonzero(unresolved[: max(0, n - max_rounds)])[0]:
            rest = np.abs(v[i + max_rounds :] - v[i]) >= diff
            j = np.argmax(rest)
            if rest[j]:
                nxt[i] = i + max_rounds + j

    # orbit of 0 by path doubling; sentinel node n maps to itself
    jmp = np.concatenate([nxt, np.array([n], dtype=np.int64)])
    path = np.array([0], dtype=np.int64)
    while path[-1] != n and path.shape[0] <= n:
        path = np.concatenate([path, jmp[path]])
        jmp = jmp[jmp]
    return path[path < n]


def diff_compact_indices_slow(values: np.ndarray, diff: float) -> np.ndarray:
    """Scalar-loop oracle of the event-diff filter (for tests)."""
    v = np.asarray(values, dtype=np.float32)
    out = []
    last = None
    for i in range(v.shape[0]):
        if i > 0 and abs(float(v[i]) - last) < diff:
            continue
        last = float(v[i])
        out.append(i)
    return np.asarray(out, dtype=np.int64)


def pack_and_hash(codes: np.ndarray, e: int, q: int) -> np.ndarray:
    """Rolling e-event pack of q-bit codes -> 32-bit seed hash.

    codes: int array of kept quantized codes (already masked to q bits).
    Returns uint32 hashes for windows ending at t = e-1 .. len-1 (length
    len-e+1).  Only the low 32 bits of the packed word feed the hash
    (the reference's hash64 masks every step to 32 bits).
    """
    codes = np.asarray(codes, dtype=np.uint64)
    m = codes.shape[0]
    if m < e:
        return np.zeros(0, dtype=np.uint32)
    packed = np.zeros(m - e + 1, dtype=np.uint64)
    for j in range(e):
        packed |= codes[j : m - e + 1 + j] << np.uint64(q * (e - 1 - j))
    if q * e < 64:
        packed &= np.uint64((1 << (q * e)) - 1)
    return hash32_np(packed.astype(np.uint32))


def minimizer_mask(hashes: np.ndarray, w: int) -> np.ndarray:
    """Boolean mask of seeds that are the minimum (with ties) of at least one
    length-w window over the seed stream (reference: ri_sketch_min emits the
    window minimum and all equal-hash seeds as the window slides)."""
    m = hashes.shape[0]
    if m == 0:
        return np.zeros(0, dtype=bool)
    if m < w:
        # incomplete window: reference pushes the final (rightmost) minimum
        mask = np.zeros(m, dtype=bool)
        mn = hashes.min()
        mask[np.nonzero(hashes == mn)[0][-1]] = True
        return mask
    # window minima wmin[s] = min(h[s..s+w-1]) for s in 0..m-w
    wmin = hashes[: m - w + 1].copy()
    for dshift in range(1, w):
        np.minimum(wmin, hashes[dshift : m - w + 1 + dshift], out=wmin)
    # seed t emitted iff h[t] == wmin[s] for some window s containing t
    mask = np.zeros(m, dtype=bool)
    for dshift in range(w):
        lo, hi = dshift, dshift + (m - w + 1)
        mask[lo:hi] |= hashes[lo:hi] == wmin
    return mask


def sketch_events_np(
    values: np.ndarray,
    sid: int,
    strand: int,
    diff: float,
    w: int,
    e: int,
    q: int,
    k: int,
    fine_min: float,
    fine_max: float,
    fine_range: float,
    pos_offset: int = 0,
):
    """Sketch a stream of (normalized) event values into seeds.

    Returns (hashes uint32[N], y uint64[N]) where
      y = sid << 32 | (pos + pos_offset) << 1 | strand
    and each hash covers e consecutive kept events with pos = position of the
    first event of the window (reference: ri_sketch, src/rsketch.c:271-290).
    """
    values = np.asarray(values, dtype=np.float32)
    kept = diff_compact_indices(values, diff)
    codes = dynamic_quantize_np(
        values[kept], fine_min, fine_max, fine_range, 1 << q
    ) & np.int32((1 << q) - 1)
    hashes = pack_and_hash(codes, e, q)
    if hashes.shape[0] == 0:
        return hashes, np.zeros(0, dtype=np.uint64)
    pos = kept[: hashes.shape[0]]  # first event of each window
    if w:
        mask = minimizer_mask(hashes, w)
        hashes, pos = hashes[mask], pos[mask]
    y = (
        (np.uint64(sid) << np.uint64(RI_ID_SHIFT))
        | ((pos.astype(np.uint64) + np.uint64(pos_offset)) << np.uint64(RI_POS_SHIFT))
        | np.uint64(strand)
    )
    return hashes, y
