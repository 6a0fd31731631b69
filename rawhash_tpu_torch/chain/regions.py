"""Chains -> mapping regions: coordinates, primary/secondary assignment,
secondary pruning, MAPQ.  Host-side port of the reference's hit.c (arrays are
tiny per read — a handful of chains — so this is deliberately scalar).

  * gen_regs       (reference: mm_gen_regs, hit.c:100-150)
  * set_parent     (reference: mm_set_parent, hit.c:195-263)
  * select_sub     (reference: mm_select_sub, hit.c:338-367)
  * set_mapq       (reference: mm_set_mapq, hit.c:502-539)
  * Wang 32-bit hash (reference: khash.h __ac_Wang_hash) and the 64-bit
    tiebreak hash (reference: hit.c:73-83)
"""

from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np

RI_HASH_SHIFT = 6
RI_ID_SHIFT = 32
SPAN_MASK = (1 << RI_HASH_SHIFT) - 1
PARENT_UNSET = -1
PARENT_TMP_PRI = -2
M64 = (1 << 64) - 1


def wang_hash32(key: int) -> int:
    """reference: __ac_Wang_hash (khash.h)."""
    key = key & 0xFFFFFFFF
    key += ~(key << 15) & 0xFFFFFFFF
    key &= 0xFFFFFFFF
    key ^= key >> 10
    key += (key << 3) & 0xFFFFFFFF
    key &= 0xFFFFFFFF
    key ^= key >> 6
    key += ~(key << 11) & 0xFFFFFFFF
    key &= 0xFFFFFFFF
    key ^= key >> 16
    return key & 0xFFFFFFFF


def hash64(key: int) -> int:
    """64-bit mixing hash (reference: hit.c:73-83, no mask)."""
    key &= M64
    key = (~key + (key << 21)) & M64
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & M64
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & M64
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & M64
    return key


@dataclasses.dataclass
class Region:
    """One candidate mapping (reference: mm_reg1_t, chain.h:27-45)."""

    id: int = 0
    parent: int = PARENT_UNSET
    score: int = 0
    score0: int = 0
    hash: int = 0
    cnt: int = 0
    as_: int = 0  # start index into the chain-anchor array
    rev: int = 0
    rid: int = 0
    rs: int = 0
    re: int = 0
    qs: int = 0
    qe: int = 0
    mlen: int = 0
    blen: int = 0
    n_sub: int = 0
    subsc: int = 0
    mapq: int = 0
    inv: int = 0
    is_alt: int = 0
    strand_retained: int = 0
    alignment_score: float = 0.0


# the Region fields the native region pipeline writes, one int64 column each
# (_native/chain_tail.cpp), in its order
REGION_COLUMNS = (
    "id", "parent", "score", "score0", "hash", "cnt", "as_", "rev", "rid",
    "rs", "re", "qs", "qe", "mlen", "blen", "n_sub", "subsc", "inv", "is_alt",
    "strand_retained",
)
RegionRow = collections.namedtuple("RegionRow", REGION_COLUMNS + ("mapq",))


class RegionRows:
    """A read's regions as rows of the native batch decision's output
    (REGION_COLUMNS, then mapq): a sequence of read-only RegionRow, so a
    reader of Region lists reads these the same way."""

    __slots__ = ("rows",)

    def __init__(self, rows: np.ndarray):
        self.rows = rows

    def __len__(self) -> int:
        return self.rows.shape[0]

    def __getitem__(self, j: int) -> RegionRow:
        return RegionRow._make(self.rows[j].tolist())


def hash64_vec(key: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit mixing hash (reference: hit.c:73-83)."""
    key = key.astype(np.uint64)
    with np.errstate(over="ignore"):
        key = ~key + (key << np.uint64(21))
        key = key ^ (key >> np.uint64(24))
        key = key + (key << np.uint64(3)) + (key << np.uint64(8))
        key = key ^ (key >> np.uint64(14))
        key = key + (key << np.uint64(2)) + (key << np.uint64(4))
        key = key ^ (key >> np.uint64(28))
        key = key + (key << np.uint64(31))
    return key


def gen_regs(read_hash: int, n_u: int, u: np.ndarray, ax: np.ndarray, ay: np.ndarray):
    """Chains -> regions sorted by score with hashed tiebreak, coordinates and
    fuzzy match lengths computed vectorized over all chains at once
    (reference: mm_gen_regs + mm_reg_set_coor + mm_cal_fuzzy_len,
    hit.c:10-150).

    u: [(score, cnt)] in target-position order, matching (ax, ay)."""
    if n_u == 0:
        return []
    cnts = u[:, 1].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(cnts)[:-1]])
    lasts = starts + cnts - 1

    h = hash64_vec(
        (hash64_vec(ax[starts]) + hash64_vec(ay[starts]))
        ^ np.uint64(read_hash & 0xFFFFFFFF)
    ) & np.uint64(0xFFFFFFFF)
    with np.errstate(over="ignore"):
        zx = (
            (u[:, 0].astype(np.uint64) << np.uint64(32)) | u[:, 1].astype(np.uint64)
        ) ^ h

    # coordinates (mm_reg_set_coor)
    x0 = ax[starts]
    rev = (x0 >> np.uint64(63)).astype(np.int64)
    rid = ((x0 >> np.uint64(32)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
    rs = (x0 & np.uint64(0xFFFFFFFF)).astype(np.int64)
    re = (ax[lasts] & np.uint64(0xFFFFFFFF)).astype(np.int64) + 1
    qs = (ay[starts] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    qe = (ay[lasts] & np.uint64(0xFFFFFFFF)).astype(np.int64) + 1

    # fuzzy lengths (mm_cal_fuzzy_len) over all anchors, segment-summed
    n_a = ax.shape[0]
    span0 = ((ay[starts] >> np.uint64(RI_ID_SHIFT)) & np.uint64(SPAN_MASK)).astype(
        np.int64
    )
    if n_a > 1:
        spans = ((ay >> np.uint64(RI_ID_SHIFT)) & np.uint64(SPAN_MASK)).astype(np.int64)
        tl = (ax & np.uint64(0xFFFFFFFF)).astype(np.int64)
        ql = (ay & np.uint64(0xFFFFFFFF)).astype(np.int64)
        tl = np.diff(tl, prepend=tl[:1])
        ql = np.diff(ql, prepend=ql[:1])
        mx = np.maximum(tl, ql)
        mn = np.minimum(tl, ql)
        ml = np.where((tl > spans) & (ql > spans), spans, mn) + mn
        # zero out chain-first anchors, then segment-sum with cumsum gathers
        first_mask = np.zeros(n_a, dtype=bool)
        first_mask[starts] = True
        mx[first_mask] = 0
        mn_zeroed = np.where(first_mask, 0, ml)
        cb = np.concatenate([[0], np.cumsum(mx)])
        cm = np.concatenate([[0], np.cumsum(mn_zeroed)])
        blen = span0 + (cb[lasts + 1] - cb[starts])
        mlen = span0 + (cm[lasts + 1] - cm[starts])
    else:
        blen = span0.copy()
        mlen = span0.copy()

    order = np.argsort(zx, kind="stable")[::-1]
    regs = []
    for i, ci in enumerate(order):
        regs.append(
            Region(
                id=i,
                parent=PARENT_UNSET,
                score=int(zx[ci] >> np.uint64(32)),
                score0=int(zx[ci] >> np.uint64(32)),
                hash=int(zx[ci] & np.uint64(0xFFFFFFFF)),
                cnt=int(cnts[ci]),
                as_=int(starts[ci]),
                rev=int(rev[ci]),
                rid=int(rid[ci]),
                rs=int(rs[ci]),
                re=int(re[ci]),
                qs=int(qs[ci]),
                qe=int(qe[ci]),
                mlen=int(mlen[ci]),
                blen=int(blen[ci]),
            )
        )
    return regs


def gen_regs_from_summaries(read_hash: int, summ: np.ndarray, span: int):
    """Regions from the device-tail's per-chain summaries (chain coordinates,
    fuzzy lengths and counts were already aggregated on-device by
    chain/backtrack_device.py).  Produces the identical Region list (same
    hashed tiebreak sort) as gen_regs on the full anchor arrays
    (reference: mm_gen_regs + mm_reg_set_coor + mm_cal_fuzzy_len,
    hit.c:10-150).

    summ: i32 [K, 10] rows (target-sorted chains):
      score, cnt, key(u32 bits), tpos0, qpos0, tposL, qposL, mlen, blen,
      valid."""
    n_u = int(summ[:, 9].sum())
    if n_u == 0:
        return []
    s = summ[:n_u]
    key = s[:, 2].astype(np.uint32).astype(np.uint64)
    rev = (key >> np.uint64(31)).astype(np.int64)
    rid = (key & np.uint64(0x7FFFFFFF)).astype(np.int64)
    ax0 = (
        (rev.astype(np.uint64) << np.uint64(63))
        | (rid.astype(np.uint64) << np.uint64(32))
        | s[:, 3].astype(np.uint64)
    )
    ay0 = (np.uint64(span) << np.uint64(RI_ID_SHIFT)) | s[:, 4].astype(
        np.uint64
    )
    h = hash64_vec(
        (hash64_vec(ax0) + hash64_vec(ay0)) ^ np.uint64(read_hash & 0xFFFFFFFF)
    ) & np.uint64(0xFFFFFFFF)
    with np.errstate(over="ignore"):
        zx = (
            (s[:, 0].astype(np.uint64) << np.uint64(32))
            | s[:, 1].astype(np.uint64)
        ) ^ h
    cnts = s[:, 1].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(cnts)[:-1]])
    order = np.argsort(zx, kind="stable")[::-1]
    regs = []
    for i, ci in enumerate(order):
        regs.append(
            Region(
                id=i,
                parent=PARENT_UNSET,
                score=int(zx[ci] >> np.uint64(32)),
                score0=int(zx[ci] >> np.uint64(32)),
                hash=int(zx[ci] & np.uint64(0xFFFFFFFF)),
                cnt=int(cnts[ci]),
                as_=int(starts[ci]),
                rev=int(rev[ci]),
                rid=int(rid[ci]),
                rs=int(s[ci, 3]),
                re=int(s[ci, 5]) + 1,
                qs=int(s[ci, 4]),
                qe=int(s[ci, 6]) + 1,
                mlen=int(s[ci, 7]),
                blen=int(s[ci, 8]),
            )
        )
    return regs


def set_parent(regs, mask_level: float, mask_len: int, hard_mask_level: bool,
               alt_diff_frac: float) -> None:
    """Primary/secondary assignment by query-interval overlap
    (reference: mm_set_parent, hit.c:195-263)."""
    n = len(regs)
    if n <= 0:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    k = 1
    for i in range(1, n):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        uncov_len = 0
        if not hard_mask_level:
            cov = []
            for j in range(k):
                rp = regs[w[j]]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                cov.append((max(sj, si), min(ej, ei)))
            if cov:
                cov.sort()
                x = si
                for sj, ej in cov:
                    if sj > x:
                        uncov_len += sj - x
                    x = max(ej, x)
                if ei > x:
                    uncov_len += ei - x
            else:
                w.append(i)
                ri.parent = i
                ri.n_sub = 0
                k += 1
                continue
        placed = False
        for j in range(k):
            rp = regs[w[j]]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                continue
            mn = min(ej - sj, ei - si)
            mx = max(ej - sj, ei - si)
            if si < sj:
                ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
            else:
                ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
            if (ol / mn - uncov_len / mx) > mask_level and uncov_len <= mask_len:
                sci = ri.score
                ri.parent = rp.parent
                if (not rp.is_alt) and ri.is_alt:
                    sci = _alt_score(sci, alt_diff_frac)
                rp.subsc = max(rp.subsc, sci)
                if ri.cnt >= rp.cnt:
                    rp.n_sub += 1
                placed = True
                break
        if not placed:
            w.append(i)
            ri.parent = i
            ri.n_sub = 0
            k += 1


def _alt_score(score: int, alt_diff_frac: float) -> int:
    if score < 0:
        return score
    score = int(score * (1.0 - alt_diff_frac) + 0.499)
    return score if score > 0 else 1


def select_sub(regs, pri_ratio: float, best_n: int, check_strand: bool,
               min_strand_sc: int):
    """Prune secondaries (reference: mm_select_sub, hit.c:338-367).
    Returns the pruned list (parents re-synced)."""
    if pri_ratio <= 0.0 or len(regs) <= 0:
        return regs
    out = []
    n_2nd = 0
    for i, r in enumerate(regs):
        p = r.parent
        if p == i or r.inv:
            out.append(r)
        elif r.score >= regs[p].score * pri_ratio and n_2nd < best_n:
            rp = regs[p]
            if not (
                r.qs == rp.qs and r.qe == rp.qe and r.rid == rp.rid
                and r.rs == rp.rs and r.re == rp.re
            ):
                out.append(r)
                n_2nd += 1
        elif (
            check_strand and n_2nd < best_n and r.score > min_strand_sc
            and r.rev != regs[p].rev
        ):
            r.strand_retained = 1
            out.append(r)
            n_2nd += 1
    if len(out) != len(regs):
        _sync_regs(out)
    return out


def _sync_regs(regs) -> None:
    """reference: mm_sync_regs, hit.c:312-336."""
    if not regs:
        return
    tmp = {}
    for i, r in enumerate(regs):
        if r.id >= 0:
            tmp[r.id] = i
    for i, r in enumerate(regs):
        old_parent = r.parent
        r.id = i
        if old_parent == PARENT_TMP_PRI:
            r.parent = i
        elif old_parent >= 0 and old_parent in tmp:
            r.parent = tmp[old_parent]
        else:
            r.parent = PARENT_UNSET


def set_mapq(regs, min_chain_sc: int, rep_len: int, is_dtw: bool) -> None:
    """MAPQ from score ratios, anchor counts and repeat fraction
    (reference: mm_set_mapq, hit.c:502-539)."""
    if not regs:
        return
    q_coef = 40.0
    sum_sc = sum(r.score for r in regs if r.parent == r.id)
    uniq_ratio = sum_sc / (sum_sc + rep_len) if (sum_sc + rep_len) > 0 else 0.0
    for r in regs:
        pen_s1 = (1.0 if r.score > 100 else 0.01 * r.score) * uniq_ratio
        pen_cm = 1.0 if r.cnt > 10 else 0.1 * r.cnt
        pen_cm = min(pen_s1, pen_cm)
        subsc = max(r.subsc, min_chain_sc)
        x = subsc / r.score0 if r.score0 else 0.0
        mapq = 0
        if is_dtw and r.alignment_score > 0:
            mapq = int(pen_cm * q_coef * (1.0 - x) * 2 * math.log(r.alignment_score))
        elif not is_dtw:
            if r.score > 0:
                mapq = int(pen_cm * q_coef * (1.0 - x) * math.log(r.score))
        mapq -= int(4.343 * math.log(r.n_sub + 1) + 0.499)
        mapq = max(mapq, 0)
        r.mapq = min(mapq, 60)
