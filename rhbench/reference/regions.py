"""Chains -> mapping regions, primary and secondary, MAPQ (minimap2's and
RawHash2's hit.c): mm_gen_regs, mm_set_parent, mm_select_sub, mm_set_mapq,
with the Wang and 64-bit tiebreak hashes."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

RI_ID_SHIFT = 32
SPAN_MASK = (1 << 6) - 1
PARENT_UNSET = -1
PARENT_TMP_PRI = -2


def wang_hash32(key: int) -> int:
    """__ac_Wang_hash (khash.h)."""
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


def hash64_vec(key):
    """The 64-bit mixing hash (hit.c:73-83)."""
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


@dataclasses.dataclass
class Region:
    id: int = 0
    parent: int = PARENT_UNSET
    score: int = 0
    score0: int = 0
    hash: int = 0
    cnt: int = 0
    rev: int = 0
    rid: int = 0
    rs: int = 0
    re: int = 0
    qs: int = 0
    qe: int = 0
    n_sub: int = 0
    subsc: int = 0
    mapq: int = 0
    inv: int = 0
    is_alt: int = 0


def gen_regs(read_hash: int, u, ax, ay) -> list:
    """Regions of the chains u = (score, count) in target order over the
    chain anchors (ax, ay), sorted by score with the hashed tiebreak."""
    if u.shape[0] == 0:
        return []
    cnts = u[:, 1].astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(cnts)[:-1]])
    lasts = starts + cnts - 1
    h = hash64_vec((hash64_vec(ax[starts]) + hash64_vec(ay[starts]))
                   ^ np.uint64(read_hash & 0xFFFFFFFF)) & np.uint64(0xFFFFFFFF)
    with np.errstate(over="ignore"):
        zx = ((u[:, 0].astype(np.uint64) << np.uint64(32)) | u[:, 1].astype(np.uint64)) ^ h
    x0 = ax[starts]
    rev = (x0 >> np.uint64(63)).astype(np.int64)
    rid = ((x0 >> np.uint64(32)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
    rs = (x0 & np.uint64(0xFFFFFFFF)).astype(np.int64)
    re = (ax[lasts] & np.uint64(0xFFFFFFFF)).astype(np.int64) + 1
    qs = (ay[starts] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    qe = (ay[lasts] & np.uint64(0xFFFFFFFF)).astype(np.int64) + 1
    order = np.argsort(zx, kind="stable")[::-1]
    return [Region(id=i, score=int(zx[c] >> np.uint64(32)),
                   score0=int(zx[c] >> np.uint64(32)),
                   hash=int(zx[c] & np.uint64(0xFFFFFFFF)), cnt=int(cnts[c]),
                   rev=int(rev[c]), rid=int(rid[c]), rs=int(rs[c]), re=int(re[c]),
                   qs=int(qs[c]), qe=int(qe[c]))
            for i, c in enumerate(order)]


def set_parent(regs, mask_level: float, mask_len: int, alt_diff_frac: float) -> None:
    """Primary/secondary by query-interval overlap (mm_set_parent), soft
    mask level."""
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
                    sci = max(int(sci * (1.0 - alt_diff_frac) + 0.499), 1) if sci >= 0 else sci
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


def select_sub(regs, pri_ratio: float, best_n: int, check_strand: bool,
               min_strand_sc: int):
    """Prune secondaries (mm_select_sub) and re-sync the parents."""
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
            if not (r.qs == rp.qs and r.qe == rp.qe and r.rid == rp.rid
                    and r.rs == rp.rs and r.re == rp.re):
                out.append(r)
                n_2nd += 1
        elif (check_strand and n_2nd < best_n and r.score > min_strand_sc
              and r.rev != regs[p].rev):
            out.append(r)
            n_2nd += 1
    if len(out) != len(regs):
        tmp = {r.id: i for i, r in enumerate(out) if r.id >= 0}
        for i, r in enumerate(out):
            old = r.parent
            r.id = i
            if old == PARENT_TMP_PRI:
                r.parent = i
            elif old >= 0 and old in tmp:
                r.parent = tmp[old]
            else:
                r.parent = PARENT_UNSET
    return out


def set_mapq(regs, min_chain_sc: int, rep_len: int) -> None:
    """MAPQ from score ratios, anchor counts and the repeat share
    (mm_set_mapq)."""
    if not regs:
        return
    sum_sc = sum(r.score for r in regs if r.parent == r.id)
    uniq_ratio = sum_sc / (sum_sc + rep_len) if (sum_sc + rep_len) > 0 else 0.0
    for r in regs:
        pen_s1 = (1.0 if r.score > 100 else 0.01 * r.score) * uniq_ratio
        pen_cm = 1.0 if r.cnt > 10 else 0.1 * r.cnt
        pen_cm = min(pen_s1, pen_cm)
        subsc = max(r.subsc, min_chain_sc)
        x = subsc / r.score0 if r.score0 else 0.0
        mapq = int(pen_cm * 40.0 * (1.0 - x) * math.log(r.score)) if r.score > 0 else 0
        mapq -= int(4.343 * math.log(r.n_sub + 1) + 0.499)
        r.mapq = min(max(mapq, 0), 60)
