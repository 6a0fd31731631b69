"""The seed index of a genome (RawHash2's rindex.c as a flat CSR table)
and the per-read seed lookup with the occurrence filter (rseed.c)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..gen import PoreModel, seq_to_sig
from .sketch import sketch_events_np

U32 = 0xFFFFFFFF
I32_MAX = 0x7FFFFFFF


@dataclasses.dataclass
class Index:
    keys: np.ndarray  # uint32 [K] sorted unique hashes
    offsets: np.ndarray  # int64 [K + 1]
    pos: np.ndarray  # uint64 [N] id<<32 | pos<<1 | strand, sorted by (key, y)
    seq_lens: list
    mid_occ: int


def build_index(records, pore: PoreModel, o: dict) -> Index:
    """Both strands of each (name, sequence) sketched, seeds sorted by
    (hash, y); mid_occ from the per-key counts (ri_idx_cal_max_occ and
    ri_mapopt_update)."""
    hs, ys = [], []
    for rid, (_, seq) in enumerate(records):
        if len(seq) < pore.k:
            continue
        for strand in (0, 1):
            h, y = sketch_events_np(seq_to_sig(seq, pore, strand), rid, strand, o)
            hs.append(h)
            ys.append(y)
    hashes = np.concatenate(hs) if hs else np.zeros(0, np.uint32)
    ys = np.concatenate(ys) if ys else np.zeros(0, np.uint64)
    order = np.lexsort((ys, hashes))
    hashes, ys = hashes[order], ys[order]
    if hashes.shape[0]:
        flags = np.empty(hashes.shape[0], dtype=bool)
        flags[0] = True
        np.not_equal(hashes[1:], hashes[:-1], out=flags[1:])
        starts = np.nonzero(flags)[0]
    else:
        starts = np.zeros(0, dtype=np.int64)
    keys = hashes[starts].astype(np.uint32)
    offsets = np.concatenate([starts, [hashes.shape[0]]]).astype(np.int64)
    counts = np.diff(offsets)
    frac = o["mid_occ_frac"]
    if frac <= 0.0 or counts.shape[0] == 0:
        mid = np.iinfo(np.int32).max
    else:
        kth = min(max(int((1.0 - frac) * counts.shape[0]), 0), counts.shape[0] - 1)
        mid = int(np.partition(counts, kth)[kth]) + 1
    mid = max(mid, o["min_mid_occ"])
    if o["max_mid_occ"] > o["min_mid_occ"]:
        mid = min(mid, o["max_mid_occ"])
    return Index(keys, offsets, ys, [len(s) for _, s in records], int(mid))


def lookup(index: Index, hashes, qpos_seed, valid, ev_offset: int, span: int):
    """One read's seeds (in seed order) -> anchors in slot order (key as u32
    rev<<31 | tid, tpos, qpos; int64) and rep_len: seeds with more than
    mid_occ hits are filtered out and their query intervals' union is the
    repeat length (rseed.c:105-151)."""
    k = index.keys.shape[0]
    i = np.searchsorted(index.keys, hashes.astype(np.uint32)) if k else np.zeros_like(hashes)
    i_c = np.clip(i, 0, max(k - 1, 0))
    found = valid & (i < k) & (index.keys[i_c] == hashes) if k else np.zeros_like(valid)
    start = index.offsets[i_c]
    count = np.where(found, index.offsets[i_c + 1] - start, 0)
    flt = count > index.mid_occ
    st_i = qpos_seed + 1
    en_i = st_i + span + 1
    cummax_en = np.maximum.accumulate(np.where(flt, en_i, 0))
    excl = np.concatenate([[0], cummax_en[:-1]])
    contrib = np.maximum(en_i - np.maximum(st_i, excl), 0)
    rep_len = int(np.where(flt, contrib, 0).sum())
    count = np.where(flt, 0, count)
    seeds = np.nonzero(count > 0)[0]
    if seeds.size:
        fetch = np.concatenate([np.arange(start[s], start[s] + count[s]) for s in seeds])
        hit = index.pos[fetch].astype(np.int64)
        seed_of = np.repeat(seeds, count[seeds])
    else:
        hit = np.zeros(0, np.int64)
        seed_of = np.zeros(0, np.int64)
    ps = hit & U32
    a_key = ((ps & 1) << 31) | (hit >> 32)
    a_tpos = (ps >> 1) & I32_MAX
    a_qpos = qpos_seed[seed_of] + ev_offset
    return a_key, a_tpos, a_qpos, rep_len
