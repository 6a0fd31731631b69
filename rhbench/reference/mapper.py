"""The reference mapper: reads mapped chunk by chunk as RawHash2's
map_worker_for does (rmap.cpp:389-599), each read on its own with nothing
capped, the reads of a block stepped together only to share the loops of
the events stage and the fill.  A read's record is what it compares:
(mapped, strand, target id, target start, target length, query start,
query end, query length, MAPQ, chunks consumed ci, chain anchors cm,
chains nc, chain score s1)."""

from __future__ import annotations

import numpy as np
import torch

from ..gen import PoreModel
from .chain import chain_backtrack, chain_fill, compact_chains
from .events import NormCarry, detect_events
from .index import build_index, lookup
from .options import options
from .regions import gen_regs, select_sub, set_mapq, set_parent, wang_hash32
from .sketch import sketch_batch

I32_MAX = 0x7FFFFFFF


def _pack_xy(key, tpos, qpos, span: int):
    key = key.astype(np.uint64)
    ax = ((key >> np.uint64(31)) << np.uint64(63)) | (
        (key & np.uint64(0x7FFFFFFF)) << np.uint64(32)) | tpos.astype(np.uint64)
    ay = (np.uint64(span) << np.uint64(32)) | qpos.astype(np.uint64)
    return ax, ay


def _unpack_xy(ax, ay):
    rev = (ax >> np.uint64(63)).astype(np.int64)
    tid = ((ax >> np.uint64(32)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
    key = (rev << 31) | tid
    return key, (ax & np.uint64(0xFFFFFFFF)).astype(np.int64), (
        ay & np.uint64(0xFFFFFFFF)).astype(np.int64)


def decide(regs, o: dict):
    """The map/stop decision for a read after a chunk (rmap.cpp:423-500):
    (chain ids to map, done)."""
    n = len(regs)
    if n == 1 and regs[0].mapq >= o["min_mapq"]:
        return [0], True
    if n < 1:
        return [], False
    mean_c = sum(r.score for r in regs) / n
    mean_q = sum(r.mapq for r in regs) / n
    best_q, best_c = float(regs[0].mapq), float(regs[0].score)
    r_bestq = min(best_q / 30.0, 1.0) if best_q > 0 else 0.0
    r_bestmq = max(1.0 - mean_q / best_q, 0.0) if best_q > 0 else 0.0
    r_bestmc = max(1.0 - mean_c / best_c, 0.0) if best_c > 0 else 0.0
    weighted = o["w_bestq"] * r_bestq + o["w_bestmq"] * r_bestmq + o["w_bestmc"] * r_bestmc
    if weighted >= o["w_threshold"]:
        return [0], True
    return [], False


class ReferenceMapper:
    """The index of `genome` under `preset` and the mapping of reads on it;
    `dtype` is the events stage's float type (bfloat16 for the control)."""

    def __init__(self, genome: str, pore: PoreModel, preset: str,
                 dtype=torch.float32):
        self.o = options(preset)
        self.index = build_index([("chr1", genome)], pore, self.o)
        self.dtype = dtype

    def map(self, reads: list, block: int = 64) -> list:
        """Records of [(name, signal)], in order, `block` reads at a time."""
        out = []
        for i in range(0, len(reads), block):
            out.extend(self._map_block([s for _, s in reads[i : i + block]]))
        return out

    def _tail(self, key, tpos, qpos, f, p, ev_total):
        """Backtrack, compaction and regions of one read's chunk: (regions,
        carried anchors (key, tpos, qpos))."""
        o = self.o
        ax, ay = _pack_xy(key, tpos, qpos, o["span"])
        u, v = chain_backtrack(f.astype(np.int32), p.astype(np.int64),
                               o["min_num_anchors"], o["min_chaining_score"], o["bw"])
        u_s, bx, by, px, py = compact_chains(u, v, ax, ay)
        h = wang_hash32((wang_hash32(ev_total) + wang_hash32(11)) & 0xFFFFFFFF)
        regs = gen_regs(h, u_s, bx, by)
        set_parent(regs, o["mask_level"], o["mask_len"], o["alt_drop"])
        regs = select_sub(regs, o["pri_ratio"], o["best_n"], True,
                          int(o["max_target_gap_length"] * 0.8))
        return regs, _unpack_xy(px, py)

    def _map_block(self, sigs: list) -> list:
        o = self.o
        b, l_chunk = len(sigs), o["chunk_size"]
        empty = np.zeros(0, np.int64)
        carry = NormCarry.zeros(b, self.dtype)
        ev_offset = torch.zeros(b, dtype=torch.int32)
        prev = [(empty, empty, empty)] * b
        active = np.ones(b, dtype=bool)
        last_regs = [[] for _ in range(b)]
        c_counts = np.zeros(b, dtype=np.int64)
        map_ids = [None] * b
        ev_totals = np.zeros(b, dtype=np.int64)
        for c in range(o["max_num_chunk"]):
            if not active.any():
                break
            chunk = np.zeros((b, l_chunk), dtype=np.float32)
            slen = np.zeros(b, dtype=np.int32)
            for i in np.nonzero(active)[0]:
                seg = sigs[i][c * l_chunk : (c + 1) * l_chunk]
                chunk[i, : seg.shape[0]] = seg
                slen[i] = seg.shape[0]
            # the signal travels as f16, as the mapper ships it
            sig = torch.from_numpy(chunk.astype(np.float16).astype(np.float32))
            slen_t = torch.from_numpy(slen)
            events, n_ev, carry2 = detect_events(sig, slen_t, carry, o, self.dtype)
            processed = (n_ev >= o["min_events"]).numpy()
            hashes, qpos_seed, valid = sketch_batch(events, n_ev, o)
            evoff = ev_offset.numpy().astype(np.int64)
            new_evoff = evoff + np.where(processed, n_ev.numpy(), 0)
            rows, rep = {}, {}
            for i in np.nonzero(active)[0]:
                if slen[i] == 0 or not processed[i]:
                    continue
                a_key, a_tpos, a_qpos, rep[i] = lookup(
                    self.index, hashes[i].numpy(), qpos_seed[i].numpy(),
                    valid[i].numpy(), int(evoff[i]), o["span"])
                pk, pt, pq = prev[i]
                m_key = np.concatenate([a_key, pk])
                m_tpos = np.concatenate([a_tpos, pt])
                m_qpos = np.concatenate([a_qpos, pq])
                order = np.argsort((m_key << 31) | m_tpos, kind="stable")
                rows[i] = (m_key[order], m_tpos[order], m_qpos[order])
            fp = self._fill(rows, b)
            for i in range(b):
                if not active[i]:
                    continue
                if slen[i] == 0:
                    active[i] = False
                    continue
                c_counts[i] = c
                if not processed[i]:
                    last_regs[i] = []
                    continue
                ev_totals[i] = int(new_evoff[i])
                key, tpos, qpos = rows[i]
                regs, prev[i] = self._tail(key, tpos, qpos, *fp[i], int(new_evoff[i]))
                set_mapq(regs, o["min_chaining_score"], rep[i])
                last_regs[i] = regs
                ids, done = decide(regs, o)
                if done:
                    map_ids[i] = ids
                    active[i] = False
            carry = carry2
            ev_offset = torch.from_numpy(new_evoff.astype(np.int32))
        return [self._records(sigs[i], last_regs[i], map_ids[i], int(c_counts[i]),
                              int(ev_totals[i])) for i in range(b)]

    def _fill(self, rows: dict, b: int) -> dict:
        """f and p of each read's sorted anchors, the rows filled together."""
        o = self.o
        if not rows:
            return {}
        ids = sorted(rows)
        n = max(1, max(rows[i][0].shape[0] for i in ids))
        key = np.zeros((len(ids), n), np.int64)
        tpos = np.zeros((len(ids), n), np.int64)
        qpos = np.zeros((len(ids), n), np.int64)
        n_anc = np.zeros(len(ids), np.int64)
        for r, i in enumerate(ids):
            k, t, q = rows[i]
            m = k.shape[0]
            key[r, :m] = np.where(k >= 1 << 31, k - (1 << 32), k)
            tpos[r, :m], qpos[r, :m], n_anc[r] = t, q, m
        f, p = chain_fill(*(x.astype(np.int32) for x in (key, tpos, qpos, n_anc)),
                          q_span=o["span"], max_dist_t=o["max_target_gap_length"],
                          max_dist_q=o["max_query_gap_length"], bw=o["bw"],
                          max_iter=o["max_chain_iter"], chn_pen_gap=o["chn_pen_gap"],
                          chn_pen_skip=o["chn_pen_skip"])
        return {i: (f[r, : n_anc[r]], p[r, : n_anc[r]]) for r, i in enumerate(ids)}

    def _records(self, sig, regs, ids, cc: int, offset: int) -> list:
        """A read's records (rmap.cpp:507-586), as tuples."""
        o = self.o
        qlen = int(sig.shape[0])
        if ids is None and regs and regs[0].mapq > o["min_mapq"]:
            ids = [0]  # the last-chance accept
        lc = qlen if qlen < o["chunk_size"] else o["chunk_size"]
        scale = 0.0 if offset == 0 else ((cc + 1) * lc / offset) / o["sample_per_base"]
        if ids:
            out = []
            for ic in ids:
                r = regs[ic]
                frag_start = self.index.seq_lens[r.rid] + 1 - r.re if r.rev else r.rs
                out.append((1, r.rev, r.rid, frag_start, r.re - r.rs + 1,
                            int(scale * r.qs), int(scale * r.qe), int(scale * r.qe),
                            r.mapq, cc + 1, r.cnt, len(regs), r.score))
            return out
        cnt, score = (regs[0].cnt, regs[0].score) if regs else (0, 0)
        return [(0, 0, 0, 0, 0, 0, 0, int(scale * offset), 0, cc + 1, cnt, len(regs),
                 score)]


RECORD_FIELDS = ("mapped", "rev", "ref_id", "frag_start", "frag_len", "read_start",
                 "read_end", "read_length", "mapq", "ci", "cm", "nc", "s1")


def records_of(results) -> list:
    """The port's ReadResults as the reference's record tuples."""
    out = []
    for res in results:
        recs = []
        for m in res.records:
            tags = dict(t.split(":", 2)[::2] for t in m.tags.split("\t"))
            recs.append((m.mapped, m.rev, m.ref_id, m.frag_start, m.frag_len,
                         m.read_start, m.read_end, m.read_length, m.mapq,
                         int(tags["ci"]), int(tags["cm"]), int(tags["nc"]),
                         int(tags["s1"])))
        out.append(recs)
    return out
