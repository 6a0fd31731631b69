"""Real-time mapping engine: batch chunk loop, host chain tail, decisions and
PAF records (port of rawhash_tpu/map/engine.py, host-tail path).

Per batch of reads it keeps the per-read carry (normalisation sums, event
offset, carried chain anchors), runs one device chunk step per chunk
(map/device_step.py), and runs the sequential tail per read on the host:
chain backtracking in native C++, regions, MAPQ and the mapping decision
(reference: map_worker_for, rmap.cpp:389-599).  Reads leave the loop as
soon as a decision fires.  Batches run one after another.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from rawhash_tpu._native import chain_tail_native, gen_regions_native
from rawhash_tpu.chain.host import chain_backtrack, compact_chains
from rawhash_tpu.chain.regions import (
    gen_regs, select_sub, set_mapq, set_parent, wang_hash32,
)
from rawhash_tpu.config import MapFlag, MapOptions
from rawhash_tpu.index.build import RawIndex, update_mid_occ
from rawhash_tpu.utils.timers import StageProfiler

from ..index.device import DeviceIndex
from ..signal.events import NormCarry
from .device_step import chunk_step


def _pow2_up(x: int) -> int:
    """Smallest power of two >= x."""
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass
class MapRecord:
    """One output mapping (reference: ri_map_t, rmap.h)."""

    read_length: int = 0
    ref_id: int = 0
    read_start: int = 0
    read_end: int = 0
    frag_start: int = 0
    frag_len: int = 0
    mapq: int = 0
    rev: int = 0
    mapped: int = 0
    tags: str = ""


@dataclasses.dataclass
class ReadResult:
    name: str
    records: list  # list[MapRecord]


def _pack_xy(key: np.ndarray, tpos: np.ndarray, qpos: np.ndarray, span: int):
    """Anchor planes -> the reference's 128-bit packing for the host chain
    tail (x = rev<<63 | tid<<32 | tpos, y = span<<32 | qpos)."""
    key = key.astype(np.uint64)
    rev = key >> np.uint64(31)
    tid = key & np.uint64(0x7FFFFFFF)
    ax = (rev << np.uint64(63)) | (tid << np.uint64(32)) | tpos.astype(np.uint64)
    ay = (np.uint64(span) << np.uint64(32)) | qpos.astype(np.uint64)
    return ax, ay


def _unpack_xy(ax: np.ndarray, ay: np.ndarray):
    rev = (ax >> np.uint64(63)).astype(np.uint32)
    tid = ((ax >> np.uint64(32)) & np.uint64(0x7FFFFFFF)).astype(np.uint32)
    key = (rev << np.uint32(31)) | tid
    tpos = (ax & np.uint64(0xFFFFFFFF)).astype(np.int32)
    qpos = (ay & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return key, tpos, qpos


def unsupported_options(mopt: MapOptions) -> list:
    """Mapping options this engine does not implement yet."""
    out = []
    if mopt.flag & MapFlag.ALL_CHAINS:
        out.append("all-vs-all mapping (-x ava*)")
    if mopt.flag & MapFlag.DTW_EVALUATE_CHAINS:
        out.append("--dtw-evaluate-chains")
    if mopt.flag & MapFlag.RMQ:
        out.append("--rmq")
    if mopt.bw_long > mopt.bw:
        out.append("--bw-long")
    if mopt.flag & MapFlag.SEQUENCEUNTIL:
        out.append("--sequence-until")
    if mopt.n_shards >= 1:
        out.append("--n-shards")
    return out


def fill_params(iopt, mopt: MapOptions) -> dict:
    """Chaining DP parameters of a run (penalties: rmap.cpp:318)."""
    span = iopt.k + iopt.e - 1
    f = np.float32
    return dict(
        q_span=span, max_dist_t=mopt.max_target_gap_length,
        max_dist_q=mopt.max_query_gap_length, bw=mopt.bw,
        max_iter=mopt.max_chain_iter,
        chn_pen_gap=float(f(mopt.chain_gap_scale) * f(0.01) * f(span)),
        chn_pen_skip=float(f(mopt.chain_skip_scale) * f(0.01) * f(span)),
    )


class MappingEngine:
    def __init__(self, index: RawIndex, mopt: MapOptions, device="cuda"):
        missing = unsupported_options(mopt)
        if missing:
            raise NotImplementedError(
                "not supported by the PyTorch engine yet: " + ", ".join(missing)
            )
        self.device = torch.device(device)
        self.profiler = StageProfiler()
        self.index = index
        self.iopt = index.opts
        self.mopt = mopt
        update_mid_occ(mopt, index)
        self.didx = DeviceIndex.from_host(index, self.device)
        self.span = self.iopt.k + self.iopt.e - 1
        self.fill_params = fill_params(self.iopt, mopt)
        self.stats = {"hit_overflow": 0, "prev_overflow": 0, "reads": 0,
                      "mapped": 0, "anchor_regrows": 0}
        self._occ_cache = None
        # observed per-chunk anchor watermark (p95 of hits + overflow);
        # once set it sizes the next batches' a_cap instead of the model
        self._learned_need = 0

    # ---------- decisions and the host tail ----------

    def _decide(self, regs):
        """Mapping decision for one read after a chunk
        (reference: rmap.cpp:423-500). Returns (map_chain_ids, done)."""
        mo = self.mopt
        n_cregs = len(regs)
        if n_cregs == 1 and regs[0].mapq >= mo.min_mapq:
            return [0], True
        n_chains = 1 if n_cregs >= 1 else n_cregs
        mean_c = mean_q = 0.0
        if n_cregs > 0:
            mean_c = sum(r.score for r in regs) / n_cregs
            mean_q = sum(r.mapq for r in regs) / n_cregs
        maps = []
        for ic in range(n_chains):
            best_q = float(regs[ic].mapq)
            best_c = float(regs[ic].score)
            r_bestq = min(best_q / 30.0, 1.0) if best_q > 0 else 0.0
            r_bestmq = max(1.0 - mean_q / best_q, 0.0) if best_q > 0 else 0.0
            r_bestmc = max(1.0 - mean_c / best_c, 0.0) if best_c > 0 else 0.0
            weighted = (mo.w_bestq * r_bestq + mo.w_bestmq * r_bestmq
                        + mo.w_bestmc * r_bestmc)
            if weighted >= mo.w_threshold:
                maps.append(ic)
        return maps, len(maps) > 0

    def _chunk_tail(self, key, tpos, qpos, n_anchors, f, p, ev_total):
        """Host tail of one chunk for one read: backtrack -> regions.
        Returns (regs, carried-anchor (px, py))."""
        mo = self.mopt
        n = int(n_anchors)
        ax, ay = _pack_xy(key[:n], tpos[:n], qpos[:n], self.span)
        native = chain_tail_native(
            f[:n], p[:n], ax, ay,
            mo.min_num_anchors, mo.min_chaining_score, mo.bw,
        )
        if native is not None:
            u_s, bx, by, px, py = native
        else:
            u, v = chain_backtrack(
                f[:n].astype(np.int32), p[:n].astype(np.int64),
                min_cnt=mo.min_num_anchors, min_sc=mo.min_chaining_score,
                max_drop=mo.bw,
            )
            u_s, bx, by, px, py = compact_chains(u, v, ax, ay)
        # read hash (reference: rmap.cpp:346-348)
        h = wang_hash32((wang_hash32(ev_total) + wang_hash32(11)) & 0xFFFFFFFF)
        args = (mo.mask_level, mo.mask_len, bool(mo.flag & MapFlag.HARD_MLEVEL),
                mo.alt_drop)
        sel = (mo.pri_ratio, mo.best_n, True, int(mo.max_target_gap_length * 0.8))
        regs = gen_regions_native(h, u_s, bx, by, *args, True, *sel)
        if regs is None:  # no native toolchain: the numpy path
            regs = gen_regs(h, u_s.shape[0], u_s, bx, by)
            set_parent(regs, *args)
            regs = select_sub(regs, *sel)
        return regs, (px, py)

    # ---------- capacities ----------

    def _occ_stats(self):
        """Position-weighted occupancy (mu, sigma) of the filtered index:
        expected hits per seed and its spread (rseed.c:105-133)."""
        if self._occ_cache is None:
            counts = self.index.counts().astype(np.float64)
            tot = counts.sum()
            if tot <= 0:
                self._occ_cache = (1.0, 0.0)
            else:
                surv = counts[counts <= self.mopt.mid_occ]
                mu = float((surv**2).sum() / tot)
                ex2 = float((surv**3).sum() / tot)
                self._occ_cache = (mu, float(np.sqrt(max(ex2 - mu * mu, 0.0))))
        return self._occ_cache

    def _plan(self, qlens: np.ndarray):
        """Initial capacities of a batch: (l_chunk, max_chunk, e_cap, a_cap,
        p_cap).  The chunk loop grows a_cap/p_cap whenever a chunk
        overflows, so no hit is dropped (rh_kvec never truncates)."""
        mo = self.mopt
        if mo.flag & MapFlag.NO_ADAPTIVE:
            l_chunk = int(max(1, qlens.max()))
            l_chunk = ((l_chunk + 4095) // 4096) * 4096
            max_chunk = 1
            e_cap = max(256, min(_pow2_up(l_chunk // 3), 1 << 14))
            mu, sigma = self._occ_stats()
            expected = int(e_cap * mu + 4.0 * np.sqrt(e_cap) * sigma)
            a_cap = max(mo.max_anchors_per_read, expected, 512)
            a_cap = min(_pow2_up(a_cap), int(mo.max_anchor_cap) or 32000)
            p_cap = 8  # single chunk: carried anchors unused
        else:
            l_chunk = int(mo.chunk_size)
            max_chunk = int(mo.max_num_chunk)
            e_cap = mo.max_events_per_chunk
            total = mo.max_anchors_per_read
            if self._learned_need > 0:
                a_cap = _pow2_up(max(512, self._learned_need))
            else:
                mu, sigma = self._occ_stats()
                expected = int(e_cap * mu + 4.0 * np.sqrt(e_cap) * sigma)
                a_cap = min(_pow2_up(max(512, expected)), _pow2_up(total) // 2)
            a_cap = min(a_cap, int(mo.max_anchor_cap) or 32000)
            p_cap = _pow2_up(max(min(total - a_cap, 4 * a_cap), 64))
        return l_chunk, max_chunk, e_cap, a_cap, p_cap

    def _tags(self, mt_ms, ci, sl, cm, nc, s1):
        """PAF tag block (reference: rmap.cpp:527-570); `sm:f` mirrors the
        reference's never-assigned mean chain score."""
        sm = "0" if nc == 0 else "0.00"
        return (
            f"mt:f:{mt_ms:.6f}\tci:i:{ci}\tsl:i:{sl}\tcm:i:{cm}"
            f"\tnc:i:{nc}\ts1:i:{s1}\tsm:f:{sm}"
        )

    # ---------- entry points ----------

    def map_stream(self, batches):
        """Map batches of (name, signal) one after another; yields one list
        of ReadResult per batch, in order."""
        for reads in batches:
            st = _BatchState(self, reads)
            while not st.done():
                _run_chunk(self, st)
            yield _finalize_batch(self, st)

    def map_batch(self, reads: list) -> list:
        return next(self.map_stream([reads]))


class _BatchState:
    """All per-batch mapping state across the chunk loop."""

    def __init__(self, engine: MappingEngine, reads: list):
        self.b = b = len(reads)
        self.names = [n for n, _ in reads]
        self.sigs = [np.asarray(s, dtype=np.float32) for _, s in reads]
        self.qlens = np.array([s.shape[0] for s in self.sigs], dtype=np.int64)
        (self.l_chunk, self.max_chunk, self.e_cap, self.a_cap,
         self.p_cap) = engine._plan(self.qlens)
        self.carry = NormCarry.zeros(b, engine.device)
        self.ev_offset = torch.zeros(b, dtype=torch.int32, device=engine.device)
        self.prev_key = np.full((b, self.p_cap), 0xFFFFFFFF, dtype=np.uint32)
        self.prev_tpos = np.zeros((b, self.p_cap), dtype=np.int32)
        self.prev_qpos = np.zeros((b, self.p_cap), dtype=np.int32)
        self.n_prev = np.zeros(b, dtype=np.int32)
        self.active = np.ones(b, dtype=bool)
        self.last_regs = [[] for _ in range(b)]
        self.c_counts = np.zeros(b, dtype=np.int64)
        self.map_ids = [None] * b
        self.ev_totals = np.zeros(b, dtype=np.int64)
        self.t_start = np.full(b, time.perf_counter())
        self.t_decided = np.zeros(b, dtype=np.float64)
        self.chunk_idx = 0

    def done(self) -> bool:
        return self.chunk_idx >= self.max_chunk or not self.active.any()

    def grow_prev(self, need: int, cap_ceil: int) -> None:
        """Widen the carried-anchor buffers to hold `need` chain anchors
        (the reference carries every chain anchor on, rmap.cpp:111-116)."""
        new_p = 1 << max(int(np.ceil(np.log2(max(need, 8)))), 3)
        new_p = min(new_p, cap_ceil)
        if new_p <= self.p_cap:
            return
        pad = new_p - self.p_cap
        self.prev_key = np.pad(self.prev_key, ((0, 0), (0, pad)),
                               constant_values=0xFFFFFFFF)
        self.prev_tpos = np.pad(self.prev_tpos, ((0, 0), (0, pad)))
        self.prev_qpos = np.pad(self.prev_qpos, ((0, 0), (0, pad)))
        self.p_cap = new_p


def _step(engine: MappingEngine, st: _BatchState, inputs, a_cap: int):
    """The device chunk step on `inputs` (sig, slen, carry, ev_offset and
    the carried-anchor planes, all on the engine's device)."""
    mo, io = engine.mopt, engine.iopt
    return chunk_step(
        engine.didx, *inputs,
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
        fine_min=io.fine_min, fine_max=io.fine_max, fine_range=io.fine_range,
        window_length1=mo.window_length1, window_length2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height,
        e_cap=st.e_cap, a_cap=a_cap,
        min_events=mo.min_events, mid_occ=int(mo.mid_occ),
        **{k: v for k, v in engine.fill_params.items() if k != "q_span"},
        prof=engine.profiler,
    )


def _to_host(out, width: int):
    """The first `width` sorted anchors (key as u32) and f/p of every row of
    `out`, as numpy."""
    planes = (out.key, out.tpos, out.qpos, out.f, out.p)
    key, tpos, qpos, f, p = (t[:, :width].cpu().numpy() for t in planes)
    return key.view(np.uint32), tpos, qpos, f, p


def _quarantine_overflow(engine: MappingEngine, st: _BatchState, inputs,
                         h_over: np.ndarray) -> dict:
    """Re-run ONLY the rows whose seed hits overflowed a_cap, as a sub-batch
    at a grown capacity, so no hit is dropped and one repeat-heavy read does
    not widen every row.  Returns {row: (key, tpos, qpos, f, p, n_anchors)}.
    Hits past --max-anchor-cap stay dropped and counted."""
    cap_ceil = int(engine.mopt.max_anchor_cap)
    rows = np.nonzero(h_over > 0)[0]
    if rows.size == 0:
        return {}
    if cap_ceil <= st.a_cap:  # hard cap already reached: truncation stands
        engine.stats["hit_overflow"] += int(h_over[rows].sum())
        return {}
    idx = torch.as_tensor(rows, device=engine.device)
    sub = tuple(NormCarry(*(c[idx] for c in x)) if isinstance(x, NormCarry)
                else x[idx] for x in inputs)
    sub_a = st.a_cap
    need = int(h_over[rows].max())
    while True:
        engine.stats["anchor_regrows"] += 1
        sub_a = min(_pow2_up(max(sub_a + need, 2 * sub_a)), cap_ceil)
        out = _step(engine, st, sub, sub_a)
        over = out.overflow.cpu().numpy()
        need = int(over.max())
        if need <= 0 or sub_a >= cap_ceil:
            break
    engine.stats["hit_overflow"] += int(over.sum())
    n_anc = out.n_anchors.cpu().numpy()
    key, tpos, qpos, f, p = _to_host(out, width=int(n_anc.max()))
    if rows.size > st.b // 4 and sub_a > st.a_cap:
        # a quarter of the batch overflowed: later chunks of this batch
        # start at the converged capacity
        st.a_cap = sub_a
    return {
        int(row): (key[j], tpos[j], qpos[j], f[j], p[j], int(n_anc[j]))
        for j, row in enumerate(rows)
    }


def _run_chunk(engine: MappingEngine, st: _BatchState) -> None:
    """One chunk of a batch: device step, then the host tail and decision
    per live read (reference: rmap.cpp:415-500)."""
    mo = engine.mopt
    dev = engine.device
    c = st.chunk_idx
    no_adaptive = bool(mo.flag & MapFlag.NO_ADAPTIVE)
    chunk = np.zeros((st.b, st.l_chunk), dtype=np.float32)
    slen = np.zeros(st.b, dtype=np.int32)
    for i in np.nonzero(st.active)[0]:
        lo = 0 if no_adaptive else c * st.l_chunk
        seg = st.sigs[i][lo : lo + st.l_chunk]
        chunk[i, : seg.shape[0]] = seg
        slen[i] = seg.shape[0]

    t0 = time.perf_counter()
    p_use = max(1, int(st.n_prev.max()))  # live carried-anchor width
    inputs = (
        # signal travels to the device as f16 and is widened there, as in
        # the reference engine (events depend on that rounding)
        torch.from_numpy(chunk.astype(np.float16)).to(dev),
        torch.from_numpy(slen).to(dev),
        st.carry, st.ev_offset,
        torch.from_numpy(st.prev_key[:, :p_use].astype(np.int64)).to(dev),
        torch.from_numpy(st.prev_tpos[:, :p_use]).to(dev),
        torch.from_numpy(st.prev_qpos[:, :p_use]).to(dev),
        torch.from_numpy(st.n_prev).to(dev),
    )
    engine.profiler.add("transfer", time.perf_counter() - t0)
    out = _step(engine, st, inputs, st.a_cap)

    t0 = time.perf_counter()
    h_nanc, h_rep, h_proc, h_over, h_evoff = (
        t.cpu().numpy() for t in
        (out.n_anchors, out.rep_len, out.processed, out.overflow, out.ev_offset)
    )
    engine.profiler.add("transfer", time.perf_counter() - t0)
    overrides = _quarantine_overflow(engine, st, inputs, h_over)
    # carry commits only now, so the quarantine reran the same inputs
    st.carry = out.carry
    st.ev_offset = out.ev_offset
    t0 = time.perf_counter()
    clean = np.ones(st.b, dtype=bool)
    clean[list(overrides)] = False
    nmax = int(h_nanc[clean].max()) if clean.any() else 0
    h_key, h_tpos, h_qpos, h_f, h_p = _to_host(out, width=nmax)
    engine.profiler.add("transfer", time.perf_counter() - t0)

    t_host = now = time.perf_counter()
    decide = []
    wms = []  # per-read anchor watermarks for the learned a_cap
    for i in range(st.b):
        if not st.active[i]:
            continue
        if slen[i] == 0:
            st.active[i] = False
            st.n_prev[i] = 0
            continue
        st.c_counts[i] = c
        if not h_proc[i]:
            st.last_regs[i] = []
            continue
        st.ev_totals[i] = int(h_evoff[i])
        ov = overrides.get(i)
        if ov is not None:
            k_i, t_i, q_i, f_i, p_i, n_i = ov
            wms.append(min(n_i, st.a_cap))
        else:
            k_i, t_i, q_i, f_i, p_i = h_key[i], h_tpos[i], h_qpos[i], h_f[i], h_p[i]
            n_i = int(h_nanc[i])
            wms.append(n_i + int(h_over[i]))
        regs, (px, py) = engine._chunk_tail(
            k_i, t_i, q_i, n_i, f_i, p_i, int(h_evoff[i])
        )
        st.last_regs[i] = regs
        if px.shape[0] > st.p_cap and mo.max_anchor_cap > 0:
            st.grow_prev(px.shape[0], int(mo.max_anchor_cap))
        npv = min(px.shape[0], st.p_cap)
        if px.shape[0] > st.p_cap:
            engine.stats["prev_overflow"] += px.shape[0] - st.p_cap
        k2, t2, q2 = _unpack_xy(px[:npv], py[:npv])
        st.prev_key[i, :npv] = k2
        st.prev_tpos[i, :npv] = t2
        st.prev_qpos[i, :npv] = q2
        st.n_prev[i] = npv
        decide.append(i)

    for i in decide:
        regs = st.last_regs[i]
        set_mapq(regs, mo.min_chaining_score, int(h_rep[i]), False)
        ids, done = engine._decide(regs)
        if done:
            st.map_ids[i] = ids
            st.t_decided[i] = now
            st.active[i] = False
            st.n_prev[i] = 0
    engine.profiler.add("host_tail", time.perf_counter() - t_host)
    if wms:
        # 95th percentile: the main step fits the typical read; outliers
        # go through the quarantine sub-batch
        wm = int(np.quantile(np.asarray(wms), 0.95))
        engine._learned_need = max(engine._learned_need, wm)
    st.chunk_idx += 1


def _finalize_batch(engine: MappingEngine, st: _BatchState) -> list:
    """Build ReadResults (reference: rmap.cpp:507-586)."""
    mo = engine.mopt
    no_adaptive = bool(mo.flag & MapFlag.NO_ADAPTIVE)
    out_results = []
    now = time.perf_counter()
    sig_t = engine.index.sig_target
    for i in range(st.b):
        qlen = int(st.qlens[i])
        cc = 0 if no_adaptive else int(st.c_counts[i])
        regs = st.last_regs[i]
        ids = st.map_ids[i]
        # last-chance accept (reference: rmap.cpp:515-519)
        if ids is None and regs and regs[0].mapq > mo.min_mapq:
            ids = [0]
            st.t_decided[i] = now
        mt = ((st.t_decided[i] if ids is not None else now) - st.t_start[i]) * 1000.0
        offset = int(st.ev_totals[i])
        lc = qlen if (no_adaptive or qlen < st.l_chunk) else st.l_chunk
        if offset == 0 or mo.sample_per_base == 0:
            scale = 0.0
        else:
            scale = ((cc + 1) * lc / offset) / mo.sample_per_base
        recs = []
        if ids:
            for ic in ids:
                r = regs[ic]
                tags = engine._tags(mt, cc + 1, qlen, r.cnt, len(regs), r.score)
                frag_start = (
                    int(engine.index.seq_lens[r.rid]) + 1 - r.re if r.rev else r.rs
                )
                if sig_t:
                    rl, rqs, rqe = offset, r.qs, r.qe
                else:
                    rl = int(scale * r.qe)
                    rqs, rqe = int(scale * r.qs), int(scale * r.qe)
                recs.append(MapRecord(
                    read_length=rl, ref_id=r.rid, read_start=rqs, read_end=rqe,
                    frag_start=frag_start, frag_len=r.re - r.rs + 1,
                    mapq=r.mapq, rev=r.rev, mapped=1, tags=tags,
                ))
            engine.stats["mapped"] += 1
        else:
            if regs:
                tags = engine._tags(mt, cc + 1, qlen, regs[0].cnt, len(regs),
                                    regs[0].score)
            else:
                tags = engine._tags(mt, cc + 1, qlen, 0, 0, 0)
            rl = offset if sig_t else int(scale * offset)
            recs.append(MapRecord(read_length=rl, mapped=0, tags=tags))
        engine.stats["reads"] += 1
        out_results.append(ReadResult(name=st.names[i], records=recs))
    return out_results
