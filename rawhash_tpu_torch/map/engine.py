"""Real-time mapping engine: batch chunk loop, chain tail, decisions and
PAF records (port of rawhash_tpu/map/engine.py).

Per batch of reads it keeps the per-read carry (normalisation sums, event
offset, carried chain anchors) and runs one device chunk step per chunk
(map/device_step.py).  The chain tail runs one of two ways, bound per batch:

  host tail    every anchor's (f, p) comes to the host, which backtracks
               chains in native C++ per read;
  device tail  the backtrack kernel and the compaction run on the device,
               only per-chain summaries come to the host, and the carried
               anchors stay on the device.

Then, per read on the host: regions, MAPQ and the mapping decision
(reference: map_worker_for, rmap.cpp:389-599).  Engines start on the host
tail and switch to the device tail once the observed anchor watermark
passes `tail_switch_anchors`, by the reference engine's rule;
RAWHASH_TPU_DEVICE_TAIL=1 forces the device tail, RAWHASH_TPU_NO_DEVICE_TAIL=1
forbids it.  The modes that need every anchor or event on the host (--rmq,
--bw-long, --dtw-evaluate-chains) keep the host tail.  Reads leave the loop
as soon as a decision fires.  Batches run one after another.

With --n-shards (an initialised process group, parallel/dist.py) the table
is hash-range-sharded over the ranks and each rank steps its block of the
batch's rows (the batch padded to a multiple of the world size).  The host
tail's inputs are all-gathered into whole-batch arrays; on the device tail
the backtrack runs on each rank's rows, its carried anchors stay there, and
only scalars and chain summaries are gathered.  Every rank then runs the
same host logic (decisions, regrows, quarantine, tail switch) on the same
gathered values, so no rank's control flow departs from another's.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import os
import sys
import time

import numpy as np
import torch

from .._native import (
    chain_tail_native, gen_regions_native, gen_regions_summ_native,
)
from ..chain.host import chain_backtrack, compact_chains
from ..chain.regions import (
    gen_regs, gen_regs_from_summaries, select_sub, set_mapq, set_parent,
    wang_hash32,
)
from ..chain.rmq import lchain_rmq_np
from ..config import MapFlag, MapOptions
from ..dtw.evaluate import evaluate_chains_batched
from ..index.build import RawIndex, update_mid_occ
from ..index.device import DeviceIndex
from ..signal.events import NormCarry
from ..utils.timers import StageProfiler
from .device_step import chunk_step, tail_finish


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
    """Mapping options this engine does not implement (none)."""
    return []


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


def tail_switch_anchors(index: RawIndex, mopt: MapOptions) -> int:
    """The anchor watermark above which the engine takes the device tail:
    the reference engine's 8 MiB per-chunk budget for the host tail's
    anchor fetch at its packed width of 2 * (key_words + 3) bytes per
    anchor (engine.py:143-152, 212-221), so both engines switch at the
    same watermark."""
    max_len = int(max(index.seq_lens)) if index.n_seq else 1
    tid_bits = (max(index.n_seq, 1) - 1).bit_length() if index.n_seq > 1 else 0
    total_bits = 1 + tid_bits + max(1, max_len.bit_length())
    key_words = 1 if total_bits <= 16 else 2 if total_bits <= 32 else 4
    return max(512, (8 << 20) // (2 * (key_words + 3) * max(1, mopt.batch_reads)))


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
        # sharded run: this rank's table shard in place of the whole table
        self.dist = self.didx = None
        if mopt.n_shards >= 1:
            from ..parallel.dist import DistContext

            self.dist = DistContext(index, mopt.n_shards, self.device)
        else:
            self.didx = DeviceIndex.from_host(index, self.device)
        self.span = self.iopt.k + self.iopt.e - 1
        self.fill_params = fill_params(self.iopt, mopt)
        # all-vs-all name ranks: the reference skips a target whose name
        # sorts <= the query's (strcmp, rmap.cpp:86); ranks in sorted-name
        # order give the same predicate.  None in the other modes.
        self._target_rank = self._sorted_names = None
        if mopt.flag & MapFlag.ALL_CHAINS:
            order = sorted(range(index.n_seq), key=lambda i: index.seq_names[i])
            ranks = np.zeros(max(index.n_seq, 1), dtype=np.int32)
            ranks[order] = np.arange(index.n_seq, dtype=np.int32)
            self._target_rank = torch.from_numpy(ranks).to(self.device)
            self._sorted_names = [index.seq_names[i] for i in order]
        self.stats = {"hit_overflow": 0, "prev_overflow": 0, "reads": 0,
                      "mapped": 0, "anchor_regrows": 0, "chain_overflow": 0,
                      "tail_chunks": 0}
        self._occ_cache = None
        # observed per-chunk anchor watermark (p95 of hits + overflow);
        # once set it sizes the next batches' a_cap instead of the model
        self._learned_need = 0
        # device-tail capacities converged by earlier batches
        self._learned_kcap = 0
        self._learned_pcap = 0
        # device-tail mode (reference engine's rule, engine.py:192-221):
        # forced by RAWHASH_TPU_DEVICE_TAIL, forbidden by
        # RAWHASH_TPU_NO_DEVICE_TAIL, else switched on once the anchor
        # watermark passes tail_switch_anchors.  Batches bind the mode at
        # creation.
        eligible = (
            not (mopt.flag & (MapFlag.DTW_EVALUATE_CHAINS | MapFlag.RMQ))
            and mopt.bw_long <= mopt.bw
            and not os.environ.get("RAWHASH_TPU_NO_DEVICE_TAIL")
        )
        self.device_tail = eligible and bool(os.environ.get("RAWHASH_TPU_DEVICE_TAIL"))
        self._tail_auto = eligible and not self.device_tail
        self.tail_switch_anchors = tail_switch_anchors(index, mopt)

    # ---------- decisions and the host tail ----------

    def _q_rank(self, name: str) -> int:
        """Rank r such that (target rank > r) <=> target name > query name
        (the reference's all-vs-all skip, rmap.cpp:86)."""
        return bisect.bisect_right(self._sorted_names, name) - 1

    def _decide(self, regs, is_dtw: bool):
        """Mapping decision for one read after a chunk
        (reference: rmap.cpp:423-500). Returns (map_chain_ids, done)."""
        mo = self.mopt
        n_cregs = len(regs)
        all_chains = bool(mo.flag & MapFlag.ALL_CHAINS)
        if n_cregs == 1 and (
            regs[0].mapq >= mo.min_mapq
            or (is_dtw and regs[0].alignment_score >= mo.dtw_min_score)
        ):
            return [0], True
        n_chains = n_cregs if (all_chains or n_cregs < 1) else 1
        mean_c = mean_q = 0.0
        if n_cregs > 0:
            mean_c = sum(r.score for r in regs) / n_cregs
            mean_q = sum(r.mapq for r in regs) / n_cregs
        maps = []
        ic = 0
        while ic < n_chains:
            best_q = float(regs[ic].mapq)
            best_c = float(regs[ic].score)
            weighted = 0.0
            if not all_chains and is_dtw:
                best_a = regs[ic].alignment_score
                if n_chains == 1:
                    # the best alignment score decides (rmap.cpp:445-457)
                    best_ind = 0
                    for i2 in range(1, n_cregs):
                        if regs[i2].alignment_score > best_a:
                            best_a = regs[i2].alignment_score
                            best_ind = i2
                    ic = best_ind
                    best_q = float(regs[ic].mapq)
                    best_c = float(regs[ic].score)
                if best_a >= mo.dtw_min_score:
                    r_bestma = max(best_a / 50.0, 0.0) if best_a > 0 else 0.0
                    r_bestmq = max(1.0 - mean_q / best_q, 0.0) if best_q > 0 else 0.0
                    r_bestmc = max(1.0 - mean_c / best_c, 0.0) if best_c > 0 else 0.0
                    weighted = (mo.w_bestma * r_bestma + mo.w_bestmq * r_bestmq
                                + mo.w_bestmc * r_bestmc)
            elif not all_chains:
                r_bestq = min(best_q / 30.0, 1.0) if best_q > 0 else 0.0
                r_bestmq = max(1.0 - mean_q / best_q, 0.0) if best_q > 0 else 0.0
                r_bestmc = max(1.0 - mean_c / best_c, 0.0) if best_c > 0 else 0.0
                weighted = (mo.w_bestq * r_bestq + mo.w_bestmq * r_bestmq
                            + mo.w_bestmc * r_bestmc)
            if weighted >= mo.w_threshold or (
                all_chains and regs[ic].score >= mo.min_chaining_score2
            ):
                maps.append(ic)
            ic += 1
        return maps, len(maps) > 0

    def _rmq(self, ax, ay, bw: int):
        """RMQ chaining of packed anchors at band width `bw`
        (reference: mg_lchain_rmq, lchain.c:606-756)."""
        mo = self.mopt
        fp = self.fill_params
        return lchain_rmq_np(
            ax, ay, max(mo.max_target_gap_length, mo.max_query_gap_length),
            mo.rmq_inner_dist, bw, mo.max_num_skips, mo.rmq_size_cap,
            mo.min_num_anchors, mo.min_chaining_score,
            fp["chn_pen_gap"], fp["chn_pen_skip"],
        )

    def _chunk_tail(self, key, tpos, qpos, n_anchors, f, p, ev_total):
        """Host tail of one chunk for one read: backtrack -> regions.
        Returns (regs, chain anchors (bx, by), carried anchors (px, py))."""
        mo = self.mopt
        n = int(n_anchors)
        ax, ay = _pack_xy(key[:n], tpos[:n], qpos[:n], self.span)
        if mo.flag & MapFlag.RMQ:
            # RMQ chaining replaces the device fill's f/p (rmap.cpp:332-334)
            u_s, bx, by, px, py = self._rmq(ax, ay, mo.bw)
        else:
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
        if mo.bw_long > mo.bw and bx.shape[0] > 0:
            # long-gap re-chaining of the chain anchors (rmap.cpp:336-340)
            u_s, bx, by, px, py = self._rmq(bx, by, mo.bw_long)
        # read hash (reference: rmap.cpp:346-348)
        h = wang_hash32((wang_hash32(ev_total) + wang_hash32(11)) & 0xFFFFFFFF)
        args = (mo.mask_level, mo.mask_len, bool(mo.flag & MapFlag.HARD_MLEVEL),
                mo.alt_drop)
        all_chains = bool(mo.flag & MapFlag.ALL_CHAINS)
        sel = (mo.pri_ratio, mo.best_n, True, int(mo.max_target_gap_length * 0.8))
        regs = gen_regions_native(h, u_s, bx, by, *args, not all_chains, *sel)
        if regs is None:  # no native toolchain: the numpy path
            regs = gen_regs(h, u_s.shape[0], u_s, bx, by)
            set_parent(regs, *args)
            if not all_chains:
                regs = select_sub(regs, *sel)
        return regs, (bx, by), (px, py)

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
        self.b = len(reads)
        # rows on the device: a sharded run pads the batch to a multiple of
        # the world size with rows that are never active (slen 0)
        self.b_dev = b = engine.dist.pad_batch(self.b) if engine.dist else self.b
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
        self.q_rank = None  # all-vs-all only: each read's query name rank
        if engine._sorted_names is not None:
            ranks = np.zeros(b, dtype=np.int32)
            ranks[: self.b] = [engine._q_rank(n) for n in self.names]
            self.q_rank = torch.from_numpy(ranks).to(engine.device)
        self.active = np.arange(b) < self.b
        self.last_regs = [[] for _ in range(b)]
        self.c_counts = np.zeros(b, dtype=np.int64)
        self.map_ids = [None] * b
        self.ev_totals = np.zeros(b, dtype=np.int64)
        self.t_start = np.full(b, time.perf_counter())
        self.t_decided = np.zeros(b, dtype=np.float64)
        self.all_events = [[] for _ in range(b)]  # DTW: each chunk's events
        self.chunk_idx = 0
        # the tail mode binds at batch creation, so an engine-level switch
        # never changes an in-flight batch
        self.tail = engine.device_tail
        # device tail: carried anchors stay on the device between chunks
        # (key, tpos, qpos, n_prev), and the chain-summary capacity grows on
        # overflow from the width earlier batches converged to
        self.prev_dev = None
        self.k_cap = max(64, engine._learned_kcap)
        if self.tail and engine._learned_pcap > self.p_cap:
            self.p_cap = engine._learned_pcap

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


def _block(engine: MappingEngine, x):
    """This rank's rows of a whole-batch tensor or NormCarry in a sharded
    run (x itself on one device, and for None)."""
    return x if engine.dist is None or x is None else engine.dist.block(x)


def _whole(engine: MappingEngine, x):
    """The whole batch of a tensor or NormCarry of which each rank holds
    its rows, gathered from every rank in a sharded run (x itself on one
    device); its time, device synchronised, is the "gather" stage."""
    if engine.dist is None:
        return x
    sync = torch.cuda.synchronize if engine.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = engine.dist.gather(x)
    sync()
    engine.profiler.add("gather", time.perf_counter() - t0)
    return out


def _count_shard_hits(engine: MappingEngine, out) -> None:
    """Add a chunk's per-rank owned seed hits to stats["shard_hits"]
    (int64 [world], rank order: (dp, shard) flattened)."""
    if engine.dist is not None:
        sh = _whole(engine, out.shard_hits.reshape(1)).cpu().numpy()
        tot = engine.stats.get("shard_hits")
        engine.stats["shard_hits"] = sh if tot is None else tot + sh


def _step(engine: MappingEngine, st: _BatchState, inputs, a_cap: int, q_rank):
    """The device chunk step on `inputs` (sig, slen, carry, ev_offset and
    the carried-anchor planes, all on the engine's device) for the reads of
    query name ranks `q_rank`.  In a sharded run these are this rank's
    rows, and so is the output."""
    mo, io = engine.mopt, engine.iopt
    step = (functools.partial(chunk_step, engine.didx) if engine.dist is None
            else engine.dist.step)
    return step(
        *inputs, q_rank, engine._target_rank,
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
        fine_min=io.fine_min, fine_max=io.fine_max, fine_range=io.fine_range,
        window_length1=mo.window_length1, window_length2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height,
        e_cap=st.e_cap, a_cap=a_cap,
        min_events=mo.min_events, mid_occ=int(mo.mid_occ),
        **{k: v for k, v in engine.fill_params.items() if k != "q_span"},
        all_vs_all=bool(mo.flag & MapFlag.ALL_CHAINS), prof=engine.profiler,
    )


def _to_host(engine: MappingEngine, out, width: int):
    """The first `width` sorted anchors (key as u32) and f/p of every row of
    `out` (of the whole batch in a sharded run), as numpy."""
    planes = (out.key, out.tpos, out.qpos, out.f, out.p)
    key, tpos, qpos, f, p = (_whole(engine, t[:, :width].contiguous()).cpu().numpy()
                             for t in planes)
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
    # the rows' inputs (a sharded run pads them to a multiple of the world
    # size with zero rows, slen 0)
    idx = torch.as_tensor(rows, device=engine.device)
    n_sub = engine.dist.pad_batch(rows.size) if engine.dist else rows.size

    def pick(x):
        if isinstance(x, NormCarry):
            return NormCarry(*(pick(c) for c in x))
        sel = x[idx]
        pad = sel.new_zeros((n_sub - rows.size,) + tuple(sel.shape[1:]))
        return _block(engine, torch.cat([sel, pad]))
    sub = tuple(pick(x) for x in inputs)
    sub_q = None if st.q_rank is None else pick(st.q_rank)
    sub_a = st.a_cap
    need = int(h_over[rows].max())
    while True:
        engine.stats["anchor_regrows"] += 1
        sub_a = min(_pow2_up(max(sub_a + need, 2 * sub_a)), cap_ceil)
        out = _step(engine, st, sub, sub_a, sub_q)
        over = _whole(engine, out.overflow).cpu().numpy()[: rows.size]
        need = int(over.max())
        if need <= 0 or sub_a >= cap_ceil:
            break
    engine.stats["hit_overflow"] += int(over.sum())
    n_anc = _whole(engine, out.n_anchors).cpu().numpy()[: rows.size]
    key, tpos, qpos, f, p = _to_host(engine, out, width=int(n_anc.max()))
    if rows.size > st.b // 4 and sub_a > st.a_cap:
        # a quarter of the batch overflowed: later chunks of this batch
        # start at the converged capacity
        st.a_cap = sub_a
    return {
        int(row): (key[j], tpos[j], qpos[j], f[j], p[j], int(n_anc[j]))
        for j, row in enumerate(rows)
    }


def _run_chunk(engine: MappingEngine, st: _BatchState) -> None:
    """One chunk of a batch: the device step, then the chain tail and the
    decision per live read (reference: rmap.cpp:415-500)."""
    mo = engine.mopt
    dev = engine.device
    c = st.chunk_idx
    no_adaptive = bool(mo.flag & MapFlag.NO_ADAPTIVE)
    chunk = np.zeros((st.b_dev, st.l_chunk), dtype=np.float32)
    slen = np.zeros(st.b_dev, dtype=np.int32)
    for i in np.nonzero(st.active)[0]:
        lo = 0 if no_adaptive else c * st.l_chunk
        seg = st.sigs[i][lo : lo + st.l_chunk]
        chunk[i, : seg.shape[0]] = seg
        slen[i] = seg.shape[0]

    t0 = time.perf_counter()
    # signal travels to the device as f16 and is widened there, as in the
    # reference engine (events depend on that rounding)
    sig = torch.from_numpy(chunk.astype(np.float16)).to(dev)
    slen_dev = torch.from_numpy(slen).to(dev)
    if st.tail:
        engine.profiler.add("transfer", time.perf_counter() - t0)
        _run_chunk_tail(engine, st, sig, slen_dev, slen)
        return
    p_use = max(1, int(st.n_prev.max()))  # live carried-anchor width
    inputs = (
        sig, slen_dev, st.carry, st.ev_offset,
        torch.from_numpy(st.prev_key[:, :p_use].astype(np.int64)).to(dev),
        torch.from_numpy(st.prev_tpos[:, :p_use]).to(dev),
        torch.from_numpy(st.prev_qpos[:, :p_use]).to(dev),
        torch.from_numpy(st.n_prev).to(dev),
    )
    engine.profiler.add("transfer", time.perf_counter() - t0)
    out = _step(engine, st, tuple(_block(engine, x) for x in inputs), st.a_cap,
                _block(engine, st.q_rank))

    t0 = time.perf_counter()
    h_nanc, h_rep, h_proc, h_over, h_evoff = (
        _whole(engine, t).cpu().numpy() for t in
        (out.n_anchors, out.rep_len, out.processed, out.overflow, out.ev_offset)
    )
    engine.profiler.add("transfer", time.perf_counter() - t0)
    if engine._tail_auto and c == 0:
        # chunk 0 already over the watermark: finish this step's output on
        # the device tail before any anchor is fetched (the carry is not
        # committed yet and chunk 0 has no carried anchors, so the step is
        # the one the device tail would run)
        wm0 = int(np.quantile(h_nanc[: st.b] + h_over[: st.b], 0.95))
        if wm0 > engine.tail_switch_anchors:
            engine._learned_need = max(engine._learned_need, wm0)
            if not engine.device_tail:
                print(f"[rawhash-tpu-torch] chunk-0 anchor watermark {wm0} > "
                      f"{engine.tail_switch_anchors}: switching to the device "
                      "tail before the anchor fetch", file=sys.stderr)
                engine.device_tail = True
            st.tail = True
            _run_chunk_tail(engine, st, sig, slen_dev, slen, out)
            return
    _count_shard_hits(engine, out)
    overrides = _quarantine_overflow(engine, st, inputs, h_over)
    # carry commits only now, so the quarantine reran the same inputs
    st.carry = _whole(engine, out.carry)
    st.ev_offset = _whole(engine, out.ev_offset)
    t0 = time.perf_counter()
    clean = np.ones(st.b_dev, dtype=bool)
    clean[list(overrides)] = False
    nmax = int(h_nanc[clean].max()) if clean.any() else 0
    h_key, h_tpos, h_qpos, h_f, h_p = _to_host(engine, out, width=nmax)
    is_dtw = bool(mo.flag & MapFlag.DTW_EVALUATE_CHAINS)
    if is_dtw:
        # events leave the device as f16, as in the reference engine
        h_nev = _whole(engine, out.n_ev).cpu().numpy()
        h_events = _whole(engine, out.events.half()).cpu().numpy().astype(np.float32)
    engine.profiler.add("transfer", time.perf_counter() - t0)

    t_host = now = time.perf_counter()
    decide = []  # (read, its chain anchors (bx, by))
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
        if is_dtw:
            st.all_events[i].append(h_events[i, : h_nev[i]].copy())
        st.ev_totals[i] = int(h_evoff[i])
        ov = overrides.get(i)
        if ov is not None:
            k_i, t_i, q_i, f_i, p_i, n_i = ov
            wms.append(min(n_i, st.a_cap))
        else:
            k_i, t_i, q_i, f_i, p_i = h_key[i], h_tpos[i], h_qpos[i], h_f[i], h_p[i]
            n_i = int(h_nanc[i])
            wms.append(n_i + int(h_over[i]))
        regs, chain_xy, (px, py) = engine._chunk_tail(
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
        decide.append((i, chain_xy))

    if is_dtw:
        # every read's chains in one batched DTW on the engine's device
        jobs = [(st.last_regs[i], bx, by, np.concatenate(st.all_events[i]))
                for i, (bx, by) in decide if st.last_regs[i]]
        if jobs:
            evaluate_chains_batched(jobs, engine.index, mo, engine.device)
    for i, _ in decide:
        regs = st.last_regs[i]
        set_mapq(regs, mo.min_chaining_score, int(h_rep[i]), is_dtw)
        ids, done = engine._decide(regs, is_dtw)
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
        if (engine._tail_auto and not engine.device_tail
                and engine._learned_need > engine.tail_switch_anchors):
            # the O(anchors) host fetch is now the cost: new batches take
            # the device tail
            engine.device_tail = True
            print(f"[rawhash-tpu-torch] anchor watermark {engine._learned_need} "
                  f"> {engine.tail_switch_anchors}: switching new batches to "
                  "the device tail", file=sys.stderr)
    st.chunk_idx += 1


def _fetch(engine: MappingEngine, t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host, its time booked as transfer."""
    t0 = time.perf_counter()
    out = t.cpu().numpy()
    engine.profiler.add("transfer", time.perf_counter() - t0)
    return out


def _step_tail(engine: MappingEngine, st: _BatchState, sig, slen):
    """The device-tail chunk step at the batch's a_cap, on the carried
    anchors the previous chunk left on the device (none for finished reads),
    up to the fill (as chunk_step_tail runs it).  In a sharded run the
    carried anchors are this rank's rows only."""
    rows = tuple(_block(engine, x) for x in (sig, slen, st.carry, st.ev_offset))
    if st.prev_dev is None:
        z = torch.zeros((rows[0].shape[0], 8), dtype=torch.int32,
                        device=engine.device)
        prev = (z.long() + 0xFFFFFFFF, z, z, z[:, 0])
    else:
        key, tpos, qpos, n_prev = st.prev_dev
        active = _block(engine, torch.from_numpy(st.active).to(engine.device))
        prev = (key, tpos, qpos, torch.where(active, n_prev, 0))
    return _step(engine, st, (*rows, *prev), st.a_cap, _block(engine, st.q_rank))


def _finish_tail(engine: MappingEngine, st: _BatchState, out):
    """Backtrack and compaction of a chunk step's output at the batch's
    k_cap and p_cap, and its per-read scalars on the host."""
    mo = engine.mopt
    tail = tail_finish(
        out, span=engine.span, bw=mo.bw, min_cnt=mo.min_num_anchors,
        min_sc=mo.min_chaining_score, k_cap=st.k_cap, p_out=st.p_cap,
        prof=engine.profiler,
    )
    return tail, _fetch(engine, _whole(engine, tail.scalars))


def _run_chunk_tail(engine: MappingEngine, st: _BatchState, sig, slen_dev,
                    slen: np.ndarray, out=None) -> None:
    """A device-tail chunk: the step (or `out`, a step already run on the
    same inputs), regrown as a whole batch until no hit, chain or carried
    anchor is dropped; then regions, MAPQ and the decision per live read
    from the per-chain summaries (reference: rmap.cpp:415-500, with the
    backtrack and compaction already done on the device)."""
    mo = engine.mopt
    engine.stats["tail_chunks"] += 1
    if out is None:
        out = _step_tail(engine, st, sig, slen_dev)
    _count_shard_hits(engine, out)
    tail, h_scal = _finish_tail(engine, st, out)
    # zero-truncation retry: grow whichever capacity overflowed and re-run
    # on the same inputs (carry and carried anchors commit only afterwards);
    # a_cap needs the step again, k_cap and p_cap only the tail
    cap_ceil = int(mo.max_anchor_cap)
    while cap_ceil > 0:
        grew = []
        for attr, col in (("a_cap", 4), ("k_cap", 6), ("p_cap", 7)):
            need, cap = int(h_scal[:, col].max()), getattr(st, attr)
            if need > 0 and cap < cap_ceil:
                new = 1 << int(np.ceil(np.log2(cap + need)))
                setattr(st, attr, min(max(new, 2 * cap), cap_ceil))
                grew.append(attr)
        if not grew:
            break
        engine.stats["anchor_regrows"] += 1
        if "a_cap" in grew:
            out = _step_tail(engine, st, sig, slen_dev)
        tail, h_scal = _finish_tail(engine, st, out)
    # the next batches start at the converged capacities
    engine._learned_need = max(engine._learned_need, st.a_cap)
    engine._learned_kcap = max(engine._learned_kcap, st.k_cap)
    engine._learned_pcap = max(engine._learned_pcap, st.p_cap)
    st.carry = _whole(engine, tail.carry)
    st.ev_offset = _whole(engine, tail.ev_offset)
    st.prev_dev = (tail.prev_key, tail.prev_tpos, tail.prev_qpos, tail.n_prev)
    act = st.active
    engine.stats["hit_overflow"] += int(h_scal[act, 4].sum())
    engine.stats["prev_overflow"] += int(h_scal[act, 7].sum())
    engine.stats["chain_overflow"] += int(h_scal[act, 6].sum())
    # the summaries of the live chains only: [B, max n_u, 10]
    summ = _fetch(engine, _whole(engine, tail.summaries[:, : int(h_scal[:, 0].max())]
                                 .contiguous()))

    t_host = now = time.perf_counter()
    c = st.chunk_idx
    span = engine.span
    all_chains = bool(mo.flag & MapFlag.ALL_CHAINS)
    sel = (mo.pri_ratio, mo.best_n, True, int(mo.max_target_gap_length * 0.8))
    par = (mo.mask_level, mo.mask_len, bool(mo.flag & MapFlag.HARD_MLEVEL),
           mo.alt_drop)
    for i in range(st.b):
        if not st.active[i]:
            continue
        if slen[i] == 0:
            st.active[i] = False
            continue
        st.c_counts[i] = c
        if not h_scal[i, 3]:
            st.last_regs[i] = []
            continue
        ev_total = int(h_scal[i, 5])
        st.ev_totals[i] = ev_total
        # read hash (reference: rmap.cpp:346-348)
        h = wang_hash32((wang_hash32(ev_total) + wang_hash32(11)) & 0xFFFFFFFF)
        rows = summ[i, : int(h_scal[i, 0])]
        regs = gen_regions_summ_native(h, rows, span, *par, not all_chains, *sel)
        if regs is None:  # no native toolchain: the numpy path
            regs = gen_regs_from_summaries(h, rows, span)
            set_parent(regs, *par)
            if not all_chains:
                regs = select_sub(regs, *sel)
        st.last_regs[i] = regs
        set_mapq(regs, mo.min_chaining_score, int(h_scal[i, 1]), False)
        ids, done = engine._decide(regs, False)
        if done:
            st.map_ids[i] = ids
            st.t_decided[i] = now
            st.active[i] = False
    engine.profiler.add("host_tail", time.perf_counter() - t_host)
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
