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
as soon as a decision fires.

Up to --pipeline-depth batches are in flight (the reference engine's
scheduler).  Each chunk runs in two parts: `_submit_chunk` on the calling
thread assembles it, copies it to the device and runs the step;
`_process_chunk` on a worker of a pool of min(depth, 3) does everything
after the step (fetches, quarantine reruns, the tail, decisions).  A
batch's next chunk is submitted only once its previous chunk's worker has
returned, and results leave in submission order.  On a card each batch in
flight runs its device work on a CUDA stream of its own; counters and the
learned capacities shared by the batches sit under `engine._stats_lock`.
At depth 1 each chunk runs whole on the calling thread, on the caller's
stream.

With --n-shards (an initialised process group, parallel/dist.py) the table
is hash-range-sharded over the ranks and each rank steps its block of the
batch's rows (the batch padded to a multiple of the world size).  The host
tail's inputs are all-gathered into whole-batch arrays; on the device tail
the backtrack runs on each rank's rows, its carried anchors stay there, and
only scalars and chain summaries are gathered.  Every rank then runs the
same host logic (decisions, regrows, quarantine, tail switch) on the same
gathered values, so no rank's control flow departs from another's.  A
sharded run keeps every chunk on the calling thread, whatever
--pipeline-depth says, so every rank issues its collectives in one order.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import functools
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from .. import _native
from .._native import chain_tail_native, gen_regions_native, tail_decide_batch
from ..chain.host import chain_backtrack, compact_chains
from ..chain.regions import (
    RegionRows, gen_regs, select_sub, set_mapq, set_parent, wang_hash32,
)
from ..chain.rmq import lchain_rmq_np
from ..config import MapFlag, MapOptions
from ..dtw.evaluate import evaluate_chains_batched
from ..index.build import RawIndex, update_mid_occ
from ..index.device import DeviceIndex
from ..signal.events import NormCarry, events_fused
from ..utils.timers import NO_SPAN, TRANSFER, WAIT, StageProfiler
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
    same watermark.  As there, a non-empty RAWHASH_TPU_TAIL_SWITCH_ANCHORS
    is the watermark, and RAWHASH_TPU_TAIL_SWITCH_BYTES replaces the 8 MiB
    budget."""
    anchors = os.environ.get("RAWHASH_TPU_TAIL_SWITCH_ANCHORS")
    if anchors:
        return int(anchors)
    budget = int(os.environ.get("RAWHASH_TPU_TAIL_SWITCH_BYTES", str(8 << 20)))
    max_len = int(max(index.seq_lens)) if index.n_seq else 1
    tid_bits = (max(index.n_seq, 1) - 1).bit_length() if index.n_seq > 1 else 0
    total_bits = 1 + tid_bits + max(1, max_len.bit_length())
    key_words = 1 if total_bits <= 16 else 2 if total_bits <= 32 else 4
    return max(512, budget // (2 * (key_words + 3) * max(1, mopt.batch_reads)))


class MappingEngine:
    def __init__(self, index: RawIndex, mopt: MapOptions, device="cuda",
                 trace: bool = False):
        missing = unsupported_options(mopt)
        if missing:
            raise NotImplementedError(
                "not supported by the PyTorch engine yet: " + ", ".join(missing)
            )
        self.device = torch.device(device)
        # guards what the batches in flight share: stats, the profiler, the
        # learned capacities and the tail switch
        self._stats_lock = threading.RLock()
        # the tracer: on with `trace` or while a torch.profiler records
        self.profiler = StageProfiler(self._stats_lock, on=trace)
        self.index = index
        self.iopt = index.opts
        self.mopt = mopt
        update_mid_occ(mopt, index)
        # sharded run: this rank's table shard in place of the whole table
        self.dist = self.didx = None
        if mopt.n_shards >= 1:
            from ..parallel.dist import DistContext

            self.dist = DistContext(index, mopt.n_shards, self.device)
            if mopt.pipeline_depth > 1 and self.dist.rank == 0:
                print(f"[rawhash-tpu-torch] sharded run: every chunk on the "
                      f"calling thread (--pipeline-depth {mopt.pipeline_depth} "
                      "not applied), so every rank issues its collectives in "
                      "one order", file=sys.stderr)
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
        # events_fused_steps: chunk steps whose events stage ran as the
        # kernels (on the card), events_fused_wide_steps those of them that
        # staged a row in global memory (rows too wide for shared memory)
        self.stats = {"hit_overflow": 0, "prev_overflow": 0, "reads": 0,
                      "mapped": 0, "anchor_regrows": 0, "chain_overflow": 0,
                      "tail_chunks": 0, "events_fused_steps": 0,
                      "events_fused_wide_steps": 0}
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
        # watermark passes tail_switch_anchors.  Its decisions are one call
        # of the native library a chunk, so where the library does not load
        # every chunk keeps the host tail.  Batches bind the mode at creation.
        eligible = (
            not (mopt.flag & (MapFlag.DTW_EVALUATE_CHAINS | MapFlag.RMQ))
            and mopt.bw_long <= mopt.bw
            and not os.environ.get("RAWHASH_TPU_NO_DEVICE_TAIL")
        )
        forced = bool(os.environ.get("RAWHASH_TPU_DEVICE_TAIL"))
        if eligible and _native.get_lib() is None:
            eligible = False
            if forced:
                print("[rawhash-tpu-torch] RAWHASH_TPU_DEVICE_TAIL not applied: "
                      "the device tail decides through the native library, "
                      "which did not load; every chunk takes the host tail",
                      file=sys.stderr)
        self.device_tail = eligible and forced
        self._tail_auto = eligible and not forced
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
        args, sel = _tail_params(mo)
        all_chains = bool(mo.flag & MapFlag.ALL_CHAINS)
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

    @property
    def pipeline_depth(self) -> int:
        """Batches in flight: --pipeline-depth, but 1 in a sharded run."""
        return 1 if self.dist is not None else max(1, int(self.mopt.pipeline_depth))

    def map_stream(self, batches):
        """Map batches of (name, signal); yields one list of ReadResult per
        batch, in the order of `batches`, with up to pipeline_depth batches
        in flight (rawhash_tpu/map/engine.py::_map_stream_impl).  Closing
        the generator early waits for the chunks already submitted."""
        depth = self.pipeline_depth
        if depth > 1:
            yield from _map_overlapped(self, batches, depth)
            return
        for order, reads in enumerate(batches):
            st = _BatchState(self, reads)
            st.order = order
            while not st.done():
                _run_chunk(self, st)
            yield _finalize_batch(self, st)

    def map_batch(self, reads: list) -> list:
        stream = self.map_stream([reads])
        try:
            return next(stream)
        finally:
            stream.close()


def _map_overlapped(engine: MappingEngine, batches, depth: int):
    """map_stream with up to `depth` batches in flight: each batch's chunk
    is submitted on the calling thread and processed by a worker; the
    batch's next chunk is submitted once that worker returned, and results
    are held until every earlier batch's have left."""
    batches = iter(batches)
    inflight = collections.deque()
    results = {}
    n_in = n_out = 0
    # the workers take the calling thread's intra-op thread count (a new
    # thread would otherwise start from the default, every core)
    with ThreadPoolExecutor(max_workers=min(depth, 3),
                            thread_name_prefix="rawhash-chunk",
                            initializer=torch.set_num_threads,
                            initargs=(torch.get_num_threads(),)) as pool:

        def submit(st):
            _submit_chunk(engine, st)
            st.future = pool.submit(_process_chunk, engine, st)
            inflight.append(st)

        def pull():
            nonlocal n_in
            reads = next(batches, None)
            if reads is None:
                return
            st = _BatchState(engine, reads, _batch_stream(engine))
            st.order, n_in = n_in, n_in + 1
            if st.done():
                results[st.order] = _finalize_batch(engine, st)
            else:
                submit(st)

        for _ in range(depth):
            pull()
        while inflight or n_out in results:
            if inflight:
                st = inflight.popleft()
                if st.trace:
                    with engine.profiler.stage("worker_wait", _ids(st), kind=WAIT):
                        st.future.result()
                        taken = time.perf_counter()
                    # the batch's queue wait behind older batches
                    engine.profiler.add("handoff", taken - st.t_returned)
                else:
                    st.future.result()
                if st.done():
                    results[st.order] = _finalize_batch(engine, st)
                    pull()
                else:
                    submit(st)
            while n_out in results:
                yield results.pop(n_out)
                n_out += 1


def _batch_stream(engine: MappingEngine):
    """A CUDA stream of its own for a batch in flight, after all the work
    queued so far on the calling thread's stream (the index, the engine's
    tables); None off the card (the current stream then)."""
    if engine.device.type != "cuda":
        return None
    stream = torch.cuda.Stream(engine.device)
    stream.wait_stream(torch.cuda.current_stream(engine.device))
    return stream


def _count(engine: MappingEngine, **adds) -> None:
    """Add to engine.stats under the engine's lock."""
    with engine._stats_lock:
        for key, n in adds.items():
            engine.stats[key] += n


def _learn(engine: MappingEngine, need=0, kcap=0, pcap=0) -> None:
    """Raise the capacities later batches start from."""
    with engine._stats_lock:
        engine._learned_need = max(engine._learned_need, need)
        engine._learned_kcap = max(engine._learned_kcap, kcap)
        engine._learned_pcap = max(engine._learned_pcap, pcap)


class _BatchState:
    """All per-batch mapping state across the chunk loop."""

    def __init__(self, engine: MappingEngine, reads: list, stream=None):
        self.b = len(reads)
        # rows on the device: a sharded run pads the batch to a multiple of
        # the world size with rows that are never active (slen 0)
        self.b_dev = b = engine.dist.pad_batch(self.b) if engine.dist else self.b
        self.names = [n for n, _ in reads]
        self.sigs = [np.asarray(s, dtype=np.float32) for _, s in reads]
        self.qlens = np.array([s.shape[0] for s in self.sigs], dtype=np.int64)
        # the batch's CUDA stream (None: the current stream); every tensor
        # of the batch is made and used on it
        self.stream = stream
        self.pending = None  # a submitted chunk's step (_Pending)
        # tracing: the batch's id in its stream, whether its current chunk
        # is traced (read once per chunk step) and when its worker returned
        self.order = 0
        self.trace = False
        self.t_returned = 0.0
        with engine._stats_lock:
            (self.l_chunk, self.max_chunk, self.e_cap, self.a_cap,
             self.p_cap) = engine._plan(self.qlens)
            # the tail mode binds at batch creation, so an engine-level
            # switch never changes an in-flight batch
            self.tail = engine.device_tail
            learned_kcap, learned_pcap = engine._learned_kcap, engine._learned_pcap
        with torch.cuda.stream(stream):
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
            with torch.cuda.stream(stream):
                self.q_rank = torch.from_numpy(ranks).to(engine.device)
        self.active = np.arange(b) < self.b
        self.last_regs = [[] for _ in range(b)]
        self.c_counts = np.zeros(b, dtype=np.int64)
        self.map_ids = [None] * b
        self.ev_totals = np.zeros(b, dtype=np.int64)
        self.t_start = np.full(b, time.perf_counter())
        self.t_decided = np.zeros(b, dtype=np.float64)
        # the device tail's batch decisions: each chunk's tail_decide_batch
        # result, and per read the chunk its last regions and mapped ids are
        # in (-1: in last_regs and map_ids)
        self.decided = []
        self.regs_at = np.full(b, -1, dtype=np.int32)
        self.all_events = [[] for _ in range(b)]  # DTW: each chunk's events
        self.chunk_idx = 0
        # device tail: carried anchors stay on the device between chunks
        # (key, tpos, qpos, n_prev), and the chain-summary capacity grows on
        # overflow from the width earlier batches converged to
        self.prev_dev = None
        self.k_cap = max(64, learned_kcap)
        if self.tail and learned_pcap > self.p_cap:
            self.p_cap = learned_pcap

    def done(self) -> bool:
        return self.chunk_idx >= self.max_chunk or not self.active.any()

    def regions(self, i: int):
        """Read i's last regions (a Region list or RegionRows) and its
        mapped ids (None: undecided)."""
        k = self.regs_at[i]
        if k < 0:
            return self.last_regs[i], self.map_ids[i]
        rows, ids, off, n_regs, n_ids = self.decided[k]
        o = off[i]
        # a read live but not processed in that chunk (n_regs -1) has none
        return (RegionRows(rows[o:o + max(n_regs[i], 0)]),
                ids[o:o + n_ids[i]].tolist() if n_ids[i] else None)

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


def _whole(engine: MappingEngine, st: _BatchState, x):
    """The whole batch of a tensor or NormCarry of which each rank holds
    its rows, gathered from every rank in a sharded run (x itself on one
    device); on a traced chunk it is the "gather" stage, the current
    stream synchronised at both ends."""
    if engine.dist is None:
        return x
    with _span(engine, st, "gather", device=engine.device, lead=True):
        return engine.dist.gather(x)


def _ids(st: _BatchState) -> str:
    """The ids of a batch's current chunk, in its spans' names."""
    return f"batch={st.order} chunk={st.chunk_idx}"


def _span(engine: MappingEngine, st: _BatchState, name: str, **kw):
    """The span of stage `name` of the batch's current chunk
    (StageProfiler.stage), or no span if the chunk is not traced."""
    return engine.profiler.stage(name, _ids(st), **kw) if st.trace else NO_SPAN


def _range(engine: MappingEngine, st: _BatchState, name: str):
    """The range `rh.<name>` of the batch's current chunk, or none if the
    chunk is not traced."""
    return engine.profiler.range(name, _ids(st)) if st.trace else NO_SPAN


def _stage_spans(engine: MappingEngine, st: _BatchState):
    """The `prof` of the device step's stages: StageProfiler.stage with the
    chunk's ids bound, or None if the chunk is not traced."""
    return functools.partial(engine.profiler.stage, ids=_ids(st)) if st.trace else None


def _count_shard_hits(engine: MappingEngine, st: _BatchState, out) -> None:
    """Add a chunk's per-rank owned seed hits to stats["shard_hits"]
    (int64 [world], rank order: (dp, shard) flattened)."""
    if engine.dist is not None:
        sh = _whole(engine, st, out.shard_hits.reshape(1)).cpu().numpy()
        with engine._stats_lock:
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
    calls, wide = events_fused.calls, events_fused.wide_calls
    out = step(
        *inputs, q_rank, engine._target_rank,
        diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
        fine_min=io.fine_min, fine_max=io.fine_max, fine_range=io.fine_range,
        window_length1=mo.window_length1, window_length2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height,
        e_cap=st.e_cap, a_cap=a_cap,
        min_events=mo.min_events, mid_occ=int(mo.mid_occ),
        **{k: v for k, v in engine.fill_params.items() if k != "q_span"},
        all_vs_all=bool(mo.flag & MapFlag.ALL_CHAINS), prof=_stage_spans(engine, st),
    )
    # what the events stage recorded of the step: whether it ran as the
    # kernels, and whether they staged a row in global memory
    _count(engine, events_fused_steps=int(events_fused.calls > calls),
           events_fused_wide_steps=int(events_fused.wide_calls > wide))
    return out


def _to_host(engine: MappingEngine, st: _BatchState, out, width: int):
    """The first `width` sorted anchors (key as u32) and f/p of every row of
    `out` (of the whole batch in a sharded run), as numpy."""
    planes = (out.key, out.tpos, out.qpos, out.f, out.p)
    key, tpos, qpos, f, p = (_whole(engine, st, t[:, :width].contiguous()).cpu().numpy()
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
        _count(engine, hit_overflow=int(h_over[rows].sum()))
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
        _count(engine, anchor_regrows=1)
        sub_a = min(_pow2_up(max(sub_a + need, 2 * sub_a)), cap_ceil)
        out = _step(engine, st, sub, sub_a, sub_q)
        over = _whole(engine, st, out.overflow).cpu().numpy()[: rows.size]
        need = int(over.max())
        if need <= 0 or sub_a >= cap_ceil:
            break
    _count(engine, hit_overflow=int(over.sum()))
    n_anc = _whole(engine, st, out.n_anchors).cpu().numpy()[: rows.size]
    key, tpos, qpos, f, p = _to_host(engine, st, out, width=int(n_anc.max()))
    if rows.size > st.b // 4 and sub_a > st.a_cap:
        # a quarter of the batch overflowed: later chunks of this batch
        # start at the converged capacity
        st.a_cap = sub_a
    return {
        int(row): (key[j], tpos[j], qpos[j], f[j], p[j], int(n_anc[j]))
        for j, row in enumerate(rows)
    }


class _Pending(NamedTuple):
    """A submitted chunk: its step's output, the step's inputs (None on the
    device tail), the chunk's signal and lengths on the device, and its
    lengths on the host."""

    out: object
    inputs: tuple | None
    sig: torch.Tensor
    slen_dev: torch.Tensor
    slen: np.ndarray


def _run_chunk(engine: MappingEngine, st: _BatchState) -> None:
    """One chunk of a batch, whole, on the calling thread: the device step,
    then the chain tail and the decision per live read (reference:
    rmap.cpp:415-500)."""
    _submit_chunk(engine, st)
    _process_chunk(engine, st)


def _submit_chunk(engine: MappingEngine, st: _BatchState) -> None:
    """The calling thread's part of a chunk: assemble it, copy it to the
    device and run the step on the batch's stream (up to the fill; on the
    device tail, on the anchors the previous chunk carried).  Its output
    waits in st.pending for _process_chunk; nothing is fetched.  Whether the
    chunk is traced is read here, once."""
    mo = engine.mopt
    dev = engine.device
    c = st.chunk_idx
    st.trace = engine.profiler.tracing()
    with _range(engine, st, "submit"):
        no_adaptive = bool(mo.flag & MapFlag.NO_ADAPTIVE)
        chunk = np.zeros((st.b_dev, st.l_chunk), dtype=np.float32)
        slen = np.zeros(st.b_dev, dtype=np.int32)
        for i in np.nonzero(st.active)[0]:
            lo = 0 if no_adaptive else c * st.l_chunk
            seg = st.sigs[i][lo : lo + st.l_chunk]
            chunk[i, : seg.shape[0]] = seg
            slen[i] = seg.shape[0]

        with torch.cuda.stream(st.stream):
            with _span(engine, st, "transfer", kind=TRANSFER):
                # signal travels to the device as f16 and is widened there,
                # as in the reference engine (events depend on that rounding)
                sig = torch.from_numpy(chunk.astype(np.float16)).to(dev)
                slen_dev = torch.from_numpy(slen).to(dev)
                inputs = None
                if not st.tail:
                    p_use = max(1, int(st.n_prev.max()))  # live carried-anchor width
                    inputs = (
                        sig, slen_dev, st.carry, st.ev_offset,
                        torch.from_numpy(st.prev_key[:, :p_use].astype(np.int64)).to(dev),
                        torch.from_numpy(st.prev_tpos[:, :p_use]).to(dev),
                        torch.from_numpy(st.prev_qpos[:, :p_use]).to(dev),
                        torch.from_numpy(st.n_prev).to(dev),
                    )
            if inputs is None:
                out = _step_tail(engine, st, sig, slen_dev)
            else:
                out = _step(engine, st, tuple(_block(engine, x) for x in inputs),
                            st.a_cap, _block(engine, st.q_rank))
        st.pending = _Pending(out, inputs, sig, slen_dev, slen)


def _process_chunk(engine: MappingEngine, st: _BatchState) -> None:
    """Everything of a submitted chunk after its step, on the batch's stream
    (on a worker when batches overlap); then the batch moves on a chunk."""
    pend, st.pending = st.pending, None
    with torch.cuda.stream(st.stream), _range(engine, st, "process"):
        if pend.inputs is None:
            _process_tail(engine, st, pend)
        else:
            _process_host(engine, st, pend)
    st.chunk_idx += 1
    if st.trace:
        st.t_returned = time.perf_counter()


def _process_host(engine: MappingEngine, st: _BatchState, pend: _Pending) -> None:
    """A host-tail chunk after its step: the scalars, the quarantine of
    overflowed rows, the anchors on the host, the native chain tail, DTW,
    MAPQ and the decision per live read (reference: rmap.cpp:415-500)."""
    mo = engine.mopt
    c = st.chunk_idx
    out, inputs, slen = pend.out, pend.inputs, pend.slen
    with _span(engine, st, "transfer", kind=TRANSFER):
        h_nanc, h_rep, h_proc, h_over, h_evoff = (
            _whole(engine, st, t).cpu().numpy() for t in
            (out.n_anchors, out.rep_len, out.processed, out.overflow, out.ev_offset)
        )
    if engine._tail_auto and c == 0:
        # chunk 0 already over the watermark: finish this step's output on
        # the device tail before any anchor is fetched (the carry is not
        # committed yet and chunk 0 has no carried anchors, so the step is
        # the one the device tail would run)
        wm0 = int(np.quantile(h_nanc[: st.b] + h_over[: st.b], 0.95))
        if wm0 > engine.tail_switch_anchors:
            with engine._stats_lock:
                engine._learned_need = max(engine._learned_need, wm0)
                if not engine.device_tail:
                    print(f"[rawhash-tpu-torch] chunk-0 anchor watermark {wm0} > "
                          f"{engine.tail_switch_anchors}: switching to the device "
                          "tail before the anchor fetch", file=sys.stderr)
                    engine.device_tail = True
            st.tail = True
            _process_tail(engine, st, pend)
            return
    _count_shard_hits(engine, st, out)
    overrides = _quarantine_overflow(engine, st, inputs, h_over)
    # carry commits only now, so the quarantine reran the same inputs
    st.carry = _whole(engine, st, out.carry)
    st.ev_offset = _whole(engine, st, out.ev_offset)
    is_dtw = bool(mo.flag & MapFlag.DTW_EVALUATE_CHAINS)
    with _span(engine, st, "transfer", kind=TRANSFER):
        clean = np.ones(st.b_dev, dtype=bool)
        clean[list(overrides)] = False
        nmax = int(h_nanc[clean].max()) if clean.any() else 0
        h_key, h_tpos, h_qpos, h_f, h_p = _to_host(engine, st, out, width=nmax)
        if is_dtw:
            # events leave the device as f16, as in the reference engine
            h_nev = _whole(engine, st, out.n_ev).cpu().numpy()
            h_events = (_whole(engine, st, out.events.half()).cpu().numpy()
                        .astype(np.float32))

    now = time.perf_counter()  # the decisions' time (the mt:f tag)
    with _span(engine, st, "host_tail"):
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
                _count(engine, prev_overflow=px.shape[0] - st.p_cap)
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
    if wms:
        # 95th percentile: the main step fits the typical read; outliers
        # go through the quarantine sub-batch
        wm = int(np.quantile(np.asarray(wms), 0.95))
        with engine._stats_lock:
            engine._learned_need = max(engine._learned_need, wm)
            if (engine._tail_auto and not engine.device_tail
                    and engine._learned_need > engine.tail_switch_anchors):
                # the O(anchors) host fetch is now the cost: new batches
                # take the device tail
                engine.device_tail = True
                print(f"[rawhash-tpu-torch] anchor watermark "
                      f"{engine._learned_need} > {engine.tail_switch_anchors}: "
                      "switching new batches to the device tail", file=sys.stderr)


def _fetch(engine: MappingEngine, st: _BatchState, t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host, its time booked as transfer."""
    with _span(engine, st, "transfer", kind=TRANSFER):
        return t.cpu().numpy()


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
        prof=_stage_spans(engine, st),
    )
    return tail, _fetch(engine, st, _whole(engine, st, tail.scalars))


def _process_tail(engine: MappingEngine, st: _BatchState, pend: _Pending) -> None:
    """A device-tail chunk after its step (the device tail's, or chunk 0's
    host-tail step, which is the same on a batch with no carried anchors):
    backtrack and compaction, regrown as a whole batch until no hit, chain
    or carried anchor is dropped; then regions, MAPQ and the decision per
    live read from the per-chain summaries (reference: rmap.cpp:415-500,
    with the backtrack and compaction already done on the device)."""
    mo = engine.mopt
    out, sig, slen_dev, slen = pend.out, pend.sig, pend.slen_dev, pend.slen
    _count(engine, tail_chunks=1)
    _count_shard_hits(engine, st, out)
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
        _count(engine, anchor_regrows=1)
        if "a_cap" in grew:
            out = _step_tail(engine, st, sig, slen_dev)
        tail, h_scal = _finish_tail(engine, st, out)
    # the next batches start at the converged capacities
    _learn(engine, need=st.a_cap, kcap=st.k_cap, pcap=st.p_cap)
    st.carry = _whole(engine, st, tail.carry)
    st.ev_offset = _whole(engine, st, tail.ev_offset)
    st.prev_dev = (tail.prev_key, tail.prev_tpos, tail.prev_qpos, tail.n_prev)
    act = st.active
    _count(engine, hit_overflow=int(h_scal[act, 4].sum()),
           prev_overflow=int(h_scal[act, 7].sum()),
           chain_overflow=int(h_scal[act, 6].sum()))
    # the summaries of the live chains only: [B, max n_u, 10]
    live = tail.summaries[:, : int(h_scal[:, 0].max())].contiguous()
    summ = _fetch(engine, st, _whole(engine, st, live))

    now = time.perf_counter()  # the decisions' time (the mt:f tag)
    with _span(engine, st, "host_tail"):
        _decide_batch(engine, st, summ, h_scal, slen, now)


def _tail_params(mo: MapOptions):
    """The region pipeline's parameters: set_parent's, then select_sub's."""
    par = (mo.mask_level, mo.mask_len, bool(mo.flag & MapFlag.HARD_MLEVEL),
           mo.alt_drop)
    sel = (mo.pri_ratio, mo.best_n, True, int(mo.max_target_gap_length * 0.8))
    return par, sel


def _decide_batch(engine: MappingEngine, st: _BatchState, summ, h_scal,
                  slen, now: float) -> None:
    """A device-tail chunk's regions, MAPQ and decisions for the whole batch
    in one native call (tail_decide_batch, the interpreter lock released),
    and the batch's state updated over the rows at once."""
    mo = engine.mopt
    b = st.b
    par, sel = _tail_params(mo)
    active = st.active[:b]
    res = tail_decide_batch(
        summ[:b], h_scal[:b], active, slen[:b], engine.span, *par,
        bool(mo.flag & MapFlag.ALL_CHAINS), *sel,
        mo.min_chaining_score, mo.min_mapq, mo.w_bestq, mo.w_bestmq,
        mo.w_bestmc, mo.w_threshold, mo.min_chaining_score2,
    )
    n_regs, n_ids = res[3], res[4]
    live = active & (slen[:b] != 0)
    dec = n_regs >= 0  # live and processed
    # a live read's last regions are this chunk's (none if not processed)
    st.c_counts[:b][live] = st.chunk_idx
    st.ev_totals[:b][dec] = h_scal[:b, 5][dec]
    st.regs_at[:b][live] = len(st.decided)
    st.decided.append(res)
    done = n_ids > 0
    st.t_decided[:b][done] = now
    active &= live & ~done  # reads with no signal left, or decided, stop


def _finalize_batch(engine: MappingEngine, st: _BatchState) -> list:
    """Build ReadResults (reference: rmap.cpp:507-586)."""
    with _range(engine, st, "finalize"):
        mo = engine.mopt
        no_adaptive = bool(mo.flag & MapFlag.NO_ADAPTIVE)
        out_results = []
        n_mapped = 0
        now = time.perf_counter()
        sig_t = engine.index.sig_target
        for i in range(st.b):
            qlen = int(st.qlens[i])
            cc = 0 if no_adaptive else int(st.c_counts[i])
            regs, ids = st.regions(i)
            top = regs[0] if len(regs) else None
            # last-chance accept (reference: rmap.cpp:515-519)
            if ids is None and top is not None and top.mapq > mo.min_mapq:
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
                n_mapped += 1
            else:
                if top is not None:
                    tags = engine._tags(mt, cc + 1, qlen, top.cnt, len(regs),
                                        top.score)
                else:
                    tags = engine._tags(mt, cc + 1, qlen, 0, 0, 0)
                rl = offset if sig_t else int(scale * offset)
                recs.append(MapRecord(read_length=rl, mapped=0, tags=tags))
            out_results.append(ReadResult(name=st.names[i], records=recs))
        _count(engine, reads=st.b, mapped=n_mapped)
    return out_results
