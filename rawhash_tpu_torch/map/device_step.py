"""The per-chunk device step (port of rawhash_tpu/map/device_step.py,
single device):

    detect events -> sketch -> index lookup -> occurrence filter + rep_len ->
    CSR hit expansion -> merge carried anchors -> sort -> chaining DP fill

`chunk_step` stops there, and the host (map/engine.py) backtracks chains
and decides per read.  `chunk_step_tail` goes on on the device: chain
backtrack -> compaction -> carried-anchor re-pick, so only per-chain
summaries leave it and the carried anchors stay on it (reference: the body
of ri_map_frag, rmap.cpp:210-387, with lchain.c:95-281).  The lookup and
expansion is a parameter of both: `lookup_expand` on the device's whole
table by default, the collective seed merge over a hash-range-sharded
table in a sharded run (parallel/dist.py); the rest of the step is the
same code either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..chain.backtrack import chain_backtrack, compact_from_chain_stats
from ..chain.fill import chain_fill
from ..index.device import DeviceIndex, expand_hits, lookup_counts
from ..signal.events import NormCarry, dense_compact, detect_events_batch
from ..sketch.device import sketch_batch

U32_MAX = 0xFFFFFFFF
I32_MAX = 0x7FFFFFFF
# the stages of chunk_step and of tail_finish, in the order they run
STEP_STAGES = ("events", "sketch", "lookup+expand", "sort", "fill")
TAIL_STAGES = ("backtrack", "compact")


class ChunkOut(NamedTuple):
    """All int32 except `processed` (bool); anchors sorted by (key, tpos)."""

    key: torch.Tensor  # [B, N] key bits (rev<<31 | tid)
    tpos: torch.Tensor  # [B, N]
    qpos: torch.Tensor  # [B, N]
    f: torch.Tensor  # [B, N] chain score ending at each anchor
    p: torch.Tensor  # [B, N] best predecessor, -1 if none
    n_anchors: torch.Tensor  # [B]
    rep_len: torch.Tensor  # [B]
    n_ev: torch.Tensor  # [B]
    processed: torch.Tensor  # [B] enough events to map this chunk
    overflow: torch.Tensor  # [B] seed hits past a_cap (not in the anchors)
    carry: NormCarry
    ev_offset: torch.Tensor  # [B] event offset after this chunk
    events: torch.Tensor  # f32 [B, e_cap] this chunk's events (for DTW)
    # sharded runs: the seed hits this rank's table shard owns, over its
    # shard column's rows (int64 scalar); None on one device
    shard_hits: torch.Tensor | None = None


class Lookup(NamedTuple):
    """Seed lookup and CSR expansion of a batch: the anchors in slot order
    (key bits as u32 values, tpos, qpos; int64 [B, a_cap]), hits kept and
    past a_cap, rep_len (int32 [B]), and in a sharded run this rank's
    owned hits (shard_hits)."""

    a_key: torch.Tensor
    a_tpos: torch.Tensor
    a_qpos: torch.Tensor
    n_hits: torch.Tensor
    overflow: torch.Tensor
    rep_len: torch.Tensor
    shard_hits: torch.Tensor | None = None


class _Stages:
    """A step's stages one after another, each a span of the tracer (`prof`,
    StageProfiler.stage with the chunk's ids bound) that syncs the current
    stream at its mark, so the time lands on the stage that spent it; the
    first also syncs at its start.  Each runs from the previous stage's
    mark (the first from here) to its own, `mark(name)`, in the order of
    `names`.  Only the current stream: batches in flight on other streams
    go on, so with several in flight a stage's time is its batch's, and the
    stages' sums may pass the wall time."""

    def __init__(self, prof, device: torch.device, names: tuple):
        self.prof, self.device, self.names = prof, device, iter(names)
        self.span = prof(next(self.names), device=device, lead=True).__enter__()

    def mark(self, name: str) -> None:
        if name != self.span.name:
            raise RuntimeError(f"stage {name!r} marked inside {self.span.name!r}")
        self.span.__exit__(None, None, None)
        nxt = next(self.names, None)
        if nxt is not None:
            self.span = self.prof(nxt, device=self.device).__enter__()


def events_and_sketch(
    sig, slen, carry, *,
    window_length1, window_length2, threshold1, threshold2, peak_height,
    e_cap, min_events,
    diff, w, e, q, k, fine_min, fine_max, fine_range,
    stages: _Stages | None = None,
):
    """Event detection (revent.c:257; sig f16 or f32, widened to f32 as
    the events stage reads it) then sketching (rsketch.c:271)."""
    events, n_ev, carry2 = detect_events_batch(
        sig, slen, carry,
        window_length1=window_length1, window_length2=window_length2,
        threshold1=threshold1, threshold2=threshold2, peak_height=peak_height,
        e_cap=e_cap,
    )
    if stages is not None:
        stages.mark("events")
    processed = n_ev >= min_events  # reference: rmap.cpp:232
    hashes, qpos_seed, seed_valid = sketch_batch(
        events, n_ev,
        diff=diff, w=w, e=e, q=q, k=k,
        fine_min=fine_min, fine_max=fine_max, fine_range=fine_range,
    )
    seed_valid = seed_valid & processed[:, None]
    if stages is not None:
        stages.mark("sketch")
    return events, n_ev, carry2, processed, hashes, qpos_seed, seed_valid


def rep_len_from_filtered(qpos_seed, flt, span: int):
    """Union length of the q-intervals of occurrence-filtered seeds
    (rseed.c:134-151)."""
    st_i = qpos_seed + 1
    en_i = st_i + span + 1
    cummax_en = torch.cummax(torch.where(flt, en_i, 0), dim=1).values
    excl = torch.nn.functional.pad(cummax_en[:, :-1], (1, 0))
    contrib = torch.clamp_min(en_i - torch.maximum(st_i, excl), 0)
    return torch.where(flt, contrib, 0).sum(dim=1).to(torch.int32)


def unpack_hits(hit, seed_c, qpos_seed, ev_offset):
    """Anchors from expanded hits: key bits (rev<<31 | tid), tpos and qpos
    (the seed's event position past the read's earlier events)."""
    hit_ps = hit & U32_MAX
    a_key = ((hit_ps & 1) << 31) | (hit >> 32)
    a_tpos = (hit_ps >> 1) & I32_MAX
    a_qpos = torch.gather(qpos_seed, 1, seed_c) + ev_offset[:, None]
    return a_key, a_tpos, a_qpos


def lookup_expand(didx: DeviceIndex, hashes, qpos_seed, seed_valid, ev_offset,
                  *, mid_occ: int, a_cap: int, span: int) -> Lookup:
    """Seed lookup in the whole table, the occurrence filter and rep_len
    (reference: ri_collect_matches), then expansion to anchors
    (collect_seed_hits, rmap.cpp:51)."""
    start, count = lookup_counts(didx, hashes, seed_valid)
    flt = count > mid_occ
    rep_len = rep_len_from_filtered(qpos_seed, flt, span)
    count = torch.where(flt, 0, count)
    seed_c, hit, _, n_hits, overflow = expand_hits(didx, start, count, a_cap)
    return Lookup(*unpack_hits(hit, seed_c, qpos_seed, ev_offset), n_hits,
                  overflow, rep_len)


def merge_sort_fill(
    a_key, a_tpos, a_qpos, n_new,
    prev_key, prev_tpos, prev_qpos, n_prev,
    q_rank=None, target_rank=None,
    *,
    span: int, max_dist_t: int, max_dist_q: int, bw: int, max_iter: int,
    chn_pen_gap: float, chn_pen_skip: float,
    all_vs_all: bool = False,
    stages: _Stages | None = None,
):
    """All-vs-all filter -> carried-anchor merge -> sort by (key, tpos) ->
    chaining DP fill (rmap.cpp:86-121 + mg_lchain_dp, lchain.c:385).  Keys
    are u32 values in int64.  With `all_vs_all`, a hit is kept only if its
    target's name ranks above the query's (q_rank [B] and target_rank
    [n_seq], int).  Returns (key bits, tpos, qpos, n_anchors, f, p), all
    int32."""
    dev = a_key.device
    a_cap, p_cap = a_key.shape[1], prev_key.shape[1]
    if all_vs_all:
        # skip targets whose name sorts <= the query's (rmap.cpp:86:
        # strcmp(qname, ref_name) >= 0 -> skip); the kept hits stay in slot
        # order, so the stable sort below breaks ties as before
        keep = torch.arange(a_cap, device=dev)[None, :] < n_new[:, None]
        hit_id = (a_key & I32_MAX).clamp(max=target_rank.shape[0] - 1)
        keep &= target_rank[hit_id] > q_rank[:, None]
        a_key, n_new = dense_compact(a_key, keep)
        a_tpos, _ = dense_compact(a_tpos, keep)
        a_qpos, _ = dense_compact(a_qpos, keep)
    new_valid = torch.arange(a_cap, device=dev)[None, :] < n_new[:, None]
    prev_valid = torch.arange(p_cap, device=dev)[None, :] < n_prev[:, None]
    m_key = torch.cat([torch.where(new_valid, a_key, U32_MAX),
                       torch.where(prev_valid, prev_key, U32_MAX)], dim=1)
    m_tpos = torch.cat([torch.where(new_valid, a_tpos, I32_MAX),
                        torch.where(prev_valid, prev_tpos, I32_MAX)], dim=1)
    m_qpos = torch.cat([a_qpos, prev_qpos], dim=1).to(torch.int32)
    n_anchors = (n_new + n_prev).to(torch.int32)

    # one stable sort on key<<31 | tpos (tpos < 2^31, so the order is the
    # reference's (key, tpos) lexicographic one; the pad is 2^63 - 1)
    comp, order = torch.sort((m_key << 31) | m_tpos, dim=1, stable=True)
    s_key = comp >> 31
    s_key = torch.where(s_key >= 1 << 31, s_key - (1 << 32), s_key).to(torch.int32)
    s_tpos = (comp & I32_MAX).to(torch.int32)
    s_qpos = torch.gather(m_qpos, 1, order)
    if stages is not None:
        stages.mark("sort")

    f, p = chain_fill(
        s_key, s_tpos, s_qpos, n_anchors,
        q_span=span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
        bw=bw, max_iter=max_iter,
        chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip,
    )
    if stages is not None:
        stages.mark("fill")
    return s_key, s_tpos, s_qpos, n_anchors, f, p


def chunk_step(
    didx: DeviceIndex,
    sig: torch.Tensor,  # f16/f32 [B, L]
    slen: torch.Tensor,  # i32 [B]
    carry: NormCarry,
    ev_offset: torch.Tensor,  # i32 [B]
    prev_key: torch.Tensor,  # int64 [B, P] carried anchor keys (u32 values)
    prev_tpos: torch.Tensor,  # i32 [B, P]
    prev_qpos: torch.Tensor,  # i32 [B, P]
    n_prev: torch.Tensor,  # i32 [B]
    q_rank: torch.Tensor | None = None,  # [B] query name ranks (all-vs-all)
    target_rank: torch.Tensor | None = None,  # [n_seq] target name ranks
    *,
    diff: float, w: int, e: int, q: int, k: int,
    fine_min: float, fine_max: float, fine_range: float,
    window_length1: int, window_length2: int,
    threshold1: float, threshold2: float, peak_height: float,
    e_cap: int, a_cap: int,
    min_events: int, mid_occ: int,
    max_dist_t: int, max_dist_q: int, bw: int, max_iter: int,
    chn_pen_gap: float, chn_pen_skip: float,
    all_vs_all: bool = False,
    prof=None,
    lookup=None,
) -> ChunkOut:
    """One chunk for a batch of reads.  `prof` (None: tracing off), the
    tracer's span of a stage by name (StageProfiler.stage with the chunk's
    ids bound), times each stage: events, sketch, lookup+expand, sort,
    fill.  With `all_vs_all`, hits go through merge_sort_fill's rank
    filter.  `lookup` takes lookup_expand's place (its arguments after
    didx, which it does not read): the sharded seed merge."""
    stages = None if prof is None else _Stages(prof, sig.device, STEP_STAGES)
    span = k + e - 1

    events, n_ev, carry2, processed, hashes, qpos_seed, seed_valid = (
        events_and_sketch(
            sig, slen, carry,
            window_length1=window_length1, window_length2=window_length2,
            threshold1=threshold1, threshold2=threshold2,
            peak_height=peak_height, e_cap=e_cap, min_events=min_events,
            diff=diff, w=w, e=e, q=q, k=k,
            fine_min=fine_min, fine_max=fine_max, fine_range=fine_range,
            stages=stages,
        )
    )
    ev_offset2 = ev_offset + torch.where(processed, n_ev, 0)

    if lookup is None:
        lk = lookup_expand(didx, hashes, qpos_seed, seed_valid, ev_offset,
                           mid_occ=mid_occ, a_cap=a_cap, span=span)
    else:
        lk = lookup(hashes, qpos_seed, seed_valid, ev_offset,
                    mid_occ=mid_occ, a_cap=a_cap, span=span)
    if stages is not None:
        stages.mark("lookup+expand")

    s_key, s_tpos, s_qpos, n_anchors, f, p = merge_sort_fill(
        lk.a_key, lk.a_tpos, lk.a_qpos, lk.n_hits,
        prev_key, prev_tpos, prev_qpos, n_prev, q_rank, target_rank,
        span=span, max_dist_t=max_dist_t, max_dist_q=max_dist_q,
        bw=bw, max_iter=max_iter,
        chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip,
        all_vs_all=all_vs_all, stages=stages,
    )
    return ChunkOut(
        key=s_key, tpos=s_tpos, qpos=s_qpos, f=f, p=p, n_anchors=n_anchors,
        rep_len=lk.rep_len, n_ev=n_ev, processed=processed,
        overflow=lk.overflow.to(torch.int32), carry=carry2,
        ev_offset=ev_offset2.to(torch.int32), events=events,
        shard_hits=lk.shard_hits,
    )


class ChunkOutTail(NamedTuple):
    """Device-tail chunk output: per-chain summaries and per-read scalars
    for the host; the carried chain anchors (the reference's *_a arrays,
    rmap.cpp:111-116) stay on the device for the next chunk's merge."""

    # [B, K, 10] per chain (target-sorted): score, cnt, key (u32 bits),
    # tpos0, qpos0, tposL, qposL, mlen, blen, valid
    summaries: torch.Tensor
    # [B, 8]: 0 n_chains, 1 rep_len, 2 n_ev, 3 processed, 4 hit_overflow,
    # 5 ev_offset, 6 chain_overflow, 7 prev_overflow
    scalars: torch.Tensor
    prev_key: torch.Tensor  # int64 [B, P_out] u32 key values
    prev_tpos: torch.Tensor  # i32 [B, P_out]
    prev_qpos: torch.Tensor  # i32 [B, P_out]
    n_prev: torch.Tensor  # i32 [B]
    carry: NormCarry
    ev_offset: torch.Tensor  # i32 [B]
    shard_hits: torch.Tensor | None = None  # as ChunkOut's


def chunk_step_tail(
    didx: DeviceIndex,
    sig: torch.Tensor,  # f16/f32 [B, L]
    slen: torch.Tensor,  # i32 [B]
    carry: NormCarry,
    ev_offset: torch.Tensor,  # i32 [B]
    prev_key: torch.Tensor,  # int64 [B, P_in] carried anchors (device-resident)
    prev_tpos: torch.Tensor,  # i32 [B, P_in]
    prev_qpos: torch.Tensor,  # i32 [B, P_in]
    n_prev: torch.Tensor,  # i32 [B]
    active: torch.Tensor,  # i32 [B] 1 = read still mapping (keeps its carry)
    q_rank: torch.Tensor | None = None,  # [B] query name ranks (all-vs-all)
    target_rank: torch.Tensor | None = None,  # [n_seq] target name ranks
    *,
    k_cap: int, p_out: int, min_cnt: int, min_sc: int,
    prof=None,
    **step,
) -> ChunkOutTail:
    """chunk_step, then the chain backtrack and compaction on the device
    (reference: rmap.cpp:210-387 with mg_chain_backtrack + compact_a,
    lchain.c:95-281).  `step` holds chunk_step's keyword parameters
    (all_vs_all and lookup among them); `prof` also receives the backtrack
    and compact stages."""
    n_prev = torch.where(active != 0, n_prev, 0)
    out = chunk_step(didx, sig, slen, carry, ev_offset, prev_key, prev_tpos,
                     prev_qpos, n_prev, q_rank, target_rank, prof=prof, **step)
    return tail_finish(
        out, span=step["k"] + step["e"] - 1, bw=step["bw"], min_cnt=min_cnt,
        min_sc=min_sc, k_cap=k_cap, p_out=p_out, prof=prof,
    )


def tail_finish(out: ChunkOut, *, span: int, bw: int, min_cnt: int,
                min_sc: int, k_cap: int, p_out: int, prof=None) -> ChunkOutTail:
    """Backtrack (the kernel, with chain statistics) -> compaction ->
    carried-anchor re-pick of a chunk's sorted, filled anchors.  It reads
    `out` only, so a capacity regrow of k_cap or p_out reruns it alone on
    the same ChunkOut."""
    stages = None if prof is None else _Stages(prof, out.f.device, TAIL_STAGES)
    stats = chain_backtrack(
        out.f, out.p, out.n_anchors, out.tpos, out.qpos,
        min_cnt=min_cnt, min_sc=min_sc, max_drop=bw, k_cap=k_cap, q_span=span,
    )
    u_sc, u_cnt, n_u, v, n_v, chain_ovf, u_ml, u_bl, u_lo, u_hi = stats
    if stages is not None:
        stages.mark("backtrack")
    asc, _, summaries = compact_from_chain_stats(
        u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi, n_u, v, n_v,
        out.key, out.tpos, out.qpos, p_out=p_out,
    )

    # carried anchors for the next chunk (chain-major discovery order, the
    # reference's *_a layout)
    take = torch.clamp_max(n_v, p_out)
    sel = asc.long().clamp(0, out.key.shape[1] - 1)
    pvalid = torch.arange(p_out, device=asc.device)[None, :] < take[:, None]
    pk = torch.where(pvalid, torch.gather(out.key, 1, sel).long() & U32_MAX, U32_MAX)
    pt = torch.where(pvalid, torch.gather(out.tpos, 1, sel), 0)
    pq = torch.where(pvalid, torch.gather(out.qpos, 1, sel), 0)
    scalars = torch.stack(
        [n_u, out.rep_len, out.n_ev, out.processed.to(torch.int32),
         out.overflow, out.ev_offset, chain_ovf, torch.clamp_min(n_v - p_out, 0)],
        dim=1,
    ).to(torch.int32)
    if stages is not None:
        stages.mark("compact")
    return ChunkOutTail(
        summaries=summaries, scalars=scalars, prev_key=pk, prev_tpos=pt,
        prev_qpos=pq, n_prev=take.to(torch.int32), carry=out.carry,
        ev_offset=out.ev_offset, shard_hits=out.shard_hits,
    )
