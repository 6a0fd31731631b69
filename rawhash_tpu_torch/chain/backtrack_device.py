"""Chain backtracking and compaction in plain PyTorch (port of
rawhash_tpu/chain/backtrack_device.py).

`backtrack_batch` is the lockstep state machine of the reference package: a
Python loop of tensor ops over the batch in which every read advances its
own greedy all-chains backtrack one step per iteration (reference:
mg_chain_backtrack, lchain.c:95-194).  `chain_stats_plain` adds the
per-chain statistics that the CUDA kernel (chain/backtrack.py) gathers
during its claim walks, so `backtrack_plain` has the kernel's whole
contract.  They are the plain version of that kernel: the CPU path runs
them, and on the card they are its comparison only.

`compact_batch` is compact_a (lchain.c:214-281) over the batch; the tail
itself compacts from the chain statistics (chain/backtrack.py::
compact_from_chain_stats), and compact_batch is what that is held against.
`backtrack_compact`, the reference package's standalone entry, runs the
kernel's route (chain_backtrack, then compact_from_chain_stats) and gives
compact_batch's outputs.

The state buffers are updated in place (scatter into fresh tensors): the
JAX version rebuilds them each step.
"""

from __future__ import annotations

import torch

INT32_MIN = -(2**31)
I64_MAX = 2**63 - 1
U32 = 0xFFFFFFFF


def candidates(f: torch.Tensor, n_anchors: torch.Tensor):
    """The candidate order: (f, idx) ascending and stable, pads first with
    f = INT32_MIN (lchain.c:130); the backtrack visits it from the top and
    stops at the first f < min_sc.  Returns (z_f, z_idx) i32."""
    slots = torch.arange(f.shape[1], device=f.device)
    f_m = torch.where(slots[None, :] < n_anchors[:, None], f, INT32_MIN)
    z_f, z_idx = torch.sort(f_m, dim=1, stable=True)
    return z_f, z_idx.to(torch.int32)


def backtrack_batch(
    f: torch.Tensor,  # i32 [B, N] chain scores (fill output)
    p: torch.Tensor,  # i32 [B, N] predecessor indices (-1 = none)
    n_anchors: torch.Tensor,  # i32 [B]
    *,
    min_cnt: int,
    min_sc: int,
    max_drop: int,
    k_cap: int,
):
    """All-chains backtrack for a batch of reads.

    Returns (u_sc i32 [B,K], u_cnt i32 [B,K], n_u i32 [B],
             v i32 [B,N] claimed anchor indices in discovery order
             (chain-major, each chain end->start; slots past n_v may hold
             the claims of rejected chains), n_v i32 [B],
             chain_overflow i32 [B] -- chains dropped because n_u hit K).
    """
    b, n = f.shape
    dev = f.device
    i64 = torch.int64
    rows = torch.arange(b, device=dev)

    # the walk state is int64 (the same values as the reference's int32:
    # scores and indices stay far from the int32 range), and every
    # per-step access is a flat take/put at row * width + index
    z_f, z_idx = (z.to(i64) for z in candidates(f, n_anchors))
    f, p = f.to(i64), p.to(i64)

    base = {n: rows * n, k_cap: rows * k_cap}  # flat offsets of each row

    def gather(arr, idx):
        w = arr.shape[1]
        return torch.take(arr, base[w] + idx.clamp(0, w - 1))

    def scatter_where(arr, idx, val, mask):
        w = arr.shape[1]
        at = base[w] + idx.clamp(0, w - 1)
        arr.put_(at, torch.where(mask, val, torch.take(arr, at)))

    zero = torch.zeros(b, dtype=i64, device=dev)
    # phases: 0 select candidate, 1 bk_end walk, 2 claim walk, 3 done
    phase = zero.clone()
    k = torch.full((b,), n - 1, dtype=i64, device=dev)
    i, end_i = zero.clone(), torch.full((b,), -1, dtype=i64, device=dev)
    max_i, max_s, zsc = zero.clone(), zero.clone(), zero.clone()
    n_v, n_v0, n_u = zero.clone(), zero.clone(), zero.clone()
    ovf = zero.clone()
    # claimed marks; the reference's visit stamps are left out: p[i] < i, so
    # a walk never meets an anchor twice
    t1 = torch.zeros((b, n), dtype=i64, device=dev)
    v = torch.zeros((b, n), dtype=i64, device=dev)
    u_sc = torch.zeros((b, k_cap), dtype=i64, device=dev)
    u_cnt = torch.zeros((b, k_cap), dtype=i64, device=dev)
    one = torch.ones(b, dtype=i64, device=dev)

    probe = torch.arange(8, device=dev)
    step = 0
    # a finished read (phase 3) is left as it is by a step, so the loop
    # looks for the end only every 8 steps (each look waits for the device)
    while step % 8 or bool((phase != 3).any()):
        step += 1
        # ---- phase 0: pick the next unused candidate (lchain.c:131-137),
        # jumping past a leading run of up to 8 used ones at once
        in0 = phase == 0
        kd = k[:, None] - probe[None, :]
        kdc = kd.clamp(0, n - 1)
        skip = ((kd >= 0) & (torch.gather(z_f, 1, kdc) >= min_sc)
                & (torch.gather(t1, 1, torch.gather(z_idx, 1, kdc)) != 0))
        lead = torch.cumprod(skip & in0[:, None], dim=1).sum(1)
        k = k - lead
        k_idx = gather(z_idx, k)
        k_f = gather(z_f, k)
        exhausted = in0 & ((k < 0) | (k_f < min_sc))
        used = in0 & ~exhausted & (gather(t1, k_idx) != 0)
        start = in0 & ~exhausted & ~used
        # enter walk A (mg_chain_bk_end init, lchain.c:49-56)
        phase = torch.where(exhausted, 3, phase)
        k = k - used.to(i64)
        i = torch.where(start, k_idx, i)
        max_i = torch.where(start, k_idx, max_i)
        max_s = torch.where(start, 0, max_s)
        zsc = torch.where(start, k_f, zsc)
        n_v0 = torch.where(start, n_v, n_v0)
        phase = torch.where(start, 1, phase)

        # ---- phase 1: one bk_end step (lchain.c:57-70)
        in1 = phase == 1
        ni = gather(p, i)
        s = torch.where(ni < 0, zsc, zsc - gather(f, ni))
        better = s > max_s
        brk = ~better & (max_s - s > max_drop)
        max_s1 = torch.where(in1 & better, s, max_s)
        max_i1 = torch.where(in1 & better, ni, max_i)
        cont = ~brk & (ni >= 0) & (gather(t1, ni) == 0)
        # walk A finished: end at max_i, restart from the candidate head
        finish_a = in1 & ~cont
        end_i = torch.where(finish_a, max_i1, end_i)
        max_s = torch.where(in1, max_s1, max_s)
        max_i = torch.where(in1, max_i1, max_i)
        i = torch.where(in1, torch.where(cont, ni, k_idx), i)
        phase = torch.where(finish_a, 2, phase)

        # ---- phase 2: one claim step (lchain.c:139-146)
        in2 = phase == 2
        claiming = in2 & (i != end_i)
        scatter_where(v, n_v, i, claiming)
        scatter_where(t1, i, one, claiming)
        n_v = n_v + claiming.to(i64)
        i2 = gather(p, i)
        finished = in2 & ~claiming
        # chain accept/reject (lchain.c:147-158)
        sc = torch.where(i < 0, zsc, zsc - gather(f, i))
        cnt = n_v - n_v0
        accept = finished & (sc >= min_sc) & (cnt > 0) & (cnt >= min_cnt)
        keep = accept & (n_u < k_cap)
        scatter_where(u_sc, n_u, sc, keep)
        scatter_where(u_cnt, n_u, cnt, keep)
        ovf = ovf + (accept & ~keep).to(i64)
        n_u = n_u + keep.to(i64)
        # rejected chains (and overflowed ones) release their claim slots
        n_v = torch.where(finished & ~keep, n_v0, n_v)
        i = torch.where(claiming, i2, i)
        k = k - finished.to(i64)
        phase = torch.where(finished, 0, phase)

    i32 = torch.int32
    return tuple(t.to(i32) for t in (u_sc, u_cnt, n_u, v, n_v, ovf))


def _chain_segments(u_cnt, n_u, v, n_v):
    """Per-chain [start, end) slots in v (chain-major), and v mirrored into
    ascending order within each chain (`asc`, 0 past n_v)."""
    b, n = v.shape
    k_cap = u_cnt.shape[1]
    dev = v.device
    slots = torch.arange(n, device=dev)
    cids = torch.arange(k_cap, device=dev)
    chain_valid = cids[None, :] < n_u[:, None]
    cnts = torch.where(chain_valid, u_cnt, 0).long()
    ends = torch.cumsum(cnts, dim=1)
    starts = ends - cnts
    live = chain_valid & (cnts > 0)
    # chain id per claimed slot: mark each chain's start slot and
    # forward-fill (the same trick as index/device.py::expand_hits)
    tgt = torch.where(live, starts, n)
    marker = torch.zeros((b, n + 1), dtype=torch.long, device=dev)
    marker.scatter_reduce_(1, tgt, cids.expand(b, k_cap), reduce="amax")
    cid = torch.cummax(marker[:, :n], dim=1).values
    st_m = torch.gather(starts, 1, cid)
    en_m = torch.gather(ends, 1, cid)
    valid_slot = slots[None, :] < n_v[:, None]
    g = (st_m + en_m - 1 - slots[None, :]).clamp(0, n - 1)
    asc = torch.where(valid_slot, torch.gather(v, 1, g), 0)
    return chain_valid, live, cnts, starts, ends, st_m, valid_slot, asc


def _fuzzy_lengths(asc, st_m, valid_slot, starts, ends, live,
                   s_tpos, s_qpos, q_span: int):
    """(mlen, blen) [B, K] of each chain (mm_cal_fuzzy_len, hit.c:10-40):
    pairwise deltas of consecutive ascending anchors, segment-summed."""
    n = asc.shape[1]
    slots = torch.arange(n, device=asc.device)
    a_tpos = torch.gather(s_tpos, 1, asc.long()).long()
    a_qpos = torch.gather(s_qpos, 1, asc.long()).long()
    tl = a_tpos - torch.cat([a_tpos[:, :1], a_tpos[:, :-1]], dim=1)
    ql = a_qpos - torch.cat([a_qpos[:, :1], a_qpos[:, :-1]], dim=1)
    skip = (slots[None, :] == st_m) | ~valid_slot
    mn = torch.minimum(tl, ql)
    mx = torch.where(skip, 0, torch.maximum(tl, ql))
    ml = torch.where(skip, 0,
                     torch.where((tl > q_span) & (ql > q_span), q_span, mn) + mn)
    cb = torch.cumsum(mx, dim=1)
    cm = torch.cumsum(ml, dim=1)

    def seg(arr):
        hi = torch.gather(arr, 1, (ends - 1).clamp(0, n - 1))
        lo = torch.gather(arr, 1, starts.clamp(0, n - 1))
        return hi - lo

    mlen = torch.where(live, q_span + seg(cm), 0).to(torch.int32)
    blen = torch.where(live, q_span + seg(cb), 0).to(torch.int32)
    return mlen, blen


def chain_stats_plain(u_cnt, n_u, v, n_v, s_tpos, s_qpos, q_span: int):
    """The kernel's per-chain statistics from the lockstep's v, in
    discovery order: (u_ml, u_bl, u_lo, u_hi) i32 [B, K], 0 past n_u.
    u_hi is the chain's candidate (claimed first), u_lo its last claimed
    anchor; u_ml/u_bl are the fuzzy match/block lengths."""
    n = v.shape[1]
    _, live, _, starts, ends, st_m, valid_slot, asc = _chain_segments(
        u_cnt, n_u, v, n_v
    )
    u_ml, u_bl = _fuzzy_lengths(asc, st_m, valid_slot, starts, ends, live,
                                s_tpos, s_qpos, q_span)
    u_lo = torch.where(live, torch.gather(v, 1, (ends - 1).clamp(0, n - 1)), 0)
    u_hi = torch.where(live, torch.gather(v, 1, starts.clamp(0, n - 1)), 0)
    return u_ml, u_bl, u_lo, u_hi


def backtrack_plain(f, p, n_anchors, tpos, qpos, *, min_cnt: int, min_sc: int,
                    max_drop: int, k_cap: int, q_span: int):
    """The backtrack kernel's contract in plain PyTorch: (u_sc, u_cnt, n_u,
    v, n_v, ovf, u_ml, u_bl, u_lo, u_hi), with v 0 past n_v."""
    u_sc, u_cnt, n_u, v, n_v, ovf = backtrack_batch(
        f, p, n_anchors, min_cnt=min_cnt, min_sc=min_sc, max_drop=max_drop,
        k_cap=k_cap,
    )
    slots = torch.arange(v.shape[1], device=v.device)
    v = torch.where(slots[None, :] < n_v[:, None], v, 0)
    stats = chain_stats_plain(u_cnt, n_u, v, n_v, tpos, qpos, q_span)
    return (u_sc, u_cnt, n_u, v, n_v, ovf) + stats


def chain_order(key0, tpos0, live):
    """Stable chain order by first-anchor x = (key0 as u32, tpos0), dead
    chains last: one sort on the int64 composite key0 << 31 | tpos0, whose
    pad (0xFFFFFFFF, 0x7FFFFFFF) is exactly 2^63 - 1 (compact_a's radix
    sort, lchain.c:260)."""
    comp = ((key0.long() & U32) << 31) | tpos0.long()
    comp = torch.where(live, comp, I64_MAX)
    return torch.sort(comp, dim=1, stable=True).indices


def summary_rows(order, u_sc, cnts, chain_valid, live, key0, tpos0, qpos0,
                 tposl, qposl, mlen, blen):
    """[B, K, 10] i32 summaries in chain order: score, cnt, key (u32 bits),
    tpos0, qpos0, tposL, qposL, mlen, blen, valid."""
    cols = (torch.where(chain_valid, u_sc, 0), cnts, key0, tpos0, qpos0,
            tposl, qposl, mlen, blen, live)
    return torch.stack(
        [torch.gather(c.to(torch.int32), 1, order) for c in cols], dim=2
    )


def compact_batch(u_sc, u_cnt, n_u, v, n_v, s_key, s_tpos, s_qpos, *,
                  q_span: int):
    """compact_a (lchain.c:214-281) over the batch.

    Returns:
      asc       i32 [B, N]  anchor indices, chain-major (discovery order),
                            each chain's anchors ascending: the carried
                            anchor order (the reference's *_a)
      order     i64 [B, K]  chains sorted by first-anchor x (stable)
      summaries i32 [B, K, 10] in that order (see summary_rows)
    """
    n = v.shape[1]
    chain_valid, live, cnts, starts, ends, st_m, valid_slot, asc = (
        _chain_segments(u_cnt, n_u, v, n_v)
    )
    mlen, blen = _fuzzy_lengths(asc, st_m, valid_slot, starts, ends, live,
                                s_tpos, s_qpos, q_span)

    def at(arr, idx):
        return torch.gather(arr, 1, torch.gather(asc.long(), 1, idx.clamp(0, n - 1)))

    key0, tpos0, qpos0 = (at(a, starts) for a in (s_key, s_tpos, s_qpos))
    tposl, qposl = (at(a, ends - 1) for a in (s_tpos, s_qpos))
    order = chain_order(key0, tpos0, live)
    summaries = summary_rows(order, u_sc, cnts, chain_valid, live, key0,
                             tpos0, qpos0, tposl, qposl, mlen, blen)
    return asc.to(torch.int32), order, summaries


def backtrack_compact(f, p, n_anchors, s_key, s_tpos, s_qpos, *, min_cnt: int,
                      min_sc: int, max_drop: int, k_cap: int, q_span: int):
    """Backtrack and compaction in one call (the standalone entry; the tail
    calls the two pieces itself, map/device_step.py::tail_finish).

    f, p, s_key (u32 bits as i32), s_tpos, s_qpos i32 [B, N], n_anchors i32
    [B].  Returns (summaries i32 [B, K, 10], n_u i32 [B], asc i32 [B, N],
    n_v i32 [B], ovf i32 [B]), compact_batch's outputs on backtrack_batch's
    chains.  The backtrack is chain/backtrack.py::chain_backtrack: its
    kernel on CUDA tensors (1 <= N <= MAX_WIDTH), its plain version on CPU
    tensors, an error on any other device; then compact_from_chain_stats
    at p_out = N.  v and asc hold 0 past n_v.

    The summary rows past n_u (no chain; sorted last, all alike) are
    filled as compact_batch fills them, not as compact_from_chain_stats
    does: columns 2-4 from asc's slot n_v, 5-6 from its slot n_v - 1
    (clipped to the row)."""
    from .backtrack import chain_backtrack, compact_from_chain_stats

    (u_sc, u_cnt, n_u, v, n_v, ovf, u_ml, u_bl, u_lo, u_hi) = chain_backtrack(
        f, p, n_anchors, s_tpos, s_qpos, min_cnt=min_cnt, min_sc=min_sc,
        max_drop=max_drop, k_cap=k_cap, q_span=q_span,
    )
    n = f.shape[1]
    asc, _, summaries = compact_from_chain_stats(
        u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi, n_u, v, n_v, s_key, s_tpos,
        s_qpos, p_out=n,
    )

    def at(plane, slot):
        a = torch.gather(asc.long(), 1, slot.long().clamp(0, n - 1)[:, None])
        return torch.gather(plane, 1, a)[:, 0]

    empty = torch.stack([at(s_key, n_v), at(s_tpos, n_v), at(s_qpos, n_v),
                         at(s_tpos, n_v - 1), at(s_qpos, n_v - 1)], dim=1)
    dead = torch.arange(k_cap, device=f.device)[None, :] >= n_u[:, None]
    summaries[:, :, 2:7] = torch.where(dead[:, :, None], empty[:, None, :],
                                       summaries[:, :, 2:7])
    return summaries, n_u, asc, n_v, ovf
