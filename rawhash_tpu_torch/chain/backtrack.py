"""Chain backtracking: the CUDA kernel for K2 and K3 and its dispatch, and
the compaction from its per-chain statistics.

`chain_backtrack` replaces both Pallas backtrack kernels of the reference
package, rawhash_tpu/chain/backtrack_pallas.py::backtrack_pallas (anchor
widths up to 32768) and rawhash_tpu/chain/backtrack_pallas_big.py::
backtrack_pallas_big (wider, in chain-stat mode), with one kernel
(csrc/chain_backtrack.cu) at every width.  On CPU tensors it runs the plain
version (chain/backtrack_device.py::backtrack_plain); on CUDA tensors it
launches the kernel or raises.  Both give the same ten outputs bit for bit.
The kernel visits only the candidates (f >= min_sc), in the order
`candidate_order` builds from them; `candidates_cut` is that order cut from
the full sort (`candidates`), its plain version.

`backtrack_host_serial` runs the serial algorithm of the kernel's header
on the host (g++), with the work each row needs.

`compact_from_chain_stats` ports backtrack_pallas_big.py's function of that
name: summaries and the carried-anchor prefix from the chain statistics, in
O(B x K) and O(B x p_out) gathers.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .._build import check_operand, load_host_library, load_library
from .backtrack_device import (
    INT32_MIN, backtrack_plain, candidates, chain_order, summary_rows,
)

# the claimed bitmask (one bit per anchor) must fit a block's 227 KB of
# shared memory
SMEM_MAX = 232448
MAX_WIDTH = SMEM_MAX * 8
# steps of walk A a lane stages ahead of the resolution (csrc/
# chain_backtrack.cuh: at most 32, one a lane when a walk is resolved);
# chosen in PERF.md from D2's and D4's own tail calls
DEPTH = 16
PAD_KEY = (INT32_MIN << 32) | 0xFFFFFFFF  # (INT32_MIN, -1)

_FN = None
# chain_backtrack's counters are added to from every thread that maps a batch
_COUNT_LOCK = threading.Lock()


def _kernel():
    global _FN
    if _FN is None:
        fn = load_library().rh_chain_backtrack
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        _FN = fn
    return _FN


def candidate_order(f: torch.Tensor, n_anchors: torch.Tensor, min_sc: int):
    """The backtrack's candidate order from its candidates only: the slots
    n < n_anchors with f >= min_sc, compacted into [B, C] (C the largest
    count, at least 1), then sorted by (f, idx).  Each row's n_cand
    candidates sit at its top in (f, idx) ascending order, below them pads
    (INT32_MIN, -1); the backtrack visits C - 1 down to C - n_cand.  This
    is `candidates_cut`: the full order's slots below min_sc are ones the
    backtrack never visits.  One sync (for C, the largest n_anchors and the
    candidates in all); only the candidates are moved and sorted.
    Returns (z_f, z_idx i32 [B, C], n_cand i32 [B], a_max: the largest
    n_anchors, clipped to [1, N])."""
    b, n = f.shape
    dev = f.device
    slots = torch.arange(n, device=dev)
    cand = (slots < n_anchors[:, None]) & (f >= min_sc)
    n_cand = cand.sum(1, dtype=torch.int32)
    c = a_max = total = 0
    if b:
        c, a_max, total = torch.stack([n_cand.max().long(), n_anchors.max().long(),
                                       n_cand.sum(dtype=torch.int64)]).tolist()
    c, a_max = max(c, 1), min(max(a_max, 1), n)
    # the candidates in row-major order, each at its rank in its row, as
    # one int64 key (f, idx): the keys are unique, so any sort of a row
    # gives the stable order
    row, slot = torch.nonzero_static(cand, size=total).unbind(1)
    col = torch.arange(total, device=dev) - (torch.cumsum(n_cand, 0) - n_cand)[row]
    key = torch.full((b, c), PAD_KEY, dtype=torch.int64, device=dev)
    key[row, col] = (f[row, slot].long() << 32) | slot
    key = torch.sort(key, dim=1).values
    # the low word of a key, as int32, is its idx (-1 for a pad)
    return (key >> 32).to(torch.int32), key.to(torch.int32), n_cand, a_max


def candidates_cut(f, n_anchors, min_sc: int, c: int):
    """`candidate_order`'s (z_f, z_idx, n_cand) in plain form: the full
    candidate order (`candidates`) cut at min_sc, its top c columns kept,
    those below each row's candidates set to (INT32_MIN, -1)."""
    z_f, z_idx = candidates(f, n_anchors)
    n_cand = (z_f >= min_sc).sum(1, dtype=torch.int32)
    n = f.shape[1]
    if c > n:
        z_f = torch.nn.functional.pad(z_f, (c - n, 0), value=INT32_MIN)
        z_idx = torch.nn.functional.pad(z_idx, (c - n, 0), value=-1)
    z_f, z_idx = z_f[:, -c:], z_idx[:, -c:]
    pad = torch.arange(c, device=f.device)[None, :] < (c - n_cand)[:, None]
    return (torch.where(pad, INT32_MIN, z_f), torch.where(pad, -1, z_idx),
            n_cand)


def shared_bytes(a_max: int, depth: int) -> int:
    """The kernel's shared memory (csrc/chain_backtrack.cu): the claimed
    bits of a_max anchors and the staging buffer (32 rows of depth + 1
    slots, four planes: node, score, tpos, qpos; none at depth 0)."""
    return 4 * ((a_max + 31) // 32) + (512 * (depth + 1) if depth > 0 else 0)


def launch_depth(a_max: int, depth: int = DEPTH) -> int:
    """The staging depth for rows of at most a_max live anchors: `depth`,
    less only where the claimed bits leave the staging buffer no room (0 at
    MAX_WIDTH)."""
    while depth > 0 and shared_bytes(a_max, depth) > SMEM_MAX:
        depth -= 1
    return depth


def backtrack_launch(f, p, tpos, qpos, order, *, min_cnt: int, min_sc: int,
                     max_drop: int, k_cap: int, q_span: int, depth: int):
    """One launch of the kernel on checked CUDA inputs and their
    `candidate_order`, at a staging depth the shared memory holds
    (`launch_depth`).  Returns chain_backtrack's ten outputs, views of one
    zeroed buffer; counts nothing."""
    z_f, z_idx, n_cand, a_max = order
    b, n = f.shape
    out = torch.zeros(b * (n + 6 * k_cap + 3), dtype=torch.int32, device=f.device)
    v = out[:b * n].view(b, n)
    rows = out[b * n:b * (n + 6 * k_cap)].view(6, b, k_cap)
    n_u, n_v, ovf = out[b * (n + 6 * k_cap):].view(3, b)
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        rc = _kernel()(
            z_f.data_ptr(), z_idx.data_ptr(), n_cand.data_ptr(), f.data_ptr(),
            p.data_ptr(), tpos.data_ptr(), qpos.data_ptr(), v.data_ptr(),
            *(r.data_ptr() for r in rows), n_u.data_ptr(), n_v.data_ptr(),
            ovf.data_ptr(), b, n, z_f.shape[1], a_max, k_cap, min_cnt, min_sc,
            max_drop, q_span, depth, stream,
        )
    if rc != 0:
        raise RuntimeError(f"chain_backtrack kernel launch failed: CUDA error {rc}")
    u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi = rows
    return u_sc, u_cnt, n_u, v, n_v, ovf, u_ml, u_bl, u_lo, u_hi


def chain_backtrack(
    f: torch.Tensor,  # i32 [B, N] chain scores
    p: torch.Tensor,  # i32 [B, N] predecessors (-1 = none), p[i] < i
    n_anchors: torch.Tensor,  # i32 [B]
    tpos: torch.Tensor,  # i32 [B, N]
    qpos: torch.Tensor,  # i32 [B, N]
    *,
    min_cnt: int,
    min_sc: int,
    max_drop: int,
    k_cap: int,
    q_span: int,
):
    """All-chains backtrack with per-chain statistics.

    Returns (u_sc, u_cnt i32 [B,K], n_u i32 [B], v i32 [B,N], n_v i32 [B],
    ovf i32 [B], u_ml, u_bl, u_lo, u_hi i32 [B,K]): chain scores and anchor
    counts in discovery order, the claimed anchors chain-major (each chain
    end->start), the chains lost to k_cap, and per chain the fuzzy
    match/block lengths, last claimed anchor and candidate.  Slots past
    n_u / n_v are 0."""
    prm = dict(min_cnt=min_cnt, min_sc=min_sc, max_drop=max_drop, k_cap=k_cap,
               q_span=q_span)
    dev = f.device
    if dev.type == "cpu":
        return backtrack_plain(f, p, n_anchors, tpos, qpos, **prm)
    if dev.type != "cuda":
        raise ValueError(f"chain_backtrack: unsupported device {dev}")
    b, n = f.shape
    for name, t, shape in (("f", f, (b, n)), ("p", p, (b, n)),
                           ("n_anchors", n_anchors, (b,)),
                           ("tpos", tpos, (b, n)), ("qpos", qpos, (b, n))):
        check_operand("chain_backtrack", name, t, torch.int32, shape, dev)
    if not 1 <= n <= MAX_WIDTH:
        raise ValueError(f"chain_backtrack: width {n} not in [1, {MAX_WIDTH}]")
    if k_cap < 1:
        raise ValueError("chain_backtrack: k_cap must be >= 1")
    # the candidate order is built outside the kernel, as the reference
    # package sorts outside its Pallas kernels (backtrack_pallas.py:161-167)
    order = candidate_order(f, n_anchors, min_sc)
    out = backtrack_launch(f, p, tpos, qpos, order, **prm,
                           depth=launch_depth(order[3]))
    with _COUNT_LOCK:
        chain_backtrack.launches += 1
        chain_backtrack.max_width = max(chain_backtrack.max_width, n)
    return out


chain_backtrack.launches = 0
chain_backtrack.max_width = 0


def host_array(t):
    """t as a C-contiguous int32 numpy array."""
    return np.ascontiguousarray(np.asarray(t.cpu() if hasattr(t, "cpu") else t),
                                dtype=np.int32)


def ptr(a):
    """A numpy array's data as a ctypes pointer."""
    return a.ctypes.data_as(ctypes.c_void_p)


def backtrack_host_serial(f, p, n_anchors, tpos, qpos, *, min_cnt: int,
                          min_sc: int, max_drop: int, k_cap: int, q_span: int):
    """rh_backtrack_read (csrc/chain_backtrack.cuh) on the host, a row at a
    time, on the full candidate order.  Returns (the ten outputs as numpy
    int32 arrays, in chain_backtrack's order; work int64 [B, 6]: each row's
    candidates, skipped, walk steps, claim steps, kept chains, v writes)."""
    lib = load_host_library("chain_backtrack")
    f, p, tpos, qpos = map(host_array, (f, p, tpos, qpos))
    n_anchors = torch.from_numpy(host_array(n_anchors))
    z_f, z_idx = map(host_array, candidates(torch.from_numpy(f), n_anchors))
    b, n = f.shape
    v = np.zeros((b, n), np.int32)
    u = np.zeros((b, 6, k_cap), np.int32)
    counts = np.zeros((b, 3), np.int32)
    work = np.zeros((b, 6), np.int64)
    lib.rh_bt_serial.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 4
    lib.rh_bt_serial(ptr(z_f), ptr(z_idx), ptr(f), ptr(p), ptr(tpos),
                     ptr(qpos), b, n, k_cap, min_cnt, min_sc, max_drop, q_span,
                     ptr(v), ptr(u), ptr(counts), ptr(work))
    return host_outputs(u, counts, v), work


def host_outputs(u, counts, v):
    """The ten outputs from the host build's u [B, 6, K], counts [B, 3], v."""
    return (u[:, 0], u[:, 1], counts[:, 0], v, counts[:, 1], counts[:, 2],
            u[:, 2], u[:, 3], u[:, 4], u[:, 5])


def compact_from_chain_stats(u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi, n_u, v, n_v,
                             s_key, s_tpos, s_qpos, *, p_out: int):
    """compact_a (lchain.c:214-281) from the per-chain statistics.

    Returns (asc i32 [B, p_out]: the first p_out carried anchors, chain-major,
    ascending within each chain, 0 past n_v; order i64 [B, K]; summaries
    i32 [B, K, 10]), the same as compact_batch's (asc[:, :p_out], order,
    summaries) on the same chains, but for the summary rows past n_u: those
    take columns 2-6 from anchor 0 (u_lo = u_hi = 0 there), as the reference
    package's function of this name does; compact_batch takes them from
    asc's slots n_v and n_v - 1."""
    b, n = v.shape
    k_cap = u_sc.shape[1]
    dev = v.device
    cids = torch.arange(k_cap, device=dev)
    chain_valid = cids[None, :] < n_u[:, None]
    cnts = torch.where(chain_valid, u_cnt, 0).long()
    ends = torch.cumsum(cnts, dim=1)
    starts = ends - cnts
    live = chain_valid & (cnts > 0)

    lo = u_lo.long().clamp(0, n - 1)
    hi = u_hi.long().clamp(0, n - 1)
    key0, tpos0, qpos0 = (torch.gather(a, 1, lo) for a in (s_key, s_tpos, s_qpos))
    tposl, qposl = (torch.gather(a, 1, hi) for a in (s_tpos, s_qpos))
    mlen = torch.where(live, u_ml, 0)
    blen = torch.where(live, u_bl, 0)
    order = chain_order(key0, tpos0, live)
    summaries = summary_rows(order, u_sc, cnts, chain_valid, live, key0,
                             tpos0, qpos0, tposl, qposl, mlen, blen)

    # carried-anchor prefix: v mirrored within each chain, built only on the
    # first p_out slots (chain bounds forward-filled by scatter + cummax;
    # starts/ends are non-decreasing, so the fill is exact)
    po = min(p_out, n)
    pslots = torch.arange(po, device=dev)
    tgt = torch.where(live & (starts < po), starts, po)

    def ffill(vals):
        m = torch.zeros((b, po + 1), dtype=torch.long, device=dev)
        m.scatter_reduce_(1, tgt, vals, reduce="amax")
        return torch.cummax(m[:, :po], dim=1).values

    g = (ffill(starts) + ffill(ends) - 1 - pslots[None, :]).clamp(0, n - 1)
    asc = torch.gather(v, 1, g)
    valid_slot = pslots[None, :] < torch.clamp_max(n_v, po)[:, None]
    asc = torch.where(valid_slot, asc, 0)
    if po < p_out:
        asc = torch.nn.functional.pad(asc, (0, p_out - po))
    return asc, order, summaries
