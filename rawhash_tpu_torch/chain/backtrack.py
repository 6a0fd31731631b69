"""Chain backtracking: the CUDA kernel for K2 and K3 and its dispatch, and
the compaction from its per-chain statistics.

`chain_backtrack` replaces both Pallas backtrack kernels of the reference
package, rawhash_tpu/chain/backtrack_pallas.py::backtrack_pallas (anchor
widths up to 32768) and rawhash_tpu/chain/backtrack_pallas_big.py::
backtrack_pallas_big (wider, in chain-stat mode), with one kernel
(csrc/chain_backtrack.cu) at every width.  On CPU tensors it runs the plain
version (chain/backtrack_device.py::backtrack_plain); on CUDA tensors it
launches the kernel or raises.  Both give the same ten outputs bit for bit.

`compact_from_chain_stats` ports backtrack_pallas_big.py's function of that
name: summaries and the carried-anchor prefix from the chain statistics, in
O(B x K) and O(B x p_out) gathers.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .backtrack_device import (
    backtrack_plain, candidates, chain_order, summary_rows,
)

# the claimed bitmask (one bit per anchor) must fit a block's 227 KB of
# shared memory
MAX_WIDTH = 232448 * 8

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = load_library().rh_chain_backtrack
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        _FN = fn
    return _FN


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
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"chain_backtrack: {name} must be int32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"chain_backtrack: {name} must be contiguous")
    if not 1 <= n <= MAX_WIDTH:
        raise ValueError(f"chain_backtrack: width {n} not in [1, {MAX_WIDTH}]")
    if k_cap < 1:
        raise ValueError("chain_backtrack: k_cap must be >= 1")
    # the candidate sort runs outside the kernel, as the reference package
    # runs it outside its Pallas kernels (backtrack_pallas.py:161-167)
    z_f, z_idx = candidates(f, n_anchors)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    v = zeros(b, n)
    u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi = (zeros(b, k_cap) for _ in range(6))
    n_u, n_v, ovf = zeros(b), zeros(b), zeros(b)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(
            z_f.data_ptr(), z_idx.data_ptr(), f.data_ptr(), p.data_ptr(),
            tpos.data_ptr(), qpos.data_ptr(),
            v.data_ptr(), u_sc.data_ptr(), u_cnt.data_ptr(), u_ml.data_ptr(),
            u_bl.data_ptr(), u_lo.data_ptr(), u_hi.data_ptr(),
            n_u.data_ptr(), n_v.data_ptr(), ovf.data_ptr(),
            b, n, k_cap, min_cnt, min_sc, max_drop, q_span, stream,
        )
    if rc != 0:
        raise RuntimeError(f"chain_backtrack kernel launch failed: CUDA error {rc}")
    chain_backtrack.launches += 1
    chain_backtrack.max_width = max(chain_backtrack.max_width, n)
    return u_sc, u_cnt, n_u, v, n_v, ovf, u_ml, u_bl, u_lo, u_hi


chain_backtrack.launches = 0
chain_backtrack.max_width = 0


def compact_from_chain_stats(u_sc, u_cnt, u_ml, u_bl, u_lo, u_hi, n_u, v, n_v,
                             s_key, s_tpos, s_qpos, *, p_out: int):
    """compact_a (lchain.c:214-281) from the per-chain statistics.

    Returns (asc i32 [B, p_out]: the first p_out carried anchors, chain-major,
    ascending within each chain, 0 past n_v; order i64 [B, K]; summaries
    i32 [B, K, 10]), the same as compact_batch's (asc[:, :p_out], order,
    summaries) on the same chains."""
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
