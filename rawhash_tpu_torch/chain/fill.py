"""Chaining DP fill: the CUDA kernel K1 and its dispatch.

`chain_fill` replaces rawhash_tpu/chain/pallas_fill.py::chain_fill_pallas.
On CPU tensors it runs the plain PyTorch fill (chain/device.py); on CUDA
tensors it launches csrc/chain_fill.cu (a block of warps per read, each
warp filling its own chain segments through their in-band suffixes) or
raises.  Both give the same f and p bit for bit on rows sorted by
(unsigned key, tpos), which the kernel needs and does not check.  Up to
W = MAX_ITER_CAP the warps' rings are in shared memory; past it, in a
global-memory scratch buffer allocated here (a slower path that takes any
W, as the JAX fill does).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..signal.events import f32
from .device import chain_fill_batch

# a block runs as many warps a read as their rings (W + 64 slots of 16 bytes
# each: csrc/chain_fill.cuh, rh_fill_warps) fit in its 227 KB of shared
# memory, up to 16; past this W not one ring fits, and the rings go to a
# global-memory scratch buffer
MAX_ITER_CAP = 232448 // 16 - 64
# the most scratch the global-ring path takes (also at most a quarter of the
# card's free memory): 16 warps a read, and every row of a 256-read batch in
# one launch, up to W = 32704 (csrc/chain_fill.cuh: rh_fill_global_warps,
# rh_fill_global_rows)
GLOBAL_RING_BUDGET = 2 << 30

_FN = {}


def _kernel(name: str):
    if name not in _FN:
        fn = getattr(load_library(), name)
        ptr, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "rh_chain_fill_global_plan":
            fn.restype = None
            fn.argtypes = [i, i, ctypes.c_longlong, ptr, ptr]
        else:
            fn.restype = i
            extra = [i, i, ptr] if name == "rh_chain_fill_global" else []
            fn.argtypes = [ptr] * 6 + [i] * 7 + [fl] * 2 + extra + [ptr]
        _FN[name] = fn
    return _FN[name]


def global_ring_plan(b: int, w: int, budget: int) -> tuple:
    """(warps a read, rows a launch) of the global-ring path for b rows at
    W = w and a scratch of at most `budget` bytes (the card's library)."""
    warps, rows = ctypes.c_int(), ctypes.c_int()
    _kernel("rh_chain_fill_global_plan")(b, w, budget, ctypes.byref(warps),
                                         ctypes.byref(rows))
    return warps.value, rows.value


def chain_fill(
    key: torch.Tensor,  # i32 [B, N] key bits (rev<<31 | tid)
    tpos: torch.Tensor,  # i32 [B, N]
    qpos: torch.Tensor,  # i32 [B, N]
    n_anchors: torch.Tensor,  # i32 [B]
    *,
    q_span: int,
    max_dist_t: int,
    max_dist_q: int,
    bw: int,
    max_iter: int,
    chn_pen_gap: float,
    chn_pen_skip: float,
):
    """f, p (i32 [B, N]) of the chaining DP; slots past n_anchors get
    f = 0, p = -1.  Each row's live anchors must be sorted by (unsigned key,
    tpos), as merge_sort_fill sorts them: the CUDA kernel fills each row's
    chain segments apart and scans only each anchor's in-band suffix, which
    is the full-window fill only on sorted rows.  It does not check the
    order (that would cost a sync); the plain fill on CPU tensors needs no
    order.  On the card, max_iter past MAX_ITER_CAP takes the global-ring
    path (a scratch of up to GLOBAL_RING_BUDGET bytes)."""
    params = dict(
        q_span=q_span, max_dist_t=max_dist_t, max_dist_q=max_dist_q, bw=bw,
        max_iter=max_iter, chn_pen_gap=chn_pen_gap, chn_pen_skip=chn_pen_skip,
    )
    dev = key.device
    if dev.type == "cpu":
        return chain_fill_batch(key, tpos, qpos, n_anchors, **params)
    if dev.type != "cuda":
        raise ValueError(f"chain_fill: unsupported device {dev}")
    b, n = key.shape
    for name, t, shape in (("key", key, (b, n)), ("tpos", tpos, (b, n)),
                           ("qpos", qpos, (b, n)), ("n_anchors", n_anchors, (b,))):
        if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"chain_fill: {name} must be int32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"chain_fill: {name} must be contiguous")
    if max_iter < 1:
        raise ValueError("chain_fill: max_iter must be at least 1")
    f = torch.empty((b, n), dtype=torch.int32, device=dev)
    p = torch.empty((b, n), dtype=torch.int32, device=dev)
    args = (key.data_ptr(), tpos.data_ptr(), qpos.data_ptr(),
            n_anchors.data_ptr(), f.data_ptr(), p.data_ptr(),
            b, n, max_iter, q_span, max(max_dist_t, bw), max(max_dist_q, bw),
            bw, f32(chn_pen_gap), f32(chn_pen_skip))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if max_iter <= MAX_ITER_CAP:
            launches = 1
            rc = _kernel("rh_chain_fill")(*args, stream)
        else:
            budget = min(GLOBAL_RING_BUDGET, torch.cuda.mem_get_info(dev)[0] // 4)
            warps, rows = global_ring_plan(b, max_iter, budget)
            ring = torch.empty(rows * warps * 4 * (max_iter + 64),
                               dtype=torch.int32, device=dev)
            launches = -(-b // rows) if b else 0
            rc = _kernel("rh_chain_fill_global")(*args, warps, rows,
                                                 ring.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"chain_fill kernel launch failed: CUDA error {rc}")
    chain_fill.launches += launches
    return f, p


chain_fill.launches = 0
