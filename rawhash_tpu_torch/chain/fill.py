"""Chaining DP fill: the CUDA kernel K1 and its dispatch.

`chain_fill` replaces rawhash_tpu/chain/pallas_fill.py::chain_fill_pallas.
On CPU tensors it runs the plain PyTorch fill (chain/device.py); on CUDA
tensors it launches csrc/chain_fill.cu (a block of warps per read, each
warp filling its own chain segments through their in-band suffixes) or
raises.  Both give the same f and p bit for bit on rows sorted by
(unsigned key, tpos), which the kernel needs and does not check.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from ..signal.events import f32
from .device import chain_fill_batch

# a block runs as many warps a read as their rings (W + 64 slots of 16 bytes
# each: csrc/chain_fill.cuh, rh_fill_warps) fit in its 227 KB of shared
# memory, up to 16; past this W not one ring fits
MAX_ITER_CAP = 232448 // 16 - 64

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = load_library().rh_chain_fill
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        _FN = fn
    return _FN


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
    order.  On the card max_iter is at most MAX_ITER_CAP."""
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
    if not 1 <= max_iter <= MAX_ITER_CAP:
        raise ValueError(f"chain_fill: max_iter must be in [1, {MAX_ITER_CAP}]")
    f = torch.empty((b, n), dtype=torch.int32, device=dev)
    p = torch.empty((b, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(
            key.data_ptr(), tpos.data_ptr(), qpos.data_ptr(),
            n_anchors.data_ptr(), f.data_ptr(), p.data_ptr(),
            b, n, max_iter, q_span, max(max_dist_t, bw), max(max_dist_q, bw),
            bw, f32(chn_pen_gap), f32(chn_pen_skip), stream,
        )
    if rc != 0:
        raise RuntimeError(f"chain_fill kernel launch failed: CUDA error {rc}")
    chain_fill.launches += 1
    return f, p


chain_fill.launches = 0
