"""Batched sketching on tensors (port of rawhash_tpu/sketch/device.py):
events -> 32-bit seed hashes, within-chunk seed positions and validity.
Hashes are u32 values carried in int64.  The event-difference filter, a
serial scan over each read's events, runs on CUDA tensors as a kernel
(`_diff_filter`, csrc/diff_filter.cu), as the JAX package compiles its scan
into the sketch program; on CPU tensors as its plain version."""

from __future__ import annotations

import torch

from .._build import check_operand
from ..signal.events import dense_compact, f32, launch_counted
from .quantize import U32, dynamic_quantize, hash32


def _diff_filter_plain(events: torch.Tensor, n_ev: torch.Tensor, diff: float):
    """Keep events differing from the last *kept* event by >= diff
    (rsketch.c:95,187).  Returns the keep mask [B, E].  A sequential loop
    over event positions with a [B]-wide carry; it stops at the longest
    row (read back to the host), since no later position can be kept."""
    b, e = events.shape
    dev = events.device
    thr = f32(diff)
    keep = torch.zeros((b, e), dtype=torch.bool, device=dev)
    last = torch.zeros(b, dtype=torch.float32, device=dev)
    n_live = int(n_ev.max()) if b else 0
    for t in range(min(n_live, e)):
        v = events[:, t]
        k = t < n_ev
        if t > 0:
            k = k & (torch.abs(v - last) >= thr)
        last = torch.where(k, v, last)
        keep[:, t] = k
    return keep


def _diff_filter(events: torch.Tensor, n_ev: torch.Tensor, diff: float):
    """`_diff_filter_plain` (events f32 [B, E], n_ev i32 [B], contiguous ->
    bool [B, E]): on CUDA tensors by the kernel rh_diff_filter
    (csrc/diff_filter.cu), bit for bit, each row stepped to its own n_ev."""
    if events.dim() != 2:
        raise ValueError(f"_diff_filter: events must be 2-D, got {tuple(events.shape)}")
    b, e = events.shape
    dev = events.device
    check_operand("_diff_filter", "events", events, torch.float32, (b, e), dev)
    check_operand("_diff_filter", "n_ev", n_ev, torch.int32, (b,), dev)
    if dev.type == "cpu":
        return _diff_filter_plain(events, n_ev, diff)
    if dev.type != "cuda":
        raise ValueError(f"_diff_filter: unsupported device {dev}")
    keep = torch.empty((b, e), dtype=torch.bool, device=dev)
    if b and e:
        launch_counted(_diff_filter, "rh_diff_filter", dev, events.data_ptr(), n_ev.data_ptr(),
                keep.data_ptr(), b, e, f32(diff))
    return keep


_diff_filter.launches = 0


def sketch_batch(
    events: torch.Tensor,  # f32 [B, E]
    n_ev: torch.Tensor,  # i32 [B]
    *,
    diff: float,
    w: int,
    e: int,
    q: int,
    k: int,
    fine_min: float,
    fine_max: float,
    fine_range: float,
):
    """Returns (hashes int64 [B,E] holding u32, qpos int64 [B,E] within-chunk
    event position of each seed's first event, valid bool [B,E]).  Seed t
    covers kept events t-e+1..t."""
    b, cap = events.shape
    dev = events.device
    keep = _diff_filter(events, n_ev, diff)
    vals, n_kept = dense_compact(events, keep)
    pos = torch.arange(cap, device=dev).expand(b, cap)
    kept_pos, _ = dense_compact(pos, keep)

    mask = (1 << q) - 1
    codes = dynamic_quantize(vals, fine_min, fine_max, fine_range, 1 << q)
    codes = codes.to(torch.int64) & mask
    # rolling pack: seed at kept-index t packs codes[t-e+1..t], oldest highest
    packed = torch.zeros((b, cap), dtype=torch.int64, device=dev)
    for j in range(e):
        rolled = torch.nn.functional.pad(codes, (j, 0))[:, :cap]
        packed = packed | (rolled << (q * j))
    # the packed word is u32: bits past 32 fall away as they would in u32
    packed = packed & (U32 if q * e >= 32 else (1 << (q * e)) - 1)
    hashes = hash32(packed)

    t_idx = torch.arange(cap, device=dev)[None, :]
    valid = (t_idx >= e - 1) & (t_idx < n_kept[:, None])
    qpos = torch.gather(
        kept_pos, 1, torch.clamp(t_idx - (e - 1), 0, cap - 1).expand(b, cap)
    )

    if w:
        hm = torch.where(valid, hashes, U32)
        # window minima over w consecutive seeds; the window starting at
        # t-index s is valid iff it lies fully inside the seed stream
        wmin = hm
        for d in range(1, w):
            wmin = torch.minimum(
                wmin, torch.nn.functional.pad(hm, (0, d), value=U32)[:, d:]
            )
        winv = (t_idx >= e - 1) & (t_idx + (w - 1) < n_kept[:, None])
        # seed t is emitted iff it equals the min of a valid window holding it
        emit = torch.zeros_like(valid)
        for d in range(w):
            shifted = torch.nn.functional.pad(wmin, (d, 0), value=U32)[:, :cap]
            shifted_ok = torch.nn.functional.pad(winv, (d, 0))[:, :cap]
            emit = emit | ((hm == shifted) & shifted_ok)
        valid = valid & emit
    return hashes, qpos, valid
