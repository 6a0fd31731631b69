"""Batched slanted-band DTW in PyTorch (port of rawhash_tpu/dtw/device.py).

The reference's slanted-band DTW (dtw.cpp:167-520) advances one column of
the band per step, with the band in a tensor row and many alignment
problems batched in the leading axis: the sparse (anchor-to-anchor) chain
evaluation runs thousands of small alignments at once.

Each problem carries its own band radius (the reference sizes the band as a
fraction of the query length per segment, rmap.cpp:155,189); the band's
width is set by the batch's largest radius, and narrower rows mask their
outer slots to BIG.

The top coupling inside a column (new[o] depends on new[o-1]) is solved
with the prefix-min identity of dtw/banded.py:
    new[o] = min_{k<=o}(best[k] + cost[k] - csum[k]) + csum[o]
a cummin over the band.  The prefix sum csum is taken in the order XLA's
CPU backend takes the reference engine's jnp.cumsum (`_cumsum`), so costs
agree with it to the last bit; the cummin is exact in any order.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e10  # rounds to the float32 BIG of dtw/banded.py
BLOCK = 16  # XLA's scan block (its ReduceWindowRewriter base length)


def _scan_in_order(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last dim, one add after another."""
    out = x.clone()
    for k in range(1, x.shape[-1]):
        out[..., k] += out[..., k - 1]
    return out


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Prefix sum of x [B, n] along dim 1 in XLA's CPU order: sequential up
    to BLOCK elements; past that, sequential inside blocks of BLOCK, each
    block offset by the prefix (taken the same way) of the block totals
    before it.  torch.cumsum adds in another order."""
    b, n = x.shape
    if n <= BLOCK:
        return _scan_in_order(x)
    m = -(-n // BLOCK) * BLOCK
    inner = _scan_in_order(
        torch.nn.functional.pad(x, (0, m - n)).view(b, m // BLOCK, BLOCK))
    outer = _cumsum(inner[:, :, -1])
    excl = torch.nn.functional.pad(outer[:, :-1], (1, 0))
    return (excl[:, :, None] + inner).reshape(b, m)[:, :n]


def dtw_banded_batch(
    a: torch.Tensor,  # f32 [B, L] (the longer sequence of each pair)
    a_len: torch.Tensor,  # int [B]
    b: torch.Tensor,  # f32 [B, L]
    b_len: torch.Tensor,  # int [B]
    radius: torch.Tensor,  # int [B] per-pair band radius (<= max_radius)
    *,
    max_radius: int,
) -> torch.Tensor:
    """Banded DTW cost for B padded sequence pairs, on their device.

    The longer sequence of each pair must be in `a` (dtw_banded_batch_host
    swaps them).  Returns f32 [B] total |a-b| warping costs with global
    borders.  The band is 2 * max_radius + 1 slots wide; a slot outside a
    pair's radius still adds its cost to csum, so the width is part of the
    rounding, as in the reference engine."""
    dev = a.device
    bsz, max_len = a.shape
    r = int(max_radius)
    width = 2 * r + 1
    offs = torch.arange(-r, r + 1, device=dev)
    slots = torch.arange(width, device=dev)
    a_len, b_len = a_len.long(), b_len.long()
    radius = radius.long().clamp(max=r)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    # first column: cumulative cost down rows 0..min(radius, blen - 1)
    ok0 = (offs >= 0) & (offs < b_len[:, None]) & (offs <= radius[:, None])
    b0 = torch.gather(b, 1, offs.clamp(0, max_len - 1).expand(bsz, -1))
    col0 = torch.where(ok0, (a[:, :1] - b0).abs(), big)
    dp = torch.where(offs >= 0,
                     _cumsum(torch.where(offs >= 0, torch.minimum(col0, big), 0.0)),
                     big)
    dp = torch.where(col0 >= big, big, dp)

    center = torch.zeros(bsz, dtype=torch.long, device=dev)
    big_col = big.expand(bsz, 1)
    for i in range(1, int(a_len.max()) if bsz else 1):
        alive = i < a_len
        nxt = center + 1
        inc = (nxt * a_len) <= (b_len * i)
        center2 = torch.where(inc & alive, nxt, center)
        j = center2[:, None] + offs[None, :]
        valid = (j >= 0) & (j < b_len[:, None]) & (offs.abs()[None, :] <= radius[:, None])
        cost = (a[:, i:i + 1] - torch.gather(b, 1, j.clamp(0, max_len - 1))).abs()
        shifted = torch.cat([dp[:, 1:], big_col], dim=1)
        up1 = torch.cat([big_col, dp[:, :-1]], dim=1)
        left = torch.where(inc[:, None], shifted, dp)
        topleft = torch.where(inc[:, None], dp, up1)
        # reference guard: after a slide, the slot whose target row is j == 0
        # has no (i-1, j-1) predecessor (only real when center + off > 0)
        edge_slot = (r - center2).clamp(0, width - 1)
        tl_fix = (center2 - radius) <= 0
        topleft = torch.where(
            (inc & tl_fix)[:, None] & (slots[None, :] == edge_slot[:, None]),
            big, topleft)
        bm = torch.minimum(torch.minimum(left, topleft) + cost, big)
        csum = _cumsum(cost)
        new = torch.cummin(bm - csum, dim=1).values + csum
        new = torch.where(valid, torch.minimum(new, big), big)
        dp = torch.where(alive[:, None], new, dp)
        center = center2
    out_slot = (b_len - 1 - center + r).clamp(0, width - 1)
    return torch.gather(dp, 1, out_slot[:, None])[:, 0]


def _pow2_at_least(x: int, lo: int) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def dtw_banded_batch_host(pairs, band_radius, device="cuda") -> np.ndarray:
    """[(a, b)] float32 pairs -> costs [len(pairs)], computed on `device`.

    `band_radius` is an int applied to every pair or a per-pair sequence.
    Swaps each pair so the longer sequence comes first, pads, and runs one
    dtw_banded_batch for the whole batch.  The band's radius is the largest
    one rounded up to a power of two (at least 4), as in the reference
    engine: the band's width enters the rounding of csum."""
    if not pairs:
        return np.zeros(0, dtype=np.float32)
    bsz = len(pairs)
    if np.isscalar(band_radius):
        radii = np.full(bsz, int(band_radius), dtype=np.int32)
    else:
        radii = np.asarray(band_radius, dtype=np.int32)
    swapped = [(x, y) if x.shape[0] >= y.shape[0] else (y, x) for x, y in pairs]
    max_len = max(x.shape[0] for x, _ in swapped)
    a = np.zeros((bsz, max_len), dtype=np.float32)
    b = np.zeros((bsz, max_len), dtype=np.float32)
    a_len = np.zeros(bsz, dtype=np.int32)
    b_len = np.zeros(bsz, dtype=np.int32)
    for i, (x, y) in enumerate(swapped):
        a[i, : x.shape[0]] = x
        b[i, : y.shape[0]] = y
        a_len[i] = x.shape[0]
        b_len[i] = y.shape[0]
    out = dtw_banded_batch(
        *(torch.from_numpy(t).to(device) for t in (a, a_len, b, b_len, radii)),
        max_radius=_pow2_at_least(int(radii.max()), 4),
    )
    return out.cpu().numpy()
