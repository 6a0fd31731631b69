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

On CUDA tensors the JAX package's compiled scan runs as a kernel
(csrc/dtw_banded.cu), bit for bit, with two entries: `dtw_banded_ragged`,
the pairs as ragged rows of one array (the host wrapper packs them so,
`pack_pairs`), and `dtw_banded_batch`, the JAX function's padded
signature.  The kernel takes the pairs longest first, the long ones a warp
each and the rest a thread each.  On CPU tensors both run the plain
version, `dtw_banded_batch_plain`.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .._build import check_operand, kernel
from ..signal.events import launch_counted

BIG = 1e10  # rounds to the float32 BIG of dtw/banded.py
BLOCK = 16  # XLA's scan block (its ReduceWindowRewriter base length)
# the kernel's pairs of at least WARP_COLUMNS columns take a warp each, the
# rest a thread each (the dtw cell's column histogram, PERF.md section 6)
WARP_COLUMNS = 32


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


def dtw_banded_batch_plain(
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


def _launch(a, a_off, a_len, b, b_off, b_len, radius, order, *, pairs, max_radius,
            cap, threshold, long_warps) -> torch.Tensor:
    """rh_dtw_banded on CUDA tensors (a, b: f32 values; the rest i32 [pairs]),
    one counted launch; f32 [pairs]."""
    dev = a.device
    out = torch.empty(pairs, dtype=torch.float32, device=dev)
    if pairs:
        width = 2 * max_radius + 1
        scratch = None
        if width > kernel("rh_dtw_shared_width", [])():
            scratch = torch.empty(2 * (width + 3) * pairs, dtype=torch.float32, device=dev)
        launch_counted(dtw_banded_batch, "rh_dtw_banded", dev, a.data_ptr(),
                       a_off.data_ptr(), a_len.data_ptr(), b.data_ptr(), b_off.data_ptr(),
                       b_len.data_ptr(), radius.data_ptr(), order.data_ptr(),
                       out.data_ptr(), pairs, max_radius, cap, threshold,
                       max(0, min(int(long_warps), pairs)),
                       None if scratch is None else scratch.data_ptr())
    return out


def _check_radius(fn: str, max_radius: int) -> int:
    r = int(max_radius)
    if r < 0:
        raise ValueError(f"{fn}: max_radius {r} must be >= 0")
    return r


def dtw_banded_batch(
    a: torch.Tensor,  # f32 [B, L] (the longer sequence of each pair)
    a_len: torch.Tensor,  # i32 [B]
    b: torch.Tensor,  # f32 [B, L]
    b_len: torch.Tensor,  # i32 [B]
    radius: torch.Tensor,  # i32 [B] per-pair band radius (<= max_radius)
    *,
    max_radius: int,
    threshold: int | None = None,
) -> torch.Tensor:
    """`dtw_banded_batch_plain` (a, b f32 [B, L] with L >= 1, a_len, b_len,
    radius i32 [B], contiguous -> f32 [B]): on CUDA tensors by the kernel
    rh_dtw_banded (csrc/dtw_banded.cu), bit for bit, each pair to its own
    a_len, its rows read as ragged rows of offset p L, no further than L,
    the pairs taken longest first (an order torch.argsort makes on the
    card); pairs of at least `threshold` columns (WARP_COLUMNS if None) on
    a warp each.
    A band wider than the kernel's shared memory holds runs from a scratch
    of 2 x (width + 3) x B floats.  No host sync; one launch."""
    if a.dim() != 2:
        raise ValueError(f"dtw_banded_batch: a must be 2-D, got {tuple(a.shape)}")
    bsz, max_len = a.shape
    dev = a.device
    fn = "dtw_banded_batch"
    check_operand(fn, "a", a, torch.float32, (bsz, max_len), dev)
    check_operand(fn, "b", b, torch.float32, (bsz, max_len), dev)
    for name, t in (("a_len", a_len), ("b_len", b_len), ("radius", radius)):
        check_operand(fn, name, t, torch.int32, (bsz,), dev)
    if dev.type == "cpu":
        return dtw_banded_batch_plain(a, a_len, b, b_len, radius, max_radius=max_radius)
    if dev.type != "cuda":
        raise ValueError(f"dtw_banded_batch: unsupported device {dev}")
    r = _check_radius(fn, max_radius)
    if bsz and max_len < 1:
        raise ValueError(f"dtw_banded_batch: L {max_len} must be >= 1")
    if bsz * max_len >= 2 ** 31:
        raise ValueError(f"dtw_banded_batch: {bsz} x {max_len} values pass int32 offsets")
    if not bsz:
        return torch.empty(0, dtype=torch.float32, device=dev)
    t = WARP_COLUMNS if threshold is None else int(threshold)
    off = torch.arange(0, bsz * max_len, max_len, dtype=torch.int32, device=dev)
    order = torch.argsort(a_len.clamp(max=max_len), descending=True,
                          stable=True).to(torch.int32)
    return _launch(a, off, a_len, b, off, b_len, radius, order, pairs=bsz,
                   max_radius=r, cap=max_len, threshold=t,
                   long_warps=bsz if max_len >= t else 0)


dtw_banded_batch.launches = 0


def _pad_rows(values: torch.Tensor, off: torch.Tensor, n: torch.Tensor,
              width: int) -> torch.Tensor:
    """The ragged rows values[off[p] : off[p] + n[p]] as f32 [B, width],
    zero past each row's n."""
    j = torch.arange(width, device=values.device)
    inside = j[None, :] < n.long()[:, None]
    ext = torch.cat([values, values.new_zeros(1)])  # index len(values): a zero
    idx = torch.where(inside, off.long()[:, None] + j[None, :], values.shape[0])
    return ext[idx]


def dtw_banded_ragged(
    values: torch.Tensor,  # f32 [V]: every pair's a and b values
    a_off: torch.Tensor,  # i32 [B]: pair p's a at values[a_off[p] : + a_len[p]]
    a_len: torch.Tensor,  # i32 [B] (the longer sequence of each pair)
    b_off: torch.Tensor,  # i32 [B]
    b_len: torch.Tensor,  # i32 [B]
    radius: torch.Tensor,  # i32 [B] per-pair band radius (<= max_radius)
    order: torch.Tensor,  # i32 [B]: a permutation of the pairs, longest first
    *,
    max_radius: int,
    long_pairs: int | None = None,
    threshold: int | None = None,
) -> torch.Tensor:
    """The banded DTW costs (f32 [B], each at its pair's place) of ragged
    pairs: pair p's a and b are values[a_off[p]:][:a_len[p]] and
    values[b_off[p]:][:b_len[p]].  The caller keeps two promises that only
    the CPU route checks (checking them on the card would cost a host
    sync): `order` is a permutation of 0..B-1 (a repeated pair leaves
    another's cost unwritten), and every row lies inside `values` (the
    kernel reads what it is told to).  `pack_pairs` makes them so.
    On CUDA tensors one launch of rh_dtw_banded, bit-equal to
    `dtw_banded_batch_plain` of the same pairs padded: the pairs in `order`
    (longest first is fastest), the first `long_pairs` positions (all if
    None) with at least `threshold` columns (WARP_COLUMNS if None) on a
    warp each, every other pair on a thread.  On CPU tensors the pairs
    padded to the longest row and `dtw_banded_batch_plain`."""
    fn = "dtw_banded_ragged"
    if values.dim() != 1:
        raise ValueError(f"{fn}: values must be 1-D, got {tuple(values.shape)}")
    dev = values.device
    bsz = a_len.shape[0] if a_len.dim() == 1 else -1
    check_operand(fn, "values", values, torch.float32, values.shape, dev)
    for name, t in (("a_off", a_off), ("a_len", a_len), ("b_off", b_off),
                    ("b_len", b_len), ("radius", radius), ("order", order)):
        check_operand(fn, name, t, torch.int32, (bsz,), dev)
    if dev.type == "cpu":
        if not torch.equal(torch.sort(order.long()).values, torch.arange(bsz)):
            raise ValueError(f"{fn}: order is not a permutation of the {bsz} pairs")
        for name, off, n in (("a", a_off, a_len), ("b", b_off, b_len)):
            if bsz and (int(off.min()) < 0 or int(n.min()) < 0
                        or int((off.long() + n.long()).max()) > values.shape[0]):
                raise ValueError(f"{fn}: a row of {name} lies outside values "
                                 f"({values.shape[0]} floats)")
        if not bsz:
            return torch.zeros(0, dtype=torch.float32)
        width = max(int(a_len.max()), int(b_len.max()), 1)
        return dtw_banded_batch_plain(
            _pad_rows(values, a_off, a_len, width), a_len,
            _pad_rows(values, b_off, b_len, width), b_len, radius, max_radius=max_radius)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    r = _check_radius(fn, max_radius)
    return _launch(values, a_off, a_len, values, b_off, b_len, radius, order,
                   pairs=bsz, max_radius=r, cap=2 ** 31 - 1,
                   threshold=WARP_COLUMNS if threshold is None else int(threshold),
                   long_warps=bsz if long_pairs is None else long_pairs)


def _pow2_at_least(x: int, lo: int) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def pack_pairs(pairs, band_radius, threshold: int = WARP_COLUMNS):
    """[(a, b)] sequence pairs -> (values f32 [V], a_off, a_len, b_off,
    b_len, radius, order i32 [B], long_pairs): every sequence in one array
    in the pairs' order, each pair's longer sequence as its a (found by the
    offsets, nothing copied twice), the order longest a first (stable), and
    the count of pairs with at least `threshold` columns, which lead it.
    Vectorised: no Python step a pair."""
    bsz = len(pairs)
    if np.isscalar(band_radius):
        radii = np.full(bsz, int(band_radius), dtype=np.int32)
    else:
        radii = np.asarray(band_radius, dtype=np.int32)
    seqs = list(itertools.chain.from_iterable(pairs))  # x0, y0, x1, y1, ...
    lens = np.fromiter(map(len, seqs), np.int64, 2 * bsz)
    values = np.concatenate(seqs).astype(np.float32, copy=False)
    if values.shape[0] >= 2 ** 31:
        raise ValueError(f"pack_pairs: {values.shape[0]} values pass int32 offsets")
    off = np.zeros(2 * bsz, np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    lens, off = lens.reshape(bsz, 2), off.reshape(bsz, 2)
    swap = lens[:, 1] > lens[:, 0]  # y longer: y is the pair's a
    a_len = np.where(swap, lens[:, 1], lens[:, 0]).astype(np.int32)
    b_len = np.where(swap, lens[:, 0], lens[:, 1]).astype(np.int32)
    a_off = np.where(swap, off[:, 1], off[:, 0]).astype(np.int32)
    b_off = np.where(swap, off[:, 0], off[:, 1]).astype(np.int32)
    order = np.argsort(-a_len.astype(np.int64), kind="stable").astype(np.int32)
    return (values, a_off, a_len, b_off, b_len, radii, order,
            int(np.count_nonzero(a_len >= threshold)))


def dtw_banded_batch_host(pairs, band_radius, device="cuda") -> np.ndarray:
    """[(a, b)] float32 pairs -> costs [len(pairs)], computed on `device`.

    `band_radius` is an int applied to every pair or a per-pair sequence.
    Packs the pairs ragged (`pack_pairs`), copies them to the device in one
    buffer (the values and six ints a pair), and runs one
    `dtw_banded_ragged` for the whole batch: on CUDA one launch, on the CPU
    the plain version on the pairs padded to the longest.  The band's
    radius is the largest one rounded up to a power of two (at least 4), as
    in the reference engine: the band's width enters the rounding of
    csum."""
    if not pairs:
        return np.zeros(0, dtype=np.float32)
    values, *ints, long_pairs = pack_pairs(pairs, band_radius)
    buf = torch.from_numpy(np.concatenate([values.view(np.int32), *ints])).to(device)
    v, b = values.shape[0], len(pairs)
    cut = [buf[v + i * b: v + (i + 1) * b] for i in range(len(ints))]
    out = dtw_banded_ragged(buf[:v].view(torch.float32), *cut,
                            max_radius=_pow2_at_least(int(ints[4].max()), 4),
                            long_pairs=long_pairs)
    return out.cpu().numpy()
