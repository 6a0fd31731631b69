"""Batched event detection in PyTorch (port of rawhash_tpu/signal/events.py).

Same plan as the reference: streaming z-normalisation with a carried
(sum, sum_sq, n), a +/-3 sigma clip with dense compaction, two-window
t-statistics from prefix sums, the dual peak-detector state machine stepped
over signal positions with a [B]-wide state, and IQR-filtered segment means
(reference: src/revent.c).

Float sums follow the reference's summation order exactly (`ordered_sum`,
`ordered_cumsum`), so sums and prefix sums are bit-identical to the JAX
package on the CPU and the same on every device, whatever order a library
reduction would take.  The t-statistics can still differ from the JAX CPU
build by an ulp or two, so events agree to ~1e-5, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FLT_MIN = float(np.finfo(np.float32).tiny)
FLT_MAX = float(np.finfo(np.float32).max)
BIG_I32 = 0x7FFFFFFF


def f32(x) -> float:
    """A Python float holding x rounded to float32: scalar operands of f32
    tensor ops, so every constant rounds as the reference's does."""
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """f32 a*b + c rounded once.  The reference's CPU build contracts these
    multiply-adds into fused multiply-adds (XLA fuses the elementwise ops and
    its code generator emits an FMA), so the port rounds the same way.  The
    product is exact in f64 and, at the magnitudes involved, so is the sum;
    the single rounding happens in the cast back to f32."""
    a, b, c = (x.to(torch.float64) if isinstance(x, torch.Tensor) else x
               for x in (a, b, c))
    return (a * b + c).to(torch.float32)


class NormCarry(NamedTuple):
    """Running normalisation state per read (reference: rmap.cpp:412-421)."""

    sum: torch.Tensor  # f32 [B]
    sum_sq: torch.Tensor  # f32 [B]
    n: torch.Tensor  # i32 [B]

    @staticmethod
    def zeros(batch: int, device) -> "NormCarry":
        return NormCarry(
            torch.zeros(batch, dtype=torch.float32, device=device),
            torch.zeros(batch, dtype=torch.float32, device=device),
            torch.zeros(batch, dtype=torch.int32, device=device),
        )


def _seq_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive left-to-right running sum over the last axis, one add per
    element in order (no library scan, whose order varies by device)."""
    out = torch.empty_like(x)
    acc = x[..., 0] + 0.0  # 0 + x0, as the reference's sum starts (-0 -> +0)
    out[..., 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Row-wise f32 inclusive prefix sum [B, L] in the reference's order:
    sequential sums inside blocks of 16, the block totals scanned the same
    way recursively, each block offset by the exclusive prefix of the
    totals (the blocked scan XLA's CPU backend emits for jnp.cumsum)."""
    b, n = x.shape
    if n <= 16:
        return _seq_scan(x) if n else x.clone()
    m = -(-n // 16) * 16
    xp = torch.nn.functional.pad(x, (0, m - n)).reshape(b, m // 16, 16)
    inner = _seq_scan(xp)
    tot = ordered_cumsum(inner[:, :, -1].contiguous())
    excl = torch.nn.functional.pad(tot[:, :-1], (1, 0))
    return (inner + excl[:, :, None]).reshape(b, m)[:, :n]


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Row-wise f32 sum [B, L] -> [B] in the reference's order: while a row
    is longer than 32, pad it (half the padding in front) to a multiple of
    32 and replace it by the sequential sums of its 32-wide windows; then
    sum what is left sequentially (XLA's CPU tree reduction)."""
    while x.shape[1] > 32:
        p = -x.shape[1] % 32
        x = torch.nn.functional.pad(x, (p // 2, p - p // 2))
        x = x.reshape(x.shape[0], -1, 32)
        acc = x[:, :, 0] + 0.0
        for j in range(1, 32):
            acc = acc + x[:, :, j]
        x = acc
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def dense_compact(values: torch.Tensor, keep: torch.Tensor):
    """Row-wise stable compaction of values [B, L] under boolean keep.

    Returns (compacted [B, L] zero-padded, counts [B] i32)."""
    b, l = values.shape
    idx = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    tgt = torch.where(keep, idx, l)
    out = torch.zeros((b, l + 1), dtype=values.dtype, device=values.device)
    out.scatter_(1, tgt, values)  # dropped slots all land in column l
    return out[:, :l], keep.sum(dim=1, dtype=torch.int32)


def _shift_right(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[:, i] = x[:, max(i - w, 0)]."""
    return torch.cat([x[:, :1].expand(-1, w), x[:, :-w]], dim=1)


def _shift_left(x: torch.Tensor, w: int) -> torch.Tensor:
    """y[:, i] = x[:, min(i + w, last)]."""
    return torch.cat([x[:, w:], x[:, -1:].expand(-1, w)], dim=1)


def _tstat(prefix, prefix_sq, n_sig, w: int):
    """t-stat over two adjacent w-windows; zero outside [w, n_sig - w]
    (reference: comp_tstat, revent.c:38-74)."""
    b, lp1 = prefix.shape
    l = lp1 - 1
    i = torch.arange(l, device=prefix.device)[None, :]
    p_i = prefix[:, :l]
    p_im = _shift_right(prefix, w)[:, :l]
    p_ip = _shift_left(prefix, w)[:, :l]
    q_i = prefix_sq[:, :l]
    q_im = _shift_right(prefix_sq, w)[:, :l]
    q_ip = _shift_left(prefix_sq, w)[:, :l]
    sum1 = torch.where(i > w, p_i - p_im, p_i)
    sumsq1 = torch.where(i > w, q_i - q_im, q_i)
    sum2 = p_ip - p_i
    sumsq2 = q_ip - q_i
    # the reference's compiler turns x / w into x * f32(1/w) and fuses the
    # multiply-adds; 1/sqrt is correctly rounded on every device
    rw = f32(1.0 / w)
    mean1 = sum1 * rw
    mean2 = sum2 * rw
    var = fma(-mean2, mean2, fma(sumsq2, rw, fma(sumsq1, rw, -(mean1 * mean1))))
    var = torch.clamp_min(var * rw, FLT_MIN)
    t = torch.abs(mean2 - mean1) * (1.0 / torch.sqrt(var))
    ns = n_sig[:, None]
    valid = (i >= w) & (i <= ns - w) & (ns >= 2 * w)
    return torch.where(valid, t, 0.0)


def _detector_step(cur, i: int, state, active, threshold: float, wl: int,
                   peak_height: float):
    """One position update of a single peak detector, [B]-vectorised
    (reference: gen_peaks, revent.c:107-145)."""
    peak_pos, peak_val, valid = state
    in_peak = peak_pos >= 0

    # case 1: no recorded maximum yet
    c1_deeper = cur < peak_val
    c1_rise = ~c1_deeper & ((cur - peak_val) > peak_height)
    pv1 = torch.where(c1_deeper | c1_rise, cur, peak_val)
    pp1 = torch.where(c1_rise, i, peak_pos)

    # case 2: inside a candidate peak
    c2_higher = cur > peak_val
    pv2 = torch.where(c2_higher, cur, peak_val)
    pp2 = torch.where(c2_higher, i, peak_pos)
    above = pv2 > threshold
    valid2 = valid | (((pv2 - cur) > peak_height) & above)
    emit = valid2 & ((i - pp2) > (wl // 2))
    pv2e = torch.where(emit, cur, pv2)
    pp2e = torch.where(emit, -1, pp2)
    valid2e = valid2 & ~emit

    new_pp = torch.where(active & in_peak, pp2e, torch.where(active, pp1, peak_pos))
    new_pv = torch.where(active & in_peak, pv2e, torch.where(active, pv1, peak_val))
    new_valid = torch.where(active & in_peak, valid2e, valid)

    fired = active & in_peak & emit
    emit_pos = torch.where(fired, pp2, -1)
    mask_signal = active & in_peak & above  # short detector masks later ones
    return (new_pp, new_pv, new_valid), emit_pos, mask_signal, pp2


def _gen_peaks(tstat1, tstat2, n_sig, t1: float, t2: float, w1: int, w2: int,
               peak_height: float):
    """Step the dual-detector state machine over signal positions; returns
    emitted peak positions [B, 2L] in emission order (-1 = no emission).

    Positions past every row's n_sig change no state, so the loop stops at
    the longest row."""
    b, l = tstat1.shape
    dev = tstat1.device
    t1f, t2f, ph = f32(t1), f32(t2), f32(peak_height)

    def fresh():
        return (
            torch.full((b,), -1, dtype=torch.int32, device=dev),
            torch.full((b,), FLT_MAX, dtype=torch.float32, device=dev),
            torch.zeros(b, dtype=torch.bool, device=dev),
        )

    masked_to1 = torch.zeros(b, dtype=torch.int32, device=dev)
    st0, st1 = fresh(), fresh()
    emits = torch.full((b, l, 2), -1, dtype=torch.int32, device=dev)
    n_live = int(n_sig.max()) if b else 0
    for i in range(min(n_live, l)):
        alive = i < n_sig
        # detector 0 (short): its masked_to stays 0, so active from i >= 1
        act0 = alive & (i > 0)
        st0, emit0, msk, mpos = _detector_step(
            tstat1[:, i], i, st0, act0, t1f, w1, ph
        )
        # the short detector resets and masks the long one (revent.c:125-131)
        masked_to1 = torch.where(msk, mpos + w1, masked_to1)
        pp1, pv1, va1 = st1
        st1 = (
            torch.where(msk, -1, pp1),
            torch.where(msk, FLT_MAX, pv1),
            va1 & ~msk,
        )
        act1 = alive & (masked_to1 < i)
        st1, emit1, _, _ = _detector_step(
            tstat2[:, i], i, st1, act1, t2f, w2, ph
        )
        emits[:, i, 0] = emit0
        emits[:, i, 1] = emit1
    return emits.reshape(b, 2 * l)


def _sort_key_f32(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of f32 values to non-negative int64 (total
    order, -0.0 before +0.0), for sorting (segment, value) pairs as one
    integer key."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = bits >= 0x80000000
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def _segment_events(norm, n_sig, emitted, emit_ok, n_peaks, e_cap: int):
    """Events = IQR-filtered means of the segments between consecutive peaks
    (reference: gen_events + calculate_mean_of_filtered_segment)."""
    b, l = norm.shape
    dev = norm.device
    n_ev = torch.clamp_max(n_peaks, e_cap)

    pos = torch.arange(l, device=dev)[None, :]
    # seg[p] = number of emitted peaks at or before p
    ind = torch.zeros((b, l + 1), dtype=torch.int32, device=dev)
    tgt = torch.where(emit_ok, torch.clamp_max(emitted, l), l).to(torch.int64)
    ind.scatter_add_(1, tgt, torch.ones_like(tgt, dtype=torch.int32))
    seg = torch.cumsum(ind[:, :l], dim=1)
    invalid = (seg >= n_ev[:, None]) | (pos >= n_sig[:, None])
    seg = torch.where(invalid, e_cap, seg)

    # per-row (segment major, value minor) sort as one int64 key
    key = (seg.to(torch.int64) << 32) | _sort_key_f32(norm)
    key_s, order = torch.sort(key, dim=1)
    seg_s = key_s >> 32
    val_s = torch.gather(norm, 1, order)

    # segment q covers positions [pk[q-1], pk[q]) of the sorted peaks
    pk_sorted = torch.sort(
        torch.where(emit_ok, emitted, BIG_I32), dim=1
    ).values[:, :e_cap]
    qs = torch.arange(e_cap, device=dev)[None, :]
    s_q = torch.nn.functional.pad(pk_sorted[:, : e_cap - 1], (1, 0))
    ns = n_sig[:, None]
    lens = torch.where(
        qs < n_ev[:, None],
        torch.clamp_min(torch.minimum(pk_sorted, ns) - torch.minimum(s_q, ns), 0),
        0,
    ).to(torch.int64)
    bound = torch.cumsum(lens, dim=1)
    starts = bound - lens

    q1 = torch.gather(val_s, 1, torch.clamp(starts + lens // 4, 0, l - 1))
    q3 = torch.gather(val_s, 1, torch.clamp(starts + (3 * lens) // 4, 0, l - 1))
    iqr = q3 - q1
    lo = torch.nn.functional.pad(q1 - iqr, (0, 1))
    hi = torch.nn.functional.pad(q3 + iqr, (0, 1))
    seg_sc = torch.clamp(seg_s, 0, e_cap)
    keep_s = (
        (seg_s < e_cap)
        & (val_s >= torch.gather(lo, 1, seg_sc))
        & (val_s <= torch.gather(hi, 1, seg_sc))
    )

    # segment sums/counts as prefix-sum differences over the sorted row
    psum = torch.nn.functional.pad(
        ordered_cumsum(torch.where(keep_s, val_s, 0.0)), (1, 0)
    )
    pcnt = torch.nn.functional.pad(torch.cumsum(keep_s.to(torch.int64), 1), (1, 0))
    ends = starts + lens
    sums = torch.gather(psum, 1, ends) - torch.gather(psum, 1, starts)
    counts = torch.gather(pcnt, 1, ends) - torch.gather(pcnt, 1, starts)
    events = torch.where(
        counts > 0, sums / torch.clamp_min(counts, 1).to(torch.float32), 0.0
    )
    return torch.where(qs < n_ev[:, None], events, 0.0), n_ev


def detect_events_batch(
    sig: torch.Tensor,  # f32 [B, L] padded raw signal chunk
    slen: torch.Tensor,  # i32 [B] valid samples per row
    carry: NormCarry,
    *,
    window_length1: int = 3,
    window_length2: int = 9,
    threshold1: float = 4.0,
    threshold2: float = 3.5,
    peak_height: float = 0.4,
    e_cap: int = 1024,
):
    """Batched detect_events (revent.c:257-316).

    Returns (events f32 [B, e_cap], n_events i32 [B], new_carry)."""
    b, l = sig.shape
    pos = torch.arange(l, device=sig.device)[None, :]
    valid = pos < slen[:, None]
    sig_m = torch.where(valid, sig, 0.0)

    new_sum = carry.sum + ordered_sum(sig_m)
    new_sumsq = carry.sum_sq + ordered_sum(sig_m * sig_m)
    new_n = carry.n + slen
    nf = torch.clamp_min(new_n, 1).to(torch.float32)
    mean = new_sum / nf
    std = torch.sqrt(torch.clamp_min(fma(-mean, mean, new_sumsq / nf), 0.0))
    std = torch.where(std > 0, std, 1.0)
    norm = (sig - mean[:, None]) / std[:, None]
    clip = valid & (norm < 3.0) & (norm > -3.0)
    normc, n_sig = dense_compact(norm, clip)

    prefix = torch.nn.functional.pad(ordered_cumsum(normc), (1, 0))
    prefix_sq = torch.nn.functional.pad(ordered_cumsum(normc * normc), (1, 0))
    ts1 = _tstat(prefix, prefix_sq, n_sig, window_length1)
    ts2 = _tstat(prefix, prefix_sq, n_sig, window_length2)

    emitted = _gen_peaks(
        ts1, ts2, n_sig, threshold1, threshold2,
        window_length1, window_length2, peak_height,
    )
    ok = (emitted > 0) & (emitted < n_sig[:, None])
    n_peaks = ok.sum(dim=1, dtype=torch.int32)

    events, n_ev = _segment_events(normc, n_sig, emitted, ok, n_peaks, e_cap)
    return events, n_ev.to(torch.int32), NormCarry(new_sum, new_sumsq, new_n)
