"""Event detection in plain PyTorch (RawHash2's revent.c): streaming
z-normalisation with a carried (sum, sum_sq, n), a +/-3 sigma clip, two-window
t-statistics from prefix sums, the dual peak detector stepped position by
position, and IQR-filtered segment means.  Sums follow the port's fixed
order (blocks of 16 for prefix sums, windows of 32 for sums), so the result
is the same on every device.  `dtype` is the float type the stage computes
in: float32 as configured, or bfloat16 for the control."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FLT_MIN = float(np.finfo(np.float32).tiny)
FLT_MAX = float(np.finfo(np.float32).max)
BIG_I32 = 0x7FFFFFFF


def f32(x) -> float:
    """x rounded to float32, as a Python float."""
    return float(np.float32(x))


def fma(a, b, c, dtype=torch.float32) -> torch.Tensor:
    """a*b + c rounded once to `dtype` (the reference build fuses these)."""
    a, b, c = (x.to(torch.float64) if isinstance(x, torch.Tensor) else x
               for x in (a, b, c))
    return (a * b + c).to(dtype)


class NormCarry(NamedTuple):
    sum: torch.Tensor
    sum_sq: torch.Tensor
    n: torch.Tensor

    @staticmethod
    def zeros(batch: int, dtype=torch.float32) -> "NormCarry":
        return NormCarry(torch.zeros(batch, dtype=dtype),
                         torch.zeros(batch, dtype=dtype),
                         torch.zeros(batch, dtype=torch.int32))


def _seq_scan(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    acc = x[..., 0] + 0.0
    out[..., 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def _cumsum_blocks(x: torch.Tensor) -> torch.Tensor:
    b, n = x.shape
    if n <= 16:
        return _seq_scan(x) if n else x.clone()
    m = -(-n // 16) * 16
    xp = torch.nn.functional.pad(x, (0, m - n)).reshape(b, m // 16, 16)
    inner = _seq_scan(xp)
    tot = _cumsum_blocks(inner[:, :, -1].contiguous())
    excl = torch.nn.functional.pad(tot[:, :-1], (1, 0))
    return (inner + excl[:, :, None]).reshape(b, m)[:, :n]


def ordered_cumsum(x: torch.Tensor, lead_zero: bool = False) -> torch.Tensor:
    """Row-wise prefix sum: sequential inside blocks of 16, the block
    totals scanned the same way, each block offset by their exclusive
    prefix; lead_zero puts a 0 in front."""
    out = _cumsum_blocks(x)
    return torch.nn.functional.pad(out, (1, 0)) if lead_zero else out


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Row-wise sum: while a row is longer than 32, pad it (half the padding
    in front) to a multiple of 32 and replace it by its 32-wide windows'
    sequential sums; then sum what is left sequentially."""
    while x.shape[1] > 32:
        p = -x.shape[1] % 32
        x = torch.nn.functional.pad(x, (p // 2, p - p // 2))
        x = x.reshape(x.shape[0], -1, 32)
        acc = x[:, :, 0] + 0.0
        for j in range(1, 32):
            acc = acc + x[:, :, j]
        x = acc
    acc = torch.zeros(x.shape[0], dtype=x.dtype)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def dense_compact(values: torch.Tensor, keep: torch.Tensor):
    """Row-wise stable compaction under `keep`: (values, zero-padded; counts)."""
    b, l = values.shape
    idx = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    tgt = torch.where(keep, idx, l)
    out = torch.zeros((b, l + 1), dtype=values.dtype)
    out.scatter_(1, tgt, values)
    return out[:, :l], keep.sum(dim=1, dtype=torch.int32)


def _shift_right(x, w):
    return torch.cat([x[:, :1].expand(-1, w), x[:, :-w]], dim=1)


def _shift_left(x, w):
    return torch.cat([x[:, w:], x[:, -1:].expand(-1, w)], dim=1)


def _tstat(prefix, prefix_sq, n_sig, w: int, dtype):
    """t-statistic over two adjacent w-windows; zero outside [w, n_sig - w]
    (revent.c:38-74)."""
    b, lp1 = prefix.shape
    l = lp1 - 1
    i = torch.arange(l)[None, :]
    p_i, q_i = prefix[:, :l], prefix_sq[:, :l]
    p_im, q_im = _shift_right(prefix, w)[:, :l], _shift_right(prefix_sq, w)[:, :l]
    p_ip, q_ip = _shift_left(prefix, w)[:, :l], _shift_left(prefix_sq, w)[:, :l]
    sum1 = torch.where(i > w, p_i - p_im, p_i)
    sumsq1 = torch.where(i > w, q_i - q_im, q_i)
    sum2 = p_ip - p_i
    sumsq2 = q_ip - q_i
    rw = f32(1.0 / w)
    mean1 = sum1 * rw
    mean2 = sum2 * rw
    var = fma(-mean2, mean2, fma(sumsq2, rw, fma(sumsq1, rw, -(mean1 * mean1),
                                                  dtype), dtype), dtype)
    var = torch.clamp_min(var * rw, FLT_MIN)
    t = torch.abs(mean2 - mean1) * (1.0 / torch.sqrt(var))
    ns = n_sig[:, None]
    valid = (i >= w) & (i <= ns - w) & (ns >= 2 * w)
    return torch.where(valid, t, 0.0)


def _detector_step(cur, i, state, active, threshold, wl, peak_height):
    """One position of one peak detector (revent.c:107-145), NumPy [B]."""
    peak_pos, peak_val, valid = state
    in_peak = peak_pos >= 0
    c1_deeper = cur < peak_val
    c1_rise = ~c1_deeper & ((cur - peak_val) > peak_height)
    pv1 = np.where(c1_deeper | c1_rise, cur, peak_val)
    pp1 = np.where(c1_rise, i, peak_pos)
    c2_higher = cur > peak_val
    pv2 = np.where(c2_higher, cur, peak_val)
    pp2 = np.where(c2_higher, i, peak_pos)
    above = pv2 > threshold
    valid2 = valid | (((pv2 - cur) > peak_height) & above)
    emit = valid2 & ((i - pp2) > (wl // 2))
    pv2e = np.where(emit, cur, pv2)
    pp2e = np.where(emit, -1, pp2)
    valid2e = valid2 & ~emit
    live = active & in_peak
    new_pp = np.where(live, pp2e, np.where(active, pp1, peak_pos)).astype(np.int32)
    new_pv = np.where(live, pv2e, np.where(active, pv1, peak_val)).astype(np.float32)
    new_valid = np.where(live, valid2e, valid)
    emit_pos = np.where(live & emit, pp2, -1)
    return (new_pp, new_pv, new_valid), emit_pos, live & above, pp2


def gen_peaks(tstat1, tstat2, n_sig, t1, t2, w1, w2, peak_height):
    """The dual detector over positions: emitted peak positions [B, 2L] in
    emission order (-1: none).  Stepped in NumPy, whose f32 compares and
    selects are the port's plain version's; the detector's state is f32,
    so t-statistics of a lower precision pass through exactly."""
    ts1 = tstat1.to(torch.float32).numpy()
    ts2 = tstat2.to(torch.float32).numpy()
    ns = n_sig.numpy()
    b, l = ts1.shape
    t1f, t2f, ph = np.float32(t1), np.float32(t2), np.float32(peak_height)

    def fresh():
        return (np.full(b, -1, np.int32), np.full(b, FLT_MAX, np.float32),
                np.zeros(b, bool))

    masked_to1 = np.zeros(b, np.int32)
    st0, st1 = fresh(), fresh()
    emits = np.full((b, l, 2), -1, np.int32)
    n_live = int(ns.max()) if b else 0
    for i in range(min(n_live, l)):
        alive = i < ns
        act0 = alive & (i > 0)
        st0, emit0, msk, mpos = _detector_step(ts1[:, i], i, st0, act0, t1f, w1, ph)
        masked_to1 = np.where(msk, mpos + w1, masked_to1)
        pp1, pv1, va1 = st1
        st1 = (np.where(msk, -1, pp1).astype(np.int32),
               np.where(msk, np.float32(FLT_MAX), pv1).astype(np.float32), va1 & ~msk)
        act1 = alive & (masked_to1 < i)
        st1, emit1, _, _ = _detector_step(ts2[:, i], i, st1, act1, t2f, w2, ph)
        emits[:, i, 0] = emit0
        emits[:, i, 1] = emit1
    return torch.from_numpy(emits.reshape(b, 2 * l))


def _sort_key(v: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of float values (as f32 bits) to int64."""
    bits = v.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = bits >= 0x80000000
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def _segment_events(norm, n_sig, emitted, emit_ok, n_peaks, e_cap: int):
    """IQR-filtered means of the segments between consecutive peaks."""
    b, l = norm.shape
    n_ev = torch.clamp_max(n_peaks, e_cap)
    pos = torch.arange(l)[None, :]
    ind = torch.zeros((b, l + 1), dtype=torch.int32)
    tgt = torch.where(emit_ok, torch.clamp_max(emitted, l), l).to(torch.int64)
    ind.scatter_add_(1, tgt, torch.ones_like(tgt, dtype=torch.int32))
    seg = torch.cumsum(ind[:, :l], dim=1)
    invalid = (seg >= n_ev[:, None]) | (pos >= n_sig[:, None])
    seg = torch.where(invalid, e_cap, seg)
    key = (seg.to(torch.int64) << 32) | _sort_key(norm)
    key_s, order = torch.sort(key, dim=1)
    seg_s = key_s >> 32
    val_s = torch.gather(norm, 1, order)
    pk_sorted = torch.sort(torch.where(emit_ok, emitted, BIG_I32), dim=1).values[:, :e_cap]
    qs = torch.arange(e_cap)[None, :]
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
    keep_s = ((seg_s < e_cap) & (val_s >= torch.gather(lo, 1, seg_sc))
              & (val_s <= torch.gather(hi, 1, seg_sc)))
    psum = ordered_cumsum(torch.where(keep_s, val_s, 0.0), lead_zero=True)
    pcnt = torch.nn.functional.pad(torch.cumsum(keep_s.to(torch.int64), 1), (1, 0))
    ends = starts + lens
    sums = torch.gather(psum, 1, ends) - torch.gather(psum, 1, starts)
    counts = torch.gather(pcnt, 1, ends) - torch.gather(pcnt, 1, starts)
    events = torch.where(counts > 0, sums / torch.clamp_min(counts, 1).to(norm.dtype),
                         0.0)
    return torch.where(qs < n_ev[:, None], events, 0.0), n_ev


def detect_events(sig, slen, carry: NormCarry, o: dict, dtype=torch.float32):
    """Events of one chunk [B, L] (revent.c:257-316): (events f32 [B,
    e_cap], n_events i32 [B], the new carry)."""
    sig = sig.to(dtype)
    b, l = sig.shape
    valid = torch.arange(l)[None, :] < slen[:, None]
    sig_m = torch.where(valid, sig, 0.0)
    new_sum = carry.sum + ordered_sum(sig_m)
    new_sumsq = carry.sum_sq + ordered_sum(sig_m * sig_m)
    new_n = carry.n + slen
    nf = torch.clamp_min(new_n, 1).to(dtype)
    mean = new_sum / nf
    std = torch.sqrt(torch.clamp_min(fma(-mean, mean, new_sumsq / nf, dtype), 0.0))
    std = torch.where(std > 0, std, 1.0)
    norm = (sig - mean[:, None]) / std[:, None]
    clip = valid & (norm < 3.0) & (norm > -3.0)
    normc, n_sig = dense_compact(norm, clip)
    prefix = ordered_cumsum(normc, lead_zero=True)
    prefix_sq = ordered_cumsum(normc * normc, lead_zero=True)
    ts1 = _tstat(prefix, prefix_sq, n_sig, o["window_length1"], dtype)
    ts2 = _tstat(prefix, prefix_sq, n_sig, o["window_length2"], dtype)
    emitted = gen_peaks(ts1, ts2, n_sig, o["threshold1"], o["threshold2"],
                        o["window_length1"], o["window_length2"], o["peak_height"])
    ok = (emitted > 0) & (emitted < n_sig[:, None])
    n_peaks = ok.sum(dim=1, dtype=torch.int32)
    events, n_ev = _segment_events(normc, n_sig, emitted, ok, n_peaks, o["e_cap"])
    return (events.to(torch.float32), n_ev.to(torch.int32),
            NormCarry(new_sum, new_sumsq, new_n))
