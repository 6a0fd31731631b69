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

On CUDA tensors `detect_events_batch` is one call of three kernels
(`events_fused`: csrc/events_fused.cu around the peak detector of
csrc/events_peaks.cu), as the JAX package compiles the stage into one
program; on CPU tensors it is the plain version below, which the kernels
equal bit for bit.  The serial parts also have kernels of their own, each
the plain version's counterpart on CUDA tensors: the peak detector
(`_gen_peaks`, csrc/events_peaks.cu) and the ordered sums
(`ordered_cumsum`, `ordered_sum`, csrc/ordered_scan.cu); on CPU tensors
each runs its plain version (`*_plain`).  Each wrapper counts its kernel
launches (`fn.launches`); none reads a value back to the host.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from .._build import check_operand, kernel, load_library

FLT_MIN = float(np.finfo(np.float32).tiny)
FLT_MAX = float(np.finfo(np.float32).max)
BIG_I32 = 0x7FFFFFFF

# the wrappers' launch counters are added to from every thread that maps a
# batch
COUNT_LOCK = threading.Lock()
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


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


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The f32 square root rounded to nearest, as XLA (the JAX package),
    CUDA and the kernels compute it.  torch's f32 sqrt on the CPU is a vectorised
    approximation off by an ulp on ~0.7% of values (and exact on a
    tensor's scalar tail, so a row's result hung on its place in the
    batch); the f64 root rounds to the right f32 one, since the root of an
    f32 lies at least 2^-51 (relative) from a midpoint of two f32 values."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


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


def _cumsum_blocks(x: torch.Tensor) -> torch.Tensor:
    """The blocked prefix sum of ordered_cumsum_plain, without options."""
    b, n = x.shape
    if n <= 16:
        return _seq_scan(x) if n else x.clone()
    m = -(-n // 16) * 16
    xp = torch.nn.functional.pad(x, (0, m - n)).reshape(b, m // 16, 16)
    inner = _seq_scan(xp)
    tot = _cumsum_blocks(inner[:, :, -1].contiguous())
    excl = torch.nn.functional.pad(tot[:, :-1], (1, 0))
    return (inner + excl[:, :, None]).reshape(b, m)[:, :n]


def ordered_cumsum_plain(x: torch.Tensor, *, squares: bool = False,
                         lead_zero: bool = False):
    """Row-wise f32 inclusive prefix sum [B, L] in the reference's order:
    sequential sums inside blocks of 16, the block totals scanned the same
    way recursively, each block offset by the exclusive prefix of the
    totals (the blocked scan XLA's CPU backend emits for jnp.cumsum).
    lead_zero: [B, L + 1] with a 0 in front.  squares: the pair (of x, of
    x * x), each as the single call gives it."""
    if squares:
        return (ordered_cumsum_plain(x, lead_zero=lead_zero),
                ordered_cumsum_plain(x * x, lead_zero=lead_zero))
    out = _cumsum_blocks(x)
    return torch.nn.functional.pad(out, (1, 0)) if lead_zero else out


def ordered_sum_plain(x: torch.Tensor, *, squares: bool = False):
    """Row-wise f32 sum [B, L] -> [B] in the reference's order: while a row
    is longer than 32, pad it (half the padding in front) to a multiple of
    32 and replace it by the sequential sums of its 32-wide windows; then
    sum what is left sequentially (XLA's CPU tree reduction).  squares: the
    pair (of x, of x * x), each as the single call gives it."""
    if squares:
        return ordered_sum_plain(x), ordered_sum_plain(x * x)
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


# the kernels' C entries' argument types
_ARGTYPES = {
    "rh_ordered_prefix": [_P, _LL, _P, _P, _LL, _I, _I, _I, _P],
    "rh_ordered_sum": [_P, _LL, _P, _P, _I, _I, _P],
    "rh_events_peaks": [_P] * 4 + [_I] * 2 + [_F] * 3 + [_I] * 3 + [_P],
    "rh_diff_filter": [_P] * 3 + [_I] * 2 + [_F, _P],
    "rh_dtw_banded": [_P] * 9 + [_I] * 5 + [_P, _P],
    "rh_events_fused": [_P, _LL, _I] + [_P] * 10 + [_I] * 3 + [_F] * 3 + [_I] * 2 + [_P],
}


def launch_counted(fn, entry: str, dev: torch.device, *args, kernels: int = 1) -> None:
    """Launch `entry` (which starts `kernels` kernels) with args and dev's
    current stream; raise if the launch fails, else count its kernels on
    fn."""
    c_fn = kernel(entry, _ARGTYPES[entry])
    # the raw handle of dev's current stream (torch.cuda.current_stream's,
    # without building a Stream object: a few microseconds a call)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        rc = c_fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = c_fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {rc}")
    with COUNT_LOCK:
        fn.launches += kernels


def _check_rows(fn, x: torch.Tensor) -> None:
    """x must be f32 [B, L] with contiguous rows (any row stride)."""
    if x.dim() != 2:
        raise ValueError(f"{fn.__name__}: x must be 2-D, got {tuple(x.shape)}")
    check_operand(fn.__name__, "x", x, torch.float32, x.shape, x.device,
                  strided_rows=True)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn.__name__}: unsupported device {x.device}")


def ordered_cumsum(x: torch.Tensor, *, squares: bool = False,
                   lead_zero: bool = False):
    """`ordered_cumsum_plain` of f32 [B, L] (rows contiguous, any row
    stride), with its options: on CUDA tensors by the kernel
    rh_ordered_prefix (csrc/ordered_scan.cu), bit for bit, in one launch
    (a value and its square in one pass; the leading zero written by the
    kernel)."""
    _check_rows(ordered_cumsum, x)
    if x.device.type == "cpu":
        return ordered_cumsum_plain(x, squares=squares, lead_zero=lead_zero)
    b, l = x.shape
    lead = int(lead_zero)
    shape = (b, l + lead)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    out_sq = torch.empty(shape, dtype=torch.float32, device=x.device) if squares else None
    if b and l:
        launch_counted(ordered_cumsum, "rh_ordered_prefix", x.device, x.data_ptr(),
                x.stride(0), out.data_ptr(), out_sq.data_ptr() if squares else None,
                l + lead, lead, b, l)
    elif b and lead:  # no values: the leading zero alone
        out.zero_()
        if squares:
            out_sq.zero_()
    return (out, out_sq) if squares else out


def ordered_sum(x: torch.Tensor, *, squares: bool = False):
    """`ordered_sum_plain` of f32 [B, L] (rows contiguous, any row stride)
    -> [B], with its options: on CUDA tensors by the kernel rh_ordered_sum
    (csrc/ordered_scan.cu), bit for bit, in one launch (a value and its
    square in one pass)."""
    _check_rows(ordered_sum, x)
    if x.device.type == "cpu":
        return ordered_sum_plain(x, squares=squares)
    b, l = x.shape
    out = torch.empty(b, dtype=torch.float32, device=x.device)
    out_sq = torch.empty(b, dtype=torch.float32, device=x.device) if squares else None
    if b:
        launch_counted(ordered_sum, "rh_ordered_sum", x.device, x.data_ptr(), x.stride(0),
                out.data_ptr(), out_sq.data_ptr() if squares else None, b, l)
    return (out, out_sq) if squares else out


ordered_cumsum.launches = 0
ordered_sum.launches = 0


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
    t = torch.abs(mean2 - mean1) * (1.0 / sqrt_rn(var))
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


def _gen_peaks_plain(tstat1, tstat2, n_sig, t1: float, t2: float, w1: int,
                     w2: int, peak_height: float):
    """Step the dual-detector state machine over signal positions; returns
    emitted peak positions [B, 2L] in emission order (-1 = no emission).

    Positions past every row's n_sig change no state, so the loop stops at
    the longest row (read back to the host)."""
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


def _gen_peaks(tstat1, tstat2, n_sig, t1: float, t2: float, w1: int, w2: int,
               peak_height: float):
    """`_gen_peaks_plain` (tstat1, tstat2 f32 [B, L], n_sig i32 [B], all
    contiguous -> i32 [B, 2L]): on CUDA tensors by the kernel
    rh_events_peaks (csrc/events_peaks.cu), bit for bit, each row stepped
    to its own n_sig."""
    if tstat1.dim() != 2:
        raise ValueError(f"_gen_peaks: tstat1 must be 2-D, got {tuple(tstat1.shape)}")
    b, l = tstat1.shape
    dev = tstat1.device
    for name, t, dtype, shape in (("tstat1", tstat1, torch.float32, (b, l)),
                                  ("tstat2", tstat2, torch.float32, (b, l)),
                                  ("n_sig", n_sig, torch.int32, (b,))):
        check_operand("_gen_peaks", name, t, dtype, shape, dev)
    if dev.type == "cpu":
        return _gen_peaks_plain(tstat1, tstat2, n_sig, t1, t2, w1, w2, peak_height)
    if dev.type != "cuda":
        raise ValueError(f"_gen_peaks: unsupported device {dev}")
    out = torch.empty((b, 2 * l), dtype=torch.int32, device=dev)
    if b and l:
        launch_counted(_gen_peaks, "rh_events_peaks", dev, tstat1.data_ptr(),
                tstat2.data_ptr(), n_sig.data_ptr(), out.data_ptr(), b, l, f32(t1),
                f32(t2), f32(peak_height), w1, w1 // 2, w2 // 2)
    return out


_gen_peaks.launches = 0


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
    psum = ordered_cumsum(torch.where(keep_s, val_s, 0.0), lead_zero=True)
    pcnt = torch.nn.functional.pad(torch.cumsum(keep_s.to(torch.int64), 1), (1, 0))
    ends = starts + lens
    sums = torch.gather(psum, 1, ends) - torch.gather(psum, 1, starts)
    counts = torch.gather(pcnt, 1, ends) - torch.gather(pcnt, 1, starts)
    events = torch.where(
        counts > 0, sums / torch.clamp_min(counts, 1).to(torch.float32), 0.0
    )
    return torch.where(qs < n_ev[:, None], events, 0.0), n_ev


def takes_kernels(sig: torch.Tensor) -> bool:
    """Whether detect_events_batch runs the chunk sig [B, L] as the
    kernels (`events_fused`): a CUDA tensor with rows and samples."""
    return sig.device.type == "cuda" and sig.shape[0] > 0 and sig.shape[1] > 0


@functools.lru_cache(maxsize=None)
def fused_layout(b: int, l: int, e_cap: int) -> tuple:
    """(workspace bytes, wide) of `events_fused` on b rows of l samples and
    e_cap events: wide is 1 if its first row program stages a row in the
    workspace's global scratch (the row does not fit a block's shared
    memory), + 2 if the second does.  A function of the shape alone."""
    fn = load_library().rh_events_fused_workspace
    fn.restype = ctypes.c_longlong
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    wide = ctypes.c_int(0)
    return int(fn(b, l, e_cap, ctypes.byref(wide))), wide.value


def events_fused(sig, slen, carry: NormCarry, *, window_length1: int,
                 window_length2: int, threshold1: float, threshold2: float,
                 peak_height: float, e_cap: int):
    """`detect_events_batch` of CUDA tensors (sig f16 or f32 [B, L] with
    contiguous rows, L >= 1; slen, carry.n i32 [B]; carry.sum, carry.sum_sq
    f32 [B]) by the kernels of csrc/events_fused.cu, in one call that
    launches three kernels; the same outputs bit for bit as the plain
    version on the CPU.  Counts its calls (`events_fused.calls`) and those
    that staged a row in global memory (`events_fused.wide_calls`)."""
    b, l = sig.shape
    dev = sig.device
    if sig.dtype not in (torch.float16, torch.float32) or (l > 1 and sig.stride(1) != 1):
        raise ValueError(f"events_fused: sig must be f16 or f32 with contiguous rows, "
                         f"got {sig.dtype} strides {sig.stride()}")
    for name, t, dtype in (("slen", slen, torch.int32), ("carry.sum", carry.sum, torch.float32),
                           ("carry.sum_sq", carry.sum_sq, torch.float32),
                           ("carry.n", carry.n, torch.int32)):
        check_operand("events_fused", name, t, dtype, (b,), dev)
    f32t, i32t = torch.float32, torch.int32
    events = torch.empty((b, e_cap), dtype=f32t, device=dev)
    n_ev, new_n = (torch.empty(b, dtype=i32t, device=dev) for _ in range(2))
    new_sum, new_sumsq = (torch.empty(b, dtype=f32t, device=dev) for _ in range(2))
    ws_bytes, wide = fused_layout(b, l, e_cap)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    launch_counted(events_fused, "rh_events_fused", dev, sig.data_ptr(), sig.stride(0),
                   int(sig.dtype == torch.float16), slen.data_ptr(), carry.sum.data_ptr(),
                   carry.sum_sq.data_ptr(), carry.n.data_ptr(), events.data_ptr(),
                   n_ev.data_ptr(), new_sum.data_ptr(), new_sumsq.data_ptr(),
                   new_n.data_ptr(), ws.data_ptr(), b, l, e_cap, f32(threshold1),
                   f32(threshold2), f32(peak_height), window_length1, window_length2,
                   kernels=3)
    with COUNT_LOCK:
        events_fused.calls += 1
        events_fused.wide_calls += int(wide != 0)
    return events, n_ev, NormCarry(new_sum, new_sumsq, new_n)


# its kernels, its calls, and the calls that staged a row in global memory
events_fused.launches = events_fused.calls = events_fused.wide_calls = 0


def detect_events_batch(
    sig: torch.Tensor,  # f32 (or f16) [B, L] padded raw signal chunk
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
    """Batched detect_events (revent.c:257-316): on CUDA tensors by the
    kernels (`events_fused`), on CPU tensors by the plain version
    (`detect_events_batch_plain`), which they equal bit for bit.

    Returns (events f32 [B, e_cap], n_events i32 [B], new_carry)."""
    prm = dict(window_length1=window_length1, window_length2=window_length2,
               threshold1=threshold1, threshold2=threshold2,
               peak_height=peak_height, e_cap=e_cap)
    if takes_kernels(sig):
        return events_fused(sig, slen, carry, **prm)
    return detect_events_batch_plain(sig, slen, carry, **prm)


def detect_events_batch_plain(sig, slen, carry: NormCarry, *, window_length1: int,
                              window_length2: int, threshold1: float,
                              threshold2: float, peak_height: float, e_cap: int):
    """detect_events_batch in torch ops (f16 samples widened to f32 first);
    on CUDA tensors its sums and its detector are the kernels K5 and K6."""
    sig = sig.to(torch.float32)
    b, l = sig.shape
    pos = torch.arange(l, device=sig.device)[None, :]
    valid = pos < slen[:, None]
    sig_m = torch.where(valid, sig, 0.0)

    s, s_sq = ordered_sum(sig_m, squares=True)
    new_sum = carry.sum + s
    new_sumsq = carry.sum_sq + s_sq
    new_n = carry.n + slen
    nf = torch.clamp_min(new_n, 1).to(torch.float32)
    mean = new_sum / nf
    std = sqrt_rn(torch.clamp_min(fma(-mean, mean, new_sumsq / nf), 0.0))
    std = torch.where(std > 0, std, 1.0)
    norm = (sig - mean[:, None]) / std[:, None]
    clip = valid & (norm < 3.0) & (norm > -3.0)
    normc, n_sig = dense_compact(norm, clip)

    prefix, prefix_sq = ordered_cumsum(normc, squares=True, lead_zero=True)
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
