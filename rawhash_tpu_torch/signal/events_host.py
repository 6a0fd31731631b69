"""Host (numpy) event detection oracle.

Near-literal port of the reference segmentation chain
(reference: src/revent.c — normalize_signal:221-255, comp_prefix_prefixsq:
23-36, comp_tstat:38-74, gen_peaks:91-150, calculate_mean_of_filtered_segment:
158-180, gen_events:193-219, detect_events:257-316), used to validate the
batched device kernel and as a scalar fallback.

One deliberate deviation: emitted peak positions are sorted ascending before
segmentation.  The reference consumes peaks in emission order, which is almost
always ascending; when the two detectors emit out of order it would compute a
negative-length segment (undefined behaviour in C).  Sorting defines that
corner case while leaving the common case bit-identical.
"""

from __future__ import annotations

import numpy as np

FLT_MIN = np.float32(1.1754943508222875e-38)
FLT_MAX = np.float32(3.4028234663852886e38)


def normalize_signal_np(sig: np.ndarray, carry: tuple[float, float, int]):
    """Streaming z-normalization with running (sum, sum_sq, n) carried across
    chunks; keeps only samples with |z| < 3 (reference: revent.c:221-255)."""
    sig = np.asarray(sig, dtype=np.float32)
    s, s2, n = carry
    s = s + float(np.sum(sig, dtype=np.float64))
    s2 = s2 + float(np.sum(sig.astype(np.float64) ** 2))
    n = n + sig.shape[0]
    mean = s / n
    std = np.sqrt(s2 / n - mean * mean)
    norm = ((sig - np.float32(mean)) / np.float32(std)).astype(np.float32)
    kept = norm[(norm < 3) & (norm > -3)]
    return kept, (s, s2, n)


def comp_tstat_np(prefix: np.ndarray, prefix_sq: np.ndarray, s_len: int, w: int):
    """Two-window Student t-statistic (reference: revent.c:38-74)."""
    tstat = np.zeros(s_len + 1, dtype=np.float32)
    if s_len < 2 * w or w < 2:
        return tstat
    i = np.arange(w, s_len - w + 1)
    sum1 = prefix[i] - np.where(i > w, prefix[i - w], 0.0).astype(np.float32)
    sumsq1 = prefix_sq[i] - np.where(i > w, prefix_sq[i - w], 0.0).astype(np.float32)
    sum2 = prefix[i + w] - prefix[i]
    sumsq2 = prefix_sq[i + w] - prefix_sq[i]
    mean1 = sum1 / np.float32(w)
    mean2 = sum2 / np.float32(w)
    combined_var = (
        sumsq1 / np.float32(w) - mean1 * mean1 + sumsq2 / np.float32(w) - mean2 * mean2
    ) / np.float32(w)
    combined_var = np.maximum(combined_var, FLT_MIN)
    tstat[i] = np.abs(mean2 - mean1) / np.sqrt(combined_var)
    # fudge boundaries: zero out the trailing window (reference: revent.c:71)
    tstat[s_len - w + 1 :] = 0.0
    return tstat


class _Detector:
    __slots__ = ("sig", "threshold", "window_length", "masked_to", "peak_pos",
                 "peak_value", "valid_peak")

    def __init__(self, sig, threshold, window_length):
        self.sig = sig
        self.threshold = np.float32(threshold)
        self.window_length = int(window_length)
        self.masked_to = 0
        self.peak_pos = -1
        self.peak_value = FLT_MAX
        self.valid_peak = 0


def gen_peaks_np(tstat1, tstat2, s_len, t1, t2, w1, w2, peak_height):
    """Dual peak detector state machine (reference: gen_peaks, revent.c:91-150).
    The short detector masks the long one while it holds an above-threshold
    peak."""
    peak_height = np.float32(peak_height)
    dets = [_Detector(tstat1, t1, w1), _Detector(tstat2, t2, w2)]
    peaks = []
    for i in range(s_len):
        for k, det in enumerate(dets):
            if det.masked_to >= i:
                continue
            cur = det.sig[i]
            if det.peak_pos == -1:
                if cur < det.peak_value:
                    det.peak_value = cur
                elif cur - det.peak_value > peak_height:
                    det.peak_value = cur
                    det.peak_pos = i
            else:
                if cur > det.peak_value:
                    det.peak_value = cur
                    det.peak_pos = i
                if det.peak_value > det.threshold:
                    for later in dets[k + 1 :]:
                        later.masked_to = det.peak_pos + dets[0].window_length
                        later.peak_pos = -1
                        later.peak_value = FLT_MAX
                        later.valid_peak = 0
                if (
                    det.peak_value - cur > peak_height
                    and det.peak_value > det.threshold
                ):
                    det.valid_peak = 1
                if det.valid_peak and (i - det.peak_pos) > det.window_length // 2:
                    peaks.append(det.peak_pos)
                    det.peak_pos = -1
                    det.peak_value = cur
                    det.valid_peak = 0
    return np.asarray(peaks, dtype=np.int64)


def iqr_filtered_mean_np(segment: np.ndarray) -> float:
    """Mean of values within [q1-iqr, q3+iqr]
    (reference: calculate_mean_of_filtered_segment, revent.c:158-180)."""
    n = segment.shape[0]
    if n == 0:
        return 0.0
    seg = np.sort(segment)
    q1 = seg[n // 4]
    q3 = seg[(3 * n) // 4]
    iqr = q3 - q1
    lo, hi = q1 - iqr, q3 + iqr
    kept = seg[(seg >= lo) & (seg <= hi)]
    if kept.shape[0] == 0:
        return 0.0
    return float(np.float32(np.sum(kept, dtype=np.float64)) / np.float32(kept.shape[0]))


def detect_events_np(
    sig: np.ndarray,
    carry: tuple[float, float, int],
    window_length1: int = 3,
    window_length2: int = 9,
    threshold1: float = 4.0,
    threshold2: float = 3.5,
    peak_height: float = 0.4,
):
    """Full chunk event detection (reference: detect_events, revent.c:257-316).

    Returns (events float32[n_ev], new_carry)."""
    norm, carry = normalize_signal_np(sig, carry)
    n_sig = norm.shape[0]
    if n_sig == 0:
        return np.zeros(0, dtype=np.float32), carry
    prefix = np.zeros(n_sig + 1, dtype=np.float32)
    prefix_sq = np.zeros(n_sig + 1, dtype=np.float32)
    np.cumsum(norm, dtype=np.float32, out=prefix[1:])
    np.cumsum(norm * norm, dtype=np.float32, out=prefix_sq[1:])
    tstat1 = comp_tstat_np(prefix, prefix_sq, n_sig, window_length1)
    tstat2 = comp_tstat_np(prefix, prefix_sq, n_sig, window_length2)
    peaks = gen_peaks_np(
        tstat1, tstat2, n_sig, threshold1, threshold2,
        window_length1, window_length2, peak_height,
    )
    peaks = np.sort(peaks[(peaks > 0) & (peaks < n_sig)], kind="stable")
    events = np.zeros(peaks.shape[0], dtype=np.float32)
    start = 0
    for j, p in enumerate(peaks):
        events[j] = iqr_filtered_mean_np(norm[start:p])
        start = int(p)
    return events, carry
