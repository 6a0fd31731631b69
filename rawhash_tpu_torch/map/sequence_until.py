"""Sequence Until: stop sequencing when relative-abundance estimates converge.

Port of the reference mechanism (reference: sequence_until.c:4-18 +
rmap.cpp:708-734): running per-target abundance estimates from mapped
fragment lengths; every `ttest_freq` mapped reads (after `tmin_reads`), the
last `tn_samples` estimate vectors are compared and sequencing stops when the
maximum pairwise-outlier distance drops to <= t_threshold.
"""

from __future__ import annotations

import numpy as np


def find_outlier(x: np.ndarray) -> float:
    """Max squared-distance greedy outlier sweep
    (reference: find_outlier, sequence_until.c:4-18).
    x: [m, n] matrix of m estimate vectors."""
    m = x.shape[0]
    outlier = 0
    max_dist = 0.0
    for i in range(m):
        dist = float(np.sum((x[i] - x[outlier]) ** 2))
        if dist > max_dist:
            max_dist = dist
            outlier = i
    return max_dist


class SequenceUntil:
    """Tracks abundance estimates across mapped reads
    (reference: pipeline state in rmap.h:46-67 + rmap.cpp:708-734)."""

    def __init__(self, n_seq: int, t_threshold: float, tn_samples: int,
                 ttest_freq: int, tmin_reads: int):
        self.n_seq = n_seq
        self.t_threshold = t_threshold
        self.tn_samples = tn_samples
        self.ttest_freq = ttest_freq
        self.tmin_reads = tmin_reads
        self.c_estimations = np.zeros(n_seq, dtype=np.float64)
        self.ab_count = 0
        self.nreads = 0
        self.nestimations = 0
        self.cur = 0
        self.estimations = np.zeros((tn_samples, n_seq), dtype=np.float32)
        self.stopped = False

    def observe(self, ref_id: int, fragment_length: int) -> bool:
        """Feed one mapped read; returns True when sequencing should stop."""
        if self.stopped or ref_id >= self.n_seq:
            return self.stopped
        self.c_estimations[ref_id] += fragment_length
        self.ab_count += fragment_length
        self.nreads += 1
        if self.nreads > self.tmin_reads and self.nreads % self.ttest_freq == 0:
            if self.ab_count > 0:
                self.estimations[self.cur] = self.c_estimations / self.ab_count
            self.cur = (self.cur + 1) % self.tn_samples
            self.nestimations += 1
            if self.nestimations >= self.tn_samples:
                if find_outlier(self.estimations) <= self.t_threshold:
                    self.stopped = True
        return self.stopped

    def abundances(self) -> np.ndarray:
        if self.ab_count == 0:
            return np.zeros(self.n_seq, dtype=np.float32)
        return (self.c_estimations / self.ab_count).astype(np.float32)
