"""Synthetic nanopore-signal generator for tests and benchmarks.

Simulates the physics the pipeline assumes: a read is a genome span converted
to expected event levels through the pore model (pore.seq_to_sig — the same
transform the indexer uses, reference: ri_seq_to_sig, rsig.c:13-40), each
event dwelling ~sample_rate/bp_per_sec samples, scaled to a pA-like range and
perturbed with Gaussian noise.  No reference code models reads (it consumes
real FAST5s); this generator exists so the engine can be exercised and
benchmarked hermetically.
"""

from __future__ import annotations

import numpy as np

from ..pore import PoreModel, seq_to_sig

COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")
COMPLEMENT_B = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def revcomp(seq):
    """Reverse complement (str or bytes — Gbp-scale genomes ride as bytes)."""
    if isinstance(seq, bytes):
        return seq.translate(COMPLEMENT_B)[::-1]
    return seq.translate(COMPLEMENT)[::-1]


def simulate_read(
    genome: str,
    pore: PoreModel,
    start: int,
    length: int,
    strand: int,
    rng: np.random.Generator,
    samples_per_event: float = 9.0,
    pa_mean: float = 90.0,
    pa_scale: float = 12.0,
    noise: float = 1.0,
) -> np.ndarray:
    """Raw-current read (float32 pA) for genome[start:start+length]."""
    span = genome[start : start + length]
    if strand:
        span = revcomp(span)
    levels = seq_to_sig(span, pore, 0)
    dwells = np.maximum(2, rng.poisson(samples_per_event, size=levels.shape[0]))
    sig = np.repeat(pa_mean + pa_scale * levels, dwells)
    sig = sig + rng.normal(0.0, noise, size=sig.shape[0])
    return sig.astype(np.float32)


def simulate_reads(
    genome: str,
    pore: PoreModel,
    n_reads: int,
    read_len: int,
    rng: np.random.Generator,
    **kw,
):
    """[(name, signal, true_start, strand)] with uniform random positions."""
    out = []
    for i in range(n_reads):
        start = int(rng.integers(0, max(1, len(genome) - read_len)))
        strand = int(rng.integers(0, 2))
        sig = simulate_read(genome, pore, start, read_len, strand, rng, **kw)
        out.append((f"sim_read_{i}", sig, start, strand))
    return out
