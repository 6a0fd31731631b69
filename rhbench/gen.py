"""The benchmark's traffic generator: random genomes, the synthetic pore
model and simulated raw-signal reads, made from a seed.

A frozen copy of the port's generator as it stood when the benchmark was
defined (rawhash_tpu_torch/synthetic.py::random_genome,
pore.py::synthetic_pore and seq_to_sig, io/signal_gen.py::simulate_read and
simulate_reads), so that a change to the port cannot move the traffic.
tests/test_rhbench_frozen.py holds each function equal to the port's at a
small size, so a later drift is seen.  The read pool of a cell
(`read_pool`) and the reads handed to the mapper (`handovers`) are built
from a traffic file's parameters only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")
COMPLEMENT_B = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
# A/a=0 C/c=1 G/g=2 T/t=3, everything else 4
SEQ_NT4 = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    SEQ_NT4[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    SEQ_NT4[_b] = _c


@dataclasses.dataclass
class PoreModel:
    """Z-normalized expected current level per k-mer (2-bit packed, first
    base in the most significant bits)."""

    k: int
    pore_vals: np.ndarray  # float32 [4**k]


def random_genome(length: int, rng: np.random.Generator) -> str:
    """`length` uniform random bases."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return bases[rng.integers(0, 4, length)].tobytes().decode()


def synthetic_pore(k: int = 6, seed: int = 42) -> PoreModel:
    """The deterministic synthetic pore model: per-base level contributions
    weighted towards the central bases, a small k-mer term, z-normalized."""
    rng = np.random.default_rng(seed)
    base_level = rng.normal(0.0, 1.0, size=(k, 4))
    w = np.exp(-0.5 * ((np.arange(k) - (k - 1) / 2.0) / (k / 4.0)) ** 2)
    codes = np.arange(4**k, dtype=np.uint64)
    vals = np.zeros(4**k, dtype=np.float64)
    for pos in range(k):
        shift = np.uint64(2 * (k - 1 - pos))
        b = ((codes >> shift) & np.uint64(3)).astype(np.int64)
        vals += w[pos] * base_level[pos, b]
    vals += rng.normal(0.0, 0.15, size=4**k)
    mean = vals.mean()
    std = np.sqrt((vals**2).mean() - mean * mean)
    return PoreModel(k=k, pore_vals=((vals - mean) / std).astype(np.float32))


def revcomp(seq):
    """Reverse complement of a str or bytes sequence."""
    if isinstance(seq, bytes):
        return seq.translate(COMPLEMENT_B)[::-1]
    return seq.translate(COMPLEMENT)[::-1]


def seq_to_sig(seq, pore: PoreModel, strand: int) -> np.ndarray:
    """Expected event levels of a sequence (RawHash2's ri_seq_to_sig): a
    rolling k-mer over the valid bases, one value for each position from
    k - 1 on; strand 1 walks the reverse complement.  f32 [len - k + 1]."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    n = arr.shape[0]
    k = pore.k
    if n < k:
        return np.zeros(0, dtype=np.float32)
    codes = SEQ_NT4[arr].astype(np.uint64)
    if strand:
        rev = codes[::-1]
        codes = np.where(rev < 4, rev ^ np.uint64(3), np.uint64(4))
    valid = codes < 4
    pushed = codes[valid]
    npush = pushed.shape[0]
    mask = np.uint64((1 << (2 * k)) - 1)
    padded = np.concatenate([np.zeros(k - 1, dtype=np.uint64), pushed])
    kmer_after = np.zeros(npush, dtype=np.uint64)
    for j in range(k):
        kmer_after |= padded[j : j + npush] << np.uint64(2 * (k - 1 - j))
    kmer_after &= mask
    cum = np.cumsum(valid)
    state = np.zeros(n, dtype=np.uint64)
    has = cum > 0
    state[has] = kmer_after[cum[has] - 1]
    return pore.pore_vals[state[k - 1 :].astype(np.int64)]


def simulate_read(genome: str, pore: PoreModel, start: int, length: int,
                  strand: int, rng: np.random.Generator,
                  samples_per_event: float = 9.0, pa_mean: float = 90.0,
                  pa_scale: float = 12.0, noise: float = 1.0) -> np.ndarray:
    """Raw current (f32 pA) of genome[start:start+length] on `strand`:
    each level dwells Poisson(samples_per_event) samples (at least 2), plus
    Gaussian noise."""
    span = genome[start : start + length]
    if strand:
        span = revcomp(span)
    levels = seq_to_sig(span, pore, 0)
    dwells = np.maximum(2, rng.poisson(samples_per_event, size=levels.shape[0]))
    sig = np.repeat(pa_mean + pa_scale * levels, dwells)
    sig = sig + rng.normal(0.0, noise, size=sig.shape[0])
    return sig.astype(np.float32)


def simulate_reads(genome: str, pore: PoreModel, n_reads: int, read_len: int,
                   rng: np.random.Generator, **kw):
    """[(name, signal, true start, strand)] at uniform random starts."""
    out = []
    for i in range(n_reads):
        start = int(rng.integers(0, max(1, len(genome) - read_len)))
        strand = int(rng.integers(0, 2))
        sig = simulate_read(genome, pore, start, read_len, strand, rng, **kw)
        out.append((f"sim_read_{i}", sig, start, strand))
    return out


@dataclasses.dataclass
class PoolRead:
    """A read of the pool: its signal and where it came from (on_target:
    from the indexed genome; start and strand on the genome it came from)."""

    signal: np.ndarray
    on_target: bool
    start: int
    strand: int
    length: int


def read_pool(genome: str, pore: PoreModel, traffic: dict, read_len: int,
              seed: int) -> list:
    """The traffic's read pool from `seed`: for each part of the mix,
    round(share x pool) reads, simulated from the indexed genome ("target")
    or from a random genome of its own that the index does not hold
    ("foreign"), of the part's read length ("config": the configuration's
    read_len); then shuffled.  Every seed gives the same counts and
    lengths."""
    n_pool = int(traffic["pool"])
    parts = traffic["mix"]
    counts = [int(round(p["share"] * n_pool)) for p in parts]
    counts[-1] = n_pool - sum(counts[:-1])
    rng = np.random.default_rng([seed, 0])
    pool = []
    for part, n in zip(parts, counts):
        length = read_len if part["read_len"] == "config" else int(part["read_len"])
        if part["genome"] == "target":
            src, on = genome, True
        else:
            src, on = random_genome(int(part["genome_len"]), rng), False
        for _, sig, start, strand in simulate_reads(src, pore, n, length, rng):
            pool.append(PoolRead(sig, on, start, strand, length))
    order = rng.permutation(len(pool))
    return [pool[i] for i in order]


def handovers(pool: list, batch_reads: int, max_offset: int, seed: int):
    """The reads handed to the mapper, batch by batch, for ever: the pool
    replayed in order, each handover cut at a seeded offset of 0 to
    max_offset samples from its front and given a fresh name, so no signal
    is handed over twice.  Yields (batch as [(name, signal)], the pool
    index of each read)."""
    rng = np.random.default_rng([seed, 1])
    n = 0
    while True:
        idx = [(n + j) % len(pool) for j in range(batch_reads)]
        cuts = rng.integers(0, max_offset + 1, batch_reads)
        batch = [(f"h{n + j}", pool[i].signal[int(c):])
                 for j, (i, c) in enumerate(zip(idx, cuts))]
        n += batch_reads
        yield batch, idx
