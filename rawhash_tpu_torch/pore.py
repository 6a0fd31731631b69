"""Pore (k-mer) model: loading, normalization, and sequence->expected-signal.

Capabilities mirrored from the reference:
  * load_pore          (reference: src/rutils.c:133-178)
  * value z-normalization + sorted (value, index, revcomp-index) pairs
                       (reference: create_sorted_pairs, src/rutils.c:91-115)
  * seq -> expected signal, forward and reverse-complement
                       (reference: ri_seq_to_sig, src/rsig.c:13-40)

The sequence->signal conversion is vectorized (numpy) instead of the
reference's per-base scalar loop; ambiguous bases leave the rolling k-mer
state unchanged, exactly like the reference.
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io

import numpy as np

# Base encoding identical to seq_nt4_table (reference: src/rutils.c:9-20):
# A/a=0 C/c=1 G/g=2 T/t=3, everything else 4 (ambiguous).
SEQ_NT4 = np.full(256, 4, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    SEQ_NT4[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    SEQ_NT4[_b] = _c


@dataclasses.dataclass
class PoreModel:
    """Z-normalized expected current level per k-mer.

    pore_vals[i] = normalized level of the k-mer whose 2-bit encoding is i
    (A=0 C=1 G=2 T=3, first base in the most significant bits).
    """

    k: int
    pore_vals: np.ndarray  # float32 [4**k]

    @property
    def n_pore_vals(self) -> int:
        return self.pore_vals.shape[0]

    def sorted_pairs(self):
        """(value, index, revcomp index) triples sorted by value
        (reference: create_sorted_pairs, src/rutils.c:91-115)."""
        idx = np.arange(self.n_pore_vals, dtype=np.uint32)
        rev = revcomp_kmer_codes(idx, self.k)
        order = np.argsort(self.pore_vals, kind="stable")
        return self.pore_vals[order], idx[order], rev[order]


def revcomp_kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of 2-bit packed k-mer codes
    (reference: rev_complement, src/rutils.c:77-84)."""
    x = codes.astype(np.uint64)
    y = np.zeros_like(x)
    for _ in range(k):
        y = (y << np.uint64(2)) | ((x & np.uint64(3)) ^ np.uint64(3))
        x = x >> np.uint64(2)
    return y.astype(np.uint32)


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return _io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def load_pore(path: str, k: int, lev_col: int = 1) -> PoreModel:
    """Load a k-mer model file (TSV with a `kmer` header line, level means in
    column `lev_col`), then z-normalize the levels over the whole table
    (reference: load_pore, src/rutils.c:133-178).

    Rows are assumed to be in lexicographic k-mer order (ACGT alphabet), as in
    the standard ONT model files the reference consumes.
    """
    vals = np.zeros(4**k, dtype=np.float64)
    i = 0
    with _open_text(path) as fp:
        for line in fp:
            if line.startswith("kmer"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) <= lev_col:
                continue
            vals[i] = float(parts[lev_col])
            i += 1
    if i == 0:
        raise ValueError(f"no k-mer rows parsed from {path}")
    mean = vals[:i].sum() / i
    std = np.sqrt((vals[:i] ** 2).sum() / i - mean * mean)
    vals[:i] = (vals[:i] - mean) / std
    return PoreModel(k=k, pore_vals=vals.astype(np.float32))


def synthetic_pore(k: int = 6, seed: int = 42) -> PoreModel:
    """Deterministic synthetic pore model for tests/benchmarks.

    Physically-flavoured: each k-mer level is a weighted sum of per-base
    contributions (central bases dominate, as in real pores) plus a small
    k-mer-specific pseudo-random term, then z-normalized like load_pore does.
    """
    rng = np.random.default_rng(seed)
    base_level = rng.normal(0.0, 1.0, size=(k, 4))
    # central positions contribute the most
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


def seq_to_sig(seq: bytes | str, pore: PoreModel, strand: int) -> np.ndarray:
    """Expected event-level signal of a DNA sequence.

    Vectorized re-implementation of the reference's rolling-k-mer loop
    (reference: ri_seq_to_sig, src/rsig.c:13-40):

      * strand 0: walk the sequence forward, k-mer = (kmer<<2 | code) & mask
      * strand 1: walk the sequence backward, k-mer = (kmer<<2 | code^3) & mask
        (i.e. the expected signal of the reverse-complement in forward order)
      * ambiguous bases do not update the k-mer state
      * one value is emitted for every position i >= k-1 (so len-k+1 values),
        using whatever the k-mer state is at that point

    Returns float32 [len(seq) - k + 1] (empty if shorter than k).
    """
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

    # Rolling k-mer over the *pushed* stream (valid bases only), then mapped
    # back to per-position state via the cumulative count of valid bases.
    pushed = codes[valid]
    npush = pushed.shape[0]
    mask = np.uint64((1 << (2 * k)) - 1)
    # kmer_after_t = 2-bit pack of pushed[t-k+1 .. t] (zeros before start)
    padded = np.concatenate([np.zeros(k - 1, dtype=np.uint64), pushed])
    kmer_after = np.zeros(npush, dtype=np.uint64)
    for j in range(k):
        kmer_after |= padded[j : j + npush] << np.uint64(2 * (k - 1 - j))
    kmer_after &= mask

    # state index per position: number of pushes made up to and including i
    cum = np.cumsum(valid)
    # kmer state at position i = kmer_after[cum[i]-1] (0 if no push yet)
    state = np.zeros(n, dtype=np.uint64)
    has = cum > 0
    state[has] = kmer_after[cum[has] - 1]
    return pore.pore_vals[state[k - 1 :].astype(np.int64)]
