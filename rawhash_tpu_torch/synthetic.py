"""Synthetic mapping workloads from a seed: genome, pore model, reads with
their true positions, and the preset's options; and chain-backtrack inputs.
Used by the tests and by chip_smoke.py."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from .config import IndexOptions, MapOptions, set_preset
from .index.build import build_index_from_sequences
from .io.sigfile import write_sig_npz
from .io.signal_gen import simulate_reads
from .pore import synthetic_pore


def options(preset: str):
    """(IndexOptions, MapOptions) of a `-x` preset."""
    iopt, mopt = IndexOptions(), MapOptions()
    set_preset(preset, iopt, mopt)
    return iopt, mopt


def random_genome(length: int, rng: np.random.Generator) -> str:
    """`length` uniform random bases (the draws of
    rng.choice(list("ACGT"), length), made in bulk)."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    return bases[rng.integers(0, 4, length)].tobytes().decode()


def write_fixture(d: Path, genome_len: int = 8000, n_reads: int = 6,
                  read_len: int = 600, seed: int = 5) -> dict:
    """ref.fa, pore.model (k=6 synthetic levels) and reads.sig.npz in d.
    Returns {read name: (true start, strand)}."""
    d = Path(d)
    rng = np.random.default_rng(seed)
    genome = random_genome(genome_len, rng)
    (d / "ref.fa").write_text(f">chr1\n{genome}\n")
    pore = synthetic_pore(k=6)
    lines = ["kmer\tlevel_mean\tlevel_stdv"]
    for i, v in enumerate(pore.pore_vals):
        kmer = "".join("ACGT"[(i >> (2 * (5 - j))) & 3] for j in range(6))
        lines.append(f"{kmer}\t{90 + 12 * v:.4f}\t2.0")
    (d / "pore.model").write_text("\n".join(lines) + "\n")
    reads = simulate_reads(genome, pore, n_reads=n_reads, read_len=read_len, rng=rng)
    write_sig_npz(str(d / "reads.sig.npz"), [(n, s) for n, s, _, _ in reads])
    return {n: (start, strand) for n, _, start, strand in reads}


def deployment(genome_len: int, preset: str, n_reads: int, read_len: int,
               max_anchors: int, seed: int, batch_reads: int = 256,
               seconds: dict | None = None):
    """A genome of genome_len random bases from `seed`, its index under
    `preset`, and n_reads simulated reads: (index, mopt, reads) with reads
    as (name, signal, true start, strand).  `seconds`, if given, receives
    the wall time of each part (genome, index, reads)."""
    t = [time.perf_counter()]

    def lap(name):
        t.append(time.perf_counter())
        if seconds is not None:
            seconds[name] = t[-1] - t[-2]

    rng = np.random.default_rng(seed)
    genome = random_genome(genome_len, rng)
    lap("genome")
    pore = synthetic_pore(k=6)
    iopt, mopt = options(preset)
    mopt.batch_reads = batch_reads
    mopt.max_anchors_per_read = max_anchors
    index = build_index_from_sequences([("chr1", genome)], pore, iopt)
    lap("index")
    reads = simulate_reads(genome, pore, n_reads=n_reads, read_len=read_len, rng=rng)
    lap("reads")
    return index, mopt, reads


def random_chains(seed: int, b: int, n: int, n_heads: int, min_sc: int = 20):
    """Chain-backtrack inputs from a seed: (f, p, n_anchors, tpos, qpos) of b
    rows of n anchors, with p[i] < i as a fill leaves it, n_heads chain
    candidates (f >= min_sc) among the top anchors and short predecessor
    chains, so the plain lockstep backtrack stays quick at wide widths."""
    rng = np.random.default_rng(seed)
    p = np.arange(n)[None, :] - rng.integers(1, 40, (b, n))
    p[rng.random((b, n)) < 0.05] = -1
    p = np.maximum(p, -1).astype(np.int32)
    f = rng.integers(0, min_sc, (b, n)).astype(np.int32)
    lo = max(0, n - 10 * n_heads)
    for r in range(b):
        heads = rng.choice(np.arange(lo, n), n_heads, replace=False)
        f[r, heads] = rng.integers(min_sc, 700, n_heads)
    tpos = np.sort(rng.integers(0, 8 * n, (b, n)), axis=1).astype(np.int32)
    qpos = (tpos // 2 + rng.integers(-30, 30, (b, n))).clip(0).astype(np.int32)
    n_anchors = np.full(b, n, np.int32)
    n_anchors[-1] = n - 7
    return f, p, n_anchors, tpos, qpos
