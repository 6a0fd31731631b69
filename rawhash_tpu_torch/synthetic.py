"""Synthetic mapping workloads from a seed: genome, pore model, reads with
their true positions, and the preset's options.  Used by the tests and by
chip_smoke.py; the simulator is the reference package's (framework-free)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from rawhash_tpu.config import IndexOptions, MapOptions, set_preset
from rawhash_tpu.index.build import build_index_from_sequences
from rawhash_tpu.io.signal_gen import simulate_reads
from rawhash_tpu.io.sigfile import write_sig_npz
from rawhash_tpu.pore import synthetic_pore


def options(preset: str):
    """(IndexOptions, MapOptions) of a `-x` preset."""
    iopt, mopt = IndexOptions(), MapOptions()
    set_preset(preset, iopt, mopt)
    return iopt, mopt


def random_genome(length: int, rng: np.random.Generator) -> str:
    return "".join(rng.choice(list("ACGT"), size=length))


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
               max_anchors: int, seed: int, batch_reads: int = 256):
    """A genome of genome_len random bases from `seed`, its index under
    `preset`, and n_reads simulated reads: (index, mopt, reads) with reads
    as (name, signal, true start, strand)."""
    rng = np.random.default_rng(seed)
    genome = random_genome(genome_len, rng)
    pore = synthetic_pore(k=6)
    iopt, mopt = options(preset)
    mopt.batch_reads = batch_reads
    mopt.max_anchors_per_read = max_anchors
    index = build_index_from_sequences([("chr1", genome)], pore, iopt)
    reads = simulate_reads(genome, pore, n_reads=n_reads, read_len=read_len, rng=rng)
    return index, mopt, reads
