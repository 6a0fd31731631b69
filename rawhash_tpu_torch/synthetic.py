"""Synthetic mapping workloads from a seed: genome, pore model, reads with
their true positions, and the preset's options; all-vs-all overlap
workloads with their true pairs; chain-backtrack inputs; and raw signal
chunks and t-statistics for the event kernels.  Used by the tests and by
chip_smoke.py."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from .config import IndexFlag, IndexOptions, MapOptions, set_preset
from .index.build import build_index_from_sequences
from .io.sigfile import write_sig_npz
from .io.signal_gen import simulate_read, simulate_reads
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
               seconds: dict | None = None, store_sig: bool = False):
    """A genome of genome_len random bases from `seed`, its index under
    `preset` (with the expected signal stored, for DTW, if `store_sig`),
    and n_reads simulated reads: (index, mopt, reads) with reads as (name,
    signal, true start, strand).  `seconds`, if given, receives the wall
    time of each part (genome, index, reads)."""
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
    if store_sig:
        iopt.flag |= IndexFlag.STORE_SIG
    index = build_index_from_sequences([("chr1", genome)], pore, iopt)
    lap("index")
    reads = simulate_reads(genome, pore, n_reads=n_reads, read_len=read_len, rng=rng)
    lap("reads")
    return index, mopt, reads


def ava_fixture_reads():
    """tests/test_ava.py's all-vs-all fixture: 5 reads of 2000 bases from a
    6 kb genome (seed 11), read i starting at 800 i on the forward strand,
    as (name, signal)."""
    rng = np.random.default_rng(11)
    genome = random_genome(6000, rng)
    pore = synthetic_pore(k=6)
    return [(f"read_{i:02d}", simulate_read(genome, pore, i * 800, 2000, 0, rng))
            for i in range(5)]


def overlap_workload(n_reads: int, genome_len: int, read_len: int, seed: int,
                     min_ov: int = 450):
    """All-vs-all reads as bench.py's _ava_overlap_quality makes them: each
    read from a uniform start on a random strand of a random genome.
    Returns (reads as (name, signal), pairs that overlap at all, pairs that
    overlap by >= min_ov bases); a pair is (name, name) in name order."""
    rng = np.random.default_rng(seed)
    genome = random_genome(genome_len, rng)
    pore = synthetic_pore(k=6)
    reads, spans = [], []
    for i in range(n_reads):
        start = int(rng.integers(0, genome_len - read_len))
        strand = int(rng.integers(0, 2))
        reads.append((f"r{i:04d}", simulate_read(genome, pore, start, read_len,
                                                 strand, rng)))
        spans.append((start, start + read_len))
    truth_any, truth_sub = set(), set()
    for i in range(n_reads):
        for j in range(i + 1, n_reads):
            ov = min(spans[i][1], spans[j][1]) - max(spans[i][0], spans[j][0])
            if ov > 0:
                truth_any.add((reads[i][0], reads[j][0]))
            if ov >= min_ov:
                truth_sub.add((reads[i][0], reads[j][0]))
    return reads, truth_any, truth_sub


def overlap_quality(pred: set, truth_any: set, truth_sub: set):
    """(precision, recall) of predicted pairs as bench.py counts them: a
    pair is right if the reads overlap at all; recall is over the pairs
    that overlap by >= min_ov bases."""
    return (len(pred & truth_any) / max(len(pred), 1),
            len(pred & truth_sub) / max(len(truth_sub), 1))


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


def clustered_anchors(seed: int, b: int, n: int):
    """Fill inputs along one diagonal per strand from a seed: (key bits as
    int32, tpos, qpos, n_anchors) of b rows of n anchors, n/2 to n live,
    sorted by (unsigned key, tpos); each row is two long chain segments."""
    rng = np.random.default_rng(seed)
    tpos = np.sort(rng.integers(0, 4 * n, (b, n)), axis=1).astype(np.int32)
    qpos = (tpos // 2 + rng.integers(-20, 20, (b, n))).clip(0).astype(np.int32)
    key = np.sort(rng.integers(0, 2, (b, n)).astype(np.uint32) << 31, axis=1)
    n_anchors = rng.integers(n // 2, n + 1, b).astype(np.int32)
    return key.view(np.int32), tpos, qpos, n_anchors


def wide_band_anchors(seed: int, b: int, n: int, max_dist: int, stride: int):
    """Fill inputs from a seed whose anchors all lie within max_dist (at
    most a preset's max_dist_t and max_dist_q; the smaller, the less the
    gap penalty takes from a chain step) of each other on one strand: (key bits as uint32, tpos, qpos, n_anchors)
    of b rows of n anchors, n/2 to n live, each row one chain segment with
    every predecessor in band.  Every stride-th anchor lies on the diagonal,
    the rest at random query positions far off it, so a chain's next
    anchor is `stride` anchors back: a fill finds it only with a window W
    of at least `stride` (K1 past the shared-memory cap)."""
    rng = np.random.default_rng(seed)
    tpos = np.sort(rng.integers(0, max_dist, (b, n)), axis=1).astype(np.int32)
    diagonal = np.arange(n)[None, :] % stride == 0
    qpos = np.where(diagonal, tpos,
                    rng.integers(10**6, 2 * 10**6, (b, n))).astype(np.int32)
    key = np.zeros((b, n), np.uint32)
    key[b // 2:] = 1 << 31
    n_anchors = rng.integers(n // 2, n + 1, b).astype(np.int32)
    n_anchors[0] = n
    return key, tpos, qpos, n_anchors


def sparse_anchors(seed: int, b: int, n: int):
    """Fill inputs like D4's from a seed: (key bits as uint32, tpos, qpos,
    n_anchors) of b rows of n anchors, n/2 to n live, mostly lone hits
    spread over a 100 Mbp target (chain segments of one or a few anchors),
    plus one to three dense diagonal clusters of 8 to 200 anchors, each on
    one strand; sorted by (unsigned key, tpos)."""
    rng = np.random.default_rng(seed)
    key = np.empty((b, n), np.uint32)
    tpos = np.empty((b, n), np.int32)
    qpos = np.empty((b, n), np.int32)
    for r in range(b):
        sizes = rng.integers(8, min(n // 6, 200), rng.integers(1, 4))
        n_lone = n - int(sizes.sum())
        ks = [rng.integers(0, 2, n_lone)]
        ts = [rng.integers(0, 10**8, n_lone)]
        qs = [rng.integers(0, 3000, n_lone)]
        for size in sizes:
            step = rng.integers(1, 60, size)
            ks.append(np.full(size, rng.integers(0, 2)))
            ts.append(rng.integers(0, 10**8) + np.cumsum(step))
            qs.append(rng.integers(0, 1000) + np.cumsum(step + rng.integers(-3, 4, size)))
        k = np.concatenate(ks).astype(np.uint32) << 31
        t, q = np.concatenate(ts), np.concatenate(qs)
        order = np.lexsort((t, k))
        key[r], tpos[r], qpos[r] = k[order], t[order], q[order]
    n_anchors = rng.integers(n // 2, n + 1, b).astype(np.int32)
    n_anchors[0] = n
    return key, tpos, qpos, n_anchors


def border_anchors(max_dist_t: int, bw: int, n: int = 120, seed: int = 41):
    """Fill inputs at the chain segments' borders: 4 rows whose tpos gaps
    include exactly the clamped max_dist_t and one more, and 0 (duplicate
    tpos); n_anchors of n, 0, 1 and n - 7, the last live anchor of row 3
    on the other strand.  (key bits as uint32, tpos, qpos, n_anchors)."""
    mdt = max(max_dist_t, bw)
    rng = np.random.default_rng(seed)
    gaps = rng.choice(np.array([0, 1, 7, 40, mdt, mdt + 1]), size=(4, n),
                      p=[0.15, 0.2, 0.25, 0.2, 0.1, 0.1])
    gaps[:, 0] = 0
    tpos = np.cumsum(gaps, axis=1).astype(np.int32)
    qpos = (tpos + rng.integers(-3, 4, (4, n))).clip(0).astype(np.int32)
    key = np.zeros((4, n), np.uint32)
    key[3, n - 8:] = 1 << 31
    n_anchors = np.array([n, 0, 1, n - 7], np.int32)
    return key, tpos, qpos, n_anchors


def signal_chunk(rng: np.random.Generator, b: int, l: int) -> np.ndarray:
    """A nanopore-like f32 chunk [b, l] in pA: levels held ~9 samples plus
    noise, rounded to f16 as the engine ships signal, then widened."""
    levels = rng.normal(90.0, 12.0, size=(b, l // 9 + 1))
    sig = np.repeat(levels, 9, axis=1)[:, :l] + rng.normal(0, 1.0, (b, l))
    return sig.astype(np.float16).astype(np.float32)


def event_tstats(rng: np.random.Generator, b: int, l: int, n_sig: np.ndarray,
                 w1: int, w2: int):
    """The peak detector's inputs for nanopore-like z-normalised rows: the
    t-statistics (f32 [b, l]) over windows w1 and w2, valid up to each
    row's n_sig, as the events stage computes them (plain PyTorch on the
    CPU)."""
    import torch

    from .signal import events as ev

    levels = rng.normal(0.0, 1.0, size=(b, l // 9 + 2))
    x = np.repeat(levels, 9, axis=1)[:, :l] + rng.normal(0, 0.15, (b, l))
    norm = torch.from_numpy(x.astype(np.float32))
    prefix, prefix_sq = ev.ordered_cumsum_plain(norm, squares=True, lead_zero=True)
    ns = torch.from_numpy(np.minimum(n_sig, l).astype(np.int32))
    return (ev._tstat(prefix, prefix_sq, ns, w1).numpy(),
            ev._tstat(prefix, prefix_sq, ns, w2).numpy())


def peak_handoff_tstats():
    """t-statistics (f32 [4, 160]) and n_sig (i32 [4]) on which the peak
    detectors act across the 32-position tiles of the kernel at the viral
    preset's parameters (t1 4.0, t2 3.5, w1 3, w2 9, peak_height 0.4):
    row 0, the short detector enters a peak at 30 and masks the long one
    from 31 up to 30 + w1 = 33, in the next tile, over a long peak at
    28-40; row 1, the same long peak with no short peak; row 2, a long peak
    at 60-65 whose drop comes in the next tile (pending across 64); row 3,
    a short peak at 94-95 masking past 96 while a long peak sits at
    90-99."""
    l = 160
    ts1 = np.zeros((4, l), np.float32)
    ts2 = np.full((4, l), 0.5, np.float32)
    ts1[0, 30:32] = 9.0
    ts2[0:2, 28:41] = 6.0
    ts2[0:2, 34] = 7.0
    ts2[2, 60:63] = 6.5
    ts2[2, 63:66] = 6.4
    ts2[2, 66] = 1.0
    ts1[3, 94:96] = 8.0
    ts2[3, 90:100] = 5.0
    ts2[3, 95] = 5.5
    return ts1, ts2, np.full(4, l, np.int32)
