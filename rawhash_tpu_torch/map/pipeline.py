"""Index build or load, then mapping to PAF (port of
rawhash_tpu/map/pipeline.py::run_pipeline, serial: batches of reads are
mapped one after another on the calling thread)."""

from __future__ import annotations

import sys
import time

from ..config import IndexFlag
from ..index.build import build_index_from_sequences, build_index_from_signals
from ..index.ref_ind import dump_ref_index, is_ref_index, load_ref_index
from ..index.serialize import is_index_file, load_index, save_index
from ..io.fasta import read_fasta
from ..io.paf import write_paf
from ..io.sigfile import find_signal_files, read_signals
from ..pore import load_pore
from ..utils.timers import resource_summary
from .engine import MappingEngine, unsupported_options


def _read_all(path):
    return list(read_signals(path))


def parallel_file_reads(files, n_threads: int):
    """Decode signal containers with a worker pool (the reference decodes
    under opt->n_io_threads; rsig.c:192-194, main.cpp:414).  Up to
    2*n_threads files are in flight; results are yielded strictly in file
    order so the stream is identical to a 1-thread run.

    Memory trade-off: each in-flight file is fully decoded into memory, so
    --io-thread changes residency from O(one batch) to O(2*n_threads x file
    size).  That suits the reference datasets' many-small-files layout
    (FAST5 dirs at ~4k reads/file); for a few huge BLOW5 files, prefer
    --io-thread 1 (streaming, O(batch) memory).  Unlike the reference's
    slow5_init_mt, parallelism here is across files, not within one file, so
    a single large file sees no decode speedup."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        inflight = collections.deque()
        it = iter(files)
        for f in it:
            inflight.append(ex.submit(_read_all, f))
            if len(inflight) >= 2 * n_threads:
                break
        while inflight:
            yield from inflight.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                inflight.append(ex.submit(_read_all, nxt))


def _batched_reads(paths, batch_size: int, mini_batch_bytes: int,
                   n_io_threads: int = 1):
    """Yield lists of (name, signal) with at most batch_size reads."""
    files = [f for path in paths for f in find_signal_files(path)]
    if n_io_threads > 1 and len(files) > 1:
        reads_iter = parallel_file_reads(files, n_io_threads)
    else:
        reads_iter = (r for f in files for r in read_signals(f))
    batch = []
    for name, sig in reads_iter:
        batch.append((name, sig))
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


def load_or_build_index(args, iopt, log):
    """The target as an index: loaded from a .rhi.npz or reference .ind
    file, or built from a FASTA (with -p) or from signals (--sig-target)."""
    if is_index_file(args.target):
        index = load_index(args.target)
        log(f"loaded index: {index.n_seq} target(s), {index.n_seeds} seeds")
        return index
    if is_ref_index(args.target):
        index = load_ref_index(args.target)
        log(f"loaded reference .ind index: {index.n_seq} target(s), "
            f"{index.n_seeds} seeds")
        return index
    pore = load_pore(args.pore_file, iopt.k, iopt.lev_col) if args.pore_file else None
    if iopt.flag & IndexFlag.SIG_TARGET:
        reads = [r for f in find_signal_files(args.target) for r in read_signals(f)]
        index = build_index_from_signals(reads, pore, iopt)
    else:
        if pore is None:
            raise ValueError("a pore model (-p) is required to index a sequence file")
        index = build_index_from_sequences(read_fasta(args.target), pore, iopt)
    log(f"built index: {index.n_seq} target(s), {index.n_seeds} seeds")
    if args.dump_index:
        if args.dump_index.endswith(".ind"):
            dump_ref_index(args.dump_index, index)
        else:
            save_index(args.dump_index, index)
        log(f"index dumped to {args.dump_index}")
    return index


def run_pipeline(args, iopt, mopt, t0: float, device: str) -> int:
    log = lambda msg: print(f"[M::rawhash-tpu-torch::{time.time()-t0:.3f}] {msg}",
                            file=sys.stderr)
    unsupported = unsupported_options(mopt)
    if iopt.flag & IndexFlag.OUT_QUANTIZE:
        unsupported.append("--out-quantize")
    if unsupported:
        print("[ERROR] not supported by the PyTorch engine yet: "
              + ", ".join(unsupported), file=sys.stderr)
        return 1
    try:
        index = load_or_build_index(args, iopt, log)
    except ValueError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    if not args.query:
        if not args.dump_index and not is_index_file(args.target):
            log("no query files; only the index was constructed")
        return 0

    engine = MappingEngine(index, mopt, device=device)
    log(f"mid_occ = {mopt.mid_occ}; device = {engine.device}")
    out = sys.stdout
    if args.output and args.output != "-":
        out = open(args.output, "w")
    n_reads = n_mapped = total_samples = 0
    try:
        for batch in _batched_reads(args.query, mopt.batch_reads,
                                    mopt.mini_batch_size,
                                    getattr(args, "io_thread", 1) or 1):
            results = engine.map_batch(batch)
            write_paf(results, index, out)
            out.flush()
            n_reads += len(batch)
            total_samples += sum(sig.shape[0] for _, sig in batch)
            n_mapped += sum(any(m.mapped for m in r.records) for r in results)
    finally:
        if out is not sys.stdout:
            out.close()

    dt = time.time() - t0
    log(f"stage profile: {engine.profiler.summary()}")
    log(resource_summary(t0))
    log(f"mapped {n_mapped}/{n_reads} reads, {total_samples} samples in "
        f"{dt:.2f}s ({total_samples/max(dt,1e-9):.0f} samples/s)")
    if engine.stats["hit_overflow"] or engine.stats["prev_overflow"]:
        log(f"capacity overflows: {engine.stats['hit_overflow']} seed hits, "
            f"{engine.stats['prev_overflow']} carried anchors dropped "
            "(raise --max-anchors to eliminate)")
    return 0
