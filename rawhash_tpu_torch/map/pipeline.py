"""Index build or load, then mapping to PAF (port of
rawhash_tpu/map/pipeline.py::run_pipeline).  A thread reads and batches the
signal files ahead of the mapping (two batches queued); the engine keeps
--pipeline-depth batches in flight (map/engine.py) and hands the results
back in read order, which are written per read.  Sequence Until stops
reading once its abundance estimates converge (rmap.cpp:708-734);
--out-quantize prints quantized event streams instead of mapping.  No
thread that a run starts outlives it.

A mapping run with --n-shards joins a process group (torchrun's, or a world
of one) for its duration.  Every rank reads every read and maps each batch
together with the others (map/engine.py); only rank 0 writes the PAF, the
index dump and the log."""

from __future__ import annotations

import collections
import os
import queue
import sys
import threading
import time

from ..config import IndexFlag, MapFlag
from ..index.build import build_index_from_sequences, build_index_from_signals
from ..index.ref_ind import dump_ref_index, is_ref_index, load_ref_index
from ..index.serialize import is_index_file, load_index, save_index
from ..io.fasta import read_fasta
from ..io.paf import write_paf
from ..io.sigfile import find_signal_files, read_signals
from ..pore import load_pore
from ..signal.events_host import detect_events_np, normalize_signal_np
from ..sketch.host import diff_compact_indices
from ..sketch.quantize import dynamic_quantize_np
from ..utils.timers import resource_summary
from .engine import MappingEngine, unsupported_options
from .sequence_until import SequenceUntil


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


def _prefetch(gen, q: queue.Queue, stop: threading.Event) -> None:
    """Put each batch of `gen` on q, then None (or the exception that ended
    it), until stop is set; never blocks past stop."""
    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    try:
        for item in gen:
            if not put(item):
                return
        put(None)
    except Exception as e:  # handed to the mapping thread, which raises it
        put(e)
    finally:
        gen.close()


def _prefetched(q: queue.Queue, pending: collections.deque):
    """The batches the prefetch thread queues, each also appended to
    `pending` (the batches whose results are still to come)."""
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, Exception):
            raise item
        pending.append(item)
        yield item


def load_or_build_index(args, iopt, log, main: bool = True):
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
    if args.dump_index and main:
        if args.dump_index.endswith(".ind"):
            dump_ref_index(args.dump_index, index)
        else:
            save_index(args.dump_index, index)
        log(f"index dumped to {args.dump_index}")
    return index


def _output(args):
    """The -o file opened for writing, or stdout."""
    return open(args.output, "w") if args.output and args.output != "-" else sys.stdout


def run_pipeline(args, iopt, mopt, t0: float, device: str) -> int:
    if mopt.n_shards >= 1 and args.query and not iopt.flag & IndexFlag.OUT_QUANTIZE:
        import torch.distributed as dist

        from ..parallel.dist import init_process_group

        dev = init_process_group(device)
        try:
            return _run(args, iopt, mopt, t0, dev, main=dist.get_rank() == 0)
        finally:
            dist.destroy_process_group()
    return _run(args, iopt, mopt, t0, device, main=True)


def _run(args, iopt, mopt, t0: float, device, main: bool) -> int:
    """run_pipeline in one process; `main` (rank 0 of a sharded run) writes
    the output, the index dump and the log."""
    log = lambda msg: main and print(
        f"[M::rawhash-tpu-torch::{time.time()-t0:.3f}] {msg}", file=sys.stderr)
    unsupported = unsupported_options(mopt)
    if unsupported:
        print("[ERROR] not supported by the PyTorch engine yet: "
              + ", ".join(unsupported), file=sys.stderr)
        return 1
    if iopt.flag & IndexFlag.OUT_QUANTIZE:
        out = _output(args)
        try:
            _run_out_quantize(args, iopt, out)
        finally:
            if out is not sys.stdout:
                out.close()
        return 0
    try:
        index = load_or_build_index(args, iopt, log, main)
    except ValueError as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    if not args.query:
        if not args.dump_index and not is_index_file(args.target):
            log("no query files; only the index was constructed")
        return 0

    engine = MappingEngine(index, mopt, device=device, trace=args.profile)
    log(f"mid_occ = {mopt.mid_occ}; device = {engine.device}")
    su = None
    if mopt.flag & MapFlag.SEQUENCEUNTIL:
        su = SequenceUntil(index.n_seq, mopt.t_threshold, mopt.tn_samples,
                           mopt.ttest_freq, mopt.tmin_reads)
    out = _output(args) if main else open(os.devnull, "w")
    n_reads = n_mapped = total_samples = 0
    # reads are batched on a thread, two batches ahead; each result pairs
    # with its batch in order (pending)
    q = queue.Queue(maxsize=2)
    stop = threading.Event()
    gen = _batched_reads(args.query, mopt.batch_reads, mopt.mini_batch_size,
                         getattr(args, "io_thread", 1) or 1)
    reader = threading.Thread(target=_prefetch, args=(gen, q, stop),
                              name="rawhash-prefetch", daemon=True)
    reader.start()
    pending = collections.deque()
    stream = engine.map_stream(_prefetched(q, pending))
    try:
        for results in stream:
            batch = pending.popleft()
            done = False
            for (_, sig), res in zip(batch, results):
                write_paf([res], index, out)
                n_reads += 1
                total_samples += sig.shape[0]
                mapped = [m for m in res.records if m.mapped]
                if mapped:
                    n_mapped += 1
                    # Sequence Until watches each read's first mapping
                    if su is not None and su.observe(mapped[0].ref_id,
                                                     mapped[0].frag_len):
                        log("Sequence Until: estimates converged, stopping "
                            f"after {su.nreads} mapped reads")
                        done = True
                        break
            out.flush()
            if done:
                break
    finally:
        # stop reading, wait for the engine's chunks in flight, then let
        # the reader see the stop and join it
        stop.set()
        stream.close()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        reader.join(timeout=30.0)
        if out is not sys.stdout:
            out.close()

    dt = time.time() - t0
    if args.profile:
        depth = engine.pipeline_depth
        overlap = (f" (per batch; {depth} batches in flight overlap, so the "
                   "stages may sum past the wall time)" if depth > 1 else "")
        log(f"stage profile{overlap}: {engine.profiler.summary()}")
    log(resource_summary(t0))
    log(f"mapped {n_mapped}/{n_reads} reads, {total_samples} samples in "
        f"{dt:.2f}s ({total_samples/max(dt,1e-9):.0f} samples/s)")
    if engine.stats["hit_overflow"] or engine.stats["prev_overflow"]:
        log(f"capacity overflows: {engine.stats['hit_overflow']} seed hits, "
            f"{engine.stats['prev_overflow']} carried anchors dropped "
            "(raise --max-anchors to eliminate)")
    return 0


def _run_out_quantize(args, iopt, out) -> None:
    """Print quantized event streams (reference: --out-quantize,
    rsketch.c:179,192 + worker_sig_pipeline)."""
    for path in [args.target] + list(args.query):
        for f in find_signal_files(path):
            for name, sig in read_signals(f):
                if iopt.flag & IndexFlag.NO_EVENT_DETECTION:
                    events, _ = normalize_signal_np(sig, (0.0, 0.0, 0))
                else:
                    events, _ = detect_events_np(
                        sig, (0.0, 0.0, 0),
                        iopt.window_length1, iopt.window_length2,
                        iopt.threshold1, iopt.threshold2, iopt.peak_height,
                    )
                kept = diff_compact_indices(events, iopt.diff)
                codes = dynamic_quantize_np(
                    events[kept], iopt.fine_min, iopt.fine_max,
                    iopt.fine_range, 1 << iopt.q,
                ) & ((1 << iopt.q) - 1)
                out.write(name + "\n")
                out.write(",".join(str(int(c)) for c in codes) + "\n")
