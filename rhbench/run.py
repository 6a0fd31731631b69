"""One run of one cell of the benchmark of rawhash_tpu_torch, the PyTorch
and CUDA port of rawhash-tpu, on the card it is started on:

    python3 rhbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m rhbench.run ...`) from the root of a checkout.  It makes
the cell's genome, the port's index of it and a pool of simulated reads
from the seed, warms the engine up, then hands batches of reads to
`MappingEngine.map_stream` in a closed loop for `--seconds` (the batches in
flight when the window closes are waited for and counted).  With --trace 1
the window runs under torch.profiler and the per-layer metrics are read;
with --trace 0 the end-to-end ones.  Then a sample of the window's reads,
drawn from the seed, is mapped again by the plain reference
(rhbench/reference) and every record compared.  The last line of standard
output is the result as one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error.

It exits with an error and prints no result without a CUDA card, with
fewer cards than the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    __package__ = "rhbench"  # noqa: A001

import numpy as np  # noqa: E402

from rhbench import gen, spec  # noqa: E402

# reads of the window the reference maps again (the read with the most
# chunks among them)
CHECK_READS = 64
# the limits of the comparison (PERF.md gives the readings they were set
# from): the share of the sampled reads whose records differ from the
# reference's, and reads handed over whose result never came
LIMITS = {"records_differ_share": 0.02, "results_missing": 0}
BANNED = ("jax", "jaxlib", "flax", "rawhash_tpu")


def banned_modules() -> list:
    """Modules loaded in this process whose top-level name is one of
    BANNED, compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


def card_info() -> dict:
    """The card's name and power limit (nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
        name, limit = (s.strip() for s in out.split(","))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": "unknown", "power_limit": "unknown"}


def _ci(record) -> int:
    """The chunks a read consumed: its record's `ci` tag."""
    tags = record.tags
    k = tags.index("ci:i:") + 5
    e = tags.find("\t", k)
    return int(tags[k:] if e < 0 else tags[k:e])


class Window:
    """The closed loop and its record.  A batch arrives when the engine
    takes it; the window hands over batches until it closes, then waits for
    those in flight.  It keeps, a batch at a time, the arrival and return
    times and the reads' chunks; of the results only a reservoir of
    `keep` reads drawn from the seed (Algorithm R, uniform over the
    window's reads) and the first read with the most chunks.  Nothing else
    of a batch outlives its return, so the heap, and the collector's work
    on it, does not grow over the window."""

    def __init__(self, stream, seconds: float, marks: bool, seed: int, keep: int):
        self.stream = stream
        self.seconds = seconds
        self.marks = marks
        self.keep = keep
        self.rng = np.random.default_rng([seed, 3])
        self.inflight = collections.deque()  # (batch, pool indices) taken
        self.arrived = []  # the time each batch was taken
        self.returned = []  # the time its results came back
        self.sizes = []  # its reads
        self.chunks = []  # the sum of its reads' ci
        self.mapped = 0
        self.reservoir = []  # (name, signal, pool index, result)
        self.longest = None  # (ci, (name, signal, pool index, result))
        self.n_reads = 0

    def feed(self):
        from rhbench.trace import WINDOW_OPEN, mark

        t_open = time.perf_counter()
        if self.marks:
            mark(WINDOW_OPEN)
        while not self.arrived or time.perf_counter() < t_open + self.seconds:
            batch, idx = next(self.stream)
            self.arrived.append(time.perf_counter())
            self.inflight.append((batch, idx))
            yield batch

    def run(self, engine) -> None:
        from rhbench.trace import WINDOW_CLOSE, mark

        for results in engine.map_stream(self.feed()):
            self.returned.append(time.perf_counter())
            self._record(*self.inflight.popleft(), results)
        if self.marks:
            mark(WINDOW_CLOSE)

    def _record(self, batch: list, idx: list, results: list) -> None:
        if [r.name for r in results] != [n for n, _ in batch]:
            raise RuntimeError("a batch's results are not its reads")
        cis = [_ci(r.records[0]) for r in results]
        self.sizes.append(len(results))
        self.chunks.append(sum(cis))
        self.mapped += sum(r.records[0].mapped for r in results)
        best = max(range(len(cis)), key=cis.__getitem__)
        if self.longest is None or cis[best] > self.longest[0]:
            self.longest = (cis[best], (*batch[best], idx[best], results[best]))
        n = self.n_reads
        draw = self.rng.integers(0, np.arange(n, n + len(results)) + 1)
        for k, j in enumerate(draw):
            slot = n + k if n + k < self.keep else int(j)
            if slot < self.keep:
                read = (*batch[k], idx[k], results[k])
                if slot == len(self.reservoir):
                    self.reservoir.append(read)
                else:
                    self.reservoir[slot] = read
        self.n_reads = n + len(results)


class HostClock:
    """What the host did over the window: the collector's pauses by
    generation (gc.callbacks) and this process's CPU time as a share of
    the wall time (its threads together)."""

    def __init__(self):
        self.gc_s = [0.0, 0.0, 0.0]
        self.gc_n = [0, 0, 0]
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.gc_s[g] += time.perf_counter() - self._t
            self.gc_n[g] += 1
            self._t = None

    @staticmethod
    def _cpu() -> float:
        t = os.times()
        return t.user + t.system

    def __enter__(self):
        self.cpu0, self.t0 = self._cpu(), time.perf_counter()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.cpu1, self.t1 = self._cpu(), time.perf_counter()

    def summary(self) -> dict:
        return {"gc_s": self.gc_s, "gc_n": self.gc_n,
                "process_cpu_share": (self.cpu1 - self.cpu0) / (self.t1 - self.t0)}


def build_cell(cell: spec.Cell, seed: int, device: str, scale: dict | None = None,
               laps: dict | None = None):
    """The cell's genome, the port's index and engine, the read pool and
    the handover stream, from the seed.  `scale` overrides configuration
    and traffic numbers (the tests' small sizes); `laps` gets the
    perf_counter time at which each part was done."""
    laps = {} if laps is None else laps
    from rawhash_tpu_torch.config import IndexOptions, MapOptions, set_preset
    from rawhash_tpu_torch.index.build import build_index_from_sequences
    from rawhash_tpu_torch.map.engine import MappingEngine
    from rawhash_tpu_torch.pore import PoreModel

    conf = {**cell.config, **(scale or {}).get("config", {})}
    traffic = {**cell.traffic, **(scale or {}).get("traffic", {})}
    genome = gen.random_genome(int(conf["genome_len"]), np.random.default_rng([seed, 2]))
    pore = gen.synthetic_pore(k=int(conf["pore_k"]))
    iopt, mopt = IndexOptions(), MapOptions()
    set_preset(conf["preset"], iopt, mopt)
    mopt.batch_reads = int(conf["batch_reads"])
    mopt.max_anchors_per_read = int(conf["max_anchors"])
    index = build_index_from_sequences([("chr1", genome)],
                                       PoreModel(k=pore.k, pore_vals=pore.pore_vals), iopt)
    engine = MappingEngine(index, mopt, device=device)
    laps["index"] = time.perf_counter()
    pool = gen.read_pool(genome, pore, traffic, int(conf["read_len"]), seed)
    laps["pool"] = time.perf_counter()
    stream = gen.handovers(pool, mopt.batch_reads, int(traffic["max_offset"]), seed)
    return dict(conf=conf, traffic=traffic, genome=genome, pore=pore, engine=engine,
                mopt=mopt, pool=pool, stream=stream)


def compare(records: dict, ref: dict) -> dict:
    """The share of the sampled reads whose records differ from the
    reference's."""
    differ = [r for r in ref if records[r] != ref[r]]
    return {"records_differ_share": len(differ) / max(len(ref), 1), "sampled": len(ref),
            "differ": len(differ),
            "examples": [[r, records[r], ref[r]] for r in differ[:3]]}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float, scale: dict | None = None, check_reads: int = CHECK_READS,
             reference_dtype=None) -> tuple:
    """One run of `cell`: (the result object, the numbers compared with
    their limits, lines of information).  `reference_dtype` maps the
    sample again in that float type, as the control, and reports its
    share of differing records beside the program's."""
    import torch

    from rawhash_tpu_torch import _build
    from rawhash_tpu_torch._native import get_lib
    from rawhash_tpu_torch.map.engine import MappingEngine

    from rhbench.reference.mapper import ReferenceMapper, records_of
    from rhbench.trace import Spies, profiled, summarize

    on_card = device == "cuda"
    laps = {"imports": time.perf_counter()}
    # the kernel libraries: nvcc's and g++'s builds on a checkout's first
    # run, loads from build/rawhash_tpu_torch after that
    if on_card:
        _build.load_library()
    get_lib()
    laps["libraries"] = time.perf_counter()
    if on_card:
        torch.cuda.init()
    built = build_cell(cell, seed, device, scale, laps)
    engine: MappingEngine = built["engine"]
    mopt = built["mopt"]
    # warm-up: the tail switch and the learned capacities settle
    warm = engine.pipeline_depth + 1
    for _ in engine.map_stream(next(built["stream"])[0] for _ in range(warm)):
        pass
    if on_card:
        torch.cuda.synchronize()
    laps["warm_up"] = time.perf_counter()
    stages0 = dict(engine.profiler.totals)
    window = Window(built["stream"], seconds, trace, seed, check_reads)
    # set-up's garbage collected now, and set-up's objects (the pool, the
    # index's tables) left out of the collector's scans in the window
    gc.collect()
    gc.freeze()
    spies = prof = None
    if trace:
        spies = Spies()
        spies.install()
        prof_cm = profiled()
        prof = prof_cm.__enter__()
    try:
        setup_s = time.perf_counter() - t0
        with HostClock() as host:
            window.run(engine)
            if on_card:
                torch.cuda.synchronize()
    finally:
        gc.unfreeze()
        if trace:
            prof_cm.__exit__(None, None, None)
            spies.restore()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    stages = {k: v - stages0.get(k, 0.0) for k, v in engine.profiler.totals.items()}

    arrived, returned = np.array(window.arrived), np.array(window.returned)
    sizes = np.array(window.sizes)
    n_handed = int(sum(len(b) for b, _ in window.inflight)) + int(sizes.sum())
    missing = n_handed - window.n_reads
    chunks = int(sum(window.chunks))
    window_s = float(returned[-1] - arrived[0])
    latency = np.repeat((returned - arrived[:len(returned)]) * 1e3, sizes)
    pool = built["pool"]
    picked = [window.longest[1]] + [r for r in window.reservoir
                                    if r[0] != window.longest[1][0]][:check_reads - 1]
    records = {name: records_of([res])[0] for name, _, _, res in picked}
    truth_ok = 0
    for name, _, i, _ in picked:
        p, r = pool[i], records[name][0]
        truth_ok += bool(r[0] and p.on_target and r[1] == p.strand
                         and r[3] >= p.start - 200 and r[3] + r[4] <= p.start + p.length + 200)
    per_read = mopt.chunk_size / mopt.sample_per_base
    info = {"reads": n_handed, "batches": len(arrived), "mapped": window.mapped,
            "sampled_on_target": sum(pool[i].on_target for _, _, i, _ in picked),
            "sampled_mapped_right": truth_ok,
            "chunks": chunks, "window_s": window_s,
            "read_latency_ms_p95": float(np.percentile(latency, 95)) if latency.size else None,
            "engine_stats": {k: v for k, v in engine.stats.items() if k != "shard_hits"},
            "learned": [engine._learned_need, engine._learned_kcap, engine._learned_pcap],
            "stage_s": stages, "tail": "device" if engine.device_tail else "host",
            "host": {**host.summary(), **_pace(returned - arrived[0], window.chunks,
                                               per_read, window_s)},
            "setup_laps_s": {k: v - t0 for k, v in laps.items()},
            "build_s": laps["libraries"] - laps["imports"]}

    fill_bounds = []
    if trace:
        summary = summarize(prof)
        fill_bounds = _fill_bounds(spies.fill_calls, summary["fill_ms"])
        info["trace_counts"] = {**summary["counts"], "fill_calls": len(spies.fill_calls)}
    del engine, built["engine"], window
    if on_card:
        torch.cuda.empty_cache()

    # the check: a sample of the window's reads mapped again by the reference
    t_ref = time.perf_counter()
    reads = [(name, sig) for name, sig, _, _ in picked]
    ref_mapper = ReferenceMapper(built["genome"], built["pore"], built["conf"]["preset"])
    ref = dict(zip(records, ref_mapper.map(reads)))
    checks = compare(records, ref)
    checks["results_missing"] = missing
    info["reference_s"] = time.perf_counter() - t_ref
    info["check"] = {k: v for k, v in checks.items() if k not in LIMITS}
    if reference_dtype is not None:
        control = ReferenceMapper(built["genome"], built["pore"], built["conf"]["preset"],
                                  dtype=reference_dtype)
        low = dict(zip(records, control.map(reads)))
        info["control"] = compare(low, ref)

    ctx = dict(window_s=window_s, latency_ms=latency, chunks=chunks,
               bases=chunks * per_read, setup_s=setup_s, stages=stages,
               trace=summary if trace else None,
               rooflines={"chain_fill": fill_bounds})
    metrics = {}
    for entry, mfile in (cell.per_layer if trace else cell.end_to_end):
        params = {k: v for k, v in mfile.items() if k != "reader"}
        value = spec.reader(mfile["reader"])(ctx, **params)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
              "attempted": n_handed, "failed": missing, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    compared = {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}
    return result, compared, info


def _pace(t_out: np.ndarray, chunks: list, per_read: float, window_s: float) -> dict:
    """How the window's pace moved: bases a second completed in each fifth
    of the window, and the longest time between two batches' results with
    when it ended (seconds into the window)."""
    fifths = np.minimum((t_out / window_s * 5).astype(int), 4)
    bp = np.bincount(fifths, weights=np.asarray(chunks, float) * per_read, minlength=5)
    gaps = np.diff(np.concatenate([[0.0], t_out]))
    k = int(np.argmax(gaps))
    return {"bp_per_s_fifths": (bp / (window_s / 5)).tolist(),
            "gap_max_s": float(gaps[k]), "gap_max_at_s": float(t_out[k])}


def _fill_bounds(calls: list, fill_ms: dict) -> list:
    """(bound ms, device ms) of each kept fill call whose kernel the trace
    found, the bound worked out by rhbench.bounds on the call's inputs."""
    from rhbench import bounds

    out = []
    for mark_name, kept, params in calls:
        if kept is None or mark_name not in fill_ms:
            continue
        key, tpos, qpos, n_anchors, shape = kept
        work = bounds.fill_work(key, tpos, qpos, n_anchors, **params)
        if work["unsorted"]:
            raise RuntimeError(f"{mark_name}: {work['unsorted']} in-band pairs past "
                               "an out-of-band one: the fill's inputs are not sorted")
        nbytes = bounds.fill_bytes(int(n_anchors.sum()), *shape)
        out.append((bounds.bound(nbytes, **bounds.fill_ops(work))["bound_ms"],
                    fill_ms[mark_name]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    # one intra-op thread: the engine's host work is Python and NumPy on
    # the calling thread and its workers, whose intra-op pools otherwise
    # oversubscribe the host's cores and spread the runs
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("rhbench: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"rhbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, compared, info = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      "cuda", T_PROCESS)
    found = banned_modules()
    if found:
        print(f"rhbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps({"info": info}))
    for name, c in compared.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(result_line(result, compared, card_info()))
    return 0


def result_line(result: dict, compared: dict, card: dict) -> str:
    """The result as one line of JSON: the card's name and power limit,
    then the numbers compared with their limits, last."""
    return json.dumps({**result, "card": card, "compared": compared})


if __name__ == "__main__":
    sys.exit(main())
