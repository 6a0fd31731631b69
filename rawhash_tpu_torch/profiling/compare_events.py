"""This checkout's events and sketch stage, and its mapping, against another
checkout's, in turns on one card.

    git archive <commit> rawhash_tpu_torch | tar -x -C build/other
    python -m rawhash_tpu_torch.profiling.compare_events build/other [WORKLOAD ...]

Loads the other checkout's `rawhash_tpu_torch` under another name (it
builds its own kernels under that checkout) and runs each workload with
both, in turns (theirs, ours, ours, theirs, twice: four runs each), no
other work beside them.  Prints the card's name and power limit, then one
JSON line per workload (all of them, or those named):

  events    one chunk of 256 nanopore-like viral reads of 4000 samples
            through `events_and_sketch` (the events and sketch stage),
            seconds on the host clock up to a sync of the card; the two
            checkouts' outputs must be equal;
  d1 d2 d4  chip_smoke.py's mapping cells (the same genomes, presets, reads
            and --max-anchors: D1 viral 2 x 256 reads, D2 E. coli-sized 2 x
            256, D4 100 Mbp 1 x 256), built once and mapped by a fresh
            engine of each checkout a run, after one untimed run of each:
            bp/s and the stage sums of each run; the records must be equal;
  fixture   the viral fixture (8 kb genome, 6 reads of 600 bases, seed 5,
            --max-anchors 512) at two reads a batch, three batches, at
            --pipeline-depth 1 and 3: seconds of each;
  peaks     the peak detector's kernel (`_gen_peaks` on CUDA tensors) of
            both checkouts, where the other has one, on the t-statistics of
            256 reads at 4000 and 28672 positions: device ms
            (kernel_time.device_ms: 4 launches in a CUDA graph, the median
            of 5 replays a run); the emissions must be equal; and each
            kernel's SASS opcodes;
  scans     the ordered sums of both checkouts at 256 x 4000 and 256 x
            28672 (kernel_time.scan_times: the sum and the prefix sum of one
            input, torch.sum and torch.cumsum beside them, and the stage's
            calls of one chunk; device, call and host ms), two runs each;
            the stage's sums must be equal;
  filter    the diff filter's kernel (`_diff_filter` on CUDA tensors) of
            both checkouts on the inputs this checkout's events stage gives
            it at the viral (256 x 4000 samples, 768 events) and ava (256 x
            28672, 16384) shapes: device ms (kernel_time.device_ms, 20
            launches in a CUDA graph, the median of 5 replays a run); the
            keep masks must be equal;
  dtw       chip_smoke.py's dtw cell (D1's genome indexed with --store-sig,
            1 x 256 reads, --dtw-evaluate-chains), mapped by a fresh engine
            of each checkout a run: bp/s and the stage sums, the records
            equal; then, on the run's widest call (caught from this
            checkout's host wrapper), each checkout's host wrapper whole
            (dtw_banded_batch_host, host clock) and its kernel alone (the
            ragged entry on the pairs packed, or a checkout's padded
            dtw_banded_batch on them padded): call, host and device ms
            (kernel_time.call_ms, host_ms, device_ms); the costs equal;
  busy      one D1 batch of this checkout under torch.profiler: the share of
            the wall time in which the card ran a kernel (the union of the
            kernels' intervals over the wall time).

Each line carries every run's number, the medians and the spread (max -
min).  It needs an NVIDIA GPU and exits non-zero without one.
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import _build as this_build
from .. import synthetic
from ..config import MapFlag
from ..dtw import device as this_dtw
from ..map import device_step, engine as eng_mod
from ..signal import events as this_events
from ..sketch import device as this_sketch
from .compare_backtrack import OTHER, load_other
from .fill_loop_overhead import card

DEV = "cuda"
EVENTS_B, EVENTS_L = 256, 4000  # the events workload's chunk
PEAKS_L = (4000, 28672)  # the peaks workload's positions: viral's, ava's chunk
ORDER = ("other", "this", "this", "other") * 2
# chip_smoke.py's cells: genome length, preset, batches, read length,
# --max-anchors, seed
CELLS = {
    "d1": (30_000, "viral", 2, 1200, 3072, 7),
    "d2": (5_000_000, "sensitive", 2, 2500, 16384, 11),
    "d4": (100_000_000, "sensitive", 1, 3000, 4096, 13),
}
DTW_CELL = (30_000, "viral", 1, 1200, 3072, 7)  # chip_smoke.py's dtw cell


def summary(runs: dict) -> dict:
    return {who: {"runs": v, "median": float(np.median(v)),
                  "spread": float(max(v) - min(v))} for who, v in runs.items()}


def events_call(mod, sig, slen):
    """events_and_sketch of a checkout's device_step on one viral chunk."""
    io, mo = synthetic.options("viral")
    return mod["step"].events_and_sketch(
        sig, slen, mod["events"].NormCarry.zeros(sig.shape[0], sig.device),
        window_length1=mo.window_length1, window_length2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height, e_cap=mo.max_events_per_chunk,
        min_events=mo.min_events, diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
        fine_min=io.fine_min, fine_max=io.fine_max, fine_range=io.fine_range)


def tensors(x) -> list:
    """The tensors of nested tuples, in order."""
    return [x] if isinstance(x, torch.Tensor) else [t for y in x for t in tensors(y)]


def compare_events(mods) -> dict:
    dev = torch.device(DEV)
    b, l = EVENTS_B, EVENTS_L
    sig = torch.from_numpy(synthetic.signal_chunk(np.random.default_rng(3), b, l)).to(dev)
    slen = torch.full((b,), l, dtype=torch.int32, device=dev)
    outs = {who: events_call(m, sig, slen) for who, m in mods.items()}
    equal = all(torch.equal(a, c) for a, c in zip(tensors(outs["this"]),
                                                   tensors(outs["other"])))
    secs = {"this": [], "other": []}
    for who in ORDER:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events_call(mods[who], sig, slen)
        torch.cuda.synchronize()
        secs[who].append(time.perf_counter() - t0)
    s = summary(secs)
    return {"workload": "events", "b": b, "l": l, "equal": equal, "seconds": s,
            "speedup": s["other"]["median"] / s["this"]["median"]}


def records(results) -> list:
    return [(r.name, [(m.ref_id, m.read_start, m.read_end, m.frag_start, m.frag_len,
                       m.mapq, m.rev, m.mapped) for m in r.records]) for r in results]


def map_once(engine_cls, index, mopt, batches, bases_of):
    """(seconds, bp/s, stage sums, records) of one fresh engine's map."""
    engine = engine_cls(index, copy.deepcopy(mopt), device=DEV)
    engine.profiler.on = True  # the stage sums (an older tracer ignores it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [r for batch in engine.map_stream(batches) for r in batch]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stages = dict(engine.profiler.totals)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return dt, bases_of(results) / dt, stages, records(results)


def bases(mopt):
    """Bases of signal a run consumed, as chip_smoke.py counts them."""
    def count(results):
        total = 0.0
        for res in results:
            tags = res.records[0].tags.split("\t")
            ci = int(next(t[5:] for t in tags if t.startswith("ci:i:")))
            total += ci * mopt.chunk_size / mopt.sample_per_base
        return total
    return count


def compare_cell(name, mods, store_sig=False, flag=0) -> dict:
    genome_len, preset, n_batches, read_len, max_anchors, seed = (
        DTW_CELL if name == "dtw" else CELLS[name])
    t0 = time.perf_counter()
    index, mopt, reads = synthetic.deployment(genome_len, preset, n_batches * 256,
                                              read_len, max_anchors, seed,
                                              store_sig=store_sig)
    mopt.flag |= flag
    setup = time.perf_counter() - t0
    batches = [[(n, s) for n, s, _, _ in reads[i:i + 256]]
               for i in range(0, len(reads), 256)]
    bps, stages, recs = {"this": [], "other": []}, {"this": [], "other": []}, {}
    for who in ("other", "this"):  # each checkout's first map of the process, untimed
        map_once(mods[who]["engine"], index, mopt, batches, bases(mopt))
    for who in ORDER:
        _, r, st, rec = map_once(mods[who]["engine"], index, mopt, batches, bases(mopt))
        bps[who].append(r)
        stages[who].append(st)
        recs.setdefault(who, rec)
    s = summary(bps)
    return {"workload": name, "preset": preset, "reads": len(reads), "setup_s": setup,
            "records_equal": recs["this"] == recs["other"], "bp_per_s": s,
            "speedup": s["this"]["median"] / s["other"]["median"], "stage_seconds": stages}


def caught_call(module, name, fn):
    """(fn's result, the (args, kwargs) of every call of module.name during
    fn)."""
    orig, caught = getattr(module, name), []

    def spy(*a, **k):
        caught.append((a, k))
        return orig(*a, **k)
    spy.__dict__ = orig.__dict__  # the launch counter on the module's name
    setattr(module, name, spy)
    try:
        out = fn()
    finally:
        setattr(module, name, orig)
    return out, caught


def compare_filter(mods) -> dict:
    """The diff filter's kernel (K7) of both checkouts, in turns, on the
    inputs this checkout's events stage gives it at the viral and ava
    shapes."""
    from .kernel_time import FILTER_SHAPES, device_ms, filter_inputs

    out = {"workload": "filter", "equal": True, "shapes": {}}
    for preset, l, e_cap in FILTER_SHAPES:
        a = filter_inputs(preset, l, e_cap)
        fns = {who: (lambda m=m: m["sketch"]._diff_filter(*a)) for who, m in mods.items()}
        out["equal"] &= torch.equal(fns["this"](), fns["other"]())
        ms = {"this": [], "other": []}
        for who in ORDER:
            ms[who].append(device_ms(fns[who]))
        s = summary(ms)
        out["shapes"][preset] = {"shape": list(a[0].shape), "n_live": int(a[1].max()),
                                 "ms": s,
                                 "speedup": s["other"]["median"] / s["this"]["median"]}
    return out


def compare_dtw(mods) -> dict:
    """The dtw cell in turns, and the two checkouts' banded DTW on its
    widest call: each host wrapper's whole call (dtw_banded_batch_host:
    pack, copy, launch, copy back; host clock, the median of 3) and each
    kernel on the call's pairs, call, host and device ms (a checkout with
    dtw_banded_ragged on them packed, one without it its dtw_banded_batch
    on them padded to the longest); the costs equal."""
    from .kernel_time import call_ms, device_ms, host_ms

    row, calls = caught_call(this_dtw, "dtw_banded_batch_host", lambda: compare_cell(
        "dtw", mods, store_sig=True, flag=MapFlag.DTW_EVALUATE_CHAINS))
    pairs, radii = max(((a[0], a[1]) for a, _ in calls),
                       key=lambda c: len(c[0]) * max(c[1]))
    whole = {who: (lambda m=m: m["dtw"].dtw_banded_batch_host(pairs, radii, DEV))
             for who, m in mods.items()}
    row["dtw_equal"] = bool(np.array_equal(whole["this"](), whole["other"]()))
    packed = this_dtw.pack_pairs(pairs, radii)
    r = this_dtw._pow2_at_least(int(packed[5].max()), 4)
    ragged = [torch.from_numpy(x).to(DEV) for x in packed[:7]]
    longest = int(packed[2].max())
    pad = this_dtw._pad_rows
    padded = (pad(ragged[0], ragged[1], ragged[2], longest), ragged[2],
              pad(ragged[0], ragged[3], ragged[4], longest), ragged[4], ragged[5])

    def kernel_call(m):
        if hasattr(m["dtw"], "dtw_banded_ragged"):
            return lambda: m["dtw"].dtw_banded_ragged(*ragged, max_radius=r,
                                                      long_pairs=packed[7])
        return lambda: m["dtw"].dtw_banded_batch(*padded, max_radius=r)

    fns = {who: kernel_call(m) for who, m in mods.items()}
    row["dtw_equal"] &= bool(torch.equal(fns["this"](), fns["other"]()))
    ms = {key: {"this": [], "other": []}
          for key in ("whole_ms", "call_ms", "host_ms", "device_ms")}
    for who in ORDER[:4]:
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole[who]()
            runs.append((time.perf_counter() - t0) * 1e3)
        ms["whole_ms"][who].append(float(np.median(runs)))
        ms["call_ms"][who].append(call_ms(fns[who], 3))
        ms["host_ms"][who].append(host_ms(fns[who], 5))
        ms["device_ms"][who].append(device_ms(fns[who], 5))
    row["widest_call"] = {"pairs": len(pairs), "longest": longest, "max_radius": r,
                          "calls_a_run": len(calls) // 5}
    for key, v in ms.items():
        s = summary(v)
        row["widest_call"][key] = s
        row["widest_call"][key.replace("_ms", "_speedup")] = (
            s["other"]["median"] / s["this"]["median"])
    return row


def compare_fixture(mods) -> dict:
    index, mopt, reads = synthetic.deployment(8000, "viral", 6, 600, 512, 5, batch_reads=2)
    batches = [[(n, s) for n, s, _, _ in reads[i:i + 2]] for i in range(0, 6, 2)]
    secs = {}
    for depth in (1, 3):
        mo = copy.deepcopy(mopt)
        mo.pipeline_depth = depth
        runs = {"this": [], "other": []}
        for who in ORDER[:4]:
            runs[who].append(map_once(mods[who]["engine"], index, mo, batches,
                                      bases(mo))[0])
        secs[f"depth{depth}"] = summary(runs)
    return {"workload": "fixture", "batches": 3, "seconds": secs}


def compare_peaks(mods) -> dict:
    """The peak detector's kernel of both checkouts, in turns: device time
    (kernel_time.device_ms), and each kernel's SASS opcodes."""
    from .fill_loop_overhead import sass_ops
    from .kernel_time import device_ms

    out = {"workload": "peaks", "equal": True, "shapes": {}}
    if not hasattr(mods["other"]["events"]._gen_peaks, "launches"):
        out["skipped"] = "the other checkout has no peak-detector kernel"
        return out
    prm = dict(t1=4.0, t2=3.5, w1=3, w2=9, peak_height=0.4)
    for l in PEAKS_L:
        rng = np.random.default_rng(l)
        n_sig = np.full(256, l, np.int32)
        args = [torch.from_numpy(x).to(DEV)
                for x in (*synthetic.event_tstats(rng, 256, l, n_sig, 3, 9), n_sig)]
        fns = {who: (lambda m=m: m["events"]._gen_peaks(*args, **prm))
               for who, m in mods.items()}
        out["equal"] &= torch.equal(fns["this"](), fns["other"]())
        ms = {"this": [], "other": []}
        for who in ORDER:
            ms[who].append(device_ms(fns[who], 4))
        s = summary(ms)
        out["shapes"][str(l)] = {"ms": s,
                                 "speedup": s["other"]["median"] / s["this"]["median"]}
    out["sass"] = {who: sass_ops(m["build"].build(), "events_peaks_kernel")
                   for who, m in mods.items()}
    return out


def compare_scans(mods) -> dict:
    """The ordered sums (K6) of both checkouts, in turns, at the events
    stage's shapes: each single call and the stage's calls of one chunk,
    device time, call time and host time (kernel_time.scan_times); the
    outputs must be equal."""
    from .kernel_time import scan_inputs, scan_times, stage_scans

    out = {"workload": "scans", "equal": True, "shapes": {}}
    for l in PEAKS_L:
        x = scan_inputs(l)
        got = {who: tensors(stage_scans(m["events"], *x)) for who, m in mods.items()}
        out["equal"] &= all(torch.equal(a, c) for a, c in zip(got["this"], got["other"]))
        del got
        runs = {"this": [], "other": []}
        for who in ORDER[:4]:
            runs[who].append(scan_times(mods[who]["events"], l))
        keys = {(k, t) for r in runs["this"] for k, v in r.items() for t in v
                if t.endswith("_ms")}
        out["shapes"][str(l)] = {
            f"{k} {t}": summary({who: [r[k][t] for r in rs] for who, rs in runs.items()})
            for k, t in sorted(keys)}
    return out


def device_busy() -> dict:
    """Busy share of the card over one D1 batch of this checkout."""
    from torch.profiler import ProfilerActivity, profile

    genome_len, preset, _, read_len, max_anchors, seed = CELLS["d1"]
    index, mopt, reads = synthetic.deployment(genome_len, preset, 256, read_len,
                                              max_anchors, seed)
    batches = [[(n, s) for n, s, _, _ in reads]]
    map_once(eng_mod.MappingEngine, index, mopt, batches, bases(mopt))  # warm-up
    engine = eng_mod.MappingEngine(index, copy.deepcopy(mopt), device=DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in engine.map_stream(batches):
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, z in spans:
        if z > end:
            busy += z - max(a, end)
            end = z
    by_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t:
            by_kernel[e.key] = t
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    return {"workload": "busy", "cell": "d1", "reads": 256, "wall_s": wall,
            "device_events": len(spans), "busy_s": busy / 1e6,
            "busy_share": busy / 1e6 / wall if spans else None,
            "top_device_us": top}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names = ("events", *CELLS, "fixture", "peaks", "scans", "filter", "dtw", "busy")
    if not argv or any(a not in names for a in argv[1:]):
        print("usage: python -m rawhash_tpu_torch.profiling.compare_events "
              f"OTHER_CHECKOUT [{' '.join(names)}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_events: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    return run(Path(argv[0]), argv[1:] or names)


def run(other: Path, names) -> int:
    """The named workloads against the checkout at `other`; 0 if the
    outputs and records were equal."""
    load_other(other, "map.engine")
    mods = {"this": {"step": device_step, "events": this_events, "sketch": this_sketch,
                     "dtw": this_dtw, "engine": eng_mod.MappingEngine,
                     "build": this_build},
            "other": {"step": sys.modules[f"{OTHER}.map.device_step"],
                      "events": sys.modules[f"{OTHER}.signal.events"],
                      "sketch": sys.modules[f"{OTHER}.sketch.device"],
                      "dtw": importlib.import_module(f"{OTHER}.dtw.device"),
                      "engine": sys.modules[f"{OTHER}.map.engine"].MappingEngine,
                      "build": sys.modules[f"{OTHER}._build"]}}
    workloads = {"events": lambda: compare_events(mods),
                 **{c: (lambda c=c: compare_cell(c, mods)) for c in CELLS},
                 "fixture": lambda: compare_fixture(mods),
                 "peaks": lambda: compare_peaks(mods), "scans": lambda: compare_scans(mods),
                 "filter": lambda: compare_filter(mods), "dtw": lambda: compare_dtw(mods),
                 "busy": device_busy}
    print(card(), flush=True)
    ok = True
    for name in names:
        row = workloads[name]()
        print(json.dumps(row), flush=True)
        ok &= (row.get("equal", True) and row.get("records_equal", True)
               and row.get("dtw_equal", True))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
