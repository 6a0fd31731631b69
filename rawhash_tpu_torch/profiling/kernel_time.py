"""A kernel wrapper's time on the card, three ways, and the events stage's
kernels timed so.

- `device_ms`: n back-to-back calls between one pair of CUDA events,
  divided by n (the median of `reps` such runs).  The n calls are
  captured once into a CUDA graph and the graph is replayed, so the card
  runs the launches one after another with no wait for the host: the
  window holds the kernels and the gaps between them, not the wrapper's
  host path (a wrapper whose host path is longer than its kernel would
  otherwise time the host).  The inputs are the same on every call, so
  they are warm in the L2 cache wherever they fit (50 MB).
- `call_ms`: one call between a pair of events on an idle card (the median
  of `reps`): the window holds the wrapper's whole host path, as it does
  for a lone call on the main path.
- `host_ms`: the host clock around n calls without a sync, divided by n:
  the wrapper's host path alone (the launches only queue).

    python -m rawhash_tpu_torch.profiling.kernel_time [--probe | --dtw]

prints the card's name and power limit, then one JSON line per shape of
the events stage (256 reads of 4000 and of 28672 samples): the whole
stage (`detect_events_batch` on f16 samples: the three kernels of
csrc/events_fused.cu), the ordered sums (K6) as the plain version calls
them, each beside torch.sum / torch.cumsum on the same input, and the peak
detector (K5); then the host path of one
ordered-sum call, piece by piece (`host_pieces`).  With --probe, also K6's
fixed part and its level 0 apart (`scan_probe`) and where a launch's time
goes, phase by phase, from a build of csrc/ordered_scan.cu that stamps each
warp's clock (`scan_stamps`), and the diff filter's (K7) cycles an event
from a build of csrc/diff_filter.cu that stamps each stepping warp's tile
loop (`filter_stamps`).  With --dtw, only the banded DTW (K8) on a batch
shaped like the dtw cell's widest call (`dtw_cell_pairs`), its device
time with the long pairs on warps from T = 8 to 48 columns and with every
pair on a thread, in turns, each bit-equal to the plain version
(`dtw_paths`).  It needs an NVIDIA GPU and exits non-zero without one.
"""

from __future__ import annotations

import inspect
import json
import sys
import time

import numpy as np
import torch

from .. import synthetic
from .fill_loop_overhead import card

B = 256
SHAPES = (4000, 28672)  # viral's and sensitive's chunk, ava's whole read


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Milliseconds a call of fn() on the card: n back-to-back calls,
    captured in a CUDA graph after one warm-up call, replayed between one
    event pair, over n; the median of reps replays."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    del graph
    return float(np.median(times))


def call_ms(fn, reps: int = 7) -> float:
    """Milliseconds of one call of fn() between an event pair on an idle
    card (the median of reps, after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def host_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Milliseconds of host time a call of fn(): the host clock around n
    calls with no sync, over n (the median of reps, after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
    return float(np.median(times))


def times(fn, n: int = 20) -> dict:
    """{device_ms, call_ms, host_ms} of fn()."""
    return {"device_ms": device_ms(fn, n), "call_ms": call_ms(fn),
            "host_ms": host_ms(fn, n)}


def fused(events) -> bool:
    """Whether this events module's ordered sums take `squares=` (one
    launch for a value and its square)."""
    return "squares" in inspect.signature(events.ordered_sum).parameters


def stage_scans(events, sig_m, normc, psum_in):
    """The ordered sums of one chunk, as that module's detect_events_batch
    and _segment_events call them: the sums of sig_m and its square, the
    prefix sums (with their leading zero) of normc and its square, and the
    prefix sum of the kept values."""
    pad = torch.nn.functional.pad
    if fused(events):
        return (events.ordered_sum(sig_m, squares=True),
                events.ordered_cumsum(normc, squares=True, lead_zero=True),
                events.ordered_cumsum(psum_in, lead_zero=True))
    return (events.ordered_sum(sig_m), events.ordered_sum(sig_m * sig_m),
            pad(events.ordered_cumsum(normc), (1, 0)),
            pad(events.ordered_cumsum(normc * normc), (1, 0)),
            pad(events.ordered_cumsum(psum_in), (1, 0)))


def scan_inputs(l: int, seed: int = 3) -> tuple:
    """(sig_m, normc, psum_in) on the card: a chunk of B nanopore-like reads
    of l samples, its clipped normalised signal as the [B, l] slice of a
    [B, l + 1] array (the stage's layout), and sorted values with zeros."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    sig = torch.from_numpy(synthetic.signal_chunk(rng, B, l)).to(dev)
    norm = (sig - sig.mean(1, keepdim=True)) / sig.std(1, keepdim=True)
    wide = torch.zeros((B, l + 1), device=dev)
    wide[:, :l] = norm.clamp(-2.9, 2.9)
    vals = torch.sort(wide[:, :l], dim=1).values
    keep = torch.from_numpy(rng.random((B, l)) < 0.9).to(dev)
    return sig, wide[:, :l], torch.where(keep, vals, 0.0).contiguous()


def scan_times(events, l: int) -> dict:
    """The ordered sums of `events` at B x l: each single call (the sum and
    the prefix sum of one input) beside torch.sum / torch.cumsum on the same
    input, and the stage's calls of one chunk together."""
    sig_m, normc, psum_in = scan_inputs(l)
    out = {
        "ordered_sum": times(lambda: events.ordered_sum(sig_m)),
        "torch.sum": times(lambda: torch.sum(sig_m, dim=1)),
        "ordered_cumsum": times(lambda: events.ordered_cumsum(normc)),
        "torch.cumsum": times(lambda: torch.cumsum(normc, dim=1)),
        "stage": times(lambda: stage_scans(events, sig_m, normc, psum_in)),
    }
    out["stage"]["launches"] = 3 if fused(events) else 5
    return out


STAGE_E_CAP = {4000: 768, 28672: 16384}  # the engine's e_cap at each shape


def stage_times(events, l: int) -> dict:
    """The events stage of `events` (detect_events_batch) on one chunk of B
    nanopore-like reads of l samples, f16 as the engine ships them."""
    dev = torch.device("cuda")
    sig = torch.from_numpy(synthetic.signal_chunk(np.random.default_rng(3), B, l))
    sig = sig.half().to(dev)
    slen = torch.full((B,), l, dtype=torch.int32, device=dev)
    carry = events.NormCarry.zeros(B, dev)
    out = times(lambda: events.detect_events_batch(sig, slen, carry,
                                                   e_cap=STAGE_E_CAP[l]), n=4)
    out["e_cap"] = STAGE_E_CAP[l]
    return out


def peaks_times(events, l: int) -> dict:
    """The peak detector of `events` on the t-statistics of B reads of l
    positions, every read live to its end."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(l)
    n_sig = np.full(B, l, np.int32)
    args = [torch.from_numpy(x).to(dev)
            for x in (*synthetic.event_tstats(rng, B, l, n_sig, 3, 9), n_sig)]
    prm = dict(t1=4.0, t2=3.5, w1=3, w2=9, peak_height=0.4)
    return times(lambda: events._gen_peaks(*args, **prm), n=4)


PROBE_ROWS = (1, 8, 33, 66, 132, 256)


def scan_probe(l: int) -> dict:
    """K6's fixed part and its level 0 apart, at rows of l values: the device
    ms of each ordered sum (the sum and the prefix sum of one input, and
    the calls that take a value and its square) and of torch.sum /
    torch.cumsum at 1 to 256 rows (PROBE_ROWS).  One row is the fixed part:
    a launch, the copies of a row's first rounds, its rounds one after
    another on its warps and the levels above it on the first warp; the
    time a row past that is level 0's cost at the card's rate.  `floor` is
    256 rows of 32 values, the top level alone: a launch and a store."""
    from ..signal import events

    sig_m, normc, _ = scan_inputs(l)
    fns = {
        "ordered_sum": lambda x: events.ordered_sum(x),
        "ordered_sum_sq": lambda x: events.ordered_sum(x, squares=True),
        "torch.sum": lambda x: torch.sum(x, dim=1),
        "ordered_cumsum": lambda x: events.ordered_cumsum(x),
        "ordered_cumsum_sq_lead": lambda x: events.ordered_cumsum(x, squares=True,
                                                                  lead_zero=True),
        "torch.cumsum": lambda x: torch.cumsum(x, dim=1),
    }
    out = {}
    for name, fn in fns.items():
        x = sig_m if "sum" in name and "cumsum" not in name else normc
        out[name] = {b: device_ms(lambda: fn(x[:b])) for b in PROBE_ROWS}
        out[name]["floor"] = device_ms(lambda: fn(x[:, :32]))
    return out


STAMPS, EXIT, SM = 9, 7, 8  # words a warp, its exit and SM-id slots (ordered_scan.cu)
# the clock slots' phases: the sum's slot 5 is the levels above on the
# first warp; the prefix sum's 5 follows the second barrier, 6 the down-sweep
PHASES = {2: "first_round", 3: "level0", 4: "barrier", 5: "levels", 6: "down"}


def stamp_library(name: str = "ordered_scan", define: str = "RH_SCAN_STAMPS"):
    """csrc/<name>.cu built with -D<define> (its kernels stamp clocks:
    ordered_scan each warp's phases, diff_filter each stepping warp's tile
    loop), cached by the source's hash under build/rawhash_tpu_torch/stamps."""
    import ctypes
    import hashlib

    from .._build import BUILD_DIR, CSRC, NVCC_FLAGS, _run, nvcc_path

    srcs = (CSRC / f"{name}.cu", CSRC / f"{name}.cuh")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.read_bytes())
    so = BUILD_DIR / "stamps" / f"{name}_stamps_{h.hexdigest()[:16]}.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        _run([[nvcc_path(), *NVCC_FLAGS, f"-D{define}", "-shared", "-o", str(so),
               str(srcs[0])]])
    lib = ctypes.CDLL(str(so))
    P, LL, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    entries = {"ordered_scan": (("rh_ordered_prefix", [P, LL, P, P, LL, I, I, I, P]),
                                ("rh_ordered_sum", [P, LL, P, P, I, I, P]),
                                ("rh_scan_set_stamps", [P])),
               "diff_filter": (("rh_diff_filter", [P, P, P, I, I, F, P]),
                               ("rh_diff_set_stamps", [P]))}[name]
    for entry, args in entries:
        getattr(lib, entry).argtypes = args
        getattr(lib, entry).restype = I
    return lib


def _phases(st: np.ndarray) -> dict:
    """The stamps of one launch [warps, STAMPS] -> the launch's span and
    start skew (ns, global timer), the SMs it ran on and the most and
    fewest warps an SM took, and each phase's median and max over the warps
    that reach it (SM clock cycles)."""
    live = st[st[:, 1] != 0]
    per_sm = np.bincount(live[:, SM].astype(np.int64))
    per_sm = per_sm[per_sm > 0]
    out = {"warps": int(len(live)), "sms": int(len(per_sm)),
           "warps_per_sm": [int(per_sm.min()), int(per_sm.max())],
           "span_ns": int(live[:, EXIT].max() - live[:, 0].min()),
           "start_skew_ns": int(live[:, 0].max() - live[:, 0].min()),
           "warp_ns_median": float(np.median(live[:, EXIT] - live[:, 0]))}
    prev = live[:, 1]
    for slot, name in PHASES.items():
        ok = (live[:, slot] != 0) & (prev != 0)
        if ok.any():
            d = (live[ok, slot] - prev[ok]).astype(np.float64)
            out[f"{name}_cycles"] = {"median": float(np.median(d)), "max": float(d.max())}
        prev = np.where(live[:, slot] != 0, live[:, slot], prev)
    return out


def scan_stamps(l: int) -> dict:
    """Where a K6 launch's time goes at rows of l values, from the stamp
    build: for the sum and the prefix sum of one input and of a value and
    its square, at 1 and 256 rows, the phases of `_phases` (the second of
    two launches, the first a warm-up)."""
    import ctypes

    lib = stamp_library()
    sig_m, normc, _ = scan_inputs(l)
    out_rows = torch.empty((2, B, l + 1), device="cuda")
    out_sums = torch.empty((2, B), device="cuda")
    stamps = torch.zeros((B + 3) * 8 * STAMPS, dtype=torch.int64, device="cuda")
    assert lib.rh_scan_set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
    res = {}
    try:
        for b in (1, B):
            for name in ("sum", "sum_sq", "cumsum", "cumsum_sq_lead"):
                sq = name != "sum" and name != "cumsum"
                stream = torch.cuda.current_stream().cuda_stream
                if name.startswith("sum"):
                    call = lambda: lib.rh_ordered_sum(  # noqa: E731
                        sig_m.data_ptr(), sig_m.stride(0), out_sums[0].data_ptr(),
                        out_sums[1].data_ptr() if sq else None, b, l, stream)
                else:
                    call = lambda: lib.rh_ordered_prefix(  # noqa: E731
                        normc.data_ptr(), normc.stride(0), out_rows[0].data_ptr(),
                        out_rows[1].data_ptr() if sq else None, l + 1, int(sq), b, l,
                        stream)
                assert call() == 0
                torch.cuda.synchronize()
                stamps.zero_()
                assert call() == 0
                torch.cuda.synchronize()
                res[f"{name} b{b}"] = _phases(stamps.view(-1, STAMPS).cpu().numpy())
    finally:
        lib.rh_scan_set_stamps(None)
    return res


def _with(lock) -> None:
    with lock:
        pass


def host_pieces(n: int = 2000) -> dict:
    """Microseconds a call of each piece of an ordered sum's host path on a
    [B, 4000] CUDA tensor (timeit over n calls)."""
    import timeit

    from .._build import check_operand
    from ..signal import events

    x = torch.zeros((B, 4000), device="cuda")
    dev = x.device
    pieces = {
        "check_operand": lambda: check_operand("f", "x", x, torch.float32, x.shape, dev,
                                               strided_rows=True),
        "torch.empty": lambda: torch.empty((B, 4001), dtype=torch.float32, device=dev),
        "current_device": lambda: dev.index == torch.cuda.current_device(),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "data_ptr_stride": lambda: (x.data_ptr(), x.stride(0)),
        "count_lock": lambda: _with(events.COUNT_LOCK),
        "ordered_sum": lambda: events.ordered_sum(x),
        "ordered_cumsum_sq_lead": lambda: events.ordered_cumsum(x, squares=True,
                                                                lead_zero=True),
        "torch.sum": lambda: torch.sum(x, dim=1),
    }
    out = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        out[name] = timeit.timeit(fn, number=n) / n * 1e6
        torch.cuda.synchronize()
    return out


def filter_inputs(preset: str, l: int, e_cap: int) -> tuple:
    """(events, n_ev, diff): the diff filter's inputs as the events stage
    gives them on one chunk of B nanopore-like reads of l samples (seed 3)
    on the card, caught from this checkout's stage."""
    from ..map.device_step import events_and_sketch
    from ..signal.events import NormCarry
    from ..sketch import device as sk

    io, mo = synthetic.options(preset)
    dev = torch.device("cuda")
    sig = torch.from_numpy(synthetic.signal_chunk(np.random.default_rng(3), B, l)).to(dev)
    slen = torch.full((B,), l, dtype=torch.int32, device=dev)
    orig, caught = sk._diff_filter, []

    def spy(*a):
        caught.append(a)
        return orig(*a)
    spy.__dict__ = orig.__dict__  # the launch counter on the module's name
    sk._diff_filter = spy
    try:
        events_and_sketch(
            sig, slen, NormCarry.zeros(B, dev), window_length1=mo.window_length1,
            window_length2=mo.window_length2, threshold1=mo.threshold1,
            threshold2=mo.threshold2, peak_height=mo.peak_height, e_cap=e_cap,
            min_events=mo.min_events, diff=io.diff, w=io.w, e=io.e, q=io.q, k=io.k,
            fine_min=io.fine_min, fine_max=io.fine_max, fine_range=io.fine_range)
    finally:
        sk._diff_filter = orig
    return caught[0]


FILTER_SHAPES = (("viral", 4000, 768), ("ava", 28672, 16384))


def filter_stamps() -> dict:
    """Where K7's stepping warps spend their cycles on the stage's own
    filter inputs at the viral and ava shapes, from the stamp build (the
    second of two launches): cycles an event of the tile loop (median and
    max over the groups), cycles from entry to the loop, and the kernel's
    SASS opcodes (the chain an event: FADD, FSETP, FSEL)."""
    import ctypes

    from ..sketch.device import _diff_filter_plain
    from .fill_loop_overhead import sass_ops

    lib = stamp_library("diff_filter", "RH_DF_STAMPS")
    out = {}
    for preset, l, e_cap in FILTER_SHAPES:
        ev, n_ev, diff = filter_inputs(preset, l, e_cap)
        b, e = ev.shape
        stamps = torch.zeros(4 * ((b + 31) // 32), dtype=torch.int64, device="cuda")
        keep = torch.empty((b, e), dtype=torch.bool, device="cuda")
        assert lib.rh_diff_set_stamps(ctypes.c_void_p(stamps.data_ptr())) == 0
        try:
            for _ in range(2):
                stamps.zero_()
                assert lib.rh_diff_filter(ev.data_ptr(), n_ev.data_ptr(), keep.data_ptr(),
                                          b, e, diff,
                                          torch.cuda.current_stream().cuda_stream) == 0
                torch.cuda.synchronize()
        finally:
            lib.rh_diff_set_stamps(None)
        st = stamps.view(-1, 4).cpu().numpy()
        st = st[st[:, 3] > 0]
        per_event = (st[:, 2] - st[:, 1]) / st[:, 3]
        out[preset] = {"shape": [b, e], "n_live": int(n_ev.max()),
                       "equal": bool(torch.equal(keep, _diff_filter_plain(ev, n_ev, diff))),
                       "loop_cycles_per_event": {"median": float(np.median(per_event)),
                                                 "max": float(per_event.max())},
                       "entry_to_loop_cycles": float(np.median(st[:, 1] - st[:, 0]))}
    from .._build import build
    out["sass"] = sass_ops(build(), "diff_filter_kernel")
    return out


# the dtw cell's widest call by columns, as chip_smoke.py's dtw phase
# counts it (`pairs_with_columns_at_least`): (lo, hi, pairs with lo to
# hi - 1 columns)
DTW_COLUMNS = ((2, 4, 28734), (4, 16, 5954), (16, 24, 1060), (24, 32, 364),
               (32, 64, 267), (64, 128, 21), (180, 181, 1))
DTW_THRESHOLDS = (8, 16, 24, 32, 48)


def dtw_cell_pairs(seed: int = 5) -> tuple:
    """(pairs, radii) shaped like the dtw cell's widest call: its column
    counts (DTW_COLUMNS, 36401 pairs), each pair's b up to a quarter
    shorter than its a, the radius a tenth of b (the presets'
    dtw_band_radius_frac) and at most 16, so the band has 33 slots."""
    rng = np.random.default_rng(seed)
    cols = np.concatenate([rng.integers(lo, hi, n) for lo, hi, n in DTW_COLUMNS])
    rng.shuffle(cols)
    pairs, radii = [], []
    for n in cols.tolist():
        m = max(1, n - int(rng.integers(0, n // 4 + 1)))
        pairs.append((rng.normal(0, 1, n).astype(np.float32),
                      rng.normal(0, 1, m).astype(np.float32)))
        radii.append(min(16, max(1, int(m * 0.1))))
    return pairs, radii


def dtw_paths(dev: str = "cuda") -> dict:
    """K8 on `dtw_cell_pairs`, packed as the host wrapper packs them: its
    device time (`device_ms`, 5 launches a graph) with the pairs of at
    least T columns on warps for each T of DTW_THRESHOLDS and with every
    pair on a thread, two rounds in turns (forward, then backward), the
    median of each; each run first held bit for bit against the plain
    version of the pairs padded."""
    from ..dtw import device as dd

    pairs, radii = dtw_cell_pairs()
    values, *ints, _ = dd.pack_pairs(pairs, radii)
    args = [torch.from_numpy(x).to(dev) for x in (values, *ints)]
    r = dd._pow2_at_least(max(radii), 4)
    a_len = args[2]
    longest = int(a_len.max())
    want = dd.dtw_banded_batch_plain(
        dd._pad_rows(args[0], args[1], a_len, longest), a_len,
        dd._pad_rows(args[0], args[3], args[4], longest), args[4], args[5],
        max_radius=r)
    cols = ints[1]
    runs = {f"T{t}": dict(threshold=t, long_pairs=int((cols >= t).sum()))
            for t in DTW_THRESHOLDS}
    runs["threads"] = dict(threshold=2 ** 30, long_pairs=0)
    equal = {name: bool(torch.equal(dd.dtw_banded_ragged(*args, max_radius=r, **kw), want))
             for name, kw in runs.items()}
    got = {name: [] for name in runs}
    for _ in range(2):
        for name, kw in (*runs.items(), *reversed(runs.items())):
            got[name].append(device_ms(
                lambda kw=kw: dd.dtw_banded_ragged(*args, max_radius=r, **kw), 5))
    return {"pairs": len(pairs), "columns": int(cols.sum()), "longest": longest,
            "width": 2 * r + 1, "equal": equal,
            "pairs_on_warps": {name: kw["long_pairs"] for name, kw in runs.items()},
            "device_ms": {name: float(np.median(t)) for name, t in got.items()}}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("kernel_time: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from ..signal import events

    print(card(), flush=True)
    if "--dtw" in argv:
        row = dtw_paths()
        print(json.dumps({"dtw_paths": row}), flush=True)
        return 0 if all(row["equal"].values()) else 1
    for l in SHAPES:
        print(json.dumps({"b": B, "l": l, "stage": stage_times(events, l),
                          "scans": scan_times(events, l),
                          "gen_peaks": peaks_times(events, l)}), flush=True)
    print(json.dumps({"host_us": host_pieces()}), flush=True)
    if "--probe" in argv:
        for l in SHAPES:
            print(json.dumps({"l": l, "probe_device_ms": scan_probe(l)}), flush=True)
            print(json.dumps({"l": l, "stamps": scan_stamps(l)}), flush=True)
        print(json.dumps({"filter_stamps": filter_stamps()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
