"""Fill-loop-overhead probe: the cost of one serial ring step on the card.

Port of tools/profiling/fill_loop_overhead.py (the Pallas probe in its
`make`).  Each iteration chains k_ops integer max steps on every slot of a
W-slot ring per column, takes the column max and writes it to slot i % W:
a serial ring of dependent steps, as K1's anchor step and the backtrack's
walk step are.  The kernel (csrc/fill_loop_probe.cu) runs it the way this
card runs a serial ring best (the ring in registers up to W = 256, one
REDUX for the column max, the chain unrolled for the entry point's k_ops),
so its time per iteration is the floor those kernels' step times are
compared to; its bound is the critical path of k_ops dependent VIADDMNMX
and the column max an iteration, at latencies `measure_latencies` takes on
the card.  (Its first version timed K1's first skeleton instead: a
shared-memory ring and a 5-round shuffle max, which no kernel runs now.)

`fill_loop_probe` runs the kernel on CUDA tensors or raises; on CPU tensors
it runs `fill_loop_probe_plain`, the loop of the JAX body in PyTorch.  The
TPU probe ignores its input and starts from uninitialised scratch; here the
ring starts from x and the carry from INT32_MIN, so x = full(INT32_MIN)
gives what the Pallas interpreter gives.

    python -m rawhash_tpu_torch.profiling.fill_loop_overhead [iters]

prints the card's name and power limit, the card's latencies
(`measure_latencies`), then `k_ops=K: X us/iter (Y s total)` for K in 2,
20, 60 at W x B = 64 x 256 and `iters` iterations (default 100000), each
the best of 3 CUDA-event runs after a warm-up, with its bound, the
critical path's and the int32 rate's times.  It needs an NVIDIA GPU and
exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from .._build import build, load_library, nvcc_path
from .bounds import bound

W, B = 64, 256
K_OPS = (2, 20, 60)
INT32_MIN = -(2**31)
# a block holds the W-slot ring (4 bytes a slot) in the default 48 KB of shared memory
MAX_W = 48 * 1024 // 4

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        fn = load_library().rh_fill_loop_probe
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        _FN = fn
    return _FN


def fill_loop_probe_plain(x: torch.Tensor, n_iter: int, k_ops: int) -> torch.Tensor:
    """The probe's ring after n_iter iterations from ring = x, acc =
    INT32_MIN: each iteration chains r = max(r + 1, acc) k_ops times on
    every slot, sets acc to each column's max and writes it to row i % W."""
    w, b = x.shape
    ring = x.clone()
    acc = torch.full((1, b), INT32_MIN, dtype=torch.int32, device=x.device)
    rows = torch.arange(w, device=x.device)[:, None]
    for i in range(n_iter):
        r = ring
        for _ in range(k_ops):
            r = torch.maximum(r + 1, acc)
        acc = r.amax(dim=0, keepdim=True)
        ring = torch.where(rows == i % w, acc, r)
    return ring


def fill_loop_probe(x: torch.Tensor, n_iter: int, k_ops: int) -> torch.Tensor:
    """The probe's ring (i32 [W, B]) after n_iter iterations from x (i32
    [W, B]); see `fill_loop_probe_plain`."""
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"fill_loop_probe: x must be a contiguous 2-D int32 tensor, got "
            f"{x.dtype} {tuple(x.shape)}")
    w, b = x.shape
    if not 1 <= w <= MAX_W or b < 1:
        raise ValueError(f"fill_loop_probe: shape {(w, b)}: W must be in "
                         f"[1, {MAX_W}] and B >= 1")
    if n_iter < 0 or k_ops < 0:
        raise ValueError("fill_loop_probe: n_iter and k_ops must be >= 0")
    dev = x.device
    if dev.type == "cpu":
        return fill_loop_probe_plain(x, n_iter, k_ops)
    if dev.type != "cuda":
        raise ValueError(f"fill_loop_probe: unsupported device {dev}")
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(x.data_ptr(), out.data_ptr(), w, b, n_iter, k_ops, stream)
    if rc != 0:
        raise RuntimeError(f"fill_loop_probe kernel launch failed: CUDA error {rc}")
    fill_loop_probe.launches += 1
    return out


fill_loop_probe.launches = 0


# The latency kernels' counts (csrc/fill_loop_probe.cu: kLatK, kLatRedux,
# kLatSel, kRateThreads; lat_rate runs 4 chains a thread)
LAT_K, LAT_REDUX, LAT_SEL, RATE_THREADS, RATE_CHAINS = 60, 16, 16, 1024, 4
# the latency kernels' cycle counters before lat_rate's (SM, start, end)s
LAT_SLOTS = 10


def measure_latencies(n: int = 1024, n_rate: int = 64) -> dict:
    """The card's latencies in SM clock cycles, by clock64 in one warp
    (csrc/fill_loop_probe.cu: rh_probe_latencies), each from runs of n and
    2n iterations so that the fixed cost cancels: `viaddmnmx`, a dependent
    step r = max(r + 1, acc); `redux`, a dependent __reduce_max_sync;
    `shfl_colmax`, a column max of 5 __shfl_xor_sync rounds and maxes;
    `fsetp_plop3_sel`, an fp32 compare, a predicate op and a select in a
    row (the peak detector's kind of chain), from two probes of three
    compares and a select a step: `fsel_maj`, a step whose select takes
    the majority of the compares (FSETP -> FSETP -> FSETP -> PLOP3 -> FSEL,
    `sass_counts`'s "lat_fsel<maj>"), less two of its FSETPs, each priced
    at a quarter of `fsel_xor`, the step that takes their exclusive or
    (FSETP -> FSETP -> FSETP -> FSEL, "lat_fsel<xor>").
    `int32_per_sm_per_clock`: the steps every SM retires a clock with two
    blocks of 1024 threads, 4 independent chains a thread (the median over
    the SMs; `sms` of them ran blocks).  Needs a card."""
    fn = load_library().rh_probe_latencies
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dev = torch.device("cuda")
    blocks = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    inp = torch.arange(-16, 17, dtype=torch.int32, device=dev)
    out = torch.empty(blocks * RATE_THREADS, dtype=torch.int32, device=dev)
    cyc = torch.zeros(LAT_SLOTS + 3 * blocks, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = fn(inp.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, n_rate, blocks,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rh_probe_latencies launch failed: CUDA error {rc}")
    c = cyc.tolist()
    spans = {}  # SM -> (first clock, last clock, blocks)
    for k in range(blocks):
        sm, t0, t1 = c[LAT_SLOTS + 3 * k: LAT_SLOTS + 3 + 3 * k]
        lo, hi, nb = spans.get(sm, (t0, t1, 0))
        spans[sm] = (min(lo, t0), max(hi, t1), nb + 1)
    per_block = RATE_THREADS * RATE_CHAINS * LAT_K * n_rate
    rates = sorted(nb * per_block / (hi - lo) for lo, hi, nb in spans.values())
    return {"viaddmnmx": (c[1] - c[0]) / (n * LAT_K),
            "redux": (c[3] - c[2]) / (n * LAT_REDUX),
            "shfl_colmax": (c[5] - c[4]) / n,
            "fsel_maj": (c[7] - c[6]) / (n * LAT_SEL),
            "fsel_xor": (c[9] - c[8]) / (n * LAT_SEL),
            "fsetp_plop3_sel": ((c[7] - c[6]) - (c[9] - c[8]) / 2) / (n * LAT_SEL),
            "int32_per_sm_per_clock": rates[len(rates) // 2],
            "sms": len(spans)}


def probe_critical_path(n_iter: int, k_ops: int, w: int, lat: dict) -> float:
    """Cycles of the probe's chain of dependent instructions, k_ops kept
    unfolded: every iteration needs the last one's column max, so n_iter x
    (k_ops dependent steps + the column max).  The column max is a max over
    the SPL = ceil(W/32) slots a lane holds, ceil(log2 SPL) deep (a plain
    max priced at the step's latency), then a REDUX across the lanes."""
    spl = -(-w // 32)
    depth = (spl - 1).bit_length()
    return n_iter * ((k_ops + depth) * lat["viaddmnmx"] + lat["redux"])


def probe_bound(n_iter: int, k_ops: int, w: int = W, b: int = B,
                lat: dict | None = None) -> dict:
    """The probe's bound: x read and out written once (8 W B bytes), and
    W B (k_ops + 1) int32 instructions per iteration: per slot k_ops adds
    each fused with its max (Hopper's VIADDMNMX, as the kernel compiles) and
    the column max; with the card's latencies (`measure_latencies`), also
    its critical path (`probe_critical_path`)."""
    return bound(8.0 * w * b, int32=float(w * b * (k_ops + 1) * n_iter),
                 critical_path=None if lat is None else
                 probe_critical_path(n_iter, k_ops, w, lat))


def time_probe(n_iter: int, k_ops: int, w: int = W, b: int = B,
               reps: int = 3, lat: dict | None = None) -> dict:
    """Best of `reps` CUDA-event runs of the kernel from INT32_MIN, after a
    warm-up, with its bound."""
    x = torch.full((w, b), INT32_MIN, dtype=torch.int32, device="cuda")
    fill_loop_probe(x, n_iter, k_ops)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fill_loop_probe(x, n_iter, k_ops)
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e))
    return dict(w=w, b=b, n_iter=n_iter, k_ops=k_ops, ms=best,
                us_per_iter=best * 1e3 / max(n_iter, 1),
                **probe_bound(n_iter, k_ops, w, b, lat))


# the kernel instances (csrc/fill_loop_probe.cu, mangled): probe_regs<SPL,
# K> and probe_smem<K>, K = -1 for the k_ops read at run time
INSTANCE_RE = re.compile(r"(probe_regs|probe_smem)I((?:Li[n0-9]+E)+)E")
# integer max instructions of sm_90 SASS, the add-fused one (VIADDMNMX) included
MAX_RE = re.compile(r"\bV?I(?:ADD)?MNMX3?\b")
SASS_RES = {"max": MAX_RE, "redux": re.compile(r"\bREDUX\b"),
            "shfl": re.compile(r"\bSHFL\b"), "local": re.compile(r"\b(?:LDL|STL)\b"),
            "fsetp": re.compile(r"\bFSETP\b"), "plop3": re.compile(r"\bPLOP3\b"),
            "sel": re.compile(r"\bF?SEL\b")}


def sass_counts() -> dict:
    """Per kernel instance of the built library ("regs<SPL,K>",
    "smem<K>", K = -1 for the runtime k_ops) and per latency kernel
    ("lat_chain", ..., "lat_fsel<maj>", "lat_fsel<xor>"): its integer max
    instructions, REDUX, SHFL, local-memory loads and stores (LDL/STL),
    FSETP, PLOP3 and (F)SEL in the SASS.  Needs cuobjdump beside nvcc."""
    dump = subprocess.run(
        [str(Path(nvcc_path()).parent / "cuobjdump"), "-sass", str(build())],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    counts = {}
    for func in re.split(r"\n\s*Function : ", dump)[1:]:
        name = func.split("\n", 1)[0]
        m = INSTANCE_RE.search(name)
        if m:
            args = [int(a.replace("n", "-")) for a in re.findall(r"Li([n0-9]+)E", m.group(2))]
            key = f"{m.group(1)[6:]}<{','.join(map(str, args))}>"
        else:
            key = next((k for k in ("lat_chain", "lat_redux", "lat_shfl", "lat_rate")
                        if k in name), None)
            if "lat_fsel" in name:
                key = "lat_fsel<maj>" if "ILb1E" in name else "lat_fsel<xor>"
        if key:
            counts[key] = {k: len(r.findall(func)) for k, r in SASS_RES.items()}
    return counts


def sass_ops(library: Path, function: str) -> dict:
    """{opcode: count} of the SASS of every kernel of `library` whose
    mangled name holds `function` (the opcode without its modifiers, the
    predicate guard dropped).  Needs cuobjdump beside nvcc."""
    dump = subprocess.run(
        [str(Path(nvcc_path()).parent / "cuobjdump"), "-sass", str(library)],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    ops: dict = {}
    for func in re.split(r"\n\s*Function : ", dump)[1:]:
        if function not in func.split("\n", 1)[0]:
            continue
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", func):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0] if out else ""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_iter = int(argv[0]) if argv else 100_000
    if not torch.cuda.is_available():
        print("fill_loop_overhead: no CUDA device; the probe times an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(card())
    lat = measure_latencies()
    print("latencies (SM cycles): " + ", ".join(f"{k} {v}" for k, v in lat.items()))
    for k_ops in K_OPS:
        r = time_probe(n_iter, k_ops, lat=lat)
        print(f"k_ops={k_ops}: {r['us_per_iter']} us/iter ({r['ms'] / 1e3} s "
              f"total); bound {r['bound_ms']} ms ({r['bound_class']}); critical "
              f"path {r['class_ms']['critical_path']} ms, int32 "
              f"{r['class_ms']['int32']} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
