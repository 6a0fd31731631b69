"""Fill-loop-overhead probe: K1's loop skeleton, timed on the card.

Port of tools/profiling/fill_loop_overhead.py (the Pallas probe in its
`make`).  The first port of the fill K1 ran one warp per read through a
serial chain of anchor steps over a W-slot ring in shared memory, scoring
all W slots a step with two 64-bit shuffle maxima; csrc/chain_fill.cu no
longer does (it steps segments through their in-band suffixes), but the
probe still measures that old skeleton.  It replaces each step's scoring
by k_ops integer max steps per slot: if the time per iteration stays flat
as k_ops grows, the loop, the shuffles and the carry dominate; if it grows
with k_ops, the operations themselves do.

`fill_loop_probe` runs csrc/fill_loop_probe.cu on CUDA tensors or raises;
on CPU tensors it runs `fill_loop_probe_plain`, the loop of the JAX body in
PyTorch.  The TPU probe ignores its input and starts from uninitialised
scratch; here the ring starts from x and the carry from INT32_MIN, so
x = full(INT32_MIN) gives what the Pallas interpreter gives.

    python -m rawhash_tpu_torch.profiling.fill_loop_overhead [iters]

prints the card's name and power limit, then `k_ops=K: X us/iter (Y s
total)` for K in 2, 20, 60 at W x B = 64 x 256 and `iters` iterations
(default 100000), each the best of 3 CUDA-event runs after a warm-up, with
its bound.  It needs an NVIDIA GPU and exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from .._build import CSRC, _run, build, load_library, nvcc_path
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


def probe_bound(n_iter: int, k_ops: int, w: int = W, b: int = B) -> dict:
    """The probe's bound: x read and out written once (8 W B bytes), and
    W B (k_ops + 1) int32 instructions per iteration: per slot k_ops adds
    each fused with its max (Hopper's VIADDMNMX, as the kernel compiles) and
    the column max.  The shuffles and the slot write are left out."""
    return bound(8.0 * w * b, int32=float(w * b * (k_ops + 1) * n_iter))


def time_probe(n_iter: int, k_ops: int, w: int = W, b: int = B,
               reps: int = 3) -> dict:
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
                **probe_bound(n_iter, k_ops, w, b))


# integer max instructions of sm_90 SASS, the add-fused one (VIADDMNMX) included
MAX_RE = re.compile(r"\bV?I(?:ADD)?MNMX3?\b")


def sass_max_counts() -> dict:
    """Integer max instructions in the compiler's output, to show the k_ops
    chain is not folded: in the probe kernel of the built library, and in
    the chain alone compiled with k_ops fixed at each of K_OPS (the count
    must grow with k_ops).  Needs nvcc and cuobjdump beside it."""
    bin_dir = Path(nvcc_path()).parent
    dump = subprocess.run(
        [str(bin_dir / "cuobjdump"), "-sass", str(build())],
        capture_output=True, text=True, check=True, timeout=300,
    ).stdout
    funcs = re.split(r"\n\s*Function : ", dump)
    probe = next(f for f in funcs if "fill_loop_probe" in f.split("\n", 1)[0])
    counts = {"kernel": len(MAX_RE.findall(probe))}
    src = ("#include \"fill_loop_probe.cuh\"\n"
           "__global__ void chain(int* r, int acc) {\n"
           "  r[threadIdx.x] = rh_probe_chain(r[threadIdx.x], acc, K_OPS);\n}\n")
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "chain.cu").write_text(src)
        _run([[nvcc_path(), "-arch=sm_90a", "-std=c++17", "-O3", "--fmad=false",
               f"-DK_OPS={k}", f"-I{CSRC}", "-cubin",
               "-o", f"{d}/chain{k}.cubin", f"{d}/chain.cu"] for k in K_OPS])
        for k in K_OPS:
            sass = subprocess.run(
                [str(bin_dir / "cuobjdump"), "-sass", f"{d}/chain{k}.cubin"],
                capture_output=True, text=True, check=True, timeout=300,
            ).stdout
            counts[f"k_ops={k}"] = len(MAX_RE.findall(sass))
    return counts


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
    for k_ops in K_OPS:
        r = time_probe(n_iter, k_ops)
        print(f"k_ops={k_ops}: {r['us_per_iter']} us/iter ({r['ms'] / 1e3} s "
              f"total); bound {r['bound_ms']} ms ({r['bound_class']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
