"""Build the port's CUDA sources (`csrc/*.cu`) into one shared library.

The library has a plain C interface and is loaded with ctypes, so the build
needs only `nvcc` (no PyTorch headers: seconds instead of minutes).  It is
built at first use and cached by a hash of the sources and flags under
`build/rawhash_tpu_torch/` at the repository root: one `nvcc -c` per source,
all started together, then one link.  Concurrent builds each write private
temp files and rename the library into place.

`load_host_library(name)` builds a kernel's header for the host with g++
(`csrc/<name>_host.cpp`, which includes `csrc/<name>.cuh`): the tests, and
the backtrack's bound, run the kernel's per-read logic from it.

`kernel(name, argtypes)` is the library's C entry `name`, which launches on
the stream it is given and returns a CUDA error code; `check_operand` is
the wrappers' check of an operand's type, shape, device and layout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "rawhash_tpu_torch"
# --fmad=false: the chaining score must round like the reference's separate
# f32 multiply and add (an FMA can move the truncated int32 score by 1)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC",
]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_HOST_LIBS: dict = {}
_FNS: dict = {}
# host builds of the kernels' headers; -ffp-contract=off keeps every f32
# multiply and add apart, as --fmad=false does on the card
HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
              f"-I{CSRC}"]


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, the PATH, or the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")


def library_path() -> Path:
    """Path of the cached library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"rawhash_tpu_torch_{h.hexdigest()[:16]}.so"


def _run(cmds) -> str:
    """Run the commands in parallel; their joined output, or raise."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[0]).name} failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile `csrc/*.cu` unless the cached library is current.  The
    compiler's register/shared-memory report lands beside it as `.log`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.tmp{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = so.with_name(f"{tag}.so")
    nvcc = nvcc_path()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(srcs, objs)])
        log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return so


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(str(build()))
        return _LIB


def load_host_library(name: str) -> ctypes.CDLL:
    """A kernel's header built for the host with g++: csrc/<name>_host.cpp
    (chain_backtrack: rh_bt_serial, rh_bt_rounds; events_peaks:
    rh_peaks_host; ordered_scan: rh_prefix_host, rh_sum_host,
    rh_scan_plan_host; diff_filter: rh_diff_filter_host; dtw_banded:
    rh_dtw_banded_host; fill_loop_probe: rh_probe_serial, rh_probe_warp,
    rh_probe_chain1), cached by a hash of its sources under
    build/rawhash_tpu_torch/host, loaded once per process."""
    with _LOCK:
        if name not in _HOST_LIBS:
            srcs = (CSRC / f"{name}_host.cpp", CSRC / f"{name}.cuh")
            h = hashlib.sha256(" ".join(HOST_FLAGS[:-1]).encode())
            for src in srcs:
                h.update(src.read_bytes())
            so = BUILD_DIR / "host" / f"{name}_host_{h.hexdigest()[:16]}.so"
            if not so.exists():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise RuntimeError(f"g++ not found: the host build of {name} needs it")
                so.parent.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.stem}.tmp{os.getpid()}.so")
                _run([[gxx, *HOST_FLAGS, str(srcs[0]), "-o", str(tmp)]])
                os.replace(tmp, so)
            _HOST_LIBS[name] = ctypes.CDLL(str(so))
        return _HOST_LIBS[name]


def kernel(name: str, argtypes: list):
    """The library's C entry `name` (it returns a CUDA error code), with its
    argument types set, once per process (after that, a dict read: the
    wrappers call it on every launch)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(load_library(), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        with _LOCK:
            fn = _FNS.setdefault(name, fn)
    return fn


def check_operand(fn: str, name: str, t, dtype, shape: tuple, device, *,
                  strided_rows: bool = False) -> None:
    """Raise ValueError unless tensor t has this dtype and shape, lies on
    device and is C-contiguous (with strided_rows, each row contiguous)."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} must be {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if strided_rows:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{fn}: {name} must have contiguous rows")
    elif not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
