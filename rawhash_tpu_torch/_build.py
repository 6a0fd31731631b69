"""Build the port's CUDA sources (`csrc/*.cu`) into one shared library.

The library has a plain C interface and is loaded with ctypes, so the build
needs only `nvcc` (no PyTorch headers: seconds instead of minutes).  It is
built at first use and cached by a hash of the sources and flags under
`build/rawhash_tpu_torch/` at the repository root: one `nvcc -c` per source,
all started together, then one link.  Concurrent builds each write private
temp files and rename the library into place.
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
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
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
