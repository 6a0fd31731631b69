"""On-demand-built native (C++) host runtime components.

The TPU owns the compute path; the sequential host tail (chain backtracking
and compaction — the reference's pointer-walking loops, lchain.c:95-281) is
native C++ for throughput, compiled once with g++ and cached by source hash.
Falls back to the numpy implementation when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

from .._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _build_lib():
    srcs = [
        os.path.join(_HERE, "chain_tail.cpp"),
        os.path.join(_HERE, "index_build.cpp"),
    ]
    hasher = hashlib.sha256()
    for src in srcs:
        with open(src, "rb") as fp:
            hasher.update(fp.read())
    tag = hasher.hexdigest()[:16]
    cache = str(BUILD_DIR / "native")
    os.makedirs(cache, exist_ok=True)
    lib_path = os.path.join(cache, f"native_{tag}.so")
    if not os.path.exists(lib_path):
        tmp = lib_path + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            # strict float32: the quantizer must match numpy bit-for-bit,
            # so no FMA contraction
            "-march=native", "-ffp-contract=off",
            *srcs, "-o", tmp, "-lpthread",
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.rh_chain_tail.restype = ctypes.c_int32
    lib.rh_chain_tail.argtypes = [
        i32p, i32p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u64p, u64p,
        i64p, u64p, u64p, u64p, u64p,
        ctypes.POINTER(ctypes.c_int32),
    ]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rh_sketch_seq.restype = ctypes.c_int64
    lib.rh_sketch_seq.argtypes = [
        u8p, ctypes.c_int64,
        f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64,
        ctypes.c_void_p, u32p, u64p,
    ]
    lib.rh_sort_seeds.restype = None
    lib.rh_sort_seeds.argtypes = [u32p, u64p, ctypes.c_int64, ctypes.c_int32]
    lib.rh_rmq_fill.restype = None
    lib.rh_rmq_fill.argtypes = [
        u64p, u64p, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        i32p, i32p,
    ]
    lib.rh_gen_regions.restype = ctypes.c_int32
    lib.rh_gen_regions.argtypes = [
        ctypes.c_uint32, ctypes.c_int32,
        i64p, u64p, u64p,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        i64p,
    ]
    lib.rh_gen_regions_summ.restype = ctypes.c_int32
    lib.rh_gen_regions_summ.argtypes = [
        ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32,
        i32p,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        i64p,
    ]
    return lib


def get_lib():
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build_lib()
        except Exception as e:  # no toolchain / build failure -> python path
            print(
                f"[rawhash-tpu] native chain tail unavailable ({e}); "
                "using the numpy fallback",
                file=sys.stderr,
            )
            _LIB = None
    return _LIB


def sketch_seq_native(
    seq: bytes, pore_vals: np.ndarray, k: int, strand: int, sid: int,
    diff: float, w: int, e: int, q: int,
    fine_min: float, fine_max: float, fine_range: float,
    pos_offset: int = 0, want_sig: bool = False,
):
    """Native (sequence, strand) -> (hashes u32[N], y u64[N][, sig f32]).

    Bit-identical to pore.seq_to_sig + sketch.host.sketch_events_np
    (tested); returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(seq, dtype=np.uint8)
    n = arr.shape[0]
    m = max(n - k + 1, 0)
    hashes = np.empty(max(m, 1), dtype=np.uint32)
    ys = np.empty(max(m, 1), dtype=np.uint64)
    sig = np.empty(max(m, 1), dtype=np.float32) if want_sig else None
    if m == 0:
        out = (hashes[:0], ys[:0])
        return out + (sig[:0],) if want_sig else out
    pv = np.ascontiguousarray(pore_vals, dtype=np.float32)
    cnt = lib.rh_sketch_seq(
        np.ascontiguousarray(arr), np.int64(n),
        pv, np.int32(k), np.int32(strand), np.uint32(sid),
        float(diff), np.int32(w), np.int32(e), np.int32(q),
        float(fine_min), float(fine_max), float(fine_range),
        np.int64(pos_offset),
        sig.ctypes.data if want_sig else None, hashes, ys,
    )
    if want_sig:
        return hashes[:cnt], ys[:cnt], sig[:m]
    return hashes[:cnt], ys[:cnt]


def sort_seeds_native(hashes: np.ndarray, ys: np.ndarray, n_threads: int = 0):
    """In-place parallel sort of (hashes, ys) by (hash, y); returns False if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    assert hashes.flags["C_CONTIGUOUS"] and ys.flags["C_CONTIGUOUS"]
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.rh_sort_seeds(
        hashes, ys, np.int64(hashes.shape[0]), np.int32(n_threads)
    )
    return True


def chain_tail_native(f, p, ax, ay, min_cnt, min_sc, max_drop):
    """Native backtrack+compact; returns (u [(score,cnt)] target-sorted,
    bx, by, px, py) like chain.host.chain_backtrack+compact_chains."""
    lib = get_lib()
    if lib is None:
        return None
    n = f.shape[0]
    f = np.ascontiguousarray(f, dtype=np.int32)
    p32 = np.ascontiguousarray(p, dtype=np.int32)
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    u_out = np.zeros(2 * max(n, 1), dtype=np.int64)
    bx = np.zeros(max(n, 1), dtype=np.uint64)
    by = np.zeros(max(n, 1), dtype=np.uint64)
    px = np.zeros(max(n, 1), dtype=np.uint64)
    py = np.zeros(max(n, 1), dtype=np.uint64)
    n_v = ctypes.c_int32(0)
    n_u = lib.rh_chain_tail(
        f, p32, np.int32(n), np.int32(min_cnt), np.int32(min_sc),
        np.int32(max_drop), ax, ay, u_out, bx, by, px, py,
        ctypes.byref(n_v),
    )
    nv = int(n_v.value)
    u = u_out[: 2 * n_u].reshape(n_u, 2)
    return u, bx[:nv], by[:nv], px[:nv], py[:nv]


def rmq_fill_native(
    ax, ay, max_dist, max_dist_inner, bw, max_skip, cap_rmq_size,
    chn_pen_gap, chn_pen_skip,
):
    """Native RMQ chaining score fill; returns (f int32, p int32) like
    chain.rmq.lchain_rmq_fill_np, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(ax.shape[0])
    ax = np.ascontiguousarray(ax, dtype=np.uint64)
    ay = np.ascontiguousarray(ay, dtype=np.uint64)
    f = np.zeros(max(n, 1), dtype=np.int32)
    p = np.full(max(n, 1), -1, dtype=np.int32)
    lib.rh_rmq_fill(
        ax, ay, np.int32(n),
        np.int64(max_dist), np.int64(max_dist_inner), np.int64(bw),
        np.int64(max_skip), np.int64(cap_rmq_size),
        float(chn_pen_gap), float(chn_pen_skip), f, p,
    )
    return f[:n], p[:n]


def gen_regions_native(
    read_hash, u, bx, by,
    mask_level, mask_len, hard_mask_level, alt_diff_frac,
    do_select, pri_ratio, best_n, check_strand, min_strand_sc,
):
    """Native regions pipeline: gen_regs -> set_parent -> [select_sub+sync].
    Returns a list of chain.regions.Region (already pruned), or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..chain.regions import Region

    n_u = int(u.shape[0])
    if n_u == 0:
        return []
    u64 = np.ascontiguousarray(u.reshape(-1), dtype=np.int64)
    bx = np.ascontiguousarray(bx, dtype=np.uint64)
    by = np.ascontiguousarray(by, dtype=np.uint64)
    out = np.zeros(n_u * 20, dtype=np.int64)
    n_keep = lib.rh_gen_regions(
        ctypes.c_uint32(read_hash & 0xFFFFFFFF), np.int32(n_u),
        u64, bx, by,
        float(mask_level), np.int32(mask_len), np.int32(hard_mask_level),
        float(alt_diff_frac),
        np.int32(do_select), float(pri_ratio), np.int32(best_n),
        np.int32(check_strand), np.int32(min_strand_sc),
        out,
    )
    rows = out[: n_keep * 20].reshape(n_keep, 20)
    return [
        Region(
            id=int(r[0]), parent=int(r[1]), score=int(r[2]), score0=int(r[3]),
            hash=int(r[4]), cnt=int(r[5]), as_=int(r[6]), rev=int(r[7]),
            rid=int(r[8]), rs=int(r[9]), re=int(r[10]), qs=int(r[11]),
            qe=int(r[12]), mlen=int(r[13]), blen=int(r[14]), n_sub=int(r[15]),
            subsc=int(r[16]), inv=int(r[17]), is_alt=int(r[18]),
            strand_retained=int(r[19]),
        )
        for r in rows
    ]


def gen_regions_summ_native(
    read_hash, summ, span,
    mask_level, mask_len, hard_mask_level, alt_diff_frac,
    do_select, pri_ratio, best_n, check_strand, min_strand_sc,
):
    """Native regions pipeline from the device tail's per-chain summary
    rows ([n_u, 10] i32): gen_regs_from_summaries -> set_parent ->
    [select_sub+sync], pruning BEFORE any Python Region object exists —
    at 100 Mbp widths a chunk carries ~600k live chains and the Python
    object construction alone cost seconds.  Returns a Region list or
    None without the native toolchain."""
    lib = get_lib()
    if lib is None:
        return None
    from ..chain.regions import Region

    n_u = int(summ.shape[0])
    if n_u == 0:
        return []
    summ = np.ascontiguousarray(summ, dtype=np.int32)
    out = np.zeros(n_u * 20, dtype=np.int64)
    n_keep = lib.rh_gen_regions_summ(
        ctypes.c_uint32(read_hash & 0xFFFFFFFF), np.int32(n_u),
        np.int32(span), summ,
        float(mask_level), np.int32(mask_len), np.int32(hard_mask_level),
        float(alt_diff_frac),
        np.int32(do_select), float(pri_ratio), np.int32(best_n),
        np.int32(check_strand), np.int32(min_strand_sc),
        out,
    )
    rows = out[: n_keep * 20].reshape(n_keep, 20)
    return [
        Region(
            id=int(r[0]), parent=int(r[1]), score=int(r[2]), score0=int(r[3]),
            hash=int(r[4]), cnt=int(r[5]), as_=int(r[6]), rev=int(r[7]),
            rid=int(r[8]), rs=int(r[9]), re=int(r[10]), qs=int(r[11]),
            qe=int(r[12]), mlen=int(r[13]), blen=int(r[14]), n_sub=int(r[15]),
            subsc=int(r[16]), inv=int(r[17]), is_alt=int(r[18]),
            strand_retained=int(r[19]),
        )
        for r in rows
    ]
