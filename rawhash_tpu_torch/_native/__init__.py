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
import threading

import numpy as np

from .._build import BUILD_DIR
from ..chain.regions import REGION_COLUMNS, Region

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False
# the threads of one process that first need the library build it once
_LOCK = threading.Lock()


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
    lib.rh_tail_decide_batch.restype = ctypes.c_int64
    lib.rh_tail_decide_batch.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, u8p, i32p,
        ctypes.c_int32,
        ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32,
        i64p, i64p, i32p, i32p, i32p,
    ]
    return lib


def get_lib():
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            try:
                _LIB = _build_lib()
            except Exception as e:  # no toolchain / build failure -> python path
                print(
                    f"[rawhash-tpu] native chain tail unavailable ({e}); "
                    "using the numpy fallback",
                    file=sys.stderr,
                )
                _LIB = None
            _TRIED = True
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


def _regions(rows: np.ndarray) -> list:
    """Region objects of the native pipeline's rows (REGION_COLUMNS)."""
    return [Region(**dict(zip(REGION_COLUMNS, r))) for r in rows.tolist()]


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
    return _regions(out[: n_keep * 20].reshape(n_keep, 20))


def tail_decide_batch(
    summ, scal, active, slen, span,
    mask_level, mask_len, hard_mask_level, alt_diff_frac,
    all_chains, pri_ratio, best_n, check_strand, min_strand_sc,
    min_chain_sc, min_mapq, w_bestq, w_bestmq, w_bestmc, w_threshold,
    min_chain_sc2,
):
    """A device-tail chunk's decisions for a whole batch in one native call,
    with the interpreter lock released: for every row that is active, has
    signal (slen > 0) and was processed, the read hash, the regions from
    the row's chain summaries (chain.regions.gen_regs_from_summaries,
    set_parent, select_sub), chain.regions.set_mapq and
    MappingEngine._decide's non-DTW branches.

    summ: [B, K, 10] i32 chain summaries; scal: [B, 8] i32 scalars (n_u,
    rep_len, n_ev, processed, ..., ev_offset, ...).  Returns (rows [N, 21]
    i64: REGION_COLUMNS then mapq, ids [N] i32, off [B], n_regs [B] (-1:
    row not decided), n_ids [B] (0: undecided)); a decided row's regions
    are rows[off:off + n_regs] and its mapped ids ids[off:off + n_ids].
    Raises without the native library."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("tail_decide_batch needs the native library")
    n_rows, k = summ.shape[:2]
    summ = np.ascontiguousarray(summ, dtype=np.int32)
    scal = np.ascontiguousarray(scal, dtype=np.int32)
    if scal.shape != (n_rows, 8) or summ.shape[2:] != (10,):
        raise ValueError(f"summaries {summ.shape} and scalars {scal.shape} "
                         "do not match")
    active = np.ascontiguousarray(active, dtype=np.bool_).view(np.uint8)
    slen = np.ascontiguousarray(slen, dtype=np.int32)
    if active.shape != (n_rows,) or slen.shape != (n_rows,):
        raise ValueError("active and slen need one entry a row")
    # room for every row's chains (a row keeps at most its n_u regions)
    cap = max(int(np.minimum(scal[:, 0], k).clip(0).sum()), 1)
    rows = np.empty((cap, len(REGION_COLUMNS) + 1), dtype=np.int64)
    ids = np.empty(cap, dtype=np.int32)
    off = np.empty(n_rows, dtype=np.int64)
    n_regs = np.empty(n_rows, dtype=np.int32)
    n_ids = np.empty(n_rows, dtype=np.int32)
    n = lib.rh_tail_decide_batch(
        np.int32(n_rows), np.int32(k), summ, scal, active, slen,
        np.int32(span),
        float(mask_level), np.int32(mask_len), np.int32(hard_mask_level),
        float(alt_diff_frac),
        np.int32(all_chains), float(pri_ratio), np.int32(best_n),
        np.int32(check_strand), np.int32(min_strand_sc),
        np.int32(min_chain_sc), np.int32(min_mapq),
        float(w_bestq), float(w_bestmq), float(w_bestmc), float(w_threshold),
        np.int32(min_chain_sc2),
        rows, off, n_regs, ids, n_ids,
    )
    return rows[:n], ids[:n], off, n_regs, n_ids
