"""The table of an NVIDIA H100 SXM's peaks and K1's (the chaining fill's)
work and least time: a frozen copy of the port's
rawhash_tpu_torch/profiling/bounds.py (`bound`, `FILL_COST`, `fill_work`,
`fill_ops`, `sm_clock`) as it stood when the benchmark was defined, so that
a change to the port cannot move the roofline the benchmark reads.
tests/test_rhbench_frozen.py holds it equal to the port's at a small size.

Each class of work is priced at its own rate and the bound is the largest
of the times: device-memory bytes at 3.35 TB/s (the data sheet); per SM and
clock on compute capability 9.0 (the CUDA C++ programming guide's
arithmetic-instruction throughput table) 128 fp32 adds or multiplies, 64
int32 operations, 16 conversions, 64 fp32 compares; over 132 SMs at the
clock nvidia-smi reports as clocks.max.sm (the data sheet's 1980 MHz boost
where that cannot be read).
"""

from __future__ import annotations

import functools
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
SMS = 132
PER_SM_PER_CLOCK = {"fp32": 128, "int32": 64, "cvt": 16, "fp32_minmax": 64}
BOOST_HZ = 1.98e9


@functools.cache
def sm_clock() -> tuple[float, str]:
    """(SM clock in Hz, where it came from)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60,
        )
        return float(out.stdout.split()[0]) * 1e6, "nvidia-smi clocks.max.sm"
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return BOOST_HZ, "data sheet boost clock"


def bound(nbytes: float, critical_path: float | None = None, **ops: float) -> dict:
    """The largest of the bytes over the memory rate and each class of
    operations over its own rate (and, where given, a critical path in
    cycles at the SM clock): {bound_ms, bound_class, class_ms}."""
    hz = sm_clock()[0]
    ms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    for cls, n in ops.items():
        ms[cls] = n / (SMS * PER_SM_PER_CLOCK[cls] * hz) * 1e3
    if critical_path is not None:
        ms["critical_path"] = critical_path / hz * 1e3
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_class": by, "class_ms": ms}


# K1's instructions for one (anchor, predecessor) pair, by how far the
# kernel's pair function takes the pair (the port's csrc/chain_fill.cuh, as
# nvcc 12.8 compiles it for sm_90a); loads, loop control and reductions are
# left out, so the bound stays a lower one.
FILL_COST = {
    "tested": {"int32": 5},
    "in_band": {"int32": 13},
    "scored": {"int32": 10},
    "penalised": {"int32": 2, "fp32": 4, "cvt": 3},
    "logged": {"int32": 6, "fp32": 6, "cvt": 2},
}


def fill_work(key, tpos, qpos, n_anchors, *, q_span, max_dist_t, max_dist_q,
              bw, max_iter, **_) -> dict:
    """Counts of the (anchor i, predecessor j) pairs, i < n_anchors,
    i - max_iter <= j < i, j >= 0, that K1's function needs on these
    inputs, by the furthest step each reaches: `tested` the in-band suffix
    of each window and the one predecessor that ends its scan, `in_band`
    and later steps the pairs in band; `unsorted` the pairs in band past a
    pair out of band (none on sorted rows).  Counted with tensor operations
    on the inputs' device, one window offset at a time, the distance limits
    clamped to >= bw."""
    mdt, mdq = max(max_dist_t, bw), max(max_dist_q, bw)
    b, n = key.shape
    live = torch.arange(n, device=key.device)[None, :] < n_anchors[:, None]
    run = live.clone()
    counts = {k: torch.zeros((), dtype=torch.int64, device=key.device)
              for k in (*FILL_COST, "unsorted")}
    for d in range(1, min(max_iter, n - 1) + 1):
        on = run[:, d:]
        dr = tpos[:, d:] - tpos[:, :-d]
        dq = qpos[:, d:] - qpos[:, :-d]
        in_band = (live[:, d:] & (key[:, d:] == key[:, :-d]) & (dr >= 0)
                   & (dr <= mdt))
        dd = (dr - dq).abs()
        scored = (in_band & (dq > 0) & (dq <= mdq) & (dr != 0) & (dr <= mdq)
                  & (dd <= bw))
        penalised = scored & ((dd != 0) | (torch.minimum(dr, dq) > q_span))
        for name, mask in (("tested", on), ("unsorted", in_band & ~on),
                           ("in_band", in_band), ("scored", scored),
                           ("penalised", penalised),
                           ("logged", scored & (dd != 0))):
            counts[name] = counts[name] + mask.sum()
        run[:, d:] = on & in_band
    return {k: int(v) for k, v in counts.items()}


def fill_ops(work: dict) -> dict:
    """Operations by class for K1's pair counts (`fill_work`)."""
    ops = {"int32": 0.0, "fp32": 0.0, "cvt": 0.0}
    for step, cost in FILL_COST.items():
        for cls, per in cost.items():
            ops[cls] += per * work[step]
    return ops


def fill_bytes(n_live: int, b: int, n: int) -> float:
    """K1's device-memory bytes for a [b, n] call with n_live live anchors
    in all (as the port's chip_smoke.py::fill_bound counts them): key, tpos
    and qpos read for the live anchors, n_anchors read, f and p written for
    every slot."""
    return 12.0 * n_live + 4 * b + 8.0 * b * n
