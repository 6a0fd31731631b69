#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rawhash_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printed as one JSON line and each fatal on failure:
  1. build     the CUDA kernels from rawhash_tpu_torch/csrc with nvcc, one
               process per source, in parallel
  2. k1        chain_fill kernel vs the plain PyTorch fill on the card
               (B=256, N in {4096, 16384}, W=200, viral and sensitive
               parameters): f and p must be bit-equal; kernel timed (median
               of 7), the plain fill timed once
  3. backtrack chain_backtrack kernel vs its plain version on f/p from K1
               (sensitive): B=256 N=16384 (the D2 regime), B=32 N=40960
               (past 32768, the K3 regime), B=64 N=4096 with k_cap 4
               (chains lost to k_cap); all ten outputs, the compacted
               summaries and the carried prefix bit-equal; kernel timed
               (median of 7), the plain version once (on CPU copies)
  4. loops     time the plain stages' stepped loops (_gen_peaks, _diff_filter)
  5. fixture   the CLI (`python -m rawhash_tpu_torch`) on a small fixture,
               --device cuda vs --device cpu: same mapped reads, same PAF
               columns 1, 5 and 6, column 8 within 20; and on cuda with
               RAWHASH_TPU_DEVICE_TAIL=1: PAF columns 1-12 of the mapped
               rows equal to the host tail's
  6. d1        SARS-CoV-2-sized deployment: 30 kb genome, viral preset,
               5 x 256 reads of 1200 bases; stays on the host tail
  7. d2        E. coli-sized deployment: 5 Mbp genome, sensitive preset,
               2 x 256 reads of 2500 bases, --max-anchors 16384; switches
               to the device tail
  8. d4        100 Mbp deployment: genome from seed 13, sensitive preset,
               1 x 256 reads of 3000 bases, default --max-anchors (4096)
               and --max-anchor-cap (2^17); the device tail at backtrack
               widths past 32768
  9. d4_kernels both kernels on the inputs d4's main path gave them (its
               widest device-tail call, caught during the run): timed at
               that whole shape (median of 5), and 8 of its rows at full
               width held bit for bit against the plain fill and the plain
               backtrack (all ten outputs, compaction, carried prefix) on
               CPU copies, each plain version timed once
Phases 5-8 are the main-path run: each resets the kernels' launch counters
just before it and reads them just after; every kernel must have launched
in it.  Phases 6-8 need >= 95% of reads mapped at accuracy >= 0.95 (strand
right, mapped target interval inside the read's true interval +/- 200).
The line before the card's line lists every kernel with its launches, error
and times beside its bound; the last line is {"ok": true, "device": ...}.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): device memory bytes/s, and float32 /
# int32 operations per second on the CUDA cores (no tensor cores here)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, timed with CUDA events.
    The caller has run fn once already (the warm-up)."""
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def timed_once(torch, fn):
    """(result, milliseconds) of one call of fn, timed with CUDA events."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def spy(mod, name, record):
    """Wrap mod.name so that each call first hands (name, the original, its
    arguments, keyword arguments) to record; returns the original, which
    the caller puts back."""
    fn = getattr(mod, name)

    def wrapper(*a, **k):
        record(name, fn, a, k)
        return fn(*a, **k)
    setattr(mod, name, wrapper)
    return fn


def clustered_anchors(seed: int, b: int, n: int):
    """Sorted anchors along one diagonal per strand, from a numpy seed:
    (key bits, tpos, qpos, n_anchors), the k1 and backtrack inputs."""
    rng = np.random.default_rng(seed)
    tpos = np.sort(rng.integers(0, 4 * n, (b, n)), axis=1).astype(np.int32)
    qpos = (tpos // 2 + rng.integers(-20, 20, (b, n))).clip(0).astype(np.int32)
    key = np.sort(rng.integers(0, 2, (b, n)).astype(np.uint32) << 31, axis=1)
    n_anchors = rng.integers(n // 2, n + 1, b).astype(np.int32)
    return key.view(np.int32), tpos, qpos, n_anchors


def fill_bound(n_anchors: np.ndarray, n: int, w: int) -> dict:
    """K1's bound from this run's inputs: key/tpos/qpos read for the live
    anchors, f/p written for all n slots; ~6 integer operations (the band
    test) for every (anchor, window predecessor) pair."""
    na = n_anchors.astype(np.float64)
    pairs = float(np.sum(np.minimum(na, w) * (np.minimum(na, w) - 1) / 2
                         + np.maximum(na - w, 0) * w))
    return bound(12 * na.sum() + 4 * na.size + 8 * na.size * n, 6 * pairs)


def phase_k1(torch, dev) -> list:
    """Kernel vs plain fill on clustered anchors from a numpy seed."""
    from rawhash_tpu_torch.chain.device import chain_fill_batch
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import options

    results = []
    for preset in ("viral", "sensitive"):
        prm = fill_params(*options(preset))
        for n in (4096, 16384):
            b = 256
            host = clustered_anchors(n, b, n)
            args = [torch.from_numpy(x).to(dev) for x in host]
            f, p = chain_fill(*args, **prm)  # also the timing's warm-up
            (f0, p0), plain_ms = timed_once(
                torch, lambda: chain_fill_batch(*args, **prm))
            err = max(int((f - f0).abs().max()), int((p - p0).abs().max()))
            check(torch.equal(f, f0) and torch.equal(p, p0),
                  f"k1 {preset} N={n}: kernel disagrees with the plain fill "
                  f"(max abs err {err})")
            ms = cuda_ms(torch, lambda: chain_fill(*args, **prm), 7)
            row = dict(preset=preset, b=b, n=n, w=prm["max_iter"],
                       anchors=int(host[3].sum()), max_abs_err=err,
                       ms=ms, plain_ms=plain_ms,
                       **fill_bound(host[3], n, prm["max_iter"]))
            emit({"phase": "k1", **row})
            results.append(row)
    return results


def backtrack_bound(n_anchors, n_u, n_v) -> dict:
    """The backtrack's bound from this run's inputs and outputs: the
    candidate order (f, idx) and f, p, tpos, qpos read for every live anchor
    (24 B), v written for every claimed anchor (4 B), the six chain rows for
    every kept chain (24 B), and the read's counts (16 B); ~10 integer
    operations per live anchor (a candidate visit, a walk step and a claim
    step of a few each), far under the bytes."""
    na, n_u, n_v = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)
                    for x in (n_anchors, n_u, n_v))
    return bound(24 * na.sum() + 4 * n_v.sum() + 24 * n_u.sum() + 16 * na.size,
                 10.0 * na.sum())


def check_backtrack(torch, label, inputs, key, got, *, bt, k_cap, p_out) -> tuple:
    """Hold the kernel's ten outputs `got` (on the card) against the plain
    version on CPU copies of `inputs` (f, p, n_anchors, tpos, qpos), and the
    compaction of each (summaries of the live chains, carried prefix).
    Returns (max abs error, plain ms).

    The plain lockstep takes ~3N steps of ~150 small ops: on the card
    (launch-bound) it ran 102 s at N=16384 and 205 s at N=40960 on an H100
    80GB HBM3 at 700 W, so it runs on CPU copies of the same tensors (~4x
    faster)."""
    from rawhash_tpu_torch.chain.backtrack import compact_from_chain_stats
    from rawhash_tpu_torch.chain.backtrack_device import (
        backtrack_plain, compact_batch,
    )

    _, _, _, tpos, qpos = inputs
    asc, _, summ = compact_from_chain_stats(
        *got[:2], *got[6:], got[2], got[3], got[4], key, tpos, qpos,
        p_out=p_out)
    got, asc, summ = ([t.cpu() for t in got], asc.cpu(), summ.cpu())
    cpu_in = [t.cpu() for t in inputs]
    t0 = time.perf_counter()
    want = backtrack_plain(*cpu_in, **bt, k_cap=k_cap)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((a.long() - c.long()).abs().max()) for a, c in zip(want, got))
    check(all(torch.equal(a, c) for a, c in zip(want, got)),
          f"{label}: kernel disagrees with the plain version (max abs err {err})")
    asc_b, _, summ_b = compact_batch(*want[:5], key.cpu(), *cpu_in[3:],
                                     q_span=bt["q_span"])
    n_u, n_v = got[2], got[4]
    po = min(p_out, asc_b.shape[1])  # past the width, asc is padding
    live = torch.arange(k_cap)[None, :] < n_u[:, None]
    pre = torch.arange(po)[None, :] < n_v.clamp(max=po)[:, None]
    check(torch.equal(summ[live], summ_b[live])
          and torch.equal(asc[:, :po][pre], asc_b[:, :po][pre]),
          f"{label}: compacted summaries or carried prefix differ between "
          "the kernel's chain stats and the plain version")
    return err, plain_ms


def backtrack_params(mo, prm) -> dict:
    return dict(min_cnt=mo.min_num_anchors, min_sc=mo.min_chaining_score,
                max_drop=mo.bw, q_span=prm["q_span"])


def phase_backtrack(torch, dev) -> list:
    """The backtrack kernel vs its plain version on f/p from K1, and the
    compaction of each."""
    from rawhash_tpu_torch.chain.backtrack import candidates, chain_backtrack
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import options

    io, mo = options("sensitive")
    prm = fill_params(io, mo)
    bt = backtrack_params(mo, prm)
    results = []
    for b, n, k_cap in ((256, 16384, 1024), (32, 40960, 1024), (64, 4096, 4)):
        args = [torch.from_numpy(x).to(dev) for x in clustered_anchors(n, b, n)]
        key, tpos, qpos, n_anchors = args
        f, p = chain_fill(*args, **prm)
        inputs = (f, p, n_anchors, tpos, qpos)
        got = chain_backtrack(*inputs, **bt, k_cap=k_cap)  # the warm-up
        err, plain_ms = check_backtrack(
            torch, f"backtrack B={b} N={n}", inputs, key, got, bt=bt,
            k_cap=k_cap, p_out=min(4096, n))
        ms = cuda_ms(torch, lambda: chain_backtrack(*inputs, **bt, k_cap=k_cap), 7)
        sort_ms = cuda_ms(torch, lambda: candidates(f, n_anchors), 7)
        row = dict(b=b, n=n, k_cap=k_cap, anchors=int(n_anchors.sum()),
                   n_u_max=int(got[2].max()), n_v_max=int(got[4].max()),
                   chain_overflow=int(got[5].sum()), max_abs_err=err, ms=ms,
                   sort_ms=sort_ms, plain_ms=plain_ms, plain_device="cpu",
                   **backtrack_bound(n_anchors, got[2], got[4]))
        emit({"phase": "backtrack", **row})
        results.append(row)
        if k_cap < 10:
            check(row["chain_overflow"] > 0, "backtrack: k_cap 4 lost no chain")
    return results


def phase_d4_kernels(torch, caught, rows: int = 8) -> dict:
    """Both kernels on the inputs D4's main path gave them: the widest
    tail_finish call of the d4 run, caught there.  The kernels are timed at
    that whole shape; `rows` of its rows (the widest, the narrowest and
    others evenly between them by width), at full width, are held bit for
    bit against the plain fill and the plain backtrack on CPU copies."""
    from rawhash_tpu_torch.chain.backtrack import candidates, chain_backtrack
    from rawhash_tpu_torch.chain.device import chain_fill_batch
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import options

    io, mo = options("sensitive")
    prm = fill_params(io, mo)
    bt = backtrack_params(mo, prm)
    out, k_cap, p_out = caught["out"], caught["k_cap"], caught["p_out"]
    b, n = out.f.shape
    na = out.n_anchors.cpu().numpy()
    sel = np.argsort(-na, kind="stable")[np.linspace(0, b - 1, rows).astype(int)]
    idx = torch.as_tensor(sel, device=out.f.device)
    fill_in = (out.key, out.tpos, out.qpos, out.n_anchors)

    # K1: the main path's f/p against the plain fill on the chosen rows
    f, p = chain_fill(*fill_in, **prm)  # also the timing's warm-up
    check(torch.equal(f, out.f) and torch.equal(p, out.p),
          "d4: the fill gave another f/p on the same inputs")
    t0 = time.perf_counter()
    f0, p0 = chain_fill_batch(*(t[idx].cpu() for t in fill_in), **prm)
    fill_plain_ms = (time.perf_counter() - t0) * 1e3
    f_r, p_r = out.f[idx].cpu(), out.p[idx].cpu()
    fill_err = max(int((f_r - f0).abs().max()), int((p_r - p0).abs().max()))
    check(torch.equal(f_r, f0) and torch.equal(p_r, p0),
          f"d4: fill kernel disagrees with the plain fill (max abs err {fill_err})")
    fill_ms = cuda_ms(torch, lambda: chain_fill(*fill_in, **prm), 5)

    # K3: the main path's backtrack inputs, the kernel's outputs on the
    # chosen rows against the plain version
    inputs = (out.f, out.p, out.n_anchors, out.tpos, out.qpos)
    got = chain_backtrack(*inputs, **bt, k_cap=k_cap)  # the warm-up
    bt_err, bt_plain_ms = check_backtrack(
        torch, f"d4 backtrack {rows}x{n}", [t[idx] for t in inputs],
        out.key[idx], [t[idx] for t in got], bt=bt, k_cap=k_cap, p_out=p_out)
    bt_ms = cuda_ms(torch, lambda: chain_backtrack(*inputs, **bt, k_cap=k_cap), 5)
    sort_ms = cuda_ms(torch, lambda: candidates(out.f, out.n_anchors), 5)
    res = dict(
        b=b, n=n, k_cap=k_cap, p_out=p_out, anchors=int(na.sum()),
        anchors_max=int(na.max()), plain_rows=rows, plain_device="cpu",
        plain_rows_anchors=[int(na[r]) for r in sel],
        fill=dict(ms=fill_ms, plain_ms=fill_plain_ms, max_abs_err=fill_err,
                  **fill_bound(na, n, prm["max_iter"])),
        backtrack=dict(ms=bt_ms, sort_ms=sort_ms, plain_ms=bt_plain_ms,
                       max_abs_err=bt_err, n_u_max=int(got[2].max()),
                       n_v_max=int(got[4].max()),
                       chain_overflow=int(got[5].sum()),
                       **backtrack_bound(na, got[2], got[4])),
    )
    emit({"phase": "d4_kernels", **res})
    return res


def phase_loops(torch, dev) -> dict:
    """Time the two stepped loops of the plain stages, the candidates for the
    next kernels, at the main path's shapes (256 reads, one 4000-sample
    chunk, viral preset): the event detector's _gen_peaks and the sketch's
    _diff_filter.  Their arguments are caught from one events+sketch call."""
    from rawhash_tpu_torch.signal import events as ev
    from rawhash_tpu_torch.sketch import device as sk
    from rawhash_tpu_torch.synthetic import options

    io, mo = options("viral")
    rng = np.random.default_rng(3)
    b, l = 256, mo.chunk_size
    levels = rng.normal(90.0, 12.0, size=(b, l // 9 + 1))
    sig = np.repeat(levels, 9, axis=1)[:, :l] + rng.normal(0, 1.0, (b, l))
    sig = torch.from_numpy(sig.astype(np.float16)).to(dev).to(torch.float32)
    slen = torch.full((b,), l, dtype=torch.int32, device=dev)
    caught = {}

    def keep(name, fn, a, k):
        caught[name] = (fn, a, k)

    originals = {(ev, "_gen_peaks"): spy(ev, "_gen_peaks", keep),
                 (sk, "_diff_filter"): spy(sk, "_diff_filter", keep)}
    try:
        events, n_ev, _ = ev.detect_events_batch(
            sig, slen, ev.NormCarry.zeros(b, dev),
            window_length1=mo.window_length1, window_length2=mo.window_length2,
            threshold1=mo.threshold1, threshold2=mo.threshold2,
            peak_height=mo.peak_height, e_cap=mo.max_events_per_chunk,
        )
        sk.sketch_batch(events, n_ev, diff=io.diff, w=io.w, e=io.e, q=io.q,
                        k=io.k, fine_min=io.fine_min, fine_max=io.fine_max,
                        fine_range=io.fine_range)
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    out = {"b": b, "l": l, "e_cap": mo.max_events_per_chunk,
           "mean_events": float(n_ev.float().mean())}
    for name, (fn, a, k) in caught.items():
        out[f"{name}_ms"] = cuda_ms(torch, lambda: fn(*a, **k), 3)
    emit({"phase": "loops", **out})
    return out


def phase_fixture(d: Path) -> dict:
    from rawhash_tpu_torch.cli import main as cli
    from rawhash_tpu_torch.synthetic import write_fixture

    write_fixture(d)
    out = {}
    for preset in ("sensitive", "viral"):
        idx = d / f"ref_{preset}.rhi.npz"
        rc = cli(["-x", preset, "-p", str(d / "pore.model"), "-d", str(idx),
                  str(d / "ref.fa"), "--device", "cuda"])
        check(rc == 0, f"fixture index build failed ({rc})")
        pafs = {}
        for run, device in (("cuda", "cuda"), ("cpu", "cpu"), ("cuda_tail", "cuda")):
            paf = d / f"{preset}_{run}.paf"
            if run == "cuda_tail":
                os.environ["RAWHASH_TPU_DEVICE_TAIL"] = "1"
            t0 = time.perf_counter()
            try:
                rc = cli(["-x", preset, "--max-anchors", "512", str(idx),
                          str(d / "reads.sig.npz"), "--device", device,
                          "-o", str(paf)])
            finally:
                os.environ.pop("RAWHASH_TPU_DEVICE_TAIL", None)
            check(rc == 0, f"fixture mapping ({run}) failed ({rc})")
            pafs[run] = ([l.split("\t") for l in paf.read_text().splitlines()],
                         time.perf_counter() - t0)
        rows = {run: {c[0]: c for c in cols if c[4] in "+-"}
                for run, (cols, _) in pafs.items()}
        diffs = []
        for name in sorted(set(rows["cuda"]) | set(rows["cpu"])):
            a, c = rows["cuda"].get(name), rows["cpu"].get(name)
            if a is None or c is None or a[:12] != c[:12]:
                diffs.append({"read": name, "cuda": a and a[:12], "cpu": c and c[:12]})
        tail_same = ({n: r[:12] for n, r in rows["cuda_tail"].items()}
                     == {n: r[:12] for n, r in rows["cuda"].items()})
        emit({"phase": "fixture", "preset": preset,
              "mapped_cuda": len(rows["cuda"]), "mapped_cpu": len(rows["cpu"]),
              "mapped_cuda_device_tail": len(rows["cuda_tail"]),
              "device_tail_equals_host_tail": tail_same,
              "seconds_cuda": pafs["cuda"][1], "seconds_cpu": pafs["cpu"][1],
              "seconds_cuda_device_tail": pafs["cuda_tail"][1],
              "differences": diffs})
        check(set(rows["cuda"]) == set(rows["cpu"]), "fixture: mapped sets differ")
        for name, a in rows["cuda"].items():
            c = rows["cpu"][name]
            check(a[0] == c[0] and a[4] == c[4] and a[5] == c[5],
                  f"fixture: PAF columns 1/5/6 differ for {name}")
            check(abs(int(a[7]) - int(c[7])) <= 20,
                  f"fixture: PAF column 8 differs by > 20 for {name}")
        check(tail_same, "fixture: the device tail's PAF columns 1-12 differ "
              "from the host tail's on cuda")
        out[preset] = len(rows["cuda"])
    return out


def phase_deployment(torch, dev, name, genome_len, preset, n_batches,
                     read_len, max_anchors, seed, caught=None) -> dict:
    """Build the index and map n_batches x 256 simulated reads on the card
    through the engine's streaming entry point.  With a dict `caught`, the
    widest device-tail call of the run (its ChunkOut `out`, `k_cap` and
    `p_out`) is kept there."""
    from rawhash_tpu_torch.chain.backtrack import chain_backtrack
    from rawhash_tpu_torch.map import engine as eng_mod
    from rawhash_tpu_torch.synthetic import deployment

    t0 = time.perf_counter()
    setup = {}
    index, mopt, reads = deployment(genome_len, preset, n_batches * 256,
                                    read_len, max_anchors, seed, seconds=setup)
    t_setup = time.perf_counter() - t0
    batches = [[(n, s) for n, s, _, _ in reads[i:i + 256]]
               for i in range(0, len(reads), 256)]
    engine = eng_mod.MappingEngine(index, mopt, device=dev)

    def widest(_, fn, a, k):
        if "out" not in caught or a[0].f.shape[1] >= caught["out"].f.shape[1]:
            caught.update(out=a[0], k_cap=k["k_cap"], p_out=k["p_out"])

    original = spy(eng_mod, "tail_finish", widest) if caught is not None else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        results = [r for batch in engine.map_stream(batches) for r in batch]
    finally:
        if original is not None:
            eng_mod.tail_finish = original
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    n_mapped = n_correct = 0
    bases = 0.0
    for (_, _, start, strand), res in zip(reads, results):
        rec = res.records[0]
        ci = int(next(t[5:] for t in rec.tags.split("\t") if t.startswith("ci:i:")))
        bases += ci * mopt.chunk_size / mopt.sample_per_base
        if rec.mapped:
            n_mapped += 1
            lo, hi = rec.frag_start, rec.frag_start + rec.frag_len
            n_correct += (rec.rev == strand and lo >= start - 200
                          and hi <= start + read_len + 200)
    row = dict(
        reads=len(reads), mapped=n_mapped,
        mapped_frac=n_mapped / len(reads),
        accuracy=n_correct / max(n_mapped, 1),
        seconds=dt, bp_per_s=bases / dt, reads_per_s=len(reads) / dt,
        setup_s=t_setup, genome_s=setup["genome"], index_build_s=setup["index"],
        reads_s=setup["reads"], index_seeds=index.n_seeds,
        index_bytes_on_card=engine.didx.nbytes(),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        device_tail=engine.device_tail,
        tail_switch_anchors=engine.tail_switch_anchors,
        device_tail_chunks=engine.stats["tail_chunks"],
        backtrack_max_width=chain_backtrack.max_width,
        stage_seconds=dict(engine.profiler.totals),
        stage_counts=dict(engine.profiler.counts),
        anchor_regrows=engine.stats["anchor_regrows"],
        hit_overflow=engine.stats["hit_overflow"],
        prev_overflow=engine.stats["prev_overflow"],
        chain_overflow=engine.stats["chain_overflow"],
    )
    emit({"phase": name, "preset": preset, "genome_len": genome_len, **row})
    check(row["mapped_frac"] >= 0.95, f"{name}: mapped {n_mapped}/{len(reads)}")
    check(row["accuracy"] >= 0.95, f"{name}: accuracy {row['accuracy']:.3f}")
    return row


def main_path(name, fn, counters) -> tuple:
    """Run one main-path phase with every kernel's launch counter set to 0
    just before it; (its result, {kernel: launches in it})."""
    for k in counters.values():
        k.launches = 0
        if hasattr(k, "max_width"):
            k.max_width = 0
    t0 = time.perf_counter()
    out = fn()
    launches = {n: k.launches for n, k in counters.items()}
    emit({"phase": f"{name}_done", "seconds": time.perf_counter() - t0,
          "launches": launches})
    return out, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "rawhash_tpu_torch").is_dir():
        print("chip_smoke: run it from the root of a rawhash-tpu checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda")
    card = nvidia_smi()
    t_all = time.perf_counter()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    try:
        from rawhash_tpu_torch import _build
        from rawhash_tpu_torch.chain.backtrack import chain_backtrack
        from rawhash_tpu_torch.chain.fill import chain_fill

        t0 = time.perf_counter()
        so = _build.build()
        _build.load_library()
        log = so.with_suffix(".log")
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": so.name,
              "ptxas": [l for l in (log.read_text().splitlines() if log.exists() else [])
                        if "registers" in l or "spill" in l or "Function properties" in l]})

        timed = {}
        for name, fn in (("k1", phase_k1), ("backtrack", phase_backtrack),
                         ("loops", phase_loops)):
            t0 = time.perf_counter()
            timed[name] = fn(torch, dev)
            emit({"phase": f"{name}_done", "seconds": time.perf_counter() - t0})

        counters = {"chain_fill": chain_fill, "chain_backtrack": chain_backtrack}
        runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            runs["fixture"] = main_path(
                "fixture", lambda: phase_fixture(Path(tmp)), counters)
        caught = {}  # D4's widest device-tail call, for phase_d4_kernels
        cells = {
            "d1": (30_000, "viral", 5, 1200, 3072, 7, None),
            "d2": (5_000_000, "sensitive", 2, 2500, 16384, 11, None),
            "d4": (100_000_000, "sensitive", 1, 3000, 4096, 13, caught),
        }
        for name, cell in cells.items():
            runs[name] = main_path(
                name, lambda: phase_deployment(torch, dev, name, *cell), counters)
        (d1, n1), (d2, n2), (d4, n4) = (runs[c] for c in cells)
        check("out" in caught, "d4: no device-tail call to check the kernels on")
        t0 = time.perf_counter()
        timed["d4_kernels"] = phase_d4_kernels(torch, caught)
        caught.clear()
        emit({"phase": "d4_kernels_done", "seconds": time.perf_counter() - t0})
        check(not d1["device_tail"] and d1["device_tail_chunks"] == 0,
              "d1: the viral cell left the host tail")
        check(d2["device_tail"] and d2["device_tail_chunks"] > 0,
              "d2: the E. coli cell did not switch to the device tail")
        check(d4["backtrack_max_width"] > 32768,
              f"d4: widest backtrack {d4['backtrack_max_width']} <= 32768")
        for name, n in (("fixture", runs["fixture"][1]),
                        ("d1", {"chain_fill": n1["chain_fill"]}), ("d2", n2),
                        ("d4", n4)):
            check(all(v > 0 for v in n.values()),
                  f"{name}: a kernel of its path was not launched: {n}")
        launches = {k: sum(n[k] for _, n in runs.values()) for k in counters}
        emit({"phase": "main_path_launches", "total": launches,
              **{name: n for name, (_, n) in runs.items()}})

        k1 = timed["k1"]
        main_shape = next(r for r in k1 if r["preset"] == "sensitive" and r["n"] == 16384)
        kernels = [{
            "name": "chain_fill", "route": "cuda",
            "source": "rawhash_tpu_torch/csrc/chain_fill.cu",
            "replaces": "rawhash_tpu/chain/pallas_fill.py:226",
            "launches": launches["chain_fill"],
            "max_abs_err": max(r["max_abs_err"]
                               for r in k1 + [timed["d4_kernels"]["fill"]]),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
            "library_ms": None,
        }]
        # one kernel for both TPU kernels: K2's row at the D2 regime
        # (B=256, N=16384); K3's at D4's main-path inputs past 32768 (the
        # kernel on the whole batch, the plain version on its held rows)
        bt = timed["backtrack"]
        d4k = timed["d4_kernels"]["backtrack"]
        for replaces, shape in (("rawhash_tpu/chain/backtrack_pallas.py:147", bt[0]),
                                ("rawhash_tpu/chain/backtrack_pallas_big.py:361", d4k)):
            kernels.append({
                "name": "chain_backtrack", "route": "cuda",
                "source": "rawhash_tpu_torch/csrc/chain_backtrack.cu",
                "replaces": replaces,
                "launches": launches["chain_backtrack"],
                "max_abs_err": max(r["max_abs_err"] for r in bt + [d4k]),
                "ms": shape["ms"], "plain_ms": shape["plain_ms"],
                "bound_ms": shape["bound_ms"], "bound_by": shape["bound_by"],
                "library_ms": None,
            })
        emit({"kernels": kernels,
              **{f"{c}_bp_per_s": runs[c][0]["bp_per_s"] for c in cells},
              "seconds": time.perf_counter() - t_all})
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
