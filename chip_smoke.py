#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rawhash_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printed as one JSON line and each fatal on failure:
  1. build   the CUDA kernels from rawhash_tpu_torch/csrc with nvcc
  2. k1      chain_fill kernel vs the plain PyTorch fill on the card
             (B=256, N in {4096, 16384}, W=200, viral and sensitive
             parameters): f and p must be bit-equal; both timed
  3. loops   time the plain stages' stepped loops (_gen_peaks, _diff_filter)
  4. fixture the CLI (`python -m rawhash_tpu_torch`) on a small fixture,
             --device cuda vs --device cpu: same mapped reads, same PAF
             columns 1, 5 and 6, column 8 within 20
  5. d1      SARS-CoV-2-sized deployment: 30 kb genome, viral preset,
             5 x 256 reads of 1200 bases
  6. d2      E. coli-sized deployment: 5 Mbp genome, sensitive preset,
             2 x 256 reads of 2500 bases, --max-anchors 16384
Phases 4-6 are the main-path run: the kernels' launch counters are reset
before it and must be > 0 after it.  Phases 5-6 need >= 95% of reads mapped
at accuracy >= 0.95 (strand right, mapped target interval inside the read's
true interval +/- 200).  The last line is {"ok": true, "device": ...}.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


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


def phase_k1(torch, dev) -> dict:
    """Kernel vs plain fill on clustered anchors from a numpy seed."""
    from rawhash_tpu_torch.chain.device import chain_fill_batch
    from rawhash_tpu_torch.chain.fill import chain_fill
    from rawhash_tpu_torch.map.engine import fill_params
    from rawhash_tpu_torch.synthetic import options

    results = []
    for preset in ("viral", "sensitive"):
        prm = fill_params(*options(preset))
        for n in (4096, 16384):
            rng = np.random.default_rng(n)
            b = 256
            tpos = np.sort(rng.integers(0, 4 * n, (b, n)), axis=1).astype(np.int32)
            qpos = (tpos // 2 + rng.integers(-20, 20, (b, n))).clip(0).astype(np.int32)
            key = np.sort(rng.integers(0, 2, (b, n)).astype(np.uint32) << 31, axis=1)
            n_anchors = rng.integers(n // 2, n + 1, b).astype(np.int32)
            args = [torch.from_numpy(x).to(dev) for x in
                    (key.view(np.int32), tpos, qpos, n_anchors)]
            f, p = chain_fill(*args, **prm)  # also the timings' warm-ups
            f0, p0 = chain_fill_batch(*args, **prm)
            torch.cuda.synchronize()
            err = max(int((f - f0).abs().max()), int((p - p0).abs().max()))
            check(torch.equal(f, f0) and torch.equal(p, p0),
                  f"k1 {preset} N={n}: kernel disagrees with the plain fill "
                  f"(max abs err {err})")
            ms = cuda_ms(torch, lambda: chain_fill(*args, **prm), 7)
            plain_ms = cuda_ms(torch, lambda: chain_fill_batch(*args, **prm), 5)
            row = dict(preset=preset, b=b, n=n, w=prm["max_iter"],
                       anchors=int(n_anchors.sum()), max_abs_err=err,
                       ms=ms, plain_ms=plain_ms)
            emit({"phase": "k1", **row})
            results.append(row)
    return results


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

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            caught[name] = (fn, a, k)
            return fn(*a, **k)
        setattr(mod, name, wrapper)
        return fn

    originals = {(ev, "_gen_peaks"): spy(ev, "_gen_peaks"),
                 (sk, "_diff_filter"): spy(sk, "_diff_filter")}
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
        for device in ("cuda", "cpu"):
            paf = d / f"{preset}_{device}.paf"
            t0 = time.perf_counter()
            rc = cli(["-x", preset, "--max-anchors", "512", str(idx),
                      str(d / "reads.sig.npz"), "--device", device, "-o", str(paf)])
            check(rc == 0, f"fixture mapping on {device} failed ({rc})")
            pafs[device] = ([l.split("\t") for l in paf.read_text().splitlines()],
                            time.perf_counter() - t0)
        rows = {dv: {c[0]: c for c in cols if c[4] in "+-"}
                for dv, (cols, _) in pafs.items()}
        diffs = []
        for name in sorted(set(rows["cuda"]) | set(rows["cpu"])):
            a, c = rows["cuda"].get(name), rows["cpu"].get(name)
            if a is None or c is None or a[:12] != c[:12]:
                diffs.append({"read": name, "cuda": a and a[:12], "cpu": c and c[:12]})
        emit({"phase": "fixture", "preset": preset,
              "mapped_cuda": len(rows["cuda"]), "mapped_cpu": len(rows["cpu"]),
              "seconds_cuda": pafs["cuda"][1], "seconds_cpu": pafs["cpu"][1],
              "differences": diffs})
        check(set(rows["cuda"]) == set(rows["cpu"]), "fixture: mapped sets differ")
        for name, a in rows["cuda"].items():
            c = rows["cpu"][name]
            check(a[0] == c[0] and a[4] == c[4] and a[5] == c[5],
                  f"fixture: PAF columns 1/5/6 differ for {name}")
            check(abs(int(a[7]) - int(c[7])) <= 20,
                  f"fixture: PAF column 8 differs by > 20 for {name}")
        out[preset] = len(rows["cuda"])
    return out


def phase_deployment(torch, dev, name, genome_len, preset, n_batches,
                     read_len, max_anchors, seed) -> dict:
    """Build the index and map n_batches x 256 simulated reads on the card
    through the engine's streaming entry point."""
    from rawhash_tpu_torch.map.engine import MappingEngine
    from rawhash_tpu_torch.synthetic import deployment

    t0 = time.perf_counter()
    index, mopt, reads = deployment(genome_len, preset, n_batches * 256,
                                    read_len, max_anchors, seed)
    t_setup = time.perf_counter() - t0
    batches = [[(n, s) for n, s, _, _ in reads[i:i + 256]]
               for i in range(0, len(reads), 256)]
    engine = MappingEngine(index, mopt, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [r for batch in engine.map_stream(batches) for r in batch]
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
        setup_s=t_setup, index_bytes_on_card=engine.didx.nbytes(),
        stage_seconds=dict(engine.profiler.totals),
        anchor_regrows=engine.stats["anchor_regrows"],
        hit_overflow=engine.stats["hit_overflow"],
        prev_overflow=engine.stats["prev_overflow"],
    )
    emit({"phase": name, "preset": preset, "genome_len": genome_len, **row})
    check(row["mapped_frac"] >= 0.95, f"{name}: mapped {n_mapped}/{len(reads)}")
    check(row["accuracy"] >= 0.95, f"{name}: accuracy {row['accuracy']:.3f}")
    return row


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
        from rawhash_tpu_torch.chain.fill import chain_fill

        t0 = time.perf_counter()
        so = _build.build()
        _build.load_library()
        log = so.with_suffix(".log")
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "library": so.name,
              "ptxas": [l for l in (log.read_text().splitlines() if log.exists() else [])
                        if "registers" in l or "spill" in l]})

        t0 = time.perf_counter()
        k1 = phase_k1(torch, dev)
        emit({"phase": "k1_done", "seconds": time.perf_counter() - t0})

        t0 = time.perf_counter()
        phase_loops(torch, dev)
        emit({"phase": "loops_done", "seconds": time.perf_counter() - t0})

        chain_fill.launches = 0  # the main-path run starts here
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            phase_fixture(Path(tmp))
            emit({"phase": "fixture_done", "seconds": time.perf_counter() - t0,
                  "chain_fill_launches": chain_fill.launches})
        n0 = chain_fill.launches
        d1 = phase_deployment(torch, dev, "d1", 30_000, "viral", 5, 1200, 3072, 7)
        n1 = chain_fill.launches
        d2 = phase_deployment(torch, dev, "d2", 5_000_000, "sensitive", 2, 2500,
                              16384, 11)
        launches = chain_fill.launches
        emit({"phase": "main_path_launches", "fixture": n0, "d1": n1 - n0,
              "d2": launches - n1, "total": launches})
        check(n1 - n0 > 0 and launches - n1 > 0,
              "chain_fill kernel was not launched by the main path")
        main_shape = next(r for r in k1 if r["preset"] == "sensitive" and r["n"] == 16384)
        emit({"kernels": [{
            "name": "chain_fill", "route": "cuda",
            "source": "rawhash_tpu_torch/csrc/chain_fill.cu",
            "replaces": "rawhash_tpu/chain/pallas_fill.py:226",
            "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in k1),
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        }], "d1_bp_per_s": d1["bp_per_s"], "d2_bp_per_s": d2["bp_per_s"],
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
