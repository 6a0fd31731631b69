"""Raw-signal container IO: FAST5 (h5py), SLOW5/BLOW5, POD5 (optional), and a
simple .npz format for hermetic benchmarks.

Mirrors the reference's signal ingestion semantics (reference: src/rsig.c):
  * DAC -> picoampere conversion pa = (raw + offset) * range / digitisation
  * samples outside (30, 200) pA are *dropped* (not clipped)
    (reference: rsig.c:369-374 FAST5, 429-434 POD5, 498-503 SLOW5)
  * the FAST5 path stores pA values through an int16 buffer, truncating them
    to integers (reference: rsig.c:373 `sig[l_sig++] = pa;`) — replicated
  * recursive discovery of *.fast5/*.pod5/*.slow5/*.blow5 files
    (reference: find_sfiles, rsig.c:300-333)

POD5 support requires the `pod5` package; SLOW5 ASCII is parsed natively and
BLOW5 via zlib/zstd record decoding when available.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

SIG_EXTS = (".fast5", ".pod5", ".pod", ".slow5", ".blow5", ".sig.npz")


def find_signal_files(path: str) -> list:
    """Recursively collect signal files under path (or the file itself)."""
    if not os.path.isdir(path):
        return [path] if any(e in path for e in SIG_EXTS) else []
    out = []
    for root, _dirs, files in os.walk(path):
        for f in sorted(files):
            if any(e in f for e in SIG_EXTS):
                out.append(os.path.join(root, f))
    return sorted(out)


def _pa_filter(pa: np.ndarray, as_int16: bool = False) -> np.ndarray:
    keep = (pa > 30.0) & (pa < 200.0)
    kept = pa[keep]
    if as_int16:
        kept = kept.astype(np.int16).astype(np.float32)
    return kept.astype(np.float32)


def read_fast5(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (read_id, signal pA float32) from single- or multi-read FAST5."""
    import h5py

    with h5py.File(path, "r") as f:
        if "UniqueGlobalKey" in f:  # single-read FAST5
            ch = f["UniqueGlobalKey/channel_id"].attrs
            dig = float(ch["digitisation"])
            rng = float(ch["range"])
            off = float(ch["offset"])
            for rname in f["Raw/Reads"]:
                grp = f["Raw/Reads"][rname]
                rid = grp.attrs.get("read_id")
                if isinstance(rid, bytes):
                    rid = rid.decode()
                raw = np.asarray(grp["Signal"][:], dtype=np.float32)
                pa = (raw + off) * (rng / dig)
                yield str(rid), _pa_filter(pa, as_int16=True)
        else:  # multi-read FAST5
            for key in f:
                if not key.startswith("read"):
                    continue
                grp = f[key]
                ch = grp["channel_id"].attrs
                dig = float(ch["digitisation"])
                rng = float(ch["range"])
                off = float(ch["offset"])
                rid = grp["Raw"].attrs.get("read_id", key.replace("read_", ""))
                if isinstance(rid, bytes):
                    rid = rid.decode()
                raw = np.asarray(grp["Raw/Signal"][:], dtype=np.float32)
                pa = (raw + off) * (rng / dig)
                yield str(rid), _pa_filter(pa, as_int16=True)


def read_slow5(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (read_id, signal pA float32) from ASCII SLOW5
    (columns: read_id read_group digitisation offset range sampling_rate
    len_raw_signal raw_signal ...)."""
    opener = open
    if path.endswith(".gz"):
        import gzip

        opener = gzip.open
    with opener(path, "rt") as fp:
        for line in fp:
            if line.startswith("#") or line.startswith("@"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 8:
                continue
            rid = cols[0]
            dig, off, rng = float(cols[2]), float(cols[3]), float(cols[4])
            raw = np.array(cols[7].split(","), dtype=np.float64)
            # reference float narrowing (rsig.c:496-501): scale is a float,
            # the product is computed in double then assigned to float
            scale = np.float32(rng / dig)
            pa = ((raw + off) * np.float64(scale)).astype(np.float32)
            yield rid, _pa_filter(pa)


def read_blow5(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (read_id, signal pA float32) from binary BLOW5 (spec-native
    decoder in io/blow5.py; zlib/zstd records, svb-zd signals).  Applies the
    same pA conversion + float narrowing as the SLOW5 path (reference:
    rsig.c:496-503)."""
    from . import blow5 as _b5

    for rec in _b5.read_blow5_raw(path):
        raw = rec["signal"].astype(np.float64)
        scale = np.float32(rec["range"] / rec["digitisation"])
        pa = ((raw + rec["offset"]) * np.float64(scale)).astype(np.float32)
        yield rec["read_id"], _pa_filter(pa)


def read_pod5(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (read_id, signal pA float32) from POD5.

    Prefers the official `pod5` package when installed; otherwise decodes
    natively (io/pod5_native.py: Arrow tables + VBZ signal).  Both apply the
    reference's float32 pA conversion pa = (raw + offset) * scale and the
    (30, 200) pA drop filter (reference: rsig.c:416-431)."""
    try:
        import pod5  # noqa: F401

        have_pod5 = True
    except ImportError:
        have_pod5 = False
    if have_pod5:
        import pod5

        with pod5.Reader(path) as reader:
            for rec in reader.reads():
                cal = rec.calibration
                pa = (rec.signal.astype(np.float32) + np.float32(cal.offset)) * np.float32(cal.scale)
                yield str(rec.read_id), _pa_filter(pa)
        return
    from . import pod5_native as _p5

    for rec in _p5.read_pod5_raw(path):
        pa = (
            rec["signal"].astype(np.float32) + np.float32(rec["calibration_offset"])
        ) * np.float32(rec["calibration_scale"])
        yield rec["read_id"], _pa_filter(pa)


def read_sig_npz(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Our own simple container: npz with names[] and sig_<i> arrays
    (already in pA)."""
    data = np.load(path, allow_pickle=False)
    names = [str(n) for n in data["names"]]
    for i, name in enumerate(names):
        yield name, np.asarray(data[f"sig_{i}"], dtype=np.float32)


def write_sig_npz(path: str, reads: list) -> None:
    arrays = {"names": np.array([n for n, _ in reads])}
    for i, (_n, s) in enumerate(reads):
        arrays[f"sig_{i}"] = np.asarray(s, dtype=np.float32)
    np.savez(path, **arrays)


def read_signals(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Dispatch on extension (reference: open_sig, rsig.c:261-299)."""
    if ".sig.npz" in path:
        yield from read_sig_npz(path)
    elif ".fast5" in path:
        yield from read_fast5(path)
    elif ".slow5" in path:
        yield from read_slow5(path)
    elif ".blow5" in path:
        yield from read_blow5(path)
    elif ".pod5" in path or ".pod" in path:
        yield from read_pod5(path)
    else:
        raise ValueError(f"unrecognized signal file: {path}")


def stream_signal_dir(path: str) -> Iterator[tuple[str, np.ndarray]]:
    for f in find_signal_files(path):
        yield from read_signals(f)


def write_slow5(path: str, reads: list, sample_rate: float = 4000.0) -> None:
    """Write ASCII SLOW5 (reads: [(name, signal pA float)]) with raw values
    quantized to 0.01 pA (digitisation 10000, range 100, offset 0), so any
    SLOW5 consumer reconstructs the same filtered pA stream our reader
    yields (reference conversion: rsig.c:498-503)."""
    with open(path, "w") as fp:
        fp.write("#slow5_version\t2.0\n")
        fp.write("#num_read_groups\t1\n")
        fp.write("@asic_id\t0\n")
        fp.write(
            "#char*\tuint32_t\tdouble\tdouble\tdouble\tdouble\tuint64_t"
            "\tint16_t*\n"
        )
        fp.write(
            "#read_id\tread_group\tdigitisation\toffset\trange"
            "\tsampling_rate\tlen_raw_signal\traw_signal\n"
        )
        for name, sig in reads:
            raw = np.round(np.asarray(sig, dtype=np.float64) * 100.0)
            raw = np.clip(raw, -32768, 32767).astype(np.int16)
            fp.write(
                f"{name}\t0\t10000\t0\t100\t{sample_rate:g}"
                f"\t{raw.shape[0]}\t" + ",".join(map(str, raw.tolist())) + "\n"
            )
