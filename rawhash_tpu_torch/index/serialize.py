"""Index artifact serialization.

The reference dumps a bespoke binary ("RI" magic + params + pore + per-bucket
khash contents; reference: ri_idx_dump/ri_idx_load, rindex.c:545-776).  Our
artifact carries the same information content in an .npz container plus a JSON
header: build parameters travel with the index so map-time options cannot
silently mismatch, exactly like the reference reloading `ri->e,q,k,w,...`.
"""

from __future__ import annotations

import dataclasses
import json
import zipfile

import numpy as np

from ..config import IndexFlag, IndexOptions
from ..pore import PoreModel
from .build import RawIndex

MAGIC = "RAWHASH_TPU_INDEX_V1"


def save_index(path: str, index: RawIndex) -> None:
    opts = index.opts
    header = {
        "magic": MAGIC,
        "params": {
            "b": opts.b, "w": opts.w, "e": opts.e, "n": opts.n,
            "q": opts.q, "k": opts.k,
            "diff": opts.diff,
            "fine_min": opts.fine_min, "fine_max": opts.fine_max,
            "fine_range": opts.fine_range,
            "flag": int(opts.flag),
            "window_length1": opts.window_length1,
            "window_length2": opts.window_length2,
            "threshold1": opts.threshold1, "threshold2": opts.threshold2,
            "peak_height": opts.peak_height,
        },
        "sig_target": index.sig_target,
        "seq_names": index.seq_names,
        "has_pore": index.pore is not None,
        "store_sig": index.F is not None,
        "has_rev_sig": index.R is not None,
    }
    arrays = {
        "header": np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        "seq_lens": index.seq_lens,
        "keys": index.keys,
        "offsets": index.offsets,
        "pos": index.pos,
    }
    if index.pore is not None:
        arrays["pore_vals"] = index.pore.pore_vals
        arrays["pore_k"] = np.array([index.pore.k], dtype=np.int32)
    if index.F is not None:
        arrays["f_lens"] = np.array([len(a) for a in index.F], dtype=np.int64)
        arrays["f_sig"] = (
            np.concatenate(index.F) if index.F else np.zeros(0, np.float32)
        )
    if index.R is not None:
        arrays["r_lens"] = np.array([len(a) for a in index.R], dtype=np.int64)
        arrays["r_sig"] = (
            np.concatenate(index.R) if index.R else np.zeros(0, np.float32)
        )
    np.savez_compressed(path, **arrays)


def _split(flat: np.ndarray, lens: np.ndarray) -> list:
    out, o = [], 0
    for n in lens:
        out.append(flat[o : o + int(n)])
        o += int(n)
    return out


def load_index(path: str) -> RawIndex:
    data = np.load(path, allow_pickle=False)
    header = json.loads(bytes(data["header"]).decode())
    if header.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a rawhash-tpu index")
    p = header["params"]
    opts = IndexOptions(
        b=p["b"], w=p["w"], e=p["e"], n=p["n"], q=p["q"], k=p["k"],
        diff=p["diff"], fine_min=p["fine_min"], fine_max=p["fine_max"],
        fine_range=p["fine_range"], flag=IndexFlag(p["flag"]),
        window_length1=p["window_length1"], window_length2=p["window_length2"],
        threshold1=p["threshold1"], threshold2=p["threshold2"],
        peak_height=p["peak_height"],
    )
    pore = None
    if header["has_pore"]:
        pore = PoreModel(k=int(data["pore_k"][0]), pore_vals=data["pore_vals"])
    F = R = None
    if header["store_sig"]:
        F = _split(data["f_sig"], data["f_lens"])
        if header["has_rev_sig"]:
            R = _split(data["r_sig"], data["r_lens"])
    return RawIndex(
        opts=opts,
        seq_names=list(header["seq_names"]),
        seq_lens=data["seq_lens"],
        keys=data["keys"],
        offsets=data["offsets"],
        pos=data["pos"],
        sig_target=header["sig_target"],
        pore=pore,
        F=F,
        R=R,
    )


def is_index_file(path: str) -> bool:
    """Detect index-vs-FASTA input (reference: ri_idx_is_idx, rindex.c:994)."""
    try:
        with zipfile.ZipFile(path) as z:
            return "header.npy" in z.namelist()
    except (zipfile.BadZipFile, OSError, IsADirectoryError):
        return False
