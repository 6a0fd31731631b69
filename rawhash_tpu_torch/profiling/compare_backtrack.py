"""This checkout's chain_backtrack against another checkout's, in turns on
one card.

    git archive <commit> rawhash_tpu_torch | tar -x -C build/other
    python -m rawhash_tpu_torch.profiling.compare_backtrack build/other

Loads the other checkout's `rawhash_tpu_torch` under another name (it
builds its own kernels under that checkout), checks that both wrappers
give the same ten outputs, then times them in turns (theirs, ours, ours,
theirs, three times; each the median of 5 CUDA-event runs after a warm-up)
on: clustered 256 x 16384 and 32 x 40960 and sparse (D4-like) 256 x 131080
rows filled by this checkout's K1, and the widest device-tail call of a
D4-sized mapping run (a 100 Mbp genome from seed 13, 256 reads of 3000
bases, `-x sensitive`). Prints the card's name and power limit, then one
JSON line per input. It needs an NVIDIA GPU and exits non-zero without
one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

OTHER = "rawhash_tpu_torch_other"


def load_other(root: Path, module: str = "chain.backtrack"):
    """The other checkout's `module` (chain/backtrack.py by default), its
    package loaded as OTHER."""
    init = root / "rawhash_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        OTHER, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{OTHER}.{module}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps CUDA-event runs, after one."""
    fn()
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


def d4_tail_call(dev):
    """(f, p, n_anchors, tpos, qpos) and k_cap of the widest tail_finish
    call of a D4-sized mapping run on the card."""
    from ..map import engine as eng_mod
    from ..synthetic import deployment

    index, mopt, reads = deployment(100_000_000, "sensitive", 256, 3000, 4096, 13)
    engine = eng_mod.MappingEngine(index, mopt, device=dev)
    caught = {}
    finish = eng_mod.tail_finish

    def widest(out, **k):
        if "out" not in caught or out.f.shape[1] >= caught["out"].f.shape[1]:
            caught.update(out=out, k_cap=k["k_cap"])
        return finish(out, **k)

    eng_mod.tail_finish = widest
    try:
        for _ in engine.map_stream([[(n, s) for n, s, _, _ in reads]]):
            pass
    finally:
        eng_mod.tail_finish = finish
    out = caught["out"]
    return (out.f, out.p, out.n_anchors, out.tpos, out.qpos), caught["k_cap"]


def inputs(dev):
    """{name: (backtrack inputs, k_cap)}."""
    from ..chain.fill import chain_fill
    from ..map.engine import fill_params
    from ..synthetic import clustered_anchors, options, sparse_anchors

    prm = fill_params(*options("sensitive"))
    out = {}
    for name, rows, k_cap in (
            ("clustered_256x16384", clustered_anchors(16384, 256, 16384), 1024),
            ("clustered_32x40960", clustered_anchors(40960, 32, 40960), 1024),
            ("sparse_256x131080", sparse_anchors(7, 256, 131080), 8192)):
        key, tpos, qpos, n_anchors = (
            torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)
            for x in rows)
        f, p = chain_fill(key, tpos, qpos, n_anchors, **prm)
        out[name] = ((f, p, n_anchors, tpos, qpos), k_cap)
    out["d4_tail_256x131080"] = d4_tail_call(dev)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m rawhash_tpu_torch.profiling.compare_backtrack "
              "OTHER_CHECKOUT", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_backtrack: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from ..chain.backtrack import chain_backtrack
    from ..map.engine import fill_params
    from ..synthetic import options
    from .fill_loop_overhead import card

    theirs = load_other(Path(argv[0])).chain_backtrack
    io, mo = options("sensitive")
    bt = dict(min_cnt=mo.min_num_anchors, min_sc=mo.min_chaining_score,
              max_drop=mo.bw, q_span=fill_params(io, mo)["q_span"])
    dev = torch.device("cuda")
    print(card(), flush=True)
    for name, (args, k_cap) in inputs(dev).items():
        fns = {"other": lambda: theirs(*args, **bt, k_cap=k_cap),
               "this": lambda: chain_backtrack(*args, **bt, k_cap=k_cap)}
        equal = all(torch.equal(a, c) for a, c in zip(fns["other"](), fns["this"]()))
        ms = {"other": [], "this": []}
        for _ in range(3):
            for who in ("other", "this", "this", "other"):
                ms[who].append(cuda_ms(fns[who]))
        print(json.dumps({"input": name, "equal": equal, "ms": ms,
                          "median_ms": {k: float(np.median(v)) for k, v in ms.items()}}),
              flush=True)
        if not equal:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
