"""This checkout's fill-loop probe (K4) against another checkout's, in turns
on one card.

    git archive <commit> rawhash_tpu_torch | tar -x -C build/other
    python -m rawhash_tpu_torch.profiling.compare_probe build/other

Loads the other checkout's `rawhash_tpu_torch` under another name (it
builds its own kernels under that checkout), checks that both kernels give
the same ring from a random start, then times them in turns (theirs, ours,
ours, theirs, three times; each the median of 7 CUDA-event runs after a
warm-up) at 1000 iterations on W x 256 for W in 64, 200 (the register ring)
and 4096 (shared memory) at k_ops 2, 20 and 60.  Prints the card's name and
power limit, then one JSON line per shape.  It needs an NVIDIA GPU and
exits non-zero without one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from .compare_backtrack import cuda_ms, load_other
from .fill_loop_overhead import B, K_OPS, card, fill_loop_probe

N_ITER = 1000


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m rawhash_tpu_torch.profiling.compare_probe "
              "OTHER_CHECKOUT", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    theirs = load_other(Path(argv[0]), "profiling.fill_loop_overhead").fill_loop_probe
    print(card(), flush=True)
    rng = np.random.default_rng(9)
    for w in (64, 200, 4096):
        for k_ops in K_OPS:
            x = torch.from_numpy(
                rng.integers(-2**20, 2**20, (w, B)).astype(np.int32)).cuda()
            fns = {"other": lambda: theirs(x, N_ITER, k_ops),
                   "this": lambda: fill_loop_probe(x, N_ITER, k_ops)}
            equal = torch.equal(fns["other"](), fns["this"]())
            ms = {"other": [], "this": []}
            for _ in range(3):
                for who in ("other", "this", "this", "other"):
                    ms[who].append(cuda_ms(fns[who], 7))
            med = {k: float(np.median(v)) for k, v in ms.items()}
            print(json.dumps({"w": w, "b": B, "n_iter": N_ITER, "k_ops": k_ops,
                              "equal": equal, "ms": ms, "median_ms": med,
                              "speedup": med["other"] / med["this"]}), flush=True)
            if not equal:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
