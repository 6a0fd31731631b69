"""Command line: the reference's flags (rawhash_tpu.cli) plus --device.

    python -m rawhash_tpu_torch [options] <target.fa|index> [signal files...]
"""

from __future__ import annotations

import sys
import time

from rawhash_tpu.cli import build_parser as _reference_parser
from rawhash_tpu.cli import options_from_args

from .map.pipeline import run_pipeline


def build_parser():
    p = _reference_parser()
    p.prog = "rawhash-tpu-torch"
    p.description = "raw nanopore signal mapper (PyTorch/CUDA engine)"
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device the mapping runs on (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    io, mo = options_from_args(args)
    if args.device == "cuda" and args.query:
        import torch

        if not torch.cuda.is_available():
            print("[ERROR] --device cuda: no CUDA device is available "
                  "(use --device cpu)", file=sys.stderr)
            return 1
    return run_pipeline(args, io, mo, time.time(), args.device)


if __name__ == "__main__":
    sys.exit(main())
