"""Multi-host runtime: one process per host (or per card) joined into one
torch.distributed world (port of rawhash_tpu/parallel/multihost.py).

Each process calls `initialize()` with the address of process 0; the
(dp, shard) grid of parallel/dist.py then spans every process's card, and
the seed merge's collectives run over NCCL (gloo on the CPU) with the
mapping code unchanged.  Run a worker (one per host):

    python -m rawhash_tpu_torch.parallel.multihost \\
        --coordinator HOST0:PORT --num-processes N --process-id I \\
        --n-shards S --selftest [--device cuda|cpu]

`--selftest` runs one sharded chunk step on a toy workload from a fixed
seed (reads simulated from a 6 kb genome), gathers its outputs and holds them bit for bit against the
single-process chunk_step on this process's device, printing
MULTIHOST_OK process=I on success (tests/test_torch_multihost.py runs two
CPU processes).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from .dist import TIMEOUT, backend_of


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: str = "cuda", timeout=TIMEOUT) -> torch.device:
    """Join the world of num_processes processes over tcp://coordinator
    (HOST:PORT of process 0) as process_id; returns this process's device
    (on cards cuda:process_id mod the cards a host has, set before NCCL)."""
    kw = backend_of(device, process_id % torch.cuda.device_count()
                    if device == "cuda" else None)
    dist.init_process_group(init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout, **kw)
    return kw.get("device_id", torch.device("cpu"))


def selftest(n_shards: int, device) -> bool:
    """One sharded chunk step over the world against the local
    single-device step; True when every gathered output is bit-equal."""
    from ..config import IndexOptions
    from ..index.build import build_index_from_sequences
    from ..index.device import DeviceIndex
    from ..io.signal_gen import simulate_reads
    from ..map.device_step import chunk_step
    from ..pore import synthetic_pore
    from ..signal.events import NormCarry
    from .dist import DistContext

    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    pore = synthetic_pore(k=6)
    index = build_index_from_sequences([("chr1", genome)], pore, IndexOptions())
    ctx = DistContext(index, n_shards, device)
    b = ctx.pad_batch(max(4, ctx.world))
    l_chunk, p_cap = 1024, 32
    # reads of the genome (anchors and chains to merge), one row of noise
    reads = simulate_reads(genome, pore, n_reads=b, read_len=200, rng=rng)
    sig = np.stack([np.resize(s, l_chunk) for _, s, _, _ in reads])
    sig[-1] = rng.normal(90.0, 10.0, size=l_chunk)
    sig = torch.from_numpy(sig.astype(np.float32)).to(device)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)
    inputs = (sig, z(b) + l_chunk, NormCarry.zeros(b, device), z(b),
              z(b, p_cap).long() + 0xFFFFFFFF, z(b, p_cap), z(b, p_cap), z(b))
    params = dict(
        diff=0.35, w=0, e=8, q=4, k=6,
        fine_min=-2.0, fine_max=2.0, fine_range=0.4,
        window_length1=3, window_length2=9,
        threshold1=4.0, threshold2=3.5, peak_height=0.4,
        e_cap=256, a_cap=256, min_events=5, mid_occ=100,
        max_dist_t=2500, max_dist_q=2500, bw=500, max_iter=64,
        chn_pen_gap=0.104, chn_pen_skip=0.0,
    )
    out = ctx.step(*(ctx.block(x) for x in inputs), **params)
    ref = chunk_step(DeviceIndex.from_host(index, device), *inputs, **params)
    same = []  # every field is gathered on every rank: no early exit
    for name in ref._fields:
        want = getattr(ref, name)
        if want is None:  # shard_hits: the single-device step has none
            continue
        got = ctx.gather(getattr(out, name))
        pairs = zip(got, want) if name == "carry" else [(got, want)]
        same += [torch.equal(g, w) for g, w in pairs]
    return all(same)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rawhash-tpu-torch-multihost")
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--n-shards", type=int, default=2)
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dev = initialize(args.coordinator, args.num_processes, args.process_id,
                     args.device)
    try:
        print(f"[multihost] process {dist.get_rank()}/{dist.get_world_size()} "
              f"on {dev} ({dist.get_backend()})", file=sys.stderr)
        if args.selftest:
            ok = selftest(args.n_shards, dev)
            print(f"MULTIHOST_{'OK' if ok else 'MISMATCH'} process={args.process_id}",
                  flush=True)
            return 0 if ok else 1
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
