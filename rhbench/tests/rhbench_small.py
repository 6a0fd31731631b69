"""The benchmark's cells at a size a CPU test holds: the configuration's
genome, batch and pool cut down (the off-target genome too), so the
harness's whole run (index, warm-up, window, the reference's check) takes
seconds on the port's plain path."""

import time

import torch

from rhbench import run, spec

SEED = 2**31 + 12345


def scale(cell_name: str) -> dict:
    out = {"config": {"genome_len": 20000, "batch_reads": 8}, "traffic": {"pool": 24}}
    if "offtarget" in cell_name:
        out["traffic"]["mix"] = [
            {"share": 0.75, "genome": "foreign", "genome_len": 20000, "read_len": 3000},
            {"share": 0.25, "genome": "target", "read_len": "config"}]
    return out


def run_small(cell_name: str, trace: bool = False, seed: int = SEED, **kw):
    """(result, compared, info) of one small run on the CPU."""
    torch.set_num_threads(2)
    return run.run_cell(spec.cell(cell_name), seed, 0.5, trace, "cpu",
                        time.perf_counter(), scale=scale(cell_name), check_reads=8, **kw)
