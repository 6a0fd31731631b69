"""The harness on the CPU at small sizes: each cell's run ends in a
well-formed result line; the throughput and percentile arithmetic; every
configuration, traffic and metric file found by name; nothing of JAX or
the JAX package loaded; and, on a card, one short run of the command."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from rhbench_small import run_small

from rhbench import run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_small_run_ends_in_a_well_formed_line(cell, trace):
    result, compared, _ = run_small(cell, trace=trace)
    line = json.loads(run.result_line(result, compared, {"name": "cpu", "power_limit": "n/a"}))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["compared"]) == set(run.LIMITS)
    c = spec.cell(cell)
    want = {m["name"] for m, _ in (c.per_layer if trace else c.end_to_end)}
    got = set(line["metrics"])
    assert got <= want
    if not trace:
        assert got == want
    else:
        # off the card the device's metrics have nothing to read
        assert "device_idle_pct" not in got and "chain_fill_roofline" not in got
        assert {f"stage_ms_per_kchunk.{s}" for s in ("events", "fill")} <= got
        assert "busy_s" in line["device"] and "breakdown" in line
    for m in line["metrics"].values():
        assert np.isfinite(m["value"]) and m["value"] > 0


class _Engine:
    """Hands each batch back at once; read k of the stream consumed
    1 + k % 7 chunks (the longest first at k = 6)."""

    def map_stream(self, batches):
        from types import SimpleNamespace as NS

        for batch in batches:
            yield [NS(name=n, records=[NS(mapped=1, tags=f"ci:i:{1 + int(n) % 7}\tcm:i:3")])
                   for n, _ in batch]


def _window(seed, keep=5, seconds=0.05):
    def stream():
        k = 0
        while True:
            yield [(str(k + j), None) for j in range(4)], list(range(4))
            k += 4
    w = run.Window(stream(), seconds, False, seed, keep)
    w.run(_Engine())
    return w


def test_the_window_keeps_a_seeded_sample_and_the_longest_read():
    w = _window(3)
    assert w.n_reads == 4 * len(w.arrived) == sum(w.sizes) > 5
    assert sum(w.chunks) == sum(1 + k % 7 for k in range(w.n_reads))
    assert len(w.reservoir) == 5 and len({r[0] for r in w.reservoir}) == 5
    assert w.longest[0] == 7 and w.longest[1][0] == "6"
    assert len(w.inflight) == 0 and len(w.returned) == len(w.arrived)
    # the same reads and seed keep the same sample; another seed another
    a, b = _window(3, seconds=0.0), _window(3, seconds=0.0)
    assert [r[0] for r in a.reservoir] == [r[0] for r in b.reservoir] == ["0", "1", "2", "3"]
    picks = {tuple(r[0] for r in _window(s, keep=2, seconds=0.02).reservoir) for s in range(6)}
    assert len(picks) > 1


def test_bp_and_percentile_arithmetic():
    ctx = {"bases": 9000.0, "window_s": 2.0, "latency_ms": [10.0] * 95 + [20.0] * 5,
           "setup_s": 3.5, "chunks": 2000, "stages": {"events": 0.5, "fill": 0.0},
           "trace": {"busy_s": 0.25, "window_s": 1.0}, "rooflines": {"chain_fill": [(1.0, 4.0), (1.0, 4.0)]}}
    read = lambda name, **p: spec.reader(name)(ctx, **p)
    assert read("bp_per_s") == 4500.0
    assert read("setup_s") == 3.5
    # 100 values: the 0.95 quantile lies between rank 94 (10) and 95 (20)
    assert read("read_latency_ms", quantile=0.95) == pytest.approx(10.5)
    assert read("read_latency_ms", quantile=0.5) == 10.0
    assert read("stage_ms_per_kchunk", stage="events") == 250.0  # 500 ms / 2 kchunks
    assert read("stage_ms_per_kchunk", stage="fill") is None
    assert read("stage_ms_per_kchunk", stage="backtrack") is None
    assert read("device_idle_pct") == 75.0
    assert read("kernel_roofline", kernel="chain_fill") == 25.0
    assert read("kernel_roofline", kernel="chain_backtrack") is None


def test_every_file_is_found_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"], bench)
        assert c.config["name"] == w["config"]
        assert c.traffic["name"] == w["traffic"]
        for entry, mfile in c.end_to_end + c.per_layer:
            assert callable(spec.reader(mfile["reader"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert "reader" in spec.metric_file(m["name"])
    with pytest.raises(KeyError):
        spec.cell("no_such.cell", bench)


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json")))
def test_every_traffic_file_makes_its_pool(traffic):
    """Each mix's file, cells or not, drives the generator: the pool has the
    mix's counts and lengths, on and off the target, and is the same from
    the same seed."""
    import numpy as np

    from rhbench import gen

    mix = dict(spec._data("traffic", traffic), pool=20)
    for part in mix["mix"]:
        if part["genome"] == "foreign":
            part["genome_len"] = 5000
    genome = gen.random_genome(5000, np.random.default_rng(1))
    pore = gen.synthetic_pore()
    pool = gen.read_pool(genome, pore, mix, 300, 7)
    again = gen.read_pool(genome, pore, mix, 300, 7)
    assert len(pool) == 20
    assert all(np.array_equal(a.signal, b.signal) for a, b in zip(pool, again))
    for part in mix["mix"]:
        want = 300 if part["read_len"] == "config" else part["read_len"]
        on = part["genome"] == "target"
        assert any(p.on_target == on and p.length == want for p in pool)
    batch, idx = next(gen.handovers(pool, 8, mix["max_offset"], 7))
    assert len({n for n, _ in batch}) == 8
    for (_, sig), i in zip(batch, idx):
        cut = pool[i].signal.shape[0] - sig.shape[0]
        assert 0 <= cut <= mix["max_offset"]


@pytest.mark.parametrize("config", sorted(p.stem for p in (spec.HERE / "configs").glob("*.json")))
def test_every_configuration_file_holds_what_a_run_reads(config):
    conf = spec._data("configs", config)
    for key in ("name", "source", "preset", "genome_len", "pore_k", "max_anchors",
                "read_len", "batch_reads", "assumed"):
        assert key in conf
    assert conf["name"] == config


def test_banned_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["rawhash_tpu_torch_fake.x"] = sys
        assert "rawhash_tpu" not in run.banned_modules()
        sys.modules["rawhash_tpu.fake"] = sys
        assert "rawhash_tpu" in run.banned_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """A small run of a cell and its reference, in a process of its own,
    leaves no module named jax, jaxlib, flax or rawhash_tpu (whole
    top-level names) loaded; rawhash_tpu_torch is."""
    code = ("import sys; sys.path[:0] = ['rhbench/tests', '.']\n"
            "from rhbench_small import run_small\n"
            "from rhbench import run\n"
            f"r, c, _ = run_small({CELLS[0]!r})\n"
            "assert r['correct']\n"
            "assert 'rawhash_tpu_torch' in sys.modules\n"
            "print(run.banned_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "rhbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_command_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "rhbench/run.py", "--workload", CELLS[0],
                          "--seed", str(2**31 + 77), "--seconds", "2", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
