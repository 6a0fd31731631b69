"""The overlapped mapping pipeline of the port: --pipeline-depth batches in
flight, each chunk's step on the calling thread and the rest on a worker
pool, results in submission order, reads prefetched on a thread.  Records
at any depth equal the serial run's (depth 1) and the JAX engine's, on the
host tail, the device tail and the quarantine path; shared counters add
up; run_pipeline leaves no thread behind (mirrors tests/test_threading.py).
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu import cli as jax_cli  # noqa: E402
from rawhash_tpu import config as jcfg  # noqa: E402
from rawhash_tpu.index import build as jbuild  # noqa: E402
from rawhash_tpu.map.engine import MappingEngine as JaxEngine  # noqa: E402
from rawhash_tpu.pore import synthetic_pore as jax_pore  # noqa: E402
from rawhash_tpu_torch import cli as torch_cli  # noqa: E402
from rawhash_tpu_torch.map import engine as eng_mod  # noqa: E402
from rawhash_tpu_torch.map.engine import MappingEngine  # noqa: E402
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    deployment, options, random_genome, write_fixture,
)

GENOME, SEED, N_BATCHES, BATCH, READ_LEN = 20_000, 17, 4, 4, 900
# an anchor capacity every batch's hits fit from the start, at any depth
# (at depth 3 the first three batches plan it before any is learned); the
# squeezed test runs the quarantine reruns
CAP = 4096


@pytest.fixture(scope="module")
def setup():
    """The port's index and 4 batches of 4 viral reads of 900 bases, and
    the JAX package's index of the same genome, built by the JAX package."""
    index, _, reads = deployment(GENOME, "viral", N_BATCHES * BATCH, READ_LEN,
                                 CAP, SEED)
    batches = [[(n, s) for n, s, _, _ in reads[i:i + BATCH]]
               for i in range(0, len(reads), BATCH)]
    genome = random_genome(GENOME, np.random.default_rng(SEED))
    jio = jcfg.IndexOptions()
    jcfg.set_preset("viral", jio, jcfg.MapOptions())
    jindex = jbuild.build_index_from_sequences([("chr1", genome)], jax_pore(k=6), jio)
    np.testing.assert_array_equal(jindex.keys, index.keys)
    return index, jindex, batches


def _records(results):
    """Each read's records: PAF columns 1-12 and every tag but mt:f."""
    return [(r.name, [(m.read_length, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.mapq, m.rev, m.mapped,
                       [t for t in m.tags.split("\t") if not t.startswith("mt:f:")])
                      for m in r.records]) for r in results]


def _mopt(depth, squeeze=False):
    mopt = options("viral")[1]
    mopt.pipeline_depth = depth
    if squeeze:
        # a tiny hit capacity: most chunks overflow and rerun their rows in
        # quarantine sub-batches, on the workers, while other batches step
        mopt.max_anchors_per_read = 64
        mopt.max_anchor_cap = 1 << 13
    else:
        mopt.max_anchors_per_read = CAP
    return mopt


def _run(index, batches, depth, squeeze=False):
    engine = MappingEngine(index, _mopt(depth, squeeze), device="cpu")
    out = [r for results in engine.map_stream(iter(batches)) for r in results]
    return _records(out), engine


@pytest.fixture(scope="module")
def serial(setup):
    """The serial run (depth 1, host tail): its records and stats."""
    index, _, batches = setup
    records, engine = _run(index, batches, 1)
    return records, dict(engine.stats)


def _run_jax(jindex, batches, depth):
    mopt = jcfg.MapOptions()
    jcfg.set_preset("viral", jcfg.IndexOptions(), mopt)
    mopt.max_anchors_per_read = CAP
    mopt.pipeline_depth = depth
    engine = JaxEngine(jindex, mopt)
    return _records([r for results in engine.map_stream(iter(batches))
                     for r in results])


@pytest.mark.parametrize("tail", ["host", "device"])
def test_depths_agree_with_each_other_and_jax(setup, serial, monkeypatch, tail):
    """Depth 1 (serial) and depth 3 (three batches in flight, chunk tails on
    the workers) give the same records in the same order, equal to the JAX
    engine's at depth 3; on the host tail (4 batches) and on the forced
    device tail (3, all in flight at once: its plain backtrack is slow on
    the CPU)."""
    index, jindex, batches = setup
    for var in ("RAWHASH_TPU_DEVICE_TAIL", "RAWHASH_TPU_NO_DEVICE_TAIL"):
        monkeypatch.delenv(var, raising=False)
    want, stats1 = serial
    if tail == "device":
        monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
        batches = batches[:3]
        want, eng1 = _run(index, batches, 1)
        stats1 = eng1.stats
    threaded, eng3 = _run(index, batches, 3)
    assert threaded == want
    assert _run_jax(jindex, batches, 3) == want
    assert eng3.device_tail == (tail == "device")
    assert (eng3.stats["tail_chunks"] > 0) == (tail == "device")
    for key in ("reads", "mapped", "tail_chunks"):
        assert eng3.stats[key] == stats1[key]
    assert eng3.stats["reads"] == len(batches) * BATCH
    assert eng3.stats["mapped"] >= len(batches) * BATCH // 2


def test_squeezed_capacities_are_stable_at_depth_3(setup):
    """Capacities squeezed so that the quarantine reruns run on the workers
    beside the other batch's step; three runs at depth 3 (2 batches, both
    in flight) under a short thread switch interval each give the serial
    records and counters (the JAX package's stress loop runs 20 of 6
    batches; three of two keep this file short)."""
    index, _, batches = setup
    batches = batches[:2]
    serial, eng1 = _run(index, batches, 1, squeeze=True)
    assert eng1.stats["anchor_regrows"] > 0
    keys = ("reads", "mapped", "hit_overflow", "prev_overflow")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for it in range(3):
            got, eng3 = _run(index, batches, 3, squeeze=True)
            assert got == serial, f"run {it} diverged"
            assert {k: eng3.stats[k] for k in keys} == {k: eng1.stats[k] for k in keys}
    finally:
        sys.setswitchinterval(interval)


def test_concurrent_map_batch_same_engine(setup, serial):
    """Two threads call map_batch on one engine at once: each gets its
    batch's serial records, and the shared counters add up."""
    index, _, batches = setup
    b1, b2 = batches[0], batches[1]
    want = {"b1": serial[0][:BATCH], "b2": serial[0][BATCH:2 * BATCH]}
    eng = MappingEngine(index, _mopt(3), device="cpu")
    got, errs = {}, []

    def run(key, batch):
        try:
            got[key] = _records(eng.map_batch(batch))
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=("b1", b1)),
               threading.Thread(target=run, args=("b2", b2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert got == want
    assert eng.stats["reads"] == 2 * BATCH
    assert eng.stats["mapped"] == sum(any(m[8] for m in recs)
                                      for _, recs in want["b1"] + want["b2"])


def test_results_leave_in_submission_order(setup, monkeypatch):
    """A batch of unmappable reads of two chunks (noise: every chunk runs)
    followed by a batch of reads cut to one chunk: the second batch
    finishes first, and its results still leave second."""
    index, _, batches = setup
    rng = np.random.default_rng(5)
    chunk = options("viral")[1].chunk_size
    noise = [(f"noise_{i}", rng.normal(90.0, 9.0, 2 * chunk).astype(np.float32))
             for i in range(3)]
    short = [(n, s[:chunk]) for n, s in batches[2][:3]]
    finished = []
    finalize = eng_mod._finalize_batch

    def spy(engine, st):
        finished.append(st.names[0])
        return finalize(engine, st)
    monkeypatch.setattr(eng_mod, "_finalize_batch", spy)
    serial, _ = _run(index, [noise, short], 1)
    finished.clear()
    got, _ = _run(index, [noise, short], 3)
    assert finished == [short[0][0], noise[0][0]]  # the short batch first
    assert got == serial
    assert [name for name, _ in got] == [n for n, _ in noise + short]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline_fixture")
    write_fixture(d)
    assert torch_cli.main(["-x", "sensitive", "-p", str(d / "pore.model"), "-d",
                           str(d / "sensitive.rhi.npz"), str(d / "ref.fa"),
                           "--device", "cpu"]) == 0
    return d


def _cols(path):
    return [line.split("\t")[:12] for line in Path(path).read_text().splitlines()]


def _cli_leaves_no_thread(args) -> None:
    """Run the port's CLI; no thread it started is alive afterwards."""
    before = set(threading.enumerate())
    assert torch_cli.main(args) == 0
    left = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, left


def test_cli_depths_match_jax_and_leave_no_thread(fixture):
    """The CLI on the fixture at --pipeline-depth 1 and 3 (two reads a
    batch, so three batches): PAF columns 1-12 equal to each other and to
    `python -m rawhash_tpu`'s; --sequence-until at depth 3 stops at the JAX
    CLI's read, with batches still in flight.  No thread that run_pipeline
    started outlives it."""
    d = fixture
    args = ["-x", "sensitive", "--max-anchors", "512", "--batch-reads", "2",
            str(d / "sensitive.rhi.npz"), str(d / "reads.sig.npz")]
    assert jax_cli.main(args + ["-o", str(d / "jax.paf")]) == 0
    for depth in (1, 3):
        _cli_leaves_no_thread(args + ["--device", "cpu", "--pipeline-depth",
                                      str(depth), "-o", str(d / f"d{depth}.paf")])
    want = _cols(d / "jax.paf")
    assert _cols(d / "d1.paf") == _cols(d / "d3.paf") == want
    assert len(want) == 6 and sum(r[4] in "+-" for r in want) >= 5

    su = ["-x", "sequence-until", "--sequence-until", "--min-reads", "1",
          "--test-frequency", "1", "--n-samples", "2", "--batch-reads", "2",
          "--max-anchors", "512", str(d / "sensitive.rhi.npz"),
          str(d / "reads.sig.npz")]
    assert jax_cli.main(su + ["-o", str(d / "jax_su.paf")]) == 0
    _cli_leaves_no_thread(su + ["--device", "cpu", "--pipeline-depth", "3",
                                "-o", str(d / "su.paf")])
    want = _cols(d / "jax_su.paf")
    assert _cols(d / "su.paf") == want
    assert 0 < len(want) < 6  # stopped before the last read
