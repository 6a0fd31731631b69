"""The engine's tracer (rawhash_tpu_torch/utils/timers.py::StageProfiler).
Off, a map books nothing, makes no tracer sync and opens no `rh.*` range.
On (the engine made with tracing on, or a torch.profiler recording), every
stage is a range named by its batch and chunk, nested in the chunk's
submit or process range, and books its wall time split into the thread's
CPU time, its time off the CPU and the device drain; at depth 3 the calling
thread's waits on the workers are booked too.  The records are the same
with tracing on and off."""

import contextlib
import math
import threading
import time
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from rawhash_tpu_torch import cli  # noqa: E402
from rawhash_tpu_torch.map.device_step import STEP_STAGES, TAIL_STAGES  # noqa: E402
from rawhash_tpu_torch.map.engine import MappingEngine  # noqa: E402
from rawhash_tpu_torch.synthetic import deployment, options, write_fixture  # noqa: E402
from rawhash_tpu_torch.utils import timers  # noqa: E402

BATCH, N_BATCHES, CAP = 2, 2, 4096


def _records(results):
    """Each read's records, every tag but the wall-clock mt:f."""
    return [(r.name, [(m.read_length, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.mapq, m.rev, m.mapped,
                       [t for t in m.tags.split("\t") if not t.startswith("mt:f:")])
                      for m in r.records]) for r in results]


class Run(NamedTuple):
    records: list
    totals: dict
    counts: dict
    syncs: int  # the tracer's syncs
    ranges: list  # the tracer's ranges: (name, ids, thread, start ns, end ns)


@pytest.fixture(scope="module")
def run():
    """run(depth, trace, tail): one engine's map of 2 batches of 2 viral
    reads of 500 bases (a 20 kb genome) on the host tail or the forced
    device tail, with the tracer's syncs counted and its ranges recorded;
    each run once."""
    index, _, reads = deployment(20_000, "viral", BATCH * N_BATCHES, 500, CAP, 17)
    batches = [[(n, s) for n, s, _, _ in reads[i:i + BATCH]]
               for i in range(0, len(reads), BATCH)]
    done = {}

    def go(depth: int, trace: bool, tail: str = "host") -> Run:
        key = (depth, trace, tail)
        if key in done:
            return done[key]
        syncs, ranges = [], []
        sync, record_function = timers.sync_stream, timers.record_function

        def counted_sync(device):
            syncs.append(device)
            sync(device)

        @contextlib.contextmanager
        def recorded_range(name):
            t0 = time.perf_counter_ns()
            with record_function(name):
                yield
            label, _, ids = name.partition(" ")
            ranges.append((label[3:], ids, threading.get_ident(), t0,
                           time.perf_counter_ns()))

        mopt = options("viral")[1]
        mopt.max_anchors_per_read = CAP
        mopt.pipeline_depth = depth
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(timers, "sync_stream", counted_sync)
            mp.setattr(timers, "record_function", recorded_range)
            if tail == "device":
                mp.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
            else:
                mp.delenv("RAWHASH_TPU_DEVICE_TAIL", raising=False)
            engine = MappingEngine(index, mopt, device="cpu", trace=trace)
            assert engine.device_tail == (tail == "device")
            results = [r for res in engine.map_stream(iter(batches)) for r in res]
        done[key] = Run(_records(results), dict(engine.profiler.totals),
                        dict(engine.profiler.counts), len(syncs), ranges)
        return done[key]

    go.batches, go.index = batches, index
    return go


@pytest.mark.parametrize("depth", [1, 3])
def test_tracing_off_books_syncs_and_opens_nothing(run, depth):
    off = run(depth, False)
    assert off.totals == {} and off.counts == {}
    assert off.syncs == 0 and off.ranges == []
    # the spies see the tracer's calls when it is on
    on = run(depth, True)
    assert on.syncs > 0 and on.ranges
    assert set(STEP_STAGES) <= set(on.totals)


# where each span runs: inside its chunk's submit or process range
HOMES = {**{s: ("submit", "process") for s in STEP_STAGES + ("transfer",)},
         **{s: ("process",) for s in TAIL_STAGES + ("host_tail",)}}


def _assert_nested(ranges, n_batches: int) -> set:
    """Every range carries its batch and chunk; each batch's first chunk
    has its submit and process ranges, and each stage lies inside one of
    its chunk's, on the same thread.  Returns the ranges' names."""
    outer = {(n, ids): (tid, a, b) for n, ids, tid, a, b in ranges
             if n in ("submit", "process")}
    for b in range(n_batches):
        assert ("submit", f"batch={b} chunk=0") in outer
        assert ("process", f"batch={b} chunk=0") in outer
    for n, ids, tid, a, b in ranges:
        assert ids.startswith("batch=") and " chunk=" in ids, (n, ids)
        if n in HOMES:
            assert any(o in outer and outer[o][0] == tid and outer[o][1] <= a
                       and b <= outer[o][2]
                       for o in ((h, ids) for h in HOMES[n])), (n, ids)
    return {n for n, *_ in ranges}


@pytest.mark.parametrize("depth,tail", [(1, "host"), (3, "device")])
def test_ranges_nest_by_batch_and_chunk(run, depth, tail):
    names = _assert_nested(run(depth, True, tail).ranges, N_BATCHES)
    tail_stages = set(TAIL_STAGES) if tail == "device" else set()
    assert {"submit", "process", "finalize", "transfer", "host_tail",
            *STEP_STAGES, *tail_stages} <= names
    assert ("worker_wait" in names) == (depth > 1)
    assert bool(set(TAIL_STAGES) & names) == (tail == "device")


def test_a_profiler_turns_tracing_on_and_holds_the_ranges(run):
    """The engine is made with tracing off; torch.profiler turns it on, and
    its trace holds the ranges (one batch at depth 1: recording every op
    of the CPU's events stage is slow)."""
    mopt = options("viral")[1]
    mopt.max_anchors_per_read = CAP
    mopt.pipeline_depth = 1
    engine = MappingEngine(run.index, mopt, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.map_batch(run.batches[0])
    assert set(STEP_STAGES) <= set(engine.profiler.totals)
    assert not engine.profiler.tracing()
    ranges = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("rh."):
            name, _, ids = e.name().partition(" ")
            ranges.append((name[3:], ids, e.start_thread_id(), e.start_ns(),
                           e.start_ns() + e.duration_ns()))
    assert {"submit", "process", "finalize", "transfer", "host_tail",
            *STEP_STAGES} <= _assert_nested(ranges, 1)


@pytest.mark.parametrize("tail", ["host", "device"])
def test_the_stage_split_adds_up(run, tail):
    totals = run(3, True, tail).totals
    stages = set(STEP_STAGES) | {"host_tail"}
    if tail == "device":
        stages |= set(TAIL_STAGES)
    assert stages <= set(totals)
    walls = {k: v for k, v in timers.stage_walls(totals).items() if k != "transfer"}
    assert set(walls) == stages
    assert {"host_blocked", "device_drain", "transfer.cpu"} <= set(totals)
    cpu = sum(totals[k + ".cpu"] for k in walls)
    assert math.isclose(sum(walls.values()),
                        cpu + totals["host_blocked"] + totals["device_drain"],
                        rel_tol=1e-9, abs_tol=1e-9)
    # the CPU device has no stream: its syncs wait for nothing
    assert totals["device_drain"] < 0.01 * sum(walls.values())


@pytest.mark.parametrize("depth", [1, 3])
def test_records_equal_with_tracing_on_and_off(run, depth):
    assert run(depth, True).records == run(depth, False).records
    assert len(run(depth, True).records) == BATCH * N_BATCHES


@pytest.mark.parametrize("depth", [1, 3])
def test_worker_waits_are_booked_at_depth_3_only(run, depth):
    on = run(depth, True)
    if depth == 1:
        assert not {"worker_wait", "handoff"} & set(on.totals)
    else:
        # every chunk handed to a worker is waited for and taken back once
        n_chunks = sum(n == "process" for n, *_ in on.ranges)
        assert on.counts["worker_wait"] == on.counts["handoff"] == n_chunks >= N_BATCHES
        assert on.totals["worker_wait"] >= 0.0 and on.totals["handoff"] >= 0.0
        assert "worker_wait.cpu" not in on.totals


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing_cli")
    write_fixture(d)
    assert cli.main(["-x", "sensitive", "-p", str(d / "pore.model"), "-d",
                     str(d / "ref.rhi.npz"), str(d / "ref.fa")]) == 0
    return d


@pytest.mark.parametrize("flag", [True, False])
def test_cli_profile_flag_prints_the_stage_profile(fixture, capsys, flag):
    d = fixture
    args = ["-x", "sensitive", "--max-anchors", "512", "--device", "cpu",
            "-o", str(d / f"out{int(flag)}.paf"), str(d / "ref.rhi.npz"),
            str(d / "reads.sig.npz")]
    assert cli.main(args + ["--profile"] * flag) == 0
    err = capsys.readouterr().err
    assert ("stage profile" in err) == flag
    if flag:
        assert "events.cpu" in err and "host_blocked" in err
    assert "mapped 6/6 reads" in err
