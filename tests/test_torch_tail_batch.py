"""The device tail's batch decision: one native call a chunk
(_native.tail_decide_batch, rh_tail_decide_batch in chain_tail.cpp) held
field for field against the plain pipeline in numpy and Python
(gen_regs_from_summaries, set_parent, select_sub, set_mapq,
MappingEngine._decide) on seeded random chain summaries; the engine's
records on the forced device tail equal to the host tail's, which decides
each read in Python, at depths 1 and 3; and without the native library the
engine keeps the host tail, even when the device tail is forced, with the
same records."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small tensors; xdist workers share the cores

from rawhash_tpu_torch import _native  # noqa: E402
from rawhash_tpu_torch._native import get_lib, tail_decide_batch  # noqa: E402
from rawhash_tpu_torch.chain.regions import (  # noqa: E402
    REGION_COLUMNS, Region, gen_regs_from_summaries, select_sub, set_mapq,
    set_parent, wang_hash32,
)
from rawhash_tpu_torch.config import MapFlag, apply_depletion  # noqa: E402
from rawhash_tpu_torch.index.build import build_index_from_signals  # noqa: E402
from rawhash_tpu_torch.map import engine as eng_mod  # noqa: E402
from rawhash_tpu_torch.map.engine import MappingEngine  # noqa: E402
from rawhash_tpu_torch.synthetic import (  # noqa: E402
    ava_fixture_reads, deployment, options,
)

SPAN = 13


def _mopt(preset: str):
    """The MapOptions of a case: a -x preset, or sensitive with
    --depletion (best_n 5, so select_sub keeps secondaries)."""
    if preset == "depletion":
        mo = options("sensitive")[1]
        apply_depletion(mo)
        return mo
    return options(preset)[1]


def _chain(rng, score=None, cnt=None, rid=None, rev=None, qs=None, ln=None):
    """One summary row: score, cnt, key, tpos0, qpos0, tposL, qposL, mlen,
    blen, valid; query intervals in a narrow window so they overlap."""
    score = int(rng.integers(0, 300)) if score is None else score
    cnt = int(rng.integers(1, 30)) if cnt is None else cnt
    rid = int(rng.integers(0, 3)) if rid is None else rid
    rev = int(rng.integers(0, 2)) if rev is None else rev
    qs = int(rng.integers(0, 400)) if qs is None else qs
    ln = int(rng.integers(20, 300)) if ln is None else ln
    ts = int(rng.integers(0, 50_000))
    return [score, cnt, np.uint32((rev << 31) | rid).view(np.int32), ts, qs,
            ts + ln, qs + ln, int(rng.integers(10, 200)), ln + 13, 1]


def _single_at_min_mapq(mo):
    """A single chain and a rep_len at which set_mapq gives exactly
    min_mapq."""
    for rep in range(0, 200_000, 3):
        reg = Region(score=200, score0=200, cnt=20, parent=0, id=0)
        set_mapq([reg], mo.min_chaining_score, rep, False)
        if reg.mapq == mo.min_mapq:
            return rep
    raise AssertionError("no rep_len gives min_mapq")


def _batch(rng, mo, b=64, k=10):
    """Seeded random summaries and scalars of b rows, and the rows' active
    mask and slen, with the cases the decision branches on placed in rows
    0-9 and the rest random."""
    summ = np.zeros((b, k, 10), np.int32)
    scal = np.zeros((b, 8), np.int32)
    n_u = rng.integers(0, k + 1, b)
    for i in range(b):
        for c in range(n_u[i]):
            summ[i, c] = _chain(rng)
    n_u[0] = 0  # processed, no chains
    # score ties: a duplicated chain and equal scores elsewhere
    summ[1, :4] = [_chain(rng, score=150, cnt=12, rid=1, rev=0, qs=10, ln=200)] * 2 \
        + [_chain(rng, score=150, cnt=5), _chain(rng, score=150, cnt=12)]
    n_u[1] = 4
    # short chains: score <= 100 and cnt <= 10, and a primary of score 0
    # (score0 0) on a query interval of its own
    summ[2, :3] = [_chain(rng, score=s, cnt=c, qs=q, ln=250)
                   for s, c, q in ((90, 8, 0), (40, 3, 0), (0, 2, 1000))]
    n_u[2] = 3
    # a secondary below min_chaining_score (its primary's subsc under it),
    # and one of more anchors than its primary (n_sub > 0)
    lo = mo.min_chaining_score - 5
    summ[3, :2] = [_chain(rng, score=250, cnt=12, rid=0, qs=100, ln=300),
                   _chain(rng, score=lo, cnt=4, rid=1, qs=110, ln=280)]
    summ[9, :2] = [_chain(rng, score=250, cnt=12, rid=0, qs=100, ln=300),
                   _chain(rng, score=120, cnt=25, rid=2, qs=105, ln=290)]
    n_u[3] = n_u[9] = 2
    # a single chain whose MAPQ is exactly min_mapq
    summ[4, :1] = [_chain(rng, score=200, cnt=20)]
    n_u[4] = 1
    scal[:, 0] = n_u
    scal[:, 1] = rng.integers(0, 600, b)  # rep_len
    scal[4, 1] = _single_at_min_mapq(mo)
    scal[:, 3] = 1  # processed
    scal[5, 3] = 0  # live, not processed
    scal[:, 5] = rng.integers(0, 2**31 - 1, b)  # ev_offset
    active = np.ones(b, bool)
    active[6] = False  # finished earlier
    slen = rng.integers(1, 4000, b).astype(np.int32)
    slen[7] = 0  # no signal left
    summ[8] = summ[3]  # a twin of row 3, inactive
    scal[8] = scal[3]
    active[8] = False
    return summ, scal, active, slen


def _plain(mo, summ, scal, active, slen):
    """The plain pipeline on the same rows: {row: (regions, ids, done)}."""
    all_chains = bool(mo.flag & MapFlag.ALL_CHAINS)
    par, sel = eng_mod._tail_params(mo)
    stub = types.SimpleNamespace(mopt=mo)
    out = {}
    for i in range(summ.shape[0]):
        if not active[i] or slen[i] == 0 or not scal[i, 3]:
            continue
        h = wang_hash32((wang_hash32(int(scal[i, 5])) + wang_hash32(11)) & 0xFFFFFFFF)
        regs = gen_regs_from_summaries(h, summ[i, :scal[i, 0]], SPAN)
        set_parent(regs, *par)
        if not all_chains:
            regs = select_sub(regs, *sel)
        set_mapq(regs, mo.min_chaining_score, int(scal[i, 1]), False)
        ids, done = MappingEngine._decide(stub, regs, False)
        out[i] = (regs, ids, done)
    return out


@pytest.mark.skipif(get_lib() is None, reason="no native toolchain")
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("preset", ["sensitive", "depletion", "ava-viral"])
def test_batch_decision_matches_the_plain_pipeline(preset, seed):
    mo = _mopt(preset)
    rng = np.random.default_rng(seed)
    summ, scal, active, slen = _batch(rng, mo)
    before = active.copy()
    rows, ids, off, n_regs, n_ids = tail_decide_batch(
        summ, scal, active, slen, SPAN, *eng_mod._tail_params(mo)[0],
        bool(mo.flag & MapFlag.ALL_CHAINS), *eng_mod._tail_params(mo)[1],
        mo.min_chaining_score, mo.min_mapq, mo.w_bestq, mo.w_bestmq,
        mo.w_bestmc, mo.w_threshold, mo.min_chaining_score2,
    )
    np.testing.assert_array_equal(active, before)  # the call writes no input
    want = _plain(mo, summ, scal, active, slen)
    assert sorted(want) == list(np.nonzero(n_regs >= 0)[0])
    assert {5, 6, 7, 8}.isdisjoint(want)
    for i, (regs, w_ids, done) in want.items():
        assert n_regs[i] == len(regs), i
        got = rows[off[i]:off[i] + n_regs[i]]
        for r, g in zip(regs, got.tolist()):
            assert g == [getattr(r, f) for f in REGION_COLUMNS + ("mapq",)], (i, r, g)
        assert (n_ids[i] > 0) == done, i
        assert ids[off[i]:off[i] + n_ids[i]].tolist() == (w_ids if done else []), i
    assert rows.shape[0] == sum(len(r) for r, _, _ in want.values())

    # the branches the rows were built for were taken
    regs = {i: r for i, (r, _, _) in want.items()}
    assert regs[0] == []
    assert len({r.score for r in regs[1]}) < len(regs[1])  # ties
    assert any(r.score <= 100 and r.cnt <= 10 for r in regs[2])
    assert any(r.score0 == 0 for r in regs[2])
    assert any(0 < r.subsc < mo.min_chaining_score for r in regs[3])
    assert any(r.n_sub > 0 for r in regs[9])
    assert len(regs[4]) == 1 and regs[4][0].mapq == mo.min_mapq and want[4][2]
    assert any(d for _, _, d in want.values())
    assert not all(d for _, _, d in want.values())


def _records(results):
    """Every field of every record, without the wall-clock mt:f tag."""
    return [(r.name, [(m.read_length, m.ref_id, m.read_start, m.read_end,
                       m.frag_start, m.frag_len, m.mapq, m.rev, m.mapped,
                       m.tags.split("\t", 1)[1]) for m in r.records])
            for r in results]


@pytest.fixture(scope="module")
def workloads():
    """Three batches of four sensitive reads, and the all-vs-all fixture's
    signal-target index with its reads in two batches."""
    index, _, reads = deployment(20_000, "sensitive", 12, 900, 4096, seed=23)
    ava_reads = ava_fixture_reads()
    ava_io, _ = options("ava-viral")
    return {
        "sensitive": (index, [[(n, s) for n, s, _, _ in reads[i:i + 4]]
                              for i in range(0, 12, 4)]),
        "ava-viral": (build_index_from_signals(ava_reads, None, ava_io),
                      [ava_reads[:3], ava_reads[3:]]),
    }


def _map(workloads, preset, depth):
    """A run's records and stats, and whether it took the device tail."""
    index, batches = workloads[preset]
    mo = options(preset)[1]
    mo.max_anchors_per_read = 512 if preset == "ava-viral" else 4096
    mo.pipeline_depth = depth
    eng = MappingEngine(index, mo, device="cpu")
    recs = _records([r for rs in eng.map_stream(iter(batches)) for r in rs])
    return recs, eng.stats, eng.device_tail


@pytest.mark.parametrize("preset,depth", [("sensitive", 1), ("sensitive", 3),
                                          ("ava-viral", 3)])
def test_engine_records_equal_the_per_read_route(workloads, monkeypatch, preset,
                                                 depth):
    """The forced device tail's records equal the host tail's on the same
    batches; the host tail is the per-read route, deciding each read in
    Python (set_mapq, MappingEngine._decide), so this holds the native
    decision against the Python one through the engine (all-vs-all at
    depth 3 only: the device tail's plain backtrack is slow on the CPU)."""
    if get_lib() is None:
        pytest.skip("no native toolchain")
    monkeypatch.delenv("RAWHASH_TPU_NO_DEVICE_TAIL", raising=False)
    monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
    got, stats, device_tail = _map(workloads, preset, depth)
    assert device_tail and stats["tail_chunks"] > 0
    monkeypatch.delenv("RAWHASH_TPU_DEVICE_TAIL")
    monkeypatch.setenv("RAWHASH_TPU_NO_DEVICE_TAIL", "1")
    want, ref, device_tail = _map(workloads, preset, depth)
    assert not device_tail and ref["tail_chunks"] == 0
    assert got == want
    assert sum(m[8] for _, recs in got for m in recs) >= 3


@pytest.mark.parametrize("depth", [1, 3])
def test_engine_records_without_the_native_library(workloads, monkeypatch,
                                                   capsys, depth):
    """With no native library the engine refuses the device tail, even
    forced, and says so; its host tail (numpy throughout) gives the device
    tail's records."""
    monkeypatch.setenv("RAWHASH_TPU_DEVICE_TAIL", "1")
    monkeypatch.delenv("RAWHASH_TPU_NO_DEVICE_TAIL", raising=False)
    with_lib = None
    if get_lib() is not None:
        with_lib = _map(workloads, "sensitive", depth)
        assert with_lib[2] and with_lib[1]["tail_chunks"] > 0
    monkeypatch.setattr(_native, "get_lib", lambda: None)
    capsys.readouterr()
    got, stats, device_tail = _map(workloads, "sensitive", depth)
    assert not device_tail and stats["tail_chunks"] == 0
    assert "RAWHASH_TPU_DEVICE_TAIL not applied" in capsys.readouterr().err
    if with_lib is not None:
        assert got == with_lib[0]
